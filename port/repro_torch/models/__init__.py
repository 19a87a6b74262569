"""The LM substrate (twin of ``repro.models``), ssm family: Mamba2
prefill through the CUDA SSD intra-chunk kernel and greedy decode
through the state recurrence.

``config`` holds ``ModelConfig``, ``layers`` the init and RMS norm,
``ssm`` the Mamba2 mixer, ``blocks`` and ``lm`` the decoder, ``api``
``build`` and the prefill and serve steps, ``convert`` the bridge from
``repro``'s parameter pytree.
"""
