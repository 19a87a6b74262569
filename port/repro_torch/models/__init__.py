"""The LM substrate (twin of ``repro.models``): Mamba2 prefill through
the CUDA SSD intra-chunk kernel and greedy decode through the state
recurrence; the dense, MoE, hybrid (RG-LRU), encoder-decoder and vlm
families' prefill and greedy decode.

``config`` holds ``ModelConfig``, ``layers`` the init, RMS norm, RoPE,
attention and gated MLP, ``ssm`` the Mamba2 mixer, ``moe`` the routed
experts, ``rglru`` the recurrent block, ``blocks`` and ``lm`` the
decoder, ``encdec`` the encoder-decoder, ``api`` ``build`` and the
prefill, serve and train steps, ``convert`` the bridge from ``repro``'s
parameter pytree.
"""
