"""Correctly rounded float32 ``fma(a, b, c)`` and ``sqrt(x)`` from
float64 ops.

XLA on the CPU contracts some ``a*b + c`` of the reference into one
fused multiply-add under ``jit`` (ROADMAP Queue 3: the kNN ``d2``, the
fixed grid's edges).  The port reproduces those bits on any device:
``a*b`` of two float32 values is exact in float64, TwoSum gives the
exact sum as ``s + e``, and rounding ``s`` to odd before the float32
rounding keeps the double rounding exact (53 >= 24 + 2 bits).

torch's float32 ``sqrt`` on the CPU is not correctly rounded on every
host (AVX-512, torch 2.13: about one value in six is an ulp off), where
the reference's ``jnp.sqrt`` is.  ``sqrt32`` rounds the float64 root to
float32: rounding twice is exact for a square root (53 >= 2*24 + 2
bits), and on CUDA it gives the bits of the float32 ``sqrt``.
"""
from __future__ import annotations

import torch


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
          ) -> torch.Tensor:
    """float32 ``a*b + c`` with one rounding (broadcasting)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((e != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``sqrt(x)``, correctly rounded on every host."""
    return x.double().sqrt().float()
