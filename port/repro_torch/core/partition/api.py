"""Partitioner registry and the common result structure.

Every partitioner is a function ``(mbrs, payload, **kw) ->
Partitioning``.  The paper's Table-1 classification is attached as
registry metadata, as in ``repro.core.partition.api``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Partitioning:
    """A set of (possibly padded) partition regions.

    boxes : (kmax, 4) float32 partition boundaries
    valid : (kmax,)  bool -- real partitions vs padding rows
    """

    boxes: torch.Tensor
    valid: torch.Tensor

    @property
    def kmax(self) -> int:
        return self.boxes.shape[0]

    def k(self) -> int:
        return int(self.valid.sum())

    @classmethod
    def from_numpy(cls, boxes, valid, device: torch.device | str
                   ) -> "Partitioning":
        """Carry a partitioning (e.g. ``repro``'s) across as tensors."""
        return cls(
            boxes=torch.as_tensor(np.array(boxes, np.float32),
                                  device=device),
            valid=torch.as_tensor(np.array(valid, bool), device=device))


@dataclasses.dataclass(frozen=True)
class MethodInfo:
    fn: Callable
    overlapping: bool          # Table 1: partition-boundary dimension
    search: str                # "top-down" | "bottom-up" | "na"
    criterion: str             # "space" | "data"
    covers_universe: bool      # tight-MBR methods may leave gaps


_REGISTRY: dict[str, MethodInfo] = {}


def register(name: str, *, overlapping: bool, search: str, criterion: str,
             covers_universe: bool):
    def deco(fn):
        _REGISTRY[name] = MethodInfo(fn, overlapping, search, criterion,
                                     covers_universe)
        return fn
    return deco


def methods() -> dict[str, MethodInfo]:
    return dict(_REGISTRY)


def info(name: str) -> MethodInfo:
    return _REGISTRY[name]


def partition(method: str, mbrs: torch.Tensor, payload: int, **kw
              ) -> Partitioning:
    """Run a registered partitioner. ``payload`` is the paper's ``b``."""
    if method not in _REGISTRY:
        raise KeyError(f"unknown partition method {method!r}; "
                       f"have {sorted(_REGISTRY)}")
    return _REGISTRY[method].fn(mbrs, payload, **kw)
