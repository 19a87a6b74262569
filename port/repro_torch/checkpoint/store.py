"""Checkpoint save and restore (twin of ``repro.checkpoint.store``).

Checkpoints hold logical shapes, one ``.npy`` a leaf and a
``manifest.json``, bf16 stored as a uint16 view, as the reference
writes them.  Writes are atomic (a temporary directory, then a
rename), so a crash mid-save never corrupts the latest checkpoint: the
FT runtime (``repro_torch.ft``) relies on it.  ``restore`` places each
leaf on ``map_location``, or on the device of the leaf it replaces.

Under a mesh (``shardings``, a ``dist.parallel.StateSpecs``) ``save``
gathers each leaf to its logical shape on every rank, rank 0 writes it
and the others wait at a barrier; ``restore`` cuts each logical leaf
to this rank's block under the target mesh's specs, which need not be
the mesh that saved it (elastic), and without ``shardings`` it restores
the whole state on one device.

A state is a tensor, a dict, a dataclass (``TrainState``,
``OptState``) or a module (its parameters), nested; a leaf is named by
its path, joined by "/" (``params/blocks.0.ssm.in_proj``,
``opt/m/embed``, ``step``).
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import shutil
import tempfile

import numpy as np
import torch
from torch import nn

from ..dist import parallel


def _flatten(state, prefix: str = ""):
    """(name, tensor) for every leaf of ``state``, in order."""
    if isinstance(state, torch.Tensor):
        return [(prefix.rstrip("/"), state)]
    if isinstance(state, nn.Module):
        return [(prefix + k, p) for k, p in state.named_parameters()]
    if dataclasses.is_dataclass(state):
        items = [(f.name, getattr(state, f.name))
                 for f in dataclasses.fields(state)]
    elif isinstance(state, dict):
        items = list(state.items())
    else:
        raise TypeError(f"cannot checkpoint a {type(state).__name__}")
    return [leaf for k, v in items for leaf in _flatten(v, f"{prefix}{k}/")]


def _rebuild(like, leaves: dict, prefix: str = ""):
    """A state of ``like``'s structure whose leaves are ``leaves``."""
    if isinstance(like, torch.Tensor):
        return leaves[prefix.rstrip("/")]
    if isinstance(like, nn.Module):
        # a module's structure around new parameters, nothing else copied
        memo = {id(p): nn.Parameter(leaves[prefix + k],
                                    requires_grad=p.requires_grad)
                for k, p in like.named_parameters()}
        return copy.deepcopy(like, memo)
    if dataclasses.is_dataclass(like):
        return dataclasses.replace(like, **{
            f.name: _rebuild(getattr(like, f.name), leaves,
                             f"{prefix}{f.name}/")
            for f in dataclasses.fields(like)})
    return {k: _rebuild(v, leaves, f"{prefix}{k}/") for k, v in like.items()}


def save(path: str, state, step: int, shardings=None) -> str:
    """Atomically write ``state`` to ``path/step_<N>``; every rank of
    ``shardings.mesh`` calls it (module docstring)."""
    items = _flatten(state)
    final = os.path.join(path, f"step_{step:08d}")
    if shardings is None:
        return _write(path, final, step, items, None)
    try:
        if shardings.mesh.rank == 0:
            return _write(path, final, step, items, shardings)
        for name, leaf in items:        # the gathers rank 0 writes from
            _logical(leaf, name, shardings)
        return final
    finally:
        shardings.mesh.barrier()


def _logical(leaf: torch.Tensor, name: str, shardings) -> torch.Tensor:
    """The leaf's logical (whole) value, gathered over the mesh."""
    t = leaf.detach()
    if shardings is None:
        return t
    return parallel.unshard(t, shardings.leaf(name, t.dim()),
                            shardings.mesh)


def _write(path: str, final: str, step: int, items: list, shardings) -> str:
    os.makedirs(path, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=path, prefix=".tmp_ckpt_")
    manifest = {"step": step, "leaves": []}
    try:
        for i, (name, leaf) in enumerate(items):
            t = _logical(leaf, name, shardings).cpu()
            dtype = str(t.dtype).removeprefix("torch.")
            if t.dtype == torch.bfloat16:   # numpy has no bf16
                arr = t.view(torch.int16).numpy().view(np.uint16)
            else:
                arr = t.numpy()
            np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
            manifest["leaves"].append(
                {"name": name, "file": f"leaf_{i:05d}.npy",
                 "dtype": dtype, "shape": list(arr.shape)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(path)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore(path: str, like, step: int | None = None, map_location=None,
            shardings=None):
    """Restore into the structure of ``like`` -> (state, step): the
    latest step unless ``step`` is given, each leaf on
    ``map_location`` or else on the device of ``like``'s leaf, and cut
    to this rank's block under ``shardings`` (a
    ``dist.parallel.StateSpecs``) where given."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {m["name"]: m for m in manifest["leaves"]}
    leaves = {}
    for name, leaf in _flatten(like):
        m = by_name[name]
        arr = np.load(os.path.join(d, m["file"]))
        if m["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if shardings is not None:
            t = parallel.shard(t, shardings.leaf(name, t.dim()),
                               shardings.mesh)
        leaves[name] = t.to(leaf.device if map_location is None
                            else map_location)
    return _rebuild(like, leaves), manifest["step"]
