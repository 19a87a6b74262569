"""Roofline terms of one rank's step, counted on fake tensors (twin of
``repro.launch.roofline``).

Three terms per (arch x shape x mesh), all per rank:

  compute    = FLOPs                / PEAK_FLOPS   [989e12 bf16]
  memory     = bytes                / HBM_BW       [3.35e12 B/s]
  collective = sum of link_bytes(op) / LINK_BW     [450e9 B/s]

The reference reads these from XLA's compiled per-device program.  The
port runs the rank's eager step once on fake tensors (``count``):
``torch.utils.flop_counter.FlopCounterMode`` counts the FLOPs, a
dispatch mode (``Tally``) counts every aten op's input and output bytes
and tracks the live bytes for the peak, and a ``launch.mesh.
RecordingMesh`` records the collectives, which ``collective_bytes``
costs with the reference's ring model.  The bytes are the *eager*
program's: every op reads its inputs and writes its outputs through
memory, so they are an upper figure beside XLA's fused "bytes
accessed".  link_bytes applies the ring cost model per op: all-reduce
moves about 2x its operand a link; all-gather and all-to-all about 1x
their result.
"""
from __future__ import annotations

import dataclasses
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

# datasheet peaks of the NVIDIA H100 80GB HBM3 (SXM, dense, 700 W)
PEAK_FLOPS = 989e12          # bf16 tensor-core FLOP/s
HBM_BW = 3.35e12             # B/s
LINK_BW = 450e9              # B/s, NVLink 4, one direction
HBM_BYTES = 80e9             # a card's memory

# Per-rank link bytes under a ring algorithm, in terms of the op's
# RESULT size R and group size g:
#   all-reduce:         operand==result==R; ring moves 2R(g-1)/g ~ 2R
#   all-gather:         result R = g*operand; ring moves R(g-1)/g ~ R
#   reduce-scatter:     result R = operand/g; ring moves R(g-1)
#   all-to-all:         moves R(g-1)/g ~ R
#   collective-permute: moves R
_COLL_RESULT_FACTOR = {
    "all-reduce": lambda g: 2.0 * (g - 1) / max(g, 1),
    "all-gather": lambda g: 1.0 * (g - 1) / max(g, 1),
    "reduce-scatter": lambda g: float(g - 1),
    "all-to-all": lambda g: 1.0 * (g - 1) / max(g, 1),
    "collective-permute": lambda g: 1.0,
}


def collective_bytes(ops, default_group: int = 16) -> dict:
    """Per-op-kind per-rank link bytes (ring model) of recorded
    collectives: ``ops`` is a ``RecordingMesh``'s list of (kind, result
    bytes, group size); kinds outside the model (a barrier) move
    nothing.  -> {kind: bytes, "total": bytes, "ops": {kind: count}}."""
    out: dict = {k: 0.0 for k in _COLL_RESULT_FACTOR}
    counts: dict[str, int] = {}
    for kind, r, g in ops:
        if kind not in _COLL_RESULT_FACTOR:
            continue
        out[kind] += r * _COLL_RESULT_FACTOR[kind](g or default_group)
        counts[kind] = counts.get(kind, 0) + 1
    out["total"] = sum(out.values())
    out["ops"] = counts
    return out


# allocations move no data
_ALLOC = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided"}


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) \
        else 0


class Tally(TorchDispatchMode):
    """Counts every aten op's input and output bytes (``bytes``; an
    allocation, or an op whose outputs all alias its inputs without
    writing them, a view, moves none) and tracks the bytes of the live storages
    (``live``, ``peak``): a storage counts from the op that makes it
    until it is freed.  ``hold`` counts the storages of tensors made
    before it (a step's starting state)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._seen: dict[int, int] = {}

    def hold(self, tensors) -> None:
        for t in tensors:
            self._add(t)

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        self._seen[key] = n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if outs and func.namespace == "aten" \
                and func.overloadpacket.__name__ not in _ALLOC:
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            held = {id(t.untyped_storage()) for t in ins}
            if func._schema.is_mutable or any(
                    id(t.untyped_storage()) not in held for t in outs):
                self.bytes += (sum(map(_nbytes, ins))
                               + sum(map(_nbytes, outs)))
        for t in outs:
            self._add(t)
        return out


@dataclasses.dataclass
class Counts:
    """One run of a rank's step: FLOPs, bytes, the collectives'
    ``collective_bytes``, the peak live bytes (the starting state
    included) and the run's seconds."""

    flops: int
    hbm_bytes: int
    coll: dict
    peak_memory: int
    seconds: float


def count(fn, mesh=None, hold=()) -> tuple:
    """Run ``fn()`` once under the counters -> (``Counts``, its result).
    ``mesh``: the ``RecordingMesh`` whose collectives it makes; ``hold``:
    the tensors of the starting state, whose bytes the peak includes.
    Run it on fake tensors (inside their ``FakeTensorMode``) for the
    dry-run; on real ones it counts the same."""
    start = len(mesh.ops) if mesh is not None else 0
    tally = Tally()
    tally.hold(hold)
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc, tally:
        out = fn()
    seconds = time.perf_counter() - t0
    ops = mesh.ops[start:] if mesh is not None else []
    return Counts(fc.get_total_flops(), tally.bytes, collective_bytes(ops),
                  tally.peak, seconds), out


@dataclasses.dataclass
class Roofline:
    flops: float                # per-rank FLOPs
    hbm_bytes: float            # per-rank bytes accessed (eager)
    coll_bytes: float           # per-rank link bytes (ring model)
    coll_detail: dict
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    peak_memory: int            # per-rank live bytes at the peak

    def dominant(self):
        return max(("compute", self.t_compute),
                   ("memory", self.t_memory),
                   ("collective", self.t_collective), key=lambda kv: kv[1])


def analyze(c: Counts) -> Roofline:
    coll = c.coll
    tc = c.flops / PEAK_FLOPS
    tm = c.hbm_bytes / HBM_BW
    tl = coll["total"] / LINK_BW
    name = max([("compute", tc), ("memory", tm), ("collective", tl)],
               key=lambda kv: kv[1])[0]
    return Roofline(flops=float(c.flops), hbm_bytes=float(c.hbm_bytes),
                    coll_bytes=coll["total"], coll_detail=coll,
                    t_compute=tc, t_memory=tm, t_collective=tl,
                    bottleneck=name, peak_memory=int(c.peak_memory))


def model_flops(cfg, shape, chips: int) -> float:
    """6·N_active·D per chip (dense: N_active = N)."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        factor = 6.0
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        factor = 2.0
    else:  # decode: one token per sequence
        tokens = shape.global_batch
        factor = 2.0
    return factor * n * tokens / chips


def useful_ratio(cfg, shape, chips: int, rl: Roofline) -> float:
    return model_flops(cfg, shape, chips) / max(rl.flops, 1.0)
