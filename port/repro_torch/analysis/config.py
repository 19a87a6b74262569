"""Rule configuration for the port's hazard checker (twin of
``repro.analysis.config``, its vocabulary read from this package's own
code).

Everything package-specific lives here so the rule engines in r1..r5
stay mechanical: the closure sinks, the staging-attribute vocabulary,
torch's tensor producers, the hot-path module set for the host-sync
audit, the module/function allowlist (each entry carries its rationale
— the analyzer refuses entries without one), the width parameters R2
guards, and the input table for kernel-twin parity.
"""

from __future__ import annotations

import torch

# ---------------------------------------------------------------------------
# torch's vocabulary (ArrayishEnv)
# ---------------------------------------------------------------------------

# A call ``<module>.<op>(...)`` with the module resolved through the
# file's imports returns a tensor when the module is one of these and
# the op is not in NON_TENSOR_FUNCS (the ones the package calls).
# ``torch.cuda.*``, ``torch.distributed.*`` and ``torch.backends.*``
# return no tensor.
TENSOR_MODULES = {"torch", "torch.nn.functional"}
NON_TENSOR_FUNCS = {"device", "Generator", "finfo", "is_grad_enabled",
                    "no_grad", "enable_grad"}
# Annotations that make a parameter a tensor.
TENSOR_TYPES = {"torch.Tensor", "torch.nn.Parameter"}
# Methods that return a tensor whatever they are called on (a tensor or
# a value the analyzer cannot classify).
TENSOR_MOVES = {"to", "cuda"}
# Methods only a torch tensor has (numpy's arrays have none of them):
# a name they are called on is a tensor in that function.
TENSOR_ONLY_METHODS = {"numel", "data_ptr", "element_size", "is_contiguous",
                       "contiguous"}

# ---------------------------------------------------------------------------
# R1 closure capture
# ---------------------------------------------------------------------------

# A call whose callee's final name is one of these keeps the callable
# it receives past the call, or runs it where a re-stage can come
# between: a staged tensor captured by closure is then the *old*
# staging, served stale and kept resident after ``_TilesBase._restage``
# released it (the doubled-capacity re-stage that ran the card out of
# memory).  Each entry, from the package's own code:
CLOSURE_SINKS = {
    # launch/mesh.py: ``fn(rank, *args)`` runs in spawned ranks after
    # the caller moved on; a captured tensor is copied into every rank
    "spawn",
    # launch/mesh.py: ``fn()`` runs once a rank in turn, each turn
    # after the card's cached blocks were handed back; a captured
    # staging stays resident through every rank's turn
    "in_turns",
    # models/lm.py, models/encdec.py: torch.utils.checkpoint runs the
    # callable again in the backward; a captured tensor is held until
    # then and read as it is then, not as the forward read it
    "checkpoint",
    # serve/frontend/frontend.py: the asyncio frontend hands the batch
    # callable to its executor thread, which runs it after batches
    # formed later; concurrent.futures' ``submit`` likewise
    "run_in_executor", "submit",
    # serve/frontend/sim.py: ``execute=`` is kept and called for every
    # batch of the simulated stream
    "simulate_open_loop",
}

# Attribute names that hold staged device tensors.  An attribute access
# with one of these names is classified "arrayish" regardless of the
# object it hangs off — the vocabulary is the staging convention of
# serve/layout.py: ``StagedLayout`` and ``ShardedLayout``'s fields, and
# what ``_TilesBase``, ``ReplicatedTiles``, ``ShardedTiles`` and
# ``HeatSharded`` hold on the device (``staged``, ``slayout``, the live
# ``extent``, the flat shard-row maps ``_rows`` / ``_rep_rows``, the
# dense oracle's ``_oracle_t``).  Their host mirrors (``_canon_np``,
# ``_alive_np``, ...) are numpy and are not listed.
STAGING_ATTRS = {
    "tiles", "ids", "canon_tiles", "tile_boxes", "probe_boxes",
    "chunk_boxes", "alive", "uni", "canon_shards", "id_shards",
    "alive_shards", "chunk_shards", "staged", "slayout", "gtiles",
    "extent", "_rows", "_rep_rows", "_oracle_t",
}

# Attribute accesses and methods that read host-side metadata off a
# tensor without a transfer — never a sync, never arrayish.
META_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "layout",
              "requires_grad", "nbytes", "itemsize"}
META_METHODS = {"numel", "dim", "size", "stride", "element_size",
                "data_ptr", "is_contiguous"}

# ---------------------------------------------------------------------------
# R2 recompile hazard
# ---------------------------------------------------------------------------

# Calls that launder a data-dependent int into a bucketed one: round_up
# (core/partition/assign.py), _f_width (serve/engine.py), and the
# reference's _pad_pow2 (no port counterpart; kept so a port of it is
# recognised).
SANITIZER_FUNCS = {"round_up", "_f_width", "_pad_pow2"}
# Method-call sanitizers: WidthPolicy.at_least/.start and the power-of-2
# idiom ``(n - 1).bit_length()``.
SANITIZER_METHODS = {"at_least", "start", "bit_length"}

# The width parameters of the port: (module suffix, function) -> the
# reference counterpart's ``static_argnames``, copied from its
# decorators (the port imports nothing of the reference).  The index
# keeps the names the port's signature still has (no ``interpret``, no
# ``bq``: the port has no interpret mode and the kernels pick their own
# blocks).
STATIC_WIDTHS = {
    ("serve/router.py", "candidates_from_overlap"): {"f_max"},
    ("serve/router.py", "candidate_knn"): {"f_max"},
    ("kernels/range_probe/ops.py", "probe_counts"): {"bq", "interpret"},
    ("kernels/range_probe/ops.py", "gathered_counts"): {"bq", "interpret"},
    ("kernels/range_probe/ops.py", "gathered_mask"): {"bq", "interpret"},
    ("kernels/range_probe/ops.py", "probe_mask"): {"bq", "interpret"},
    ("kernels/range_probe/ops.py", "probe_counts_skip"): {"bq", "interpret"},
    ("kernels/range_probe/ops.py", "probe_mask_skip"): {"bq", "interpret"},
    ("kernels/range_probe/ops.py", "gathered_counts_skip"): {
        "bq", "interpret"},
    ("kernels/range_probe/ops.py", "gathered_mask_skip"): {"bq", "interpret"},
    ("kernels/ssd/ops.py", "ssd_forward"): {"chunk", "interpret",
                                            "use_kernel"},
    ("kernels/hilbert/ops.py", "encode"): {"order", "interpret"},
    ("kernels/hilbert/ops.py", "hilbert_keys"): {"order", "interpret"},
    ("kernels/mbr_join/ops.py", "join_count"): {"br", "bs", "interpret"},
    ("kernels/mbr_join/ops.py", "join_mask"): {"br", "bs", "interpret"},
    ("query/knn.py", "batched_knn"): {"k", "max_rounds", "max_cand"},
    ("query/knn.py", "pruned_knn"): {"k", "max_rounds", "max_cand"},
    ("query/knn.py", "knn_partial"): {"k", "max_cand"},
    ("query/join.py", "tile_join_count"): {"dedup"},
    ("query/join.py", "tile_join_pairs"): {"max_pairs", "dedup"},
    ("query/range.py", "range_ids"): {"max_hits"},
    ("query/range.py", "pruned_range_ids"): {"max_hits"},
    ("query/range.py", "routed_range_counts"): {"max_fanout"},
}

# ---------------------------------------------------------------------------
# R3 host-sync audit
# ---------------------------------------------------------------------------

# Modules on the per-batch hot path: a device->host read here is a
# synchronization stall unless explicitly justified.  Matched as
# posix-path suffixes against the scanned file's path.  The reference's
# ten serving modules, and the join kernel's wrapper: the paper's join
# (query/engine.py ``masj_pairs``, ``tile_counts``) is the other
# request the port answers, once a join on one device and once a rank
# under a mesh, and its pair list reads its total there — so it is
# audited like the serving modules.
HOT_MODULES = (
    "serve/layout.py",
    "serve/engine.py",
    "serve/exchange.py",
    "serve/router.py",
    "query/range.py",
    "query/knn.py",
    "kernels/range_probe/ops.py",
    "kernels/range_probe/ref.py",
    "kernels/range_probe/kernel.py",
    "core/placement.py",
    "kernels/mbr_join/kernel.py",
)

# Builtin casts that force a device->host transfer when fed a device
# tensor, the numpy download calls, the tensor methods that copy to the
# host, and the call that waits for the whole device.
HOST_CAST_FUNCS = {"float", "int", "bool"}
NUMPY_DOWNLOAD_FUNCS = {"asarray", "array"}
HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
DEVICE_WAITS = {"torch.cuda.synchronize"}

# ---------------------------------------------------------------------------
# Allowlist: (path suffix, function name or None for whole module, rule
# id or None for all rules, rationale).  The rationale is mandatory —
# these are deliberate host-side planes, documented here instead of
# sprinkling dozens of inline suppressions over code that is host-side
# by design.
# ---------------------------------------------------------------------------

ALLOWLIST = (
    ("serve/router.py", None, "host-sync",
     "global-index routing plane: folds overlap matrices to numpy by "
     "design — one transfer per batch, the price of host-side LPT "
     "packing, owner_split and heat tracking"),
    ("core/placement.py", None, "host-sync",
     "placement planning is host-only numpy (capped LPT, co-location "
     "local search); it reads tensors only as numpy inputs"),
    ("serve/layout.py", "stage_tiles", "host-sync",
     "staging-time capacity sizing and stats fold once per (re)stage, "
     "not per batch"),
    ("serve/layout.py", "shard_staged", "host-sync",
     "staging-time sharding planner: downloads the canonical staging "
     "once per (re)shard for host placement and the dense-oracle "
     "mirror"),
    # the reference's ``_mirror``: the port builds the mirrors at the
    # first mutation instead of at install
    ("serve/layout.py", "_ensure_mirror", "host-sync",
     "host mirror download: ingest bookkeeping needs numpy copies of "
     "the staged arrays, once per (re)install, at the first mutation"),
    # the known device->host reads, each deliberate: a length the next
    # allocation needs, or the flag that decides the next launch
    ("query/knn.py", "_deepen", "host-sync",
     "the reference's deepening while_loop runs on the host: one read "
     "of the continue flag a round decides whether the next round's "
     "counts launch"),
    ("serve/exchange.py", "any", "host-sync",
     "the sharded deepening's continue flag (all-reduced under a mesh, "
     "so every rank runs the same rounds): one read a round, as "
     "_deepen's"),
    ("kernels/range_probe/kernel.py", "emit_hits", "host-sync",
     "the routed hit list's length: the emit pass allocates its (3, "
     "total) rows from the scan's last entry, one read a hit-list call"),
    ("kernels/range_probe/kernel.py", "dense_emit_hits", "host-sync",
     "the dense hit list's length: one read of the scan's last entry a "
     "query block, to allocate the emitted rows"),
    ("kernels/mbr_join/kernel.py", "emit_pairs", "host-sync",
     "the pair list's length: one read of the kept total a join, to "
     "allocate the emitted pairs"),
    ("serve/engine.py", "chunk_skip_rate", "host-sync",
     "a diagnostic of the local index for benches and tests, off the "
     "serving path: its width and its rate are host numbers, one read "
     "each a call"),
    # not a probe: the dense passes' work list
    ("kernels/range_probe/kernel.py", "dense_group", "kernel-twin-parity",
     "reads no member and tests no slot: it lists each tile's slot "
     "segments up to the extent for the dense passes, which take alive "
     "and apply it"),
)

# ---------------------------------------------------------------------------
# R4 kernel-twin parity
# ---------------------------------------------------------------------------

# Modules making up the probe surface: every public function taking
# member-slot data must thread the tombstone mask.  kernels/<fam>/ files
# are matched by glob-ish suffix; the query/serve modules are explicit.
PROBE_SURFACE_SUFFIXES = (
    "query/range.py",
    "query/knn.py",
    "serve/exchange.py",
)
KERNEL_FAMILY_FILES = {"ops.py", "ref.py", "kernel.py"}

# Parameters that carry per-slot member data (boxes at canonical slots).
MEMBER_DATA_PARAMS = {"tiles", "gtiles", "canon_tiles"}
# Acceptable names for the threaded tombstone mask.
ALIVE_PARAMS = {"alive", "galive"}
# The live extent a kernel may stop each tile's walk at: derived from
# the mask (``ops.live_extent(alive)`` or larger), so it travels beside
# it and never without it.
EXTENT_PARAMS = {"extent"}
# Extra parameters a *_skip twin may add over its base twin.
SKIP_EXTRA_PARAMS = {"cboxes", "gcboxes"}

# Twin parity by calling both twins runs for these family files
# (row-major public surface).  kernel.py twins are the CUDA entry
# points — they get signature parity only; their outputs are covered
# transitively because ops.py calls them on the card.
ABSTRACT_PARITY_FILES = {"ops.py", "ref.py"}

# Name-driven synthesis of the parity inputs: T=4 tiles, cap=128 slots,
# Q=8 queries, F=2 candidates, C=1 chunk of 128, built on the CPU from
# a seeded numpy generator.  A required parameter missing from this
# table is itself a finding — a new family must extend the table, it
# cannot silently dodge the parity check.
ABSTRACT_SHAPES = {
    "qboxes": ((8, 4), torch.float32),
    "tiles": ((4, 128, 4), torch.float32),
    "gtiles": ((8, 2, 128, 4), torch.float32),
    "cboxes": ((4, 1, 4), torch.float32),
    "gcboxes": ((8, 2, 1, 4), torch.float32),
    "cand": ((8, 2), torch.int32),
    "ids": ((4, 128), torch.int32),
    "alive": ((4, 128), torch.bool),
    "galive": ((8, 2, 128), torch.bool),
    "extent": ((4,), torch.int32),
}
ABSTRACT_SEED = 0

# ---------------------------------------------------------------------------
# R5 TileLayout conformance
# ---------------------------------------------------------------------------

PROTOCOL_NAME = "TileLayout"
REGISTRY_NAME = "_PLACEMENT_CLS"
# The replica fan-out route: a sharded layout's scatter must resolve
# every write through ``_placements``, which must consult the replica
# rows, which must be built from ``rep_owner`` — so every ingest write
# lands on ALL resident copies.  The reference's chain is ``_scatter ->
# _owner_scatter -> _placements -> rep_owner``; the port's ``_scatter``
# does the owner-local write itself (one ``index_put_`` through the
# flat shard rows, in place of ``_owner_scatter``), its ``_placements``
# is the reference's, and it reads the replicas through ``_rep_rows``,
# the device map ``_install`` builds from ``rep_owner``.
FANOUT_CHAIN = ("_scatter", "_placements", "_rep_rows", "rep_owner")
