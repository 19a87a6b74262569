"""R4 kernel-twin parity + tombstone-mask and live-extent threading.

Two structural contracts over the probe surface:

1. Twins: every ``X_skip`` (chunk-skipping local-index executor) must
   pair with an ``X`` whose signature it extends only by the chunk-box
   parameter, and — for the row-major ops/ref surface — both twins must
   produce outputs of the same shapes and dtypes.  The reference traced
   both with ``jax.eval_shape``; here both are called on small seeded
   CPU tensors, where ``ops`` sends every call to the plain ``ref``
   version: no CUDA kernel is built or launched (``_check_parity``
   asserts it).

2. Tombstones: every public probe entry point that takes member-slot
   data (``tiles``/``gtiles``/``canon_tiles``) must accept and *use* a
   per-slot ``alive`` mask, so a new kernel family cannot silently
   resurrect deleted objects.  The live ``extent`` follows the mask
   (``ops.live_extent(alive)`` or larger, the kernels stop each tile's
   walk there): an entry point that accepts it must use it and must
   take ``alive`` beside it.

Inputs are synthesized by parameter name from config.ABSTRACT_SHAPES;
a required parameter the table cannot synthesize is itself a finding —
extending a family extends the table.
"""

from __future__ import annotations

import ast
import importlib
import importlib.util
import sys

from . import config
from .core import Finding, Module, Project, param_names

RULE = "kernel-twin-parity"


def check(project: Project) -> list[Finding]:
    out: list[Finding] = []
    for mod in project.modules:
        family = _family_file(mod)
        surface = family or mod.rel.endswith(config.PROBE_SURFACE_SUFFIXES)
        if not surface:
            continue
        fns = {fn.name: fn for fn in mod.tree.body
               if isinstance(fn, ast.FunctionDef)}
        out.extend(_check_twins(mod, fns))
        out.extend(_check_alive(mod, fns))
        if family in config.ABSTRACT_PARITY_FILES:
            out.extend(_check_abstract_parity(mod, fns))
    return out


def _family_file(mod: Module) -> str | None:
    parts = mod.rel.split("/")
    if (len(parts) >= 3 and parts[-3] == "kernels"
            and parts[-1] in config.KERNEL_FAMILY_FILES):
        return parts[-1]
    return None


# ---------------------------------------------------------------------------
# signature parity
# ---------------------------------------------------------------------------

def _twin_pairs(fns: dict[str, ast.FunctionDef]):
    for name, fn in fns.items():
        if name.startswith("_") or not name.endswith("_skip"):
            continue
        base = name.replace("_skip", "")
        yield name, fn, base, fns.get(base)


def _check_twins(mod: Module, fns: dict) -> list[Finding]:
    out: list[Finding] = []
    for name, fn, base, base_fn in _twin_pairs(fns):
        if base_fn is None:
            out.append(Finding(
                RULE, mod.rel, fn.lineno,
                f"'{name}' has no base twin '{base}' in the same module",
                hint="every *_skip executor pairs with an unindexed "
                     "oracle twin", func=name))
            continue
        skip_params = [p for p in param_names(fn)
                       if p not in config.SKIP_EXTRA_PARAMS]
        base_params = param_names(base_fn)
        if skip_params != base_params:
            out.append(Finding(
                RULE, mod.rel, fn.lineno,
                f"twin signature mismatch: '{name}'{skip_params} vs "
                f"'{base}'{base_params} (chunk-box params "
                f"{sorted(config.SKIP_EXTRA_PARAMS)} excepted)",
                hint="twins must be drop-in substitutes for the "
                     "executor selection in serve/", func=name))
    return out


# ---------------------------------------------------------------------------
# alive and extent threading
# ---------------------------------------------------------------------------

def _check_alive(mod: Module, fns: dict) -> list[Finding]:
    out: list[Finding] = []
    for name, fn in fns.items():
        if name.startswith("_"):
            continue
        params = set(param_names(fn))
        if not params & config.MEMBER_DATA_PARAMS:
            continue
        alive = params & config.ALIVE_PARAMS
        extent = params & config.EXTENT_PARAMS
        if not alive:
            out.append(Finding(
                RULE, mod.rel, fn.lineno,
                f"probe entry point '{name}' takes member-slot data but "
                "no 'alive' tombstone mask — deleted objects would "
                "resurface on this path",
                hint="thread a keyword 'alive' (or 'galive') parameter "
                     "through, like kernels/range_probe", func=name))
            if extent:
                out.append(Finding(
                    RULE, mod.rel, fn.lineno,
                    f"'{name}' takes the live 'extent' without the "
                    "'alive' mask it is derived from",
                    hint="the extent travels beside alive "
                         "(ops.live_extent(alive) or larger)", func=name))
            continue
        used = {n.id for n in ast.walk(fn)
                if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}
        if not alive & used:
            out.append(Finding(
                RULE, mod.rel, fn.lineno,
                f"'{name}' accepts '{sorted(alive)[0]}' but never uses "
                "it — the mask is dropped on the floor",
                hint="apply the mask to the hit table / pass it down",
                func=name))
        if extent and not extent & used:
            out.append(Finding(
                RULE, mod.rel, fn.lineno,
                f"'{name}' accepts 'extent' but never uses it — the "
                "kernel below walks every slot of each tile",
                hint="pass it down beside alive", func=name))
    return out


# ---------------------------------------------------------------------------
# output parity by a CPU call of both twins (plain versions only)
# ---------------------------------------------------------------------------

def _check_abstract_parity(mod: Module, fns: dict) -> list[Finding]:
    pairs = [(n, fn, b, bfn) for n, fn, b, bfn in _twin_pairs(fns)
             if bfn is not None]
    if not pairs:
        return []
    live, err = _import_module(mod)
    if live is None:
        return [Finding(RULE, mod.rel, 1,
                        f"cannot import module for twin parity: {err}",
                        hint="the family must be importable for the "
                             "CPU parity calls", func="")]
    import numpy as np
    import torch

    def synth(pname: str):
        spec = config.ABSTRACT_SHAPES.get(pname)
        if spec is None:
            return None
        shape, dtype = spec
        rng = np.random.default_rng(config.ABSTRACT_SEED)
        if dtype == torch.bool:
            return torch.from_numpy(rng.random(shape) < 0.5)
        if pname in config.SKIP_EXTRA_PARAMS:
            # chunk boxes covering every member, as the staging's bound
            # theirs: a skip twin must then give its base twin's answer
            return torch.tensor([0.0, 0.0, 1.25, 1.25],
                                dtype=dtype).expand(shape).contiguous()
        if dtype.is_floating_point:
            lo = rng.random(shape[:-1] + (2,), dtype=np.float32)
            return torch.from_numpy(np.concatenate(
                [lo, lo + 0.25], -1)).to(dtype)
        hi = {"extent": 128}.get(pname, 4)
        return torch.from_numpy(rng.integers(0, hi, shape)).to(dtype)

    out: list[Finding] = []
    launches = _launch_counts()
    for name, fn, base, base_fn in pairs:
        kwargs, missing = _build_kwargs(fn, synth)
        bkwargs, bmissing = _build_kwargs(base_fn, synth)
        if missing or bmissing:
            for p in sorted(set(missing + bmissing)):
                out.append(Finding(
                    RULE, mod.rel, fn.lineno,
                    f"cannot synthesize an input for parameter "
                    f"'{p}' of twin pair '{base}'/'{name}'",
                    hint="extend ABSTRACT_SHAPES in "
                         "repro_torch/analysis/config.py", func=name))
            continue
        for with_alive in (False, True):
            kw = dict(kwargs)
            bkw = dict(bkwargs)
            if not with_alive:
                for a in config.ALIVE_PARAMS | config.EXTENT_PARAMS:
                    kw.pop(a, None)
                    bkw.pop(a, None)
            try:
                with torch.no_grad():
                    got = getattr(live, name)(**kw)
                    want = getattr(live, base)(**bkw)
            except Exception as e:  # a call-time type error is a finding
                out.append(Finding(
                    RULE, mod.rel, fn.lineno,
                    f"CPU call of twin pair '{base}'/'{name}' "
                    f"(alive={'on' if with_alive else 'off'}) failed: "
                    f"{type(e).__name__}: {e}", func=name))
                break
            gf, wf = _avals(got), _avals(want)
            if gf != wf:
                out.append(Finding(
                    RULE, mod.rel, fn.lineno,
                    f"twin output avals differ "
                    f"(alive={'on' if with_alive else 'off'}): "
                    f"'{name}' -> {gf} but '{base}' -> {wf}",
                    hint="twins must agree on output shape/dtype so the "
                         "executor switch stays bit-compatible",
                    func=name))
    if _launch_counts() != launches:
        raise AssertionError("the twin parity calls launched a kernel")
    return out


def _avals(tree) -> list[tuple[tuple[int, ...], str]]:
    """(shape, dtype) of every tensor leaf of a nested output, in
    order."""
    import torch
    if isinstance(tree, torch.Tensor):
        return [(tuple(tree.shape), str(tree.dtype))]
    if isinstance(tree, (tuple, list)):
        return [a for x in tree for a in _avals(x)]
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _avals(tree[k])]
    return []


def _launch_counts() -> dict:
    """Every loaded kernel module's launch counts (the wrappers count
    where they launch), keyed by module and kernel."""
    return {(name, k): v for name, m in list(sys.modules.items())
            if name.startswith("repro_torch.kernels.")
            and name.endswith(".kernel")
            for k, v in getattr(m, "LAUNCHES", {}).items()}


def _build_kwargs(fn: ast.FunctionDef, synth):
    """Synthesized kwargs for every defaultless param (+ alive and
    extent params, to exercise the mask path); returns (kwargs,
    unsynthesizable)."""
    a = fn.args
    pos = a.posonlyargs + a.args
    n_required = len(pos) - len(a.defaults)
    required = [p.arg for p in pos[:n_required]]
    required += [p.arg for p, d in zip(a.kwonlyargs, a.kw_defaults)
                 if d is None]
    optional_alive = [p.arg for p in pos[n_required:] + a.kwonlyargs
                      if p.arg in config.ALIVE_PARAMS | config.EXTENT_PARAMS]
    kwargs, missing = {}, []
    for p in required:
        v = synth(p)
        if v is None:
            missing.append(p)
        else:
            kwargs[p] = v
    for p in optional_alive:
        v = synth(p)
        if v is not None:
            kwargs[p] = v
    return kwargs, missing


def _import_module(mod: Module):
    """The scanned file as a live module: imported under its package
    name (the ``__init__.py`` chain above it, so relative imports
    resolve), else loaded straight from the file (fixture trees)."""
    parts, d = [mod.path.stem], mod.path.resolve().parent
    while (d / "__init__.py").exists():
        parts.insert(0, d.name)
        d = d.parent
    first = None
    if len(parts) > 1:
        try:
            return importlib.import_module(".".join(parts)), None
        except ImportError as e:
            first = e
    try:
        uniq = "torchlint_fixture_" + mod.rel[:-3].replace("/", "_")
        spec = importlib.util.spec_from_file_location(uniq, mod.path)
        m = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(m)
        return m, None
    except Exception as e:
        return None, f"{first} / {e}" if first else str(e)
