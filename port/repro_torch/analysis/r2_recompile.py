"""R2 recompile hazard, read as the width contract.

The reference's bug class: a data-dependent Python int (``len(batch)``,
a host fold of a device reduction, a running counter) passed as a
*static* jit argument mints a fresh executable per distinct value — a
recompile storm under traffic.  The port compiles nothing per call,
but it keeps the reference's bucketed widths (``serve/engine.py``
``_f_width`` and ``WidthPolicy``, ``core/partition/assign.py``
``round_up``), because the padded ``(Q, F)`` candidate width and the
staging capacity decide the kernels' grids and keep the answers bit
for bit the reference's.  An unbucketed int in one of those width
parameters costs on the card a fresh width each batch (a grid and
scratch sized anew), a fresh allocation size in the caching allocator
(blocks that no later batch reuses, so the pool grows and fragments),
and a layout that no longer matches the reference's.

The guarded parameters are the port's counterparts of the reference's
``static_argnames`` (config.STATIC_WIDTHS, indexed by
``core._index_static_widths``); a tainted expression arriving in one
at a call site is the finding.
"""

from __future__ import annotations

import ast

from .core import Finding, Module, Project, TaintEnv, func_defs

RULE = "recompile-hazard"


def check(project: Project) -> list[Finding]:
    out: list[Finding] = []
    for mod in project.modules:
        for fn in func_defs(mod.tree):
            out.extend(_check_function(project, mod, fn))
    return out


def _check_function(project: Project, mod: Module,
                    fn: ast.FunctionDef) -> list[Finding]:
    taint = TaintEnv(fn, mod)
    out: list[Finding] = []
    for call in ast.walk(fn):
        if not isinstance(call, ast.Call):
            continue
        target = _resolve(project, mod, call.func)
        if target is None:
            continue
        info = project.static_widths.get(target)
        if not info or not info["statics"]:
            continue
        params = info["params"]
        for i, arg in enumerate(call.args):
            if i < len(params) and params[i] in info["statics"]:
                if taint.is_tainted(arg):
                    out.append(_finding(mod, fn, call, params[i], target))
        for kw in call.keywords:
            if kw.arg in info["statics"] and taint.is_tainted(kw.value):
                out.append(_finding(mod, fn, call, kw.arg, target))
    return out


def _finding(mod: Module, fn: ast.FunctionDef, call: ast.Call,
             pname: str, target: tuple[str, str]) -> Finding:
    return Finding(
        RULE, mod.rel, call.lineno,
        f"data-dependent int flows into width arg '{pname}' of "
        f"'{target[1]}' — a fresh grid and allocation size per distinct "
        f"value",
        hint="bucket it first (round_up / WidthPolicy.at_least / "
             "_f_width / .bit_length())",
        func=fn.name)


def _resolve(project: Project, mod: Module,
             func: ast.expr) -> tuple[str, str] | None:
    """Map a call's callee expression to a (module rel, fname) key in
    the project's width index, through import aliases."""
    if isinstance(func, ast.Name):
        key = (mod.rel, func.id)
        return key if key in project.static_widths else None
    if isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name):
        alias = mod.imports.get(func.value.id)
        if alias is None:
            return None
        target_mod = project.by_dotted.get(alias)
        if target_mod is None:
            return None
        key = (target_mod.rel, func.attr)
        return key if key in project.static_widths else None
    return None
