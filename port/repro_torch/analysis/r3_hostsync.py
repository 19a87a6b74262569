"""R3 host-sync audit.

On the per-batch hot path (config.HOT_MODULES), ``float()`` /
``int()`` / ``bool()`` of a tensor, ``np.asarray()`` / ``np.array()``
of one, ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()``, and
``torch.cuda.synchronize()`` block the host until the card has run
every queued launch and the value has crossed — a stall per call, per
batch, with the card idle behind it.  serve/layout.py alone has many
such candidate call sites; most fold host numpy and are fine, which is
why the casts and methods fire only when the operand is positively
classified arrayish (torch results, staging attributes, tensor
parameters, values derived from them).

Deliberate host-side planes are allowlisted in config.ALLOWLIST with a
rationale; one-off deliberate reads carry inline suppressions.
"""

from __future__ import annotations

import ast

from . import config
from .core import (ArrayishEnv, Finding, Module, Project, dotted_name,
                   func_defs, resolved_name)

RULE = "host-sync"


def check(project: Project) -> list[Finding]:
    out: list[Finding] = []
    for mod in project.modules:
        if not mod.rel.endswith(config.HOT_MODULES):
            continue
        numpy_aliases = {name for name, dotted in mod.imports.items()
                         if dotted == "numpy"}
        for fn in func_defs(mod.tree):
            env = ArrayishEnv(fn, mod)
            for call in ast.walk(fn):
                if not isinstance(call, ast.Call):
                    continue
                site = _classify_site(call, mod, numpy_aliases)
                if site is None or not call.args and site in ("cast",
                                                              "download"):
                    continue
                if site != "wait":
                    operand = (call.func.value if site == "method"
                               else call.args[0])
                    if not env.is_arrayish(operand):
                        continue
                label = (f".{call.func.attr}()" if site == "method"
                         else f"{dotted_name(call.func)}()")
                what = ("waits for every queued launch"
                        if site == "wait" else "on a device value blocks "
                        "on a device->host transfer")
                out.append(Finding(
                    RULE, mod.rel, call.lineno,
                    f"{label} {what} in a hot-path module",
                    hint="keep the value on the device, or read it once "
                         "and suppress with a rationale if the sync is "
                         "deliberate",
                    func=fn.name))
    return out


def _classify_site(call: ast.Call, mod: Module,
                   numpy_aliases: set[str]) -> str | None:
    f = call.func
    if isinstance(f, ast.Name) and f.id in config.HOST_CAST_FUNCS:
        return "cast"
    if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
            and f.value.id in numpy_aliases
            and f.attr in config.NUMPY_DOWNLOAD_FUNCS):
        return "download"
    if resolved_name(f, mod) in config.DEVICE_WAITS:
        return "wait"
    if isinstance(f, ast.Attribute) and f.attr in config.HOST_SYNC_METHODS:
        return "method"
    return None
