"""R1 closure capture.

The bug class in torch's terms.  In the reference a staged array
captured by closure in a callable handed to ``jit`` became a baked-in
constant that re-staging no longer reached.  The port has no tracer,
so a closure holds the tensor object itself; the hazard is a callable
that outlives the call — stored on an object, returned, or handed to a
sink that keeps or re-runs it (config.CLOSURE_SINKS: ``spawn``,
``in_turns``, ``torch.utils.checkpoint``, the frontend's executor).
After ``_TilesBase._restage`` such a callable still serves the *old*
staging and keeps it resident beside the new one (the
doubled-capacity re-stage that ran the card out of memory).  Staging
must be read through its owner (``self.staged`` / ``self.slayout`` at
call time) or passed as an argument.

Flags lambdas and locally-defined functions so stored, returned or
handed over whose free variables hold staged tensors in the enclosing
scope (``StagingEnv``).  Module globals and unknown values are never flagged.
"""

from __future__ import annotations

import ast
import builtins

from . import config
from .core import (ArrayishEnv, Finding, Module, Project, func_defs,
                   is_tensor_producer, last_attr, module_globals,
                   param_names)

RULE = "jit-closure-capture"
_BUILTINS = set(dir(builtins))


def check(project: Project) -> list[Finding]:
    out: list[Finding] = []
    for mod in project.modules:
        globals_ = module_globals(mod.tree)
        for fn in func_defs(mod.tree):
            out.extend(_check_function(mod, fn, globals_))
    return out


class StagingEnv(ArrayishEnv):
    """``ArrayishEnv`` narrowed to the staging: a value is staged when
    it is read from a staging attribute (config.STAGING_ATTRS), is a
    parameter so named, or is computed from a staged value (a method
    of one, a call taking one).  A fresh tensor (``torch.zeros``, an
    input batch) is not: capturing it keeps no staging alive."""

    def __init__(self, fn: ast.FunctionDef, mod: Module):
        self.mod = mod
        self.env = {p: True for p in param_names(fn)
                    if p in config.STAGING_ATTRS}
        self._assign_pass(fn)

    def is_arrayish(self, node: ast.expr) -> bool:
        if isinstance(node, ast.Call):
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr not in config.META_METHODS
                    and self.is_arrayish(node.func.value)):
                return True
            return is_tensor_producer(node.func, self.mod) and any(
                self.is_arrayish(a) for a in node.args)
        return super().is_arrayish(node)


def _escapes(fn: ast.FunctionDef):
    """Yield (callable expression, where it goes) for every lambda or
    local def name that leaves ``fn``: an argument of a sink call, the
    value stored on an attribute, or the value returned."""
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call)
                and last_attr(node.func) in config.CLOSURE_SINKS):
            for arg in list(node.args) + [k.value for k in node.keywords]:
                yield arg, f"handed to '{last_attr(node.func)}'"
        elif isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Attribute) for t in node.targets):
            yield node.value, "stored on an object"
        elif isinstance(node, ast.Return) and node.value is not None:
            yield node.value, "returned"


def _check_function(mod: Module, fn: ast.FunctionDef,
                    globals_: set[str]) -> list[Finding]:
    env = StagingEnv(fn, mod)
    local_defs = {n.name: n for n in ast.walk(fn)
                  if isinstance(n, ast.FunctionDef) and n is not fn}
    bound = set(param_names(fn)) | set(env.env) | set(local_defs)
    out: list[Finding] = []
    for arg, where in _escapes(fn):
        inner = None
        if isinstance(arg, ast.Lambda):
            inner = arg
        elif isinstance(arg, ast.Name) and arg.id in local_defs:
            inner = local_defs[arg.id]
        if inner is None:
            continue
        for name in sorted(_free_vars(inner)):
            if name in _BUILTINS or name in globals_:
                continue
            if name in bound and env.env.get(name, False):
                label = ("lambda" if isinstance(inner, ast.Lambda)
                         else inner.name)
                out.append(Finding(
                    RULE, mod.rel, arg.lineno,
                    f"staged tensor '{name}' captured by closure in "
                    f"'{label}' {where}",
                    hint="pass it as an argument, or read the staging "
                         "through its owner when the callable runs",
                    func=fn.name))
    return out


def _free_vars(fn: ast.Lambda | ast.FunctionDef) -> set[str]:
    """Names loaded inside fn that fn itself does not bind."""
    local = {a.arg for a in (fn.args.posonlyargs + fn.args.args
                             + fn.args.kwonlyargs)}
    for va in (fn.args.vararg, fn.args.kwarg):
        if va is not None:
            local.add(va.arg)
    body = fn.body if isinstance(fn.body, list) else [fn.body]
    loads: set[str] = set()
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Name):
                if isinstance(node.ctx, ast.Load):
                    loads.add(node.id)
                else:
                    local.add(node.id)
            elif isinstance(node, (ast.FunctionDef, ast.Lambda)):
                local.update(a.arg for a in (node.args.posonlyargs
                                             + node.args.args
                                             + node.args.kwonlyargs))
            elif isinstance(node, ast.comprehension):
                for t in ast.walk(node.target):
                    if isinstance(t, ast.Name):
                        local.add(t.id)
    return loads - local
