"""Analyzer core (twin of ``repro.analysis.core``): findings,
suppressions, the project index, and the small expression classifiers
(arrayish / taint) the rules share.

Pure stdlib (ast + re).  The rule-agnostic parts (``Finding``,
``Module`` and its suppression parser, ``Project``, the AST helpers,
the baseline) behave as the reference's: the same findings,
fingerprints and suppressions on the same source text; relative
``from . import x`` resolves (the reference's does not).  What reads
torch: ``ArrayishEnv`` (torch's tensor producers, the project's
functions annotated to return a tensor, parameters annotated or used
as tensors) and the width index R2 checks against
(``config.STATIC_WIDTHS``, the reference's ``static_argnames`` over the
port's signatures).  torch itself is imported by config (the parity
inputs' dtypes) and, to call plain versions on small CPU tensors, by
the R4 parity pass.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import re
from pathlib import Path

from . import config

SUPPRESS_RE = re.compile(
    r"#\s*reprolint:\s*disable=([A-Za-z0-9_\-, ]+?)\s*(?:--\s*(.*))?$")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # posix path relative to the scan root's parent
    line: int
    message: str
    hint: str = ""
    func: str = ""     # enclosing function, for allowlist matching

    def fingerprint(self) -> str:
        # line-free so the baseline survives unrelated edits above the site
        return f"{self.rule}::{self.path}::{self.func}::{self.message}"

    def to_json(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "func": self.func, "message": self.message,
                "hint": self.hint}

    def render(self) -> str:
        loc = f"{self.path}:{self.line}"
        tail = f"  [fix: {self.hint}]" if self.hint else ""
        return f"{loc}: {self.rule}: {self.message}{tail}"


class Module:
    """One parsed source file plus its suppression table."""

    def __init__(self, path: Path, rel: str, text: str):
        self.path = path
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=str(path))
        # line -> set of rule ids suppressed on that line
        self.suppress: dict[int, set[str]] = {}
        self.bad_suppressions: list[Finding] = []
        self._parse_suppressions()
        self.imports = self._import_aliases()
        self.dotted = rel[:-3].replace("/", ".")
        # dotted names of the project's functions annotated to return a
        # tensor (set by Project)
        self.tensor_funcs: set[str] = set()

    # -- suppressions -----------------------------------------------------

    def _parse_suppressions(self) -> None:
        from .api import RULE_IDS
        for i, raw in enumerate(self.lines, start=1):
            m = SUPPRESS_RE.search(raw)
            if not m:
                continue
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            rationale = (m.group(2) or "").strip()
            unknown = rules - set(RULE_IDS)
            if unknown:
                self.bad_suppressions.append(Finding(
                    "bad-suppression", self.rel, i,
                    f"unknown rule id(s) {sorted(unknown)} in suppression",
                    hint="valid ids: " + ", ".join(RULE_IDS)))
                rules &= set(RULE_IDS)
            if not rationale:
                self.bad_suppressions.append(Finding(
                    "bad-suppression", self.rel, i,
                    "suppression without a rationale",
                    hint="append ' -- <why this host fold / exemption is "
                         "deliberate>'"))
                continue  # a rationale-free suppression suppresses nothing
            target = i
            if raw.lstrip().startswith("#"):
                # standalone comment: applies to the next code line
                j = i
                while j < len(self.lines):
                    nxt = self.lines[j].strip()
                    if nxt and not nxt.startswith("#"):
                        target = j + 1
                        break
                    j += 1
            self.suppress.setdefault(target, set()).update(rules)

    def suppressed(self, line: int, rule: str) -> bool:
        return rule in self.suppress.get(line, set())

    # -- imports ----------------------------------------------------------

    def _import_aliases(self) -> dict[str, str]:
        """local name -> dotted module path ('' segments resolved against
        this module's package for relative imports)."""
        pkg_parts = self.rel.split("/")[:-1]  # package dirs of this module
        out: dict[str, str] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    out[a.asname or a.name.split(".")[0]] = a.name
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    base = pkg_parts[: len(pkg_parts) - (node.level - 1)]
                else:
                    base = []
                # (the reference joins an empty module name too, so its
                # ``from . import x`` resolves to 'pkg..x')
                mod = ".".join(base + ([node.module] if node.module else []))
                for a in node.names:
                    out[a.asname or a.name] = (
                        f"{mod}.{a.name}" if mod else a.name)
        return out


class Project:
    """All modules under a scan root, plus cross-module registries."""

    def __init__(self, root: Path, files: list[Path] | None = None):
        self.root = root.resolve()
        self.modules: list[Module] = []
        self.errors: list[Finding] = []
        paths = files if files is not None else sorted(
            p for p in self.root.rglob("*.py") if "__pycache__" not in p.parts)
        anchor = self.root if self.root.is_dir() else self.root.parent
        for p in paths:
            rel = p.resolve().relative_to(anchor).as_posix()
            try:
                text = p.read_text()
                self.modules.append(Module(p, rel, text))
            except (SyntaxError, UnicodeDecodeError) as e:
                self.errors.append(Finding(
                    "parse-error", rel, getattr(e, "lineno", 0) or 0,
                    f"could not parse: {e}"))
        # dotted module name -> Module, for cross-module call resolution
        self.by_dotted: dict[str, Module] = {}
        for m in self.modules:
            self.by_dotted[m.dotted] = m
            # also register without the leading package (serve.x)
            parts = m.dotted.split(".")
            for i in range(1, len(parts)):
                self.by_dotted.setdefault(".".join(parts[i:]), m)
        self.static_widths = _index_static_widths(self.modules)
        tensor_funcs = _index_tensor_returns(self.modules)
        for m in self.modules:
            m.tensor_funcs = tensor_funcs


# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------

def dotted_name(node: ast.expr) -> str:
    """'torch.nn.functional.pad' for nested Attribute/Name chains, ''
    otherwise."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def last_attr(node: ast.expr) -> str:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def func_defs(tree: ast.AST):
    """Yield the def node of every function, nested ones included."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def param_names(fn: ast.FunctionDef) -> list[str]:
    a = fn.args
    return ([p.arg for p in a.posonlyargs] + [p.arg for p in a.args]
            + [p.arg for p in a.kwonlyargs])


def module_globals(tree: ast.Module) -> set[str]:
    names: set[str] = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
        elif isinstance(node, ast.Import):
            for a in node.names:
                names.add(a.asname or a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                names.add(a.asname or a.name)
    return names


def resolved_name(node: ast.expr, mod: Module) -> str:
    """``dotted_name`` with its first part resolved through the module's
    imports: ``F.pad`` -> 'torch.nn.functional.pad' under ``import
    torch.nn.functional as F``."""
    dotted = dotted_name(node)
    if not dotted:
        return ""
    head, _, rest = dotted.partition(".")
    head = mod.imports.get(head, head)
    return f"{head}.{rest}" if rest else head


# ---------------------------------------------------------------------------
# arrayish classification (R1 / R3)
# ---------------------------------------------------------------------------

def is_tensor_producer(func: ast.expr, mod: Module) -> bool:
    """A call of ``torch.<op>`` (or ``torch.nn.functional.<op>``) that
    returns a tensor: ``torch.zeros``, ``torch.as_tensor``, ``F.pad``;
    not ``torch.device``, ``torch.Generator`` or anything under
    ``torch.cuda``."""
    full = resolved_name(func, mod)
    owner, _, op = full.rpartition(".")
    return (owner in config.TENSOR_MODULES
            and op not in config.NON_TENSOR_FUNCS)


def _is_tensor_annotation(node: ast.expr | None, mod: Module) -> bool:
    """``torch.Tensor``, ``torch.Tensor | None``,
    ``Optional[torch.Tensor]``."""
    if node is None:
        return False
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):
        return (_is_tensor_annotation(node.left, mod)
                or _is_tensor_annotation(node.right, mod))
    if (isinstance(node, ast.Subscript)
            and last_attr(node.value) == "Optional"):
        return _is_tensor_annotation(node.slice, mod)
    return resolved_name(node, mod) in config.TENSOR_TYPES


class ArrayishEnv:
    """Forward-pass classification of local names as device-tensor-ish.

    Deliberately conservative: unknown stays unknown (False), so the
    rules built on it under-report rather than spam.  The vocabulary
    that makes something arrayish: torch's tensor producers
    (``torch.zeros``, ``torch.as_tensor``, ...), the project's functions
    annotated to return ``torch.Tensor``, ``.to(...)`` and ``.cuda()``,
    staging attributes (config.STAGING_ATTRS), parameters annotated
    ``torch.Tensor`` or used as a tensor (``x.numel()``,
    ``x.data_ptr()``), and values derived from any of them.
    """

    def __init__(self, fn: ast.FunctionDef, mod: Module):
        self.mod = mod
        a = fn.args
        self.env: dict[str, bool] = {
            p.arg: True for p in a.posonlyargs + a.args + a.kwonlyargs
            if _is_tensor_annotation(p.annotation, mod)}
        self._assign_pass(fn)
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in config.TENSOR_ONLY_METHODS
                    and isinstance(node.func.value, ast.Name)):
                self.env[node.func.value.id] = True

    def _assign_pass(self, fn: ast.FunctionDef) -> None:
        for stmt in ast.walk(fn):
            if isinstance(stmt, ast.Assign):
                val = self.is_arrayish(stmt.value)
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        self.env[t.id] = val
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                if isinstance(stmt.target, ast.Name):
                    self.env[stmt.target.id] = self.is_arrayish(stmt.value)

    def is_arrayish(self, node: ast.expr) -> bool:
        if isinstance(node, ast.Name):
            return self.env.get(node.id, False)
        if isinstance(node, ast.Attribute):
            if node.attr in config.META_ATTRS:
                return False
            if node.attr in config.STAGING_ATTRS:
                return True
            return False
        if isinstance(node, ast.Subscript):
            return self.is_arrayish(node.value)
        if isinstance(node, ast.Call):
            if is_tensor_producer(node.func, self.mod):
                return True
            full = resolved_name(node.func, self.mod)
            if (full in self.mod.tensor_funcs
                    or f"{self.mod.dotted}.{full}" in self.mod.tensor_funcs):
                return True
            if isinstance(node.func, ast.Attribute):
                if node.func.attr in (config.META_METHODS
                                      | config.HOST_SYNC_METHODS):
                    return False   # host values: the read happened here
                if node.func.attr in config.TENSOR_MOVES:
                    return True
                # method call on an arrayish value returns arrayish
                # (x.sum(), x.any(), x.float())
                return self.is_arrayish(node.func.value)
            return False
        if isinstance(node, ast.BinOp):
            return (self.is_arrayish(node.left)
                    or self.is_arrayish(node.right))
        if isinstance(node, ast.UnaryOp):
            return self.is_arrayish(node.operand)
        if isinstance(node, ast.Compare):
            return (self.is_arrayish(node.left)
                    or any(self.is_arrayish(c) for c in node.comparators))
        if isinstance(node, ast.IfExp):
            return self.is_arrayish(node.body) or self.is_arrayish(node.orelse)
        return False


# ---------------------------------------------------------------------------
# taint classification (R2)
# ---------------------------------------------------------------------------

class TaintEnv:
    """Tracks Python ints whose value depends on the data (not just on
    static shapes): ``len(...)``, host folds of device reductions, and
    arithmetic thereon.  Calls through a bucketing sanitizer clear the
    taint — that is exactly the bucketed-width contract."""

    def __init__(self, fn: ast.FunctionDef, mod: Module):
        self.mod = mod
        self.env: dict[str, bool] = {}
        for stmt in ast.walk(fn):
            if isinstance(stmt, ast.Assign):
                val = self.is_tainted(stmt.value)
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        self.env[t.id] = val

    def is_tainted(self, node: ast.expr) -> bool:
        if isinstance(node, ast.Name):
            return self.env.get(node.id, False)
        if isinstance(node, ast.Call):
            fname = last_attr(node.func)
            if fname in config.SANITIZER_FUNCS:
                return False
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in config.SANITIZER_METHODS):
                return False
            if fname == "len":
                return True
            if fname in {"int", "float"} and node.args:
                return self._is_device_fold(node.args[0])
            if fname in {"max", "min", "sum", "abs"}:
                return any(self.is_tainted(a) for a in node.args)
            return False
        if isinstance(node, ast.BinOp):
            return self.is_tainted(node.left) or self.is_tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_tainted(node.operand)
        if isinstance(node, ast.IfExp):
            return self.is_tainted(node.body) or self.is_tainted(node.orelse)
        return False

    def _is_device_fold(self, node: ast.expr) -> bool:
        """int(torch.max(counts)) / int(x.max()) — a data-dependent
        host int born from a device reduction."""
        if not isinstance(node, ast.Call):
            return False
        if is_tensor_producer(node.func, self.mod):
            return True
        return (isinstance(node.func, ast.Attribute)
                and node.func.attr in {"max", "min", "sum", "item"})


def _index_tensor_returns(modules: list[Module]) -> set[str]:
    """Dotted names ('serve.router.probe_overlap', and every shorter
    suffix of the module path, as ``Project.by_dotted``) of the
    module-level functions annotated to return a tensor."""
    out: set[str] = set()
    for m in modules:
        parts = m.dotted.split(".")
        for fn in m.tree.body:
            if (isinstance(fn, ast.FunctionDef)
                    and _is_tensor_annotation(fn.returns, m)):
                for i in range(len(parts)):
                    out.add(".".join(parts[i:] + [fn.name]))
    return out


def _index_static_widths(modules: list[Module]) -> dict:
    """(module, fname) -> {'params': [...], 'statics': {...}} for every
    port function whose reference counterpart is jitted with
    ``static_argnames`` (config.STATIC_WIDTHS), the statics cut to the
    parameters the port's signature has."""
    out: dict[tuple[str, str], dict] = {}
    for m in modules:
        names = {fname: statics
                 for (suffix, fname), statics in config.STATIC_WIDTHS.items()
                 if m.rel.endswith(suffix)}
        if not names:
            continue
        for fn in m.tree.body:
            if not (isinstance(fn, ast.FunctionDef) and fn.name in names):
                continue
            params = param_names(fn)
            out[(m.rel, fn.name)] = {
                "params": params, "statics": names[fn.name] & set(params),
                "line": fn.lineno}
    return out


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------

def load_baseline(path: Path) -> set[str]:
    if not path.exists():
        return set()
    data = json.loads(path.read_text())
    return set(data.get("fingerprints", []))


def write_baseline(path: Path, findings: list[Finding]) -> None:
    path.write_text(json.dumps(
        {"fingerprints": sorted(f.fingerprint() for f in findings)},
        indent=2) + "\n")
