"""R5 TileLayout conformance.

Every placement class registered in ``_PLACEMENT_CLS`` (and any future
layout subclassing the layout bases elsewhere) must structurally
implement the full ``TileLayout`` executor + ingest contract
(serve/layout.py): protocol methods/properties as defs, protocol
attributes as class-level or ``self.X = ...`` assignments somewhere in
the MRO.

Also enforces two invariants around the registry:

* a class deriving from the layout bases but absent from the registry is
  unreachable from ``ServeConfig.placement`` — flagged;
* the replica fan-out route (config.FANOUT_CHAIN): any layout with a
  ``_placements`` in its MRO must route ``_scatter`` through it, its
  ``_placements`` must consult the replica rows ``_rep_rows``, and those
  must be built from ``rep_owner`` — otherwise ingest writes miss
  replica copies and replicas drift from their owners.
"""

from __future__ import annotations

import ast

from . import config
from .core import Finding, Module, Project

RULE = "layout-conformance"


def check(project: Project) -> list[Finding]:
    out: list[Finding] = []
    layout_mods = []
    for mod in project.modules:
        classes = {c.name: c for c in mod.tree.body
                   if isinstance(c, ast.ClassDef)}
        proto = _find_protocol(classes)
        registry = _find_registry(mod.tree)
        if proto is None or registry is None:
            continue
        layout_mods.append((mod, classes, proto, registry))
        out.extend(_check_module(mod, classes, proto, registry))
    out.extend(_check_external_subclasses(project, layout_mods))
    return out


# ---------------------------------------------------------------------------
# contract extraction
# ---------------------------------------------------------------------------

def _find_protocol(classes: dict) -> dict | None:
    cls = classes.get(config.PROTOCOL_NAME)
    if cls is None:
        return None
    if not any("Protocol" in _base_name(b) for b in cls.bases):
        return None
    methods = {n.name for n in cls.body if isinstance(n, ast.FunctionDef)
               and not n.name.startswith("__")}
    attrs = {n.target.id for n in cls.body
             if isinstance(n, ast.AnnAssign)
             and isinstance(n.target, ast.Name)}
    return {"methods": methods, "attrs": attrs, "line": cls.lineno}


def _base_name(b: ast.expr) -> str:
    while isinstance(b, ast.Subscript):
        b = b.value
    parts = []
    while isinstance(b, ast.Attribute):
        parts.append(b.attr)
        b = b.value
    if isinstance(b, ast.Name):
        parts.append(b.id)
    return ".".join(reversed(parts))


def _find_registry(tree: ast.Module) -> dict | None:
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == config.REGISTRY_NAME
                and isinstance(node.value, ast.Dict)):
            entries = {}
            for k, v in zip(node.value.keys, node.value.values):
                if (isinstance(k, ast.Constant) and isinstance(v, ast.Name)):
                    entries[k.value] = v.id
            return {"entries": entries, "line": node.lineno}
    return None


def _mro(classes: dict, name: str) -> list[ast.ClassDef]:
    """Linearized in-module ancestry, derived-first (good enough for
    single inheritance chains, which is all the layouts use)."""
    out, seen, queue = [], set(), [name]
    while queue:
        n = queue.pop(0)
        cls = classes.get(n)
        if cls is None or n in seen:
            continue
        seen.add(n)
        out.append(cls)
        queue.extend(_base_name(b).split(".")[-1] for b in cls.bases)
    return out


def _members(mro: list[ast.ClassDef]) -> tuple[set[str], dict]:
    """(implemented member names, method name -> def node resolved
    derived-first across the MRO)."""
    names: set[str] = set()
    methods: dict[str, ast.FunctionDef] = {}
    for cls in mro:
        for node in cls.body:
            if isinstance(node, ast.FunctionDef):
                names.add(node.name)
                methods.setdefault(node.name, node)
                for stmt in ast.walk(node):
                    if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                        targets = (stmt.targets
                                   if isinstance(stmt, ast.Assign)
                                   else [stmt.target])
                        for t in targets:
                            if (isinstance(t, ast.Attribute)
                                    and isinstance(t.value, ast.Name)
                                    and t.value.id == "self"):
                                names.add(t.attr)
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
            elif isinstance(node, ast.AnnAssign):
                if isinstance(node.target, ast.Name):
                    names.add(node.target.id)
    return names, methods


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def _check_module(mod: Module, classes: dict, proto: dict,
                  registry: dict) -> list[Finding]:
    out: list[Finding] = []
    registered = set(registry["entries"].values())
    contract = proto["methods"] | proto["attrs"]
    base_of_registered: set[str] = set()
    for cname in registered:
        for cls in _mro(classes, cname)[1:]:
            base_of_registered.add(cls.name)

    for key, cname in registry["entries"].items():
        cls = classes.get(cname)
        if cls is None:
            out.append(Finding(
                RULE, mod.rel, registry["line"],
                f"registry entry '{key}' points at unknown class "
                f"'{cname}'", func=config.REGISTRY_NAME))
            continue
        mro = _mro(classes, cname)
        have, methods = _members(mro)
        missing = sorted(contract - have)
        if missing:
            out.append(Finding(
                RULE, mod.rel, cls.lineno,
                f"'{cname}' does not implement TileLayout members: "
                f"{missing}",
                hint="implement the full executor + ingest contract "
                     "(see the TileLayout protocol)", func=cname))
        out.extend(_check_fanout(mod, cname, cls, methods, mro))

    # a layout subclass outside the registry is dead code to ServeConfig
    for cname, cls in classes.items():
        if cname in registered or cname in base_of_registered:
            continue
        if cname == config.PROTOCOL_NAME:
            continue
        bases = {_base_name(b).split(".")[-1] for b in cls.bases}
        if bases & (registered | base_of_registered):
            out.append(Finding(
                RULE, mod.rel, cls.lineno,
                f"layout class '{cname}' subclasses a placement base "
                f"but is not registered in {config.REGISTRY_NAME}",
                hint="register it (or it is unreachable from "
                     "ServeConfig.placement)", func=cname))
    return out


def _check_fanout(mod: Module, cname: str, cls: ast.ClassDef,
                  methods: dict, mro: list[ast.ClassDef]) -> list[Finding]:
    scatter, place, rows, marker = config.FANOUT_CHAIN
    if place not in methods:
        return []  # unsharded layout: no replica copies to fan out to
    out: list[Finding] = []
    if scatter not in methods or not _calls(methods[scatter], place):
        out.append(Finding(
            RULE, mod.rel, cls.lineno,
            f"'{cname}._scatter' does not route through "
            f"'{place}' — ingest writes would miss replica copies",
            hint="every ingest scatter fans out to all resident copies "
                 "via _placements", func=cname))
    if not _references(methods[place], rows):
        out.append(Finding(
            RULE, mod.rel, methods[place].lineno,
            f"'{cname}.{place}' never consults '{rows}' — replica "
            "copies are invisible to ingest placement", func=cname))
    elif not any(_references(v, marker) for v in _self_assigns(mro, rows)):
        out.append(Finding(
            RULE, mod.rel, methods[place].lineno,
            f"'{cname}.{rows}' is never built from '{marker}' — the "
            "replica rows do not follow the placement plan", func=cname))
    return out


def _self_assigns(mro: list[ast.ClassDef], attr: str) -> list[ast.expr]:
    """Every value assigned to ``self.<attr>`` in the classes' methods
    (chained targets included)."""
    out = []
    for cls in mro:
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Attribute) and t.attr == attr
                    and isinstance(t.value, ast.Name) and t.value.id == "self"
                    for t in node.targets):
                out.append(node.value)
    return out


def _calls(fn: ast.FunctionDef, name: str) -> bool:
    return any(isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
               and n.func.attr == name for n in ast.walk(fn))


def _references(fn: ast.FunctionDef, name: str) -> bool:
    for n in ast.walk(fn):
        if isinstance(n, ast.Attribute) and n.attr == name:
            return True
        if isinstance(n, ast.Name) and n.id == name:
            return True
    return False


def _check_external_subclasses(project: Project,
                               layout_mods: list) -> list[Finding]:
    """Layout subclasses in other modules still owe the contract."""
    if not layout_mods:
        return []
    out: list[Finding] = []
    base_names: set[str] = set()
    contract: set[str] = set()
    base_members: set[str] = set()
    for mod, classes, proto, registry in layout_mods:
        registered = set(registry["entries"].values())
        contract |= proto["methods"] | proto["attrs"]
        for cname in registered:
            for cls in _mro(classes, cname):
                base_names.add(cls.name)
                have, _ = _members([cls])
                base_members |= have
    for mod in project.modules:
        if any(mod is lm[0] for lm in layout_mods):
            continue
        classes = {c.name: c for c in mod.tree.body
                   if isinstance(c, ast.ClassDef)}
        for cname, cls in classes.items():
            bases = {_base_name(b).split(".")[-1] for b in cls.bases}
            if not bases & base_names:
                continue
            have, _ = _members(_mro(classes, cname))
            missing = sorted(contract - have - base_members)
            if missing:
                out.append(Finding(
                    RULE, mod.rel, cls.lineno,
                    f"external layout subclass '{cname}' misses "
                    f"TileLayout members: {missing}", func=cname))
    return out
