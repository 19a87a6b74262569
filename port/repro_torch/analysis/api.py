"""Analyzer driver (twin of ``repro.analysis.api``): build the project
index, run the enabled rules, apply inline suppressions, the config
allowlist, and the baseline."""

from __future__ import annotations

import dataclasses
from pathlib import Path

from . import config
from .core import Finding, Project, load_baseline

RULE_IDS = (
    "jit-closure-capture",
    "recompile-hazard",
    "host-sync",
    "kernel-twin-parity",
    "layout-conformance",
    "bad-suppression",
)

RULE_DOCS = {
    "jit-closure-capture": "staged tensors captured by closure in "
                           "callables stored, returned or handed to "
                           "spawn/in_turns/checkpoint/an executor",
    "recompile-hazard": "data-dependent ints into the bucketed width "
                        "parameters without bucketing",
    "host-sync": "float()/int()/bool()/np.asarray/.item()/.tolist()/"
                 ".cpu()/.numpy() on tensors and torch.cuda.synchronize "
                 "in hot-path modules",
    "kernel-twin-parity": "*_skip twin signatures + CPU output parity "
                          "+ alive-mask and extent threading",
    "layout-conformance": "TileLayout contract + registry + replica "
                          "fan-out route",
    "bad-suppression": "reprolint suppression without a rationale or "
                       "with an unknown rule id",
}


@dataclasses.dataclass
class Report:
    findings: list[Finding]        # actionable (unsuppressed, new)
    suppressed: list[Finding]      # silenced inline with a rationale
    allowlisted: list[Finding]     # silenced by config.ALLOWLIST
    baselined: list[Finding]       # known debt from the baseline file

    def to_json(self) -> dict:
        return {
            "findings": [f.to_json() for f in self.findings],
            "suppressed": [f.to_json() for f in self.suppressed],
            "allowlisted": [f.to_json() for f in self.allowlisted],
            "baselined": [f.to_json() for f in self.baselined],
            "counts": {
                "findings": len(self.findings),
                "suppressed": len(self.suppressed),
                "allowlisted": len(self.allowlisted),
                "baselined": len(self.baselined),
            },
        }


def run(root: str | Path, files: list[Path] | None = None,
        disable: set[str] | frozenset[str] = frozenset(),
        baseline: Path | None = None,
        use_allowlist: bool = True) -> Report:
    from . import r1_closure, r2_recompile, r3_hostsync, r4_twins, r5_layout

    project = Project(Path(root), files)
    rules = {
        "jit-closure-capture": r1_closure.check,
        "recompile-hazard": r2_recompile.check,
        "host-sync": r3_hostsync.check,
        "kernel-twin-parity": r4_twins.check,
        "layout-conformance": r5_layout.check,
    }
    raw: list[Finding] = list(project.errors)
    for rule_id, checker in rules.items():
        if rule_id not in disable:
            raw.extend(checker(project))
    if "bad-suppression" not in disable:
        for mod in project.modules:
            raw.extend(mod.bad_suppressions)

    by_rel = {m.rel: m for m in project.modules}
    report = Report([], [], [], [])
    known = load_baseline(baseline) if baseline else set()
    for f in sorted(raw, key=lambda f: (f.path, f.line, f.rule)):
        mod = by_rel.get(f.path)
        if (mod is not None and f.rule != "bad-suppression"
                and mod.suppressed(f.line, f.rule)):
            report.suppressed.append(f)
        elif use_allowlist and _allowlisted(f):
            report.allowlisted.append(f)
        elif f.fingerprint() in known:
            report.baselined.append(f)
        else:
            report.findings.append(f)
    return report


def _allowlisted(f: Finding) -> bool:
    for suffix, func, rule, reason in config.ALLOWLIST:
        assert reason, "allowlist entries must carry a rationale"
        if not f.path.endswith(suffix):
            continue
        if func is not None and f.func != func:
            continue
        if rule is not None and f.rule != rule:
            continue
        return True
    return False
