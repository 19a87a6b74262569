"""The port's hazard checker from the command line (twin of
``tools/reprolint.py``).  From ``port/``:

    python -m repro_torch.analysis repro_torch          # exit 1 if any
    python -m repro_torch.analysis repro_torch --json   # machine-readable
    python -m repro_torch.analysis repro_torch --no-allowlist  # audit

Exit codes: 0 clean, 1 findings, 2 usage error.  Suppress inline with
``# reprolint: disable=<rule> -- <rationale>``; a suppression without
a rationale is itself a finding.  AST plus CPU calls of the plain
twins only — never builds or launches a kernel.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

EXIT_OK = 0
EXIT_FINDINGS = 1
EXIT_USAGE = 2

DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.json"


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static hazard analyzer for the PyTorch/CUDA port")
    p.add_argument("root", nargs="?", default="repro_torch",
                   help="directory tree to scan (default: repro_torch)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit machine-readable JSON on stdout")
    p.add_argument("--out", type=Path, default=None, metavar="PATH",
                   help="also write the JSON report to PATH")
    p.add_argument("--baseline", type=Path, default=DEFAULT_BASELINE,
                   help="baseline file of accepted fingerprints")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore the baseline (report all findings)")
    p.add_argument("--write-baseline", action="store_true",
                   help="accept current findings into the baseline")
    p.add_argument("--no-allowlist", action="store_true",
                   help="also report findings the config allowlist "
                        "silences (audit mode)")
    p.add_argument("--disable", action="append", default=[],
                   metavar="RULE", help="disable a rule id (repeatable)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalogue and exit")
    args = p.parse_args(argv)

    from . import api
    from .core import write_baseline

    if args.list_rules:
        for rid in api.RULE_IDS:
            print(f"{rid:22s} {api.RULE_DOCS[rid]}")
        return EXIT_OK

    bad = set(args.disable) - set(api.RULE_IDS)
    if bad:
        print(f"unknown rule id(s): {sorted(bad)}", file=sys.stderr)
        return EXIT_USAGE
    root = Path(args.root)
    if not root.exists():
        print(f"no such path: {root}", file=sys.stderr)
        return EXIT_USAGE

    report = api.run(
        root, disable=set(args.disable),
        baseline=None if args.no_baseline else args.baseline,
        use_allowlist=not args.no_allowlist)

    if args.write_baseline:
        write_baseline(args.baseline, report.findings)
        print(f"baseline: {len(report.findings)} fingerprint(s) -> "
              f"{args.baseline}")
        return EXIT_OK

    lines = [f.render() for f in report.findings]
    summary = (f"reprolint: {len(report.findings)} finding(s), "
               f"{len(report.suppressed)} suppressed, "
               f"{len(report.allowlisted)} allowlisted, "
               f"{len(report.baselined)} baselined")
    human = "\n".join(lines + [summary]) if lines else summary + " — OK"
    text = json.dumps(report.to_json(), indent=2)
    if args.out is not None:
        args.out.write_text(text + "\n")
    print(text if args.as_json else human)
    return EXIT_FINDINGS if report.findings else EXIT_OK


if __name__ == "__main__":
    sys.exit(main())
