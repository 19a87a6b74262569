"""The port's hazard checker (``repro_torch.analysis``) against the
reference's (``repro.analysis``), on the CPU.

(a) The rule-agnostic core gives the reference's answers on every
source file of both packages: module globals, function names and
parameters, suppressions (every line, every rule), bad suppressions,
fingerprints, and the baseline file.  (b) Each known-bad and
known-good fixture of ``tests/test_reprolint.py``, read from that file
and translated into torch's idiom under ``repro_torch/`` paths: every
bad one fires its rule at the reference's lines on the original and
stops when the rule is disabled, every good one is clean; then the
torch readings the reference has no fixture for.  (c) The live tree:
zero findings, the known host reads at their lines without the
allowlist, every rationale present, the baseline empty.  (d) R4's CPU
twin calls build and launch no kernel.  (e) The CLI's exit codes,
rule list and JSON keys.  Tolerance: exact equality throughout."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import ast
import json
import subprocess
import textwrap
from pathlib import Path

import pytest
import torch

import test_reprolint as ref_fx
from repro.analysis import api as japi
from repro.analysis import core as jcore
from repro_torch.analysis import __main__ as tcli
from repro_torch.analysis import api as tapi
from repro_torch.analysis import config as tconfig
from repro_torch.analysis import core as tcore
from repro_torch.analysis import r4_twins
from repro_torch.kernels import cuda_build
from repro_torch.kernels.hilbert import kernel as hkernel
from repro_torch.kernels.mbr_join import kernel as mkernel
from repro_torch.kernels.range_probe import kernel as rkernel
from repro_torch.kernels.range_probe import ref as rref
from repro_torch.kernels.ssd import kernel as skernel

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "port"
BASELINE = PORT / "repro_torch" / "analysis" / "baseline.json"
KERNELS = (rkernel, hkernel, mkernel, skernel)
# the known device->host reads, each at its line
KNOWN_READS = {("query/knn.py", 155), ("kernels/range_probe/kernel.py", 222),
               ("kernels/range_probe/kernel.py", 347),
               ("kernels/mbr_join/kernel.py", 220)}


# ---------------------------------------------------------------------------
# (a) the core against the reference's
# ---------------------------------------------------------------------------

def _finding_tuple(f):
    return (f.rule, f.path, f.line, f.message, f.hint, f.func)


def _module_view(core, mod):
    fns = list(core.func_defs(mod.tree))
    return dict(
        globals=core.module_globals(mod.tree),
        funcs=[fn.name for fn in fns],
        params=[core.param_names(fn) for fn in fns],
        suppressed=[(i, r) for i in range(1, len(mod.lines) + 2)
                    for r in japi.RULE_IDS if mod.suppressed(i, r)],
        bad=[_finding_tuple(f) for f in mod.bad_suppressions])


@pytest.mark.parametrize("tree", ["src/repro", "port/repro_torch"])
def test_core_reads_every_file_as_the_reference(tree):
    root = REPO / tree
    files = sorted(p for p in root.rglob("*.py")
                   if "__pycache__" not in p.parts)
    assert files
    n_supp = 0
    for p in files:
        rel, text = p.relative_to(root).as_posix(), p.read_text()
        want = _module_view(jcore, jcore.Module(p, rel, text))
        got = _module_view(tcore, tcore.Module(p, rel, text))
        assert got == want, rel
        n_supp += len(got["suppressed"])
    assert n_supp     # both trees carry suppressions


SUPPRESSION_TEXT = '''
import numpy as np

def f(x):
    # reprolint: disable=host-sync -- a standalone comment, next code line
    a = float(x)
    b = int(x)  # reprolint: disable=host-sync,recompile-hazard -- inline
    # reprolint: disable=host-sync
    c = bool(x)
    d = int(x)  # reprolint: disable=no-such-rule -- unknown id
    # reprolint: disable=host-sync, kernel-twin-parity --
    #   a rationale on the next line does not count
    return a, b, c, d
'''


def test_suppression_parsing_and_fingerprints_match_the_reference(tmp_path):
    p = tmp_path / "mod.py"
    p.write_text(SUPPRESSION_TEXT)
    want = jcore.Module(p, "pkg/mod.py", SUPPRESSION_TEXT)
    got = tcore.Module(p, "pkg/mod.py", SUPPRESSION_TEXT)
    assert got.suppress == want.suppress and got.suppress
    assert ([_finding_tuple(f) for f in got.bad_suppressions]
            == [_finding_tuple(f) for f in want.bad_suppressions])
    assert len(got.bad_suppressions) == 3
    fields = ("host-sync", "serve/x.py", 7, "a message", "a hint", "fn")
    for kw in ({}, {"hint": ""}, {"func": ""}):
        args = dict(zip(("rule", "path", "line", "message", "hint",
                         "func"), fields), **kw)
        a, b = tcore.Finding(**args), jcore.Finding(**args)
        assert a.fingerprint() == b.fingerprint()
        assert a.render() == b.render() and a.to_json() == b.to_json()


def test_baseline_round_trips_with_the_reference(tmp_path):
    findings = [tcore.Finding("host-sync", f"serve/{i}.py", i, f"m{i}",
                              func="f") for i in (3, 1, 2)]
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    tcore.write_baseline(ours, findings)
    jcore.write_baseline(theirs, [jcore.Finding(*_finding_tuple(f))
                                  for f in findings])
    assert ours.read_text() == theirs.read_text()
    want = {f.fingerprint() for f in findings}
    assert tcore.load_baseline(ours) == jcore.load_baseline(ours) == want
    assert tcore.load_baseline(tmp_path / "none.json") == set()


# ---------------------------------------------------------------------------
# (b) the reference's fixtures in torch's idiom
# ---------------------------------------------------------------------------

def _inline_fixtures() -> dict:
    """``files = {...}`` of each test function of test_reprolint.py,
    evaluated in that module's namespace (the reference's text)."""
    tree = ast.parse(Path(ref_fx.__file__).read_text())
    out = {}
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if (isinstance(node, ast.Assign)
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == "files"):
                out[fn.name] = eval(compile(ast.Expression(node.value),
                                            ref_fx.__file__, "eval"),
                                    vars(ref_fx))
                break
    return out


INLINE = _inline_fixtures()

T_R1_BAD = {"repro_torch/serve/stage.py": """
    import torch


    def build_step(srv):
        tiles = srv.staged.canon_tiles
        srv.step = lambda q: q @ tiles
        return srv.step
    """}
T_R1_GOOD = {"repro_torch/serve/stage.py": """
    import torch


    def build_step(srv):
        tiles = srv.staged.canon_tiles
        srv.step = lambda q, t: q @ t
        return srv.step, tiles
    """}
T_R1_LOCAL = {"repro_torch/serve/stage.py": """
    import torch


    def build_step(srv):
        tiles = srv.staged.canon_tiles
        def step(q):
            return q @ tiles
        return step
    """}
T_R2_BAD = {"repro_torch/serve/router.py": """
    import torch


    # the reference jits it with static_argnames=("f_max",)
    def candidates_from_overlap(hit, f_max):
        return hit[:, :f_max]

    def serve(hit, batch):
        n = len(batch)
        return candidates_from_overlap(hit, f_max=n)
    """}
T_R2_GOOD = {"repro_torch/serve/router.py": """
    import torch

    def round_up(x, m):
        return (x + m - 1) // m * m

    # the reference jits it with static_argnames=("f_max",)
    def candidates_from_overlap(hit, f_max):
        return hit[:, :f_max]

    def serve(hit, batch):
        n = round_up(len(batch), 8)
        return candidates_from_overlap(hit, f_max=n)
    """}
T_R2_CROSS = {
    "repro_torch/kernels/hilbert/ops.py": """
        import torch


        # the reference jits it with static_argnames=("order", ...)
        def encode(gx, gy, order=16):
            return gx[:order]
        """,
    "repro_torch/serve/caller.py": """
        from ..kernels.hilbert import ops as hops

        def serve(gx, gy, batch):
            return hops.encode(gx, gy, len(batch))
        """,
}
T_R3_BAD = {"repro_torch/serve/exchange.py": """
    import torch

    def merge(parts):
        total = torch.sum(parts)
        return float(total)
    """}
T_R3_GOOD = {"repro_torch/serve/exchange.py": """
    import torch

    def merge(parts):
        return torch.sum(parts)

    def host_merge(host_counts):
        return float(sum(host_counts))
    """}
T_SUPPRESSED = {"repro_torch/serve/exchange.py": """
    import torch

    def merge(parts):
        total = torch.sum(parts)
        # reprolint: disable=host-sync -- merge result must come home
        return float(total)
    """}
T_NO_RATIONALE = {"repro_torch/serve/exchange.py": """
    import torch

    def merge(parts):
        total = torch.sum(parts)
        # reprolint: disable=host-sync
        return float(total)
    """}
T_UNKNOWN_RULE = {"repro_torch/serve/exchange.py": """
    # reprolint: disable=no-such-rule -- rationale present
    X = 1
    """}
T_R4_HEADER = """
    import torch

    def probe_counts(qboxes, tiles, *, alive=None):
        hit = qboxes[:, None, 0, None] <= tiles[None, :, :, 2]
        if alive is not None:
            hit = hit & alive[None]
        return torch.sum(hit, dim=2).to(torch.int32)
    """
T_R4_BAD_AVAL = {"repro_torch/kernels/fake/ops.py": T_R4_HEADER + """
    def probe_counts_skip(qboxes, tiles, cboxes, *, alive=None):
        hit = qboxes[:, None, 0, None] <= tiles[None, :, :, 2]
        if alive is not None:
            hit = hit & alive[None]
        return torch.sum(hit, dim=(1, 2)).to(torch.int32)
    """}
T_R4_GOOD = {"repro_torch/kernels/fake/ops.py": T_R4_HEADER + """
    def probe_counts_skip(qboxes, tiles, cboxes, *, alive=None):
        hit = qboxes[:, None, 0, None] <= tiles[None, :, :, 2]
        live = qboxes[:, None, 0, None] <= cboxes[None, :, :, 2]
        if alive is not None:
            hit = hit & alive[None]
        return (torch.sum(hit, dim=2) * live[..., 0]).to(torch.int32)
    """}
T_R4_BAD_SIG = {"repro_torch/kernels/fake/ops.py": T_R4_HEADER + """
    def probe_counts_skip(qboxes, tiles, cboxes, extra, *, alive=None):
        if alive is not None:
            tiles = tiles * alive[..., None]
        return torch.sum(tiles * extra, dim=(1, 2))
    """}
T_R4_MISSING = {"repro_torch/kernels/fake/ops.py": """
    import torch

    def probe_counts(qboxes, tiles):
        return torch.sum(tiles, dim=(1, 2))
    """}
T_R4_UNUSED = {"repro_torch/kernels/fake/ops.py": """
    import torch

    def probe_counts(qboxes, tiles, *, alive=None):
        return torch.sum(tiles, dim=(1, 2))
    """}
T_R4_ORPHAN = {"repro_torch/kernels/fake/ops.py": """
    import torch

    def gathered_mask_skip(qboxes, gtiles, gcboxes, *, galive=None):
        m = qboxes[:, None, 0, None] <= gtiles[..., 2]
        if galive is not None:
            m = m & galive
        return m
    """}
# R5 reads no jax: the reference's text under repro_torch/ paths
T_R5_FANOUT = {"repro_torch/serve/layout.py": ref_fx.R5_PRELUDE + """
    class Sharded(Base):
        def range_counts(self, qboxes):
            return 0
        def _placements(self, t):
            return t, None          # never consults _rep_rows
        def _install(self, slayout):
            self._rep_rows = slayout.rep_owner
        def _scatter(self, plan):
            return 1                # skips _placements entirely

    _PLACEMENT_CLS = {"sharded": Sharded}
    """}


def _ported(files: dict) -> dict:
    return {"repro_torch/" + rel.split("/", 1)[1]: text
            for rel, text in files.items()}


# name -> (rule, the reference's files, the port's files, message part)
BAD = {
    "r1_closure": ("jit-closure-capture", ref_fx.R1_BAD, T_R1_BAD,
                   "'tiles'"),
    "r1_local_def": ("jit-closure-capture",
                     INLINE["test_r1_local_def_capture"], T_R1_LOCAL,
                     "'step'"),
    "r2_unbucketed": ("recompile-hazard", ref_fx.R2_BAD, T_R2_BAD,
                      "'f_max'"),
    "r2_positional_cross_module": (
        "recompile-hazard", INLINE["test_r2_positional_and_cross_module"],
        T_R2_CROSS, "'order'"),
    "r3_hot_path_sync": ("host-sync", ref_fx.R3_BAD, T_R3_BAD, "float()"),
    "r3_without_rationale": (
        "host-sync",
        INLINE["test_suppression_without_rationale_is_a_finding"],
        T_NO_RATIONALE, "float()"),
    "suppression_without_rationale": (
        "bad-suppression",
        INLINE["test_suppression_without_rationale_is_a_finding"],
        T_NO_RATIONALE, "without a rationale"),
    "suppression_unknown_rule": (
        "bad-suppression",
        INLINE["test_suppression_unknown_rule_is_a_finding"],
        T_UNKNOWN_RULE, "unknown rule id"),
    "r4_aval_mismatch": ("kernel-twin-parity", ref_fx.R4_BAD_AVAL,
                         T_R4_BAD_AVAL, "output avals differ"),
    "r4_signature_mismatch": ("kernel-twin-parity", ref_fx.R4_BAD_SIG,
                              T_R4_BAD_SIG, "signature mismatch"),
    "r4_missing_alive": ("kernel-twin-parity",
                         INLINE["test_r4_missing_alive"], T_R4_MISSING,
                         "tombstone"),
    "r4_unused_alive": ("kernel-twin-parity", INLINE["test_r4_unused_alive"],
                        T_R4_UNUSED, "never uses"),
    "r4_orphan_skip_twin": ("kernel-twin-parity",
                            INLINE["test_r4_orphan_skip_twin"], T_R4_ORPHAN,
                            "no base twin"),
    "r5_missing_member": ("layout-conformance", ref_fx.R5_BAD,
                          _ported(ref_fx.R5_BAD), "range_counts"),
    "r5_unregistered_subclass": (
        "layout-conformance", INLINE["test_r5_unregistered_subclass"],
        _ported(INLINE["test_r5_unregistered_subclass"]), "not registered"),
    "r5_replica_fanout": ("layout-conformance",
                          INLINE["test_r5_replica_fanout_chain"],
                          T_R5_FANOUT, "_rep_rows"),
}
GOOD = {
    "r1": T_R1_GOOD, "r2": T_R2_GOOD, "r3": T_R3_GOOD,
    "r3_cold_module": {"repro_torch/serve/coldplane.py":
                       T_R3_BAD["repro_torch/serve/exchange.py"]},
    "r4": T_R4_GOOD, "r5": _ported(ref_fx.R5_GOOD),
}


def _write(root: Path, files: dict) -> Path:
    for rel, text in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
    return root


def _lines(report, rule):
    return sorted(f.line for f in report.findings if f.rule == rule)


@pytest.mark.parametrize("case", sorted(BAD))
def test_bad_fixture_fires_at_the_reference_line(tmp_path, case):
    rule, ref_files, port_files, part = BAD[case]
    ref_root = _write(tmp_path / "ref" / "src", ref_files)
    port_root = _write(tmp_path / "port" / "src", port_files)
    want = _lines(japi.run(ref_root, use_allowlist=False), rule)
    got = tapi.run(port_root, use_allowlist=False)
    assert want and _lines(got, rule) == want, [f.render()
                                                for f in got.findings]
    assert any(part in f.message for f in got.findings if f.rule == rule)
    off = tapi.run(port_root, disable={rule}, use_allowlist=False)
    assert not [f for f in off.findings if f.rule == rule]


@pytest.mark.parametrize("case", sorted(GOOD))
def test_good_fixture_is_clean(tmp_path, case):
    rep = tapi.run(_write(tmp_path / "src", GOOD[case]), use_allowlist=False)
    assert rep.findings == [], [f.render() for f in rep.findings]


def test_suppression_with_rationale_silences(tmp_path):
    want = japi.run(_write(tmp_path / "ref", INLINE[
        "test_suppression_with_rationale_silences"]), use_allowlist=False)
    got = tapi.run(_write(tmp_path / "port", T_SUPPRESSED),
                   use_allowlist=False)
    assert not got.findings and not want.findings
    assert ([(f.rule, f.line) for f in got.suppressed]
            == [(f.rule, f.line) for f in want.suppressed] == [("host-sync",
                                                                7)])


T_R5_NOT_FROM_REP_OWNER = {"repro_torch/serve/layout.py": ref_fx.R5_PRELUDE
                           + """
    class Sharded(Base):
        def range_counts(self, qboxes):
            return 0
        def _placements(self, t):
            return t, self._rep_rows
        def _install(self, slayout):
            self._rep_rows = slayout.owner
        def _scatter(self, plan):
            return self._placements(plan)

    _PLACEMENT_CLS = {"sharded": Sharded}
    """}


# the torch readings the reference has no fixture for -> (rule, files,
# the findings' lines, message part)
def _sink_case(call: str) -> dict:
    return {"repro_torch/serve/stage.py": f"""
        from repro_torch.launch import mesh
        from torch.utils import checkpoint

        def build(srv, m, q, loop, pool):
            tiles = srv.slayout.canon_shards
            return {call}
        """}


TORCH_ONLY = {
    "r1_in_turns": ("jit-closure-capture", _sink_case(
        "mesh.in_turns(m, lambda: tiles.sum())"), 7, "'in_turns'"),
    "r1_checkpoint": ("jit-closure-capture", _sink_case(
        "checkpoint.checkpoint(lambda x: x @ tiles, q)"), 7, "'checkpoint'"),
    "r1_executor": ("jit-closure-capture", _sink_case(
        "loop.run_in_executor(pool, lambda: tiles[q])"), 7,
        "'run_in_executor'"),
    "r3_item": ("host-sync", {"repro_torch/query/knn.py": """
        import torch

        def rounds(r: torch.Tensor):
            return r.max().item()
        """}, 5, ".item()"),
    "r3_synchronize": ("host-sync", {"repro_torch/serve/engine.py": """
        import torch

        def fence(dev):
            torch.cuda.synchronize(dev)
        """}, 5, "torch.cuda.synchronize()"),
    "r3_used_as_tensor": ("host-sync", {"repro_torch/kernels/range_probe/"
                                        "kernel.py": """
        def emit(incl):
            return int(incl[-1]) if incl.numel() else 0
        """}, 3, "int()"),
    "r3_tensor_returning_call": ("host-sync", {
        "repro_torch/serve/router.py": """
        import torch

        def overlap(a, b) -> torch.Tensor:
            return a @ b

        def fold(a, b):
            return overlap(a, b).cpu().numpy()
        """}, 8, ".cpu()"),
    "r4_extent_unused": ("kernel-twin-parity", {
        "repro_torch/kernels/fake/ops.py": """
        import torch

        def probe_counts(qboxes, tiles, *, alive=None, extent=None):
            hit = qboxes[:, None, 0, None] <= tiles[None, :, :, 2]
            if alive is not None:
                hit = hit & alive[None]
            return torch.sum(hit, dim=2)
        """}, 4, "accepts 'extent'"),
    "r4_extent_without_alive": ("kernel-twin-parity", {
        "repro_torch/kernels/fake/ops.py": """
        def probe_counts(qboxes, tiles, *, extent=None):
            return tiles[:, :extent]
        """}, [2, 2], "without the 'alive'"),
    "r5_replicas_not_from_rep_owner": ("layout-conformance",
                                       T_R5_NOT_FROM_REP_OWNER, 20,
                                       "rep_owner"),
}


@pytest.mark.parametrize("case", sorted(TORCH_ONLY))
def test_torch_reading_fires(tmp_path, case):
    rule, files, line, part = TORCH_ONLY[case]
    rep = tapi.run(_write(tmp_path / "src", files), use_allowlist=False)
    found = [f for f in rep.findings if f.rule == rule]
    want = line if isinstance(line, list) else [line]
    assert [f.line for f in found] == want, [f.render()
                                             for f in rep.findings]
    assert any(part in f.message for f in found)
    off = tapi.run(tmp_path / "src", disable={rule}, use_allowlist=False)
    assert not [f for f in off.findings if f.rule == rule]


# ---------------------------------------------------------------------------
# (c) the live tree, (d) no kernel
# ---------------------------------------------------------------------------

SKIP_TWINS = ("probe_counts_skip", "probe_mask_skip", "gathered_counts_skip",
              "gathered_mask_skip")


@pytest.fixture(scope="module")
def audit():
    """The live tree with the allowlist off (the audit), R4's parity
    calls of the plain skip twins counted and every kernel build
    refused."""
    calls = []

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return wrapper

    def no_build(sources):
        raise AssertionError(f"the checker built {sources}")

    with pytest.MonkeyPatch.context() as mp:
        for name in SKIP_TWINS:
            mp.setattr(rref, name, counted(name, getattr(rref, name)))
        mp.setattr(cuda_build, "build_all", no_build)
        for mod in KERNELS:
            mod.reset_launches()
        report = tapi.run(PORT / "repro_torch", baseline=BASELINE,
                          use_allowlist=False)
        launches = [dict(mod.LAUNCHES) for mod in KERNELS]
    return report, launches, calls


def test_live_tree_is_clean(audit):
    report = audit[0]
    live = [f for f in report.findings if not tapi._allowlisted(f)]
    assert live == [], "\n".join(f.render() for f in live)
    assert not report.baselined
    assert report.suppressed, "expected deliberate suppressed sites"


def test_known_host_reads_are_listed_without_the_allowlist(audit):
    reads = {(f.path, f.line) for f in audit[0].findings
             if f.rule == "host-sync"}
    assert KNOWN_READS <= reads


def test_every_rationale_is_present_and_the_baseline_empty(audit):
    assert not [f for f in audit[0].findings if f.rule == "bad-suppression"]
    assert all(reason.strip() for *_, reason in tconfig.ALLOWLIST)
    assert json.loads(BASELINE.read_text()) == {"fingerprints": []}


def test_twin_parity_calls_build_and_launch_no_kernel(audit):
    _, launches, calls = audit
    assert all(not any(counts.values()) for counts in launches), launches
    assert set(calls) == set(SKIP_TWINS)


def test_twin_parity_refuses_a_launch(tmp_path, monkeypatch):
    """A twin that launched a kernel would fail the check, not pass
    it."""
    seen = iter([{}, {("k", "x"): 1}])
    monkeypatch.setattr(r4_twins, "_launch_counts", lambda: next(seen))
    project = tcore.Project(_write(tmp_path / "src", T_R4_GOOD))
    with pytest.raises(AssertionError, match="launched a kernel"):
        r4_twins.check(project)


# ---------------------------------------------------------------------------
# (e) the CLI
# ---------------------------------------------------------------------------

def test_cli_from_port_exits_0_with_the_reference_json_keys():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "repro_torch",
         "--json"], cwd=PORT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    payload = json.loads(out.stdout)
    want = japi.Report([], [], [], []).to_json()
    assert payload.keys() == want.keys()
    assert payload["counts"].keys() == want["counts"].keys()
    assert payload["counts"]["findings"] == 0


def test_cli_exit_codes_and_rule_list(tmp_path, capsys):
    root = _write(tmp_path / "src", T_R1_BAD)
    assert tcli.main([str(root), "--no-baseline"]) == tcli.EXIT_FINDINGS
    assert "jit-closure-capture" in capsys.readouterr().out
    assert tcli.main([str(root), "--disable", "jit-closure-capture",
                      "--no-baseline"]) == tcli.EXIT_OK
    assert tcli.main([str(root), "--disable", "no-such-rule"]) == 2
    assert tcli.main([str(tmp_path / "missing")]) == 2
    with pytest.raises(SystemExit) as e:
        tcli.main(["--no-such-flag"])
    assert e.value.code == 2
    capsys.readouterr()
    assert tcli.main(["--list-rules"]) == tcli.EXIT_OK
    listed = [ln.split()[0] for ln in capsys.readouterr().out.splitlines()]
    assert listed == list(japi.RULE_IDS) == list(tapi.RULE_IDS)


def test_cli_baseline_accepts_and_then_silences(tmp_path, capsys):
    root = _write(tmp_path / "src", T_R3_BAD)
    base = tmp_path / "baseline.json"
    assert tcli.main([str(root), "--baseline", str(base),
                      "--write-baseline"]) == tcli.EXIT_OK
    assert len(tcore.load_baseline(base)) == 1
    assert tcli.main([str(root), "--baseline", str(base)]) == tcli.EXIT_OK
    assert tcli.main([str(root), "--baseline", str(base),
                      "--no-baseline"]) == tcli.EXIT_FINDINGS
    assert tcli.main([str(root), "--no-baseline",
                      "--no-allowlist"]) == tcli.EXIT_FINDINGS
