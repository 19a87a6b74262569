"""The port's import boundary: nothing under port/ imports jax or repro,
and importing every repro_torch module leaves both out of
sys.modules."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import ast
import json
import subprocess
from pathlib import Path

PORT = Path(__file__).resolve().parent.parent / "port"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _modules():
    for path in sorted((PORT / "repro_torch").rglob("*.py")):
        rel = path.relative_to(PORT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield path, ".".join(parts)


def _top(name: str) -> str:
    return name.split(".")[0]


def test_no_module_under_port_imports_jax_or_repro():
    found = []
    for path, _ in _modules():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [f"{path.relative_to(PORT)}:{node.lineno} {n}"
                      for n in names if _top(n) in FORBIDDEN]
    assert not found, found


def test_importing_every_module_loads_neither_jax_nor_repro():
    mods = [m for _, m in _modules()]
    assert "repro_torch.serve.engine" in mods
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {str(PORT)!r})\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(n for n in sys.modules\n"
        f"      if n.split('.')[0] in {FORBIDDEN!r})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_lm_slice_is_in_the_walk():
    mods = [m for _, m in _modules()]
    for m in ("repro_torch.models.lm", "repro_torch.models.api",
              "repro_torch.configs.mamba2_1p3b",
              "repro_torch.kernels.ssd.kernel", "repro_torch.launch.serve",
              "repro_torch.optim.adamw", "repro_torch.data.tokens",
              "repro_torch.checkpoint.store", "repro_torch.ft.runtime",
              "repro_torch.launch.train", "repro_torch.models.moe",
              "repro_torch.models.rglru", "repro_torch.models.encdec"):
        assert m in mods, m


def test_the_mesh_ranks_load_neither_jax_nor_repro():
    """The mesh mode's module is in the walk, and the program the
    spawned ranks of ``tests/test_torch_mesh.py`` unpickle imports the
    port only."""
    assert "repro_torch.launch.mesh" in [m for _, m in _modules()]
    tests = Path(__file__).resolve().parent
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(tests)!r})\n"
        "import torch_mesh_ranks\n"
        "print(json.dumps(sorted(n for n in sys.modules\n"
        f"      if n.split('.')[0] in {FORBIDDEN!r})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
