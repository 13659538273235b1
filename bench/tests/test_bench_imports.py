"""Nothing the benchmark runs imports JAX, the JAX package (``repro``) or
its benchmarks, and the reference imports nothing of the port either;
module names are compared by their whole top-level name (``repro_torch``
is not ``repro``)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NEVER = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
PLAIN = ("reference",)          # the reference's folder: no port either


def imported(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_sources_import_no_jax(path):
    names = imported(path)
    assert not names & NEVER
    if path.relative_to(BENCH).parts[0] in PLAIN or path.name == "inputs.py":
        assert "repro_torch" not in names


def _modules_after(code: str):
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path[:0] = "
         f"[{str(ROOT)!r}, {str(ROOT / 'src')!r}, {str(BENCH / 'tests')!r}]"
         f"\n{code}\nprint(' '.join(sorted({{m.split('.')[0] "
         f"for m in sys.modules}})))"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def test_reference_loads_no_port_and_no_jax():
    mods = _modules_after(
        "import bench.reference.follow, bench.reference.decoder, "
        "bench.reference.mamba2, bench.reference.server")
    assert not mods & (NEVER | {"repro_torch"})


def test_a_whole_run_loads_no_jax(tmp_path):
    mods = _modules_after(
        "import torch\nfrom tiny import tiny_root\nfrom bench import run\n"
        f"args = run.parse(['--workload', 'mamba2-370m.train', '--seed', '3',"
        f" '--seconds', '0.2', '--trace', '1'])\n"
        f"r, _ = run.run(args, root=tiny_root({str(tmp_path)!r}), "
        f"device=torch.device('cpu'))\nassert r['correct']\n"
        "assert not run.forbidden_modules()")
    assert "repro_torch" in mods and not mods & NEVER
