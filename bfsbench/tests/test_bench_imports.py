"""What the benchmark may not touch: JAX, the JAX package ``repro`` (by
whole top-level name: the port ``repro_torch`` begins with it), the
reference's ``benchmarks/`` folder and the program's ``get_dataset``."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def sources():
    return sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "")
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


def test_no_module_imports_jax_or_the_jax_package():
    assert sources()
    for path in sources():
        assert not imported_tops(path) & FORBIDDEN, path


def test_nothing_reads_benchmarks_or_get_dataset():
    for path in sources():
        text = path.read_text()
        assert "benchmarks" not in text, path
        assert "BENCH_" not in text, path
        assert "get_dataset" not in text, path


def test_a_run_loads_neither():
    """Importing every module of the benchmark and the program's entries
    it drives leaves no forbidden top-level name in ``sys.modules``."""
    mods = ["bfsbench." + p.stem for p in sources()
            if p.parent == BENCH and p.stem != "__init__"]
    loops = [p.stem for p in sorted((BENCH / "loops").glob("*.py"))]
    metrics = [p.stem for p in sorted((BENCH / "metrics").glob("*.py"))]
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        + "".join(f"import {m}\n" for m in mods) +
        f"for n in {loops!r}: bfsbench.drive.load_loop(n)\n"
        f"for n in {metrics!r}: bfsbench.harness.load_metric(n)\n"
        "import repro_torch.core.vertex_program, repro_torch.core.bfs_local\n"
        "import repro_torch.launch.dynbatch, repro_torch.graph.csr\n"
        "from bfsbench.run import forbidden_modules\n"
        "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole():
    from bfsbench.run import FORBIDDEN as RUN_FORBIDDEN
    assert RUN_FORBIDDEN == FORBIDDEN
    assert "repro_torch".split(".")[0] not in RUN_FORBIDDEN
