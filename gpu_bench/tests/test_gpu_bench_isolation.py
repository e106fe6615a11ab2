"""What the benchmark loads: no module named ``jax`` or ``points_matching_tpu``
(the JAX package; compared by whole top-level name, since the port's name
starts with it) in the run's process, and nothing of the port in the
reference, by import and by the reference's source."""
import ast
import glob
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "points_matching_tpu"}


def _top_level_after(code: str, cwd: str = ROOT) -> set:
    """Top-level names of ``sys.modules`` after ``code`` runs in a fresh
    interpreter (JAX not imported by anything else there)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHON")}
    prog = (f"import sys, json; sys.path.insert(0, {ROOT!r})\n{code}\n"
            "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], cwd=cwd, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    """Every module of the harness, its drivers, its metric readers and the
    reference, and a whole rehearsal run of every cell."""
    code = """
import glob, os
from gpu_bench import harness, rehearsal, run, readings, trace, host, generators, faults
from gpu_bench.drivers import verify, retrieval
from gpu_bench.reference import matching, ransac, all_pairs
for path in glob.glob(os.path.join(harness.HERE, "metrics", "*.py")):
    harness.load_reader(path)
root = rehearsal.tiny_copy(%r)
for cell in harness.list_all(root):
    harness.run_cell(cell, 2**40 + 7, 0.2, True, dev="cpu", root=root)
""" % str(tmp_path / "bench")
    names = _top_level_after(code)
    assert "points_matching_tpu_torch" in names            # the port ran
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level_after("from gpu_bench.reference import matching, ransac, all_pairs")
    assert not names & (FORBIDDEN | {"points_matching_tpu_torch"})


def test_the_reference_source_imports_only_torch_and_itself():
    for path in glob.glob(os.path.join(ROOT, "gpu_bench", "reference", "*.py")):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".", 1)[0]
                assert top in {"__future__", "math", "typing", "torch", "numpy", "gpu_bench"}, \
                    (path, m)
                if top == "gpu_bench":
                    assert m.startswith("gpu_bench.reference"), (path, m)
