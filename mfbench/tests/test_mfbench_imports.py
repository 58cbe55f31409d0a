"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's)."""

import ast
import os
import subprocess
import sys

from conftest import CPU_BATCH, PKG, ROOT
from mfbench import run


def test_forbidden_by_top_level_name():
    assert run.FORBIDDEN == ("jax", "jaxlib", "flax",
                             "microstructure_fingerprinting_tpu")
    assert "microstructure_fingerprinting_torch".split(".")[0] \
        not in run.FORBIDDEN


def test_sources_import_neither():
    for dirpath, _dirs, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(dirpath, f)) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module]
                else:
                    continue
                for n in names:
                    assert n.split(".")[0] not in run.FORBIDDEN, (f, n)


def test_a_run_loads_neither():
    """Whole runs of small cells on the CPU (the fast path and the
    general path, traced) and the control, then the process's
    modules."""
    probe = (
        "import io, sys\n"
        "sys.path.insert(0, %r)\n"
        "from conftest import small_cell\n"
        "from mfbench import run\n"
        "for name in ('brain_mix', 'wm_crossing_xla'):\n"
        "    cell = small_cell(name, voxels=10, judge_all=False)\n"
        "    cell.traffic['judge'] = {k: 1 for k in cell.traffic['judge']}\n"
        "    run.run_cell(cell, 3, 0.0, 1, device='cpu',\n"
        "                 fit_kw={'batch_size': %d}, log=io.StringIO())\n"
        "    run.control_run(cell, 3, device='cpu', log=io.StringIO())\n"
        "for m in cell.end_to_end + cell.per_layer:\n"
        "    run.reader(m['name'])\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(run.loaded_forbidden())\n") % (os.path.dirname(__file__),
                                              CPU_BATCH)
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    last = out.stdout.strip().splitlines()
    assert "microstructure_fingerprinting_torch" in last[-2]
    assert last[-1] == "[]"
