"""Nothing the command runs imports JAX or the JAX package (top-level
names compared whole: ``repro_torch`` is the port and is allowed), and
the plain reference imports nothing of the port either."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "fedbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not imported_roots(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "repro_torch" not in imported_roots(path), path


def test_a_run_loads_no_jax_module():
    """Import every module the command runs, drive a small cell on the CPU,
    and list what is loaded."""
    script = (
        "import json, sys\n"
        "sys.argv = ['run.py']\n"
        "import runpy\n"
        "runpy.run_path('fedbench/run.py', run_name='fedbench_run')\n"
        "runpy.run_path('fedbench/calibrate.py', run_name='fedbench_calibrate')\n"
        "sys.path.insert(0, 'fedbench/tests')\n"
        "from conftest import tiny_spec\n"
        "from fedbench import harness\n"
        "import glob, os\n"
        "for kind in ('families', 'reference', 'flops', 'metrics', 'work'):\n"
        "    for f in glob.glob(f'fedbench/{kind}/*.py'):\n"
        "        name = os.path.basename(f)[:-3]\n"
        "        if name != '__init__':\n"
        "            harness.load_module(kind, name)\n"
        "harness.run('femnist-cnn.int8-async', 1, 0.1, True, 'cpu', tiny_spec('femnist-cnn.int8-async'),\n"
        "            log=lambda s: None)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in %r)))\n"
        % sorted(FORBIDDEN))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), str(ROOT / "src")])
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_are_compared_whole():
    import types

    from fedbench import harness

    names = ("repro.fedbench_test", "jaxlib_fedbench_test", "repro_torch_fedbench_test")
    for n in names:
        sys.modules[n] = types.ModuleType(n)
    try:
        found = harness.forbidden_modules()
        assert "repro.fedbench_test" in found
        assert "jaxlib_fedbench_test" not in found and "repro_torch_fedbench_test" not in found
    finally:
        for n in names:
            del sys.modules[n]


def test_the_command_refuses_to_run_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "fedbench/run.py", "--workload", "femnist-cnn.int8-async",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""
