"""The harness finds every configuration, traffic mix, metric and kernel
work count by name, and takes a new one dropped in as a file, with no
edit of its code."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from fedbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(workload):
    spec = harness.cell_spec(workload)
    cfg, traffic = spec["config"], spec["traffic"]
    assert spec["entry"]["chips"] == 1
    for name in ("families", "reference", "flops"):
        assert harness.load_module(name, cfg["family"])
    assert traffic["server"] in ("barrier", "async")
    from fedbench.check import NAMES

    assert spec["limits"] and set(spec["limits"]) <= set(NAMES)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(harness.load_module("metrics", metric).read)


@pytest.mark.parametrize("kernel", ["fedavg_reduce", "dequant_fold", "flash_attention",
                                    "flash_attention_bwd"])
def test_every_kernel_has_a_work_count(kernel):
    assert callable(harness.load_module("work", kernel).work)


def test_config_file_of_each_configuration_is_the_one_run():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])


NEW_FILES = {
    "fedbench/configs/femnist-narrow.json": None,   # filled from femnist-cnn's below
    "fedbench/traffic/two-silos.json": json.dumps({
        "server": "barrier", "update": "dense", "silos": [[40, 10], [50, 12]], "batch": 32,
        "local_epochs": 1, "measure_messages": False, "trace_rounds": 1}),
    "fedbench/metrics/rounds_run.py": "def read(rec):\n    return float(len(rec['rounds']))\n",
    "fedbench/work/copy_rows.py": "def work(elems):\n    return {'flops': 0.0, 'bytes': 8.0 * elems}\n",
}


def test_new_cell_metric_and_work_are_taken_as_files(tmp_path):
    """A copy of the benchmark with a new configuration, traffic mix,
    metric and work file added, and BENCHMARK.json naming them: a run of
    the new cell reports the new metric, with no code edited."""
    shutil.copytree(ROOT / "fedbench", tmp_path / "fedbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((ROOT / "fedbench/configs/femnist-cnn.json").read_text())
    cfg.update(name="femnist-narrow", n_fc=2, fc_width=64)
    files = dict(NEW_FILES, **{"fedbench/configs/femnist-narrow.json": json.dumps(cfg)})
    for rel, text in files.items():
        (tmp_path / rel).write_text(text)
    limits = {"limits": {"step_loss": 1e-3, "grad1": 1e-3, "delta": 1e-2}}   # the test cell's own
    (tmp_path / "fedbench/limits/femnist-narrow.two-silos.json").write_text(json.dumps(limits))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "femnist-narrow", "source": cfg["source"],
                             "file": "fedbench/configs/femnist-narrow.json",
                             "reduced": ["n_fc", "fc_width"], "why": "test"})
    bench["workloads"].append({"name": "femnist-narrow.two-silos", "config": "femnist-narrow",
                               "traffic": "two-silos", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "rounds_run", "unit": "rounds", "better": "higher",
                               "source": "host_clock", "layer": "server round",
                               "moves": "round_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    script = (
        "import json, sys\n"
        "from fedbench import harness\n"
        "assert harness.load_module('work', 'copy_rows').work(10)['bytes'] == 80.0\n"
        "r = harness.run('femnist-narrow.two-silos', 3, 0.2, True, 'cpu', log=lambda s: None)\n"
        "print(json.dumps(r))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), str(ROOT / "src")]))
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["metrics"]["rounds_run"]["value"] == result["attempted"]
    assert result["correct"] is True, result["checks"]
