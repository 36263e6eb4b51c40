"""A family whose trained leaves mix bfloat16 and float32 (as mamba2's
``A_log``, ``D`` and ``dt_bias`` and an MoE router do) is taken as files
alone: dropped into a copy of the benchmark with its configuration,
traffic, limits, plain reference and FLOPs, it runs through
``harness.run`` on the CPU with ``correct`` true, and a fold planted to
round its float32 leaves to bfloat16 reads ``fold`` above the dense
cells' limit and is not correct."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
DENSE_FOLD_LIMIT = 0.002   # the dense cells' ``fold`` limit

FAMILY = '''"""A two-layer classifier over Gaussian class blobs: bfloat16
projections, a float32 gain a hidden unit and a float32 bias a class."""
import math

import torch
import torch.nn.functional as F

from .silos import generator, make_weights, split_rows


def weight_spec(cfg, traffic):
    D, H, C = cfg["d_in"], cfg["d_hidden"], cfg["n_classes"]
    bf, f32 = torch.bfloat16, torch.float32
    return {"w_in": ((D, H), 1 / math.sqrt(D), bf), "gain": ((H,), 0.1, f32),
            "w_out": ((H, C), 1 / math.sqrt(H), bf), "bias": ((C,), 0.5, f32)}


def make_params(cfg, traffic, seed, device):
    p = make_weights(weight_spec(cfg, traffic), seed, device)
    p["gain"].add_(1.0)
    return p


def make_silos(cfg, traffic, seed, device):
    D, C = cfg["d_in"], cfg["n_classes"]
    rows = sum(a + b for a, b in traffic["silos"])
    g = generator(seed, 1, device)
    centers = torch.randn((C, D), generator=g, device=device)
    labels = torch.randint(0, C, (rows,), generator=g, device=device)
    x = centers[labels] + 0.5 * torch.randn((rows, D), generator=g, device=device)
    return split_rows(x, labels, traffic["silos"])


def logits(p, x):
    h = torch.tanh(x @ p["w_in"].float()) * p["gain"]
    return h @ p["w_out"].float() + p["bias"]


def program_fns(cfg, traffic):
    def loss_fn(p, b):
        return F.cross_entropy(logits(p, b[0]), b[1])

    def eval_fn(p, b):
        return {"loss_sum": loss_fn(p, b) * b[0].shape[0]}

    return loss_fn, eval_fn


def round_work(cfg, traffic):
    return {"samples": {"train": sum(n for n, _ in traffic["silos"]),
                        "eval": sum(n for _, n in traffic["silos"])}}
'''

REFERENCE = '''"""The mixed classifier in plain PyTorch, float32."""
import torch
import torch.nn.functional as F


def loss(params, batch, cfg, prec, lora=None):
    x, y = batch
    h = torch.tanh(prec.mm(x, params["w_in"])) * params["gain"]
    return F.cross_entropy(prec.mm(h, params["w_out"]) + params["bias"], y)
'''

FLOPS = '''def round_flops(cfg, traffic, n_params, n_trained):
    per = 2 * (cfg["d_in"] * cfg["d_hidden"] + cfg["d_hidden"] * cfg["n_classes"])
    silos = traffic["silos"]
    return float(per * (3 * sum(n for n, _ in silos) + sum(n for _, n in silos)))
'''

CONFIG = {"name": "mixed-mlp", "family": "mixed_mlp", "source": "https://arxiv.org/abs/2405.21060",
          "d_in": 48, "d_hidden": 512, "n_classes": 10, "param_dtype": "bfloat16",
          "compute_dtype": "float32", "reduced": {},
          "optimizer": {"name": "adamw", "lr": 0.001, "b1": 0.9, "b2": 0.95, "eps": 1e-08,
                        "weight_decay": 0.1, "state_dtype": "float32"}}

TRAFFIC = {
    "dense": {"server": "barrier", "update": "dense", "silos": [[64, 16], [96, 16]],
              "batch": 32, "local_epochs": 1, "measure_messages": True, "trace_rounds": 1},
    "int8": {"server": "async", "update": "int8", "silos": [[64, 16], [96, 16]],
             "batch": 32, "local_epochs": 1, "measure_messages": True, "trace_rounds": 1},
}

# The test cell's own limits: the training numbers loose (the program
# steps on bfloat16 gradients, the reference on float32 ones), the fold's
# the dense cells'.
LIMITS = {"step_loss": 1e-3, "grad1": 1e-2, "delta3": 2e-2, "delta": 2e-2, "eval_loss": 1e-3,
          "fold": DENSE_FOLD_LIMIT}

# Planted in the program: the fold's result with its float32 leaves
# rounded to bfloat16 (and kept in float32).
PLANT = '''
import torch
from repro_torch.federated import agg_engine
from repro_torch.utils.tree import tree_flatten, tree_unflatten

def rounded(fn):
    def wrapped(*a, **kw):
        leaves, treedef = tree_flatten(fn(*a, **kw))
        return tree_unflatten(treedef, [t.to(torch.bfloat16).float() if t.dtype == torch.float32
                                        else t for t in leaves])
    return wrapped

for cls, name in ((agg_engine.AggregationEngine, "aggregate"),
                  (agg_engine.StreamingAggregator, "result"),
                  (agg_engine.StructuredStreamingAggregator, "result")):
    setattr(cls, name, rounded(getattr(cls, name)))
'''


def drop_in(tmp_path: Path, update: str) -> str:
    """A copy of the benchmark with the mixed family's files added and
    BENCHMARK.json naming its cell; returns the cell's name."""
    shutil.copytree(ROOT / "fedbench", tmp_path / "fedbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    workload = f"mixed-mlp.{update}"
    files = {"families/mixed_mlp.py": FAMILY, "reference/mixed_mlp.py": REFERENCE,
             "flops/mixed_mlp.py": FLOPS, "configs/mixed-mlp.json": json.dumps(CONFIG),
             f"traffic/{update}.json": json.dumps(TRAFFIC[update]),
             f"limits/{workload}.json": json.dumps({"limits": LIMITS})}
    for rel, text in files.items():
        (tmp_path / "fedbench" / rel).write_text(text)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "mixed-mlp", "source": CONFIG["source"],
                             "file": "fedbench/configs/mixed-mlp.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": workload, "config": "mixed-mlp", "traffic": update,
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:    # a new cell reports every end-to-end metric
        m.get("workloads", []).append(workload)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return workload


def run_cell(tmp_path: Path, workload: str, plant: bool = False) -> dict:
    script = (PLANT if plant else "") + (
        "import json\n"
        "from fedbench import harness\n"
        f"r = harness.run({workload!r}, 5, 0.2, True, 'cpu', log=lambda s: None)\n"
        "print(json.dumps(r))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), str(ROOT / "src")]))
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("update", ["dense", "int8"])
def test_a_mixed_dtype_family_is_taken_as_files(update, tmp_path):
    workload = drop_in(tmp_path, update)
    result = run_cell(tmp_path, workload)
    assert result["correct"] is True, result["checks"]
    assert result["checks"]["fold"]["value"] <= DENSE_FOLD_LIMIT
    assert {"messages.span_s", "messages.serialized_gib"} <= set(result["metrics"])
    planted = run_cell(tmp_path, workload, plant=True)
    assert planted["checks"]["fold"]["value"] > DENSE_FOLD_LIMIT, planted["checks"]
    assert planted["correct"] is False
