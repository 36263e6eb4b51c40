"""The port's dry-run (``repro_torch/launch/dryrun.py``) against the
reference's ``repro/launch/dryrun.py``.

Importing the reference's dry-run forces 512 host devices, so its side
runs once, in one child process with ``JAX_PLATFORMS=cpu``
(``reference``): parameter and active counts of the ten architectures,
the skip set and resolved configs, the probe depths, and
``extrapolated_costs`` over a stubbed ``_costs_of`` (the same stub source
in both processes, so the arithmetic is compared exactly).

On the port's side: the extrapolation against a direct count of the
full-depth step at reduced sizes for every family (relative 1e-9), the
FLOP count against ``FlopCounterMode``'s, the
``meta`` route through the three kernel wrappers, per-chip memory and
collective bytes on a hand-made tree, and ``main`` writing rows in the
reference's schema that ``benchmarks/roofline_bench.py`` reads.
"""
import ast
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCHITECTURES, INPUT_SHAPES, InputShape, get_config
from repro_torch.launch import dryrun
from repro_torch.models import get_model
from repro_torch.sharding.rules import P

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
ARCHS = sorted(ARCHITECTURES)

# extrapolated_costs' probes, replaced in both packages by one function of
# the probe's depth and local steps (not linear, so that any difference in
# the arithmetic shows).
STUB = '''
def stub_costs(cfg, shape_name, multi_pod, local_steps):
    L, T = cfg.n_layers, local_steps
    kinds = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
    return {
        "flops": 1.0e12 * (1.5 + 2.25 * L + 0.125 * L * L * T + 3.0 * T) + 7.0 * len(shape_name),
        "bytes": 3.0e9 * (0.5 + 1.75 * L * T) + (11.0 if multi_pod else 0.0),
        "coll_bytes": 2.0e8 * (4.0 + L + 0.5 * T) - 1.0e10,
        "counts": {k: (i + 1) * L + 3 * T - 7 for i, k in enumerate(kinds)},
    }
'''

REFERENCE = STUB + '''
import dataclasses, json, sys
from repro.launch import dryrun as ref
from repro.configs import ARCHITECTURES, INPUT_SHAPES, get_config
from repro.models import get_model

out = {"params": {}, "resolved": {}, "probes": {}, "extrapolated": {}}
ref._costs_of = stub_costs
for arch in sorted(ARCHITECTURES):
    cfg = get_config(arch)
    abs_params = ref._abstract_params(get_model(cfg))
    out["params"][arch] = [ref._count_params(abs_params), ref._active_params(cfg, abs_params)]
    out["probes"][arch] = list(ref._probe_depths(cfg))
    for shape in INPUT_SHAPES:
        key = arch + "|" + shape
        try:
            rcfg = ref.resolved_config(arch, shape)
        except ref.SkipShape:
            out["resolved"][key] = None
            continue
        out["resolved"][key] = {f.name: getattr(rcfg, f.name) for f in dataclasses.fields(rcfg)}
        for multi_pod in (False, True):
            out["extrapolated"][key + "|" + str(multi_pod)] = ref.extrapolated_costs(
                rcfg, shape, multi_pod)
json.dump(out, open(sys.argv[1], "w"))
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun_ref") / "ref.json"
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REFERENCE, str(path)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(path.read_text())


def _stub():
    ns: dict = {}
    exec(STUB, ns)
    return ns["stub_costs"]


def _jsonable(x):
    return json.loads(json.dumps(x))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_reference(arch, reference):
    cfg = get_config(arch)
    abs_params = dryrun._abstract_params(get_model(cfg))
    assert all(t.device.type == "meta" for t in dryrun.tree_leaves(abs_params))
    got = [dryrun._count_params(abs_params), dryrun._active_params(cfg, abs_params)]
    assert got == reference["params"][arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_resolved_config_and_skips_match_reference(arch, reference):
    for shape in INPUT_SHAPES:
        want = reference["resolved"][f"{arch}|{shape}"]
        if want is None:
            with pytest.raises(dryrun.SkipShape):
                dryrun.resolved_config(arch, shape)
            continue
        cfg = dryrun.resolved_config(arch, shape)
        got = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
        assert _jsonable(got) == want, shape


@pytest.mark.parametrize("arch", ARCHS)
def test_probe_depths_match_reference(arch, reference):
    assert list(dryrun._probe_depths(get_config(arch))) == reference["probes"][arch]


@pytest.mark.parametrize("multi_pod", [False, True], ids=["linear", "bilinear"])
def test_extrapolated_costs_match_reference(multi_pod, reference, monkeypatch):
    """The reference's arithmetic on the same stubbed probes: F(L) = a + b*L,
    and for the multi-pod train step F(L, T) bilinear over four probes."""
    monkeypatch.setattr(dryrun, "_costs_of", _stub())
    n = 0
    for arch in ARCHS:
        for shape in INPUT_SHAPES:
            try:
                cfg = dryrun.resolved_config(arch, shape)
            except dryrun.SkipShape:
                continue
            want = reference["extrapolated"][f"{arch}|{shape}|{multi_pod}"]
            assert _jsonable(dryrun.extrapolated_costs(cfg, shape, multi_pod)) == want, \
                (arch, shape)
            n += 1
    assert n == 39


# ---------------------------------------------------------------------------
# Extrapolation against a direct count, at reduced sizes
# ---------------------------------------------------------------------------

# One reduced config a family, deep enough that the full depth lies past
# both probes (hybrid: superblocks of 2; MoE: one leading dense layer).
# The MoE stack is 5 layers, not 4: the sharding rules take a leaf with
# n_experts (4 when reduced) among its leading dims for an expert tensor,
# so 4 stacked layers would shard the shared experts as experts, which
# no probe does.
FAMILIES = {
    "dense": ("olmo-1b", {"n_layers": 4}),
    "vlm": ("internvl2-2b", {"n_layers": 4}),
    "moe": ("deepseek-moe-16b", {"n_layers": 6}),
    "ssm": ("mamba2-130m", {"n_layers": 4}),
    "encdec": ("whisper-small", {"n_layers": 4, "n_encoder_layers": 4}),
    "hybrid": ("jamba-1.5-large-398b", {"n_layers": 6}),
}
TINY = {
    "train": InputShape("tiny_train", 32, 2, "train"),
    "prefill": InputShape("tiny_prefill", 32, 2, "prefill"),
    "decode": InputShape("tiny_decode", 32, 2, "decode"),
}


def _close(got, want, rel=1e-9):
    assert got == pytest.approx(want, rel=rel), (got, want)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_extrapolation_equals_direct_count_reduced(family):
    arch, depth = FAMILIES[family]
    cfg = get_config(arch).reduced().with_overrides(**depth)
    L1, L2 = dryrun._probe_depths(cfg)
    assert L2 < cfg.n_layers
    for kind, shape in TINY.items():
        got = dryrun.extrapolated_costs(cfg, shape, False)
        want = dryrun._costs_of(dryrun._probe_cfg(cfg, cfg.n_layers), shape, False,
                                dryrun.LOCAL_STEPS)
        for key in ("flops", "bytes", "coll_bytes"):
            assert want[key] > 0, (kind, key)
            _close(got[key], want[key])
        assert got["counts"] == want["counts"], kind


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_flops_equal_flop_counter_mode(family):
    """The step's FLOPs as ``count_step`` counts them equal
    ``FlopCounterMode``'s total for the same meta train step (forward and
    backward)."""
    from torch.utils.flop_counter import FlopCounterMode

    arch, depth = FAMILIES[family]
    cfg = dryrun._probe_cfg(get_config(arch).reduced().with_overrides(**depth), depth["n_layers"])
    flops, _ = dryrun.count_step(*dryrun.build_step(cfg, TINY["train"], False)[:2])
    step, args, _ = dryrun.build_step(cfg, TINY["train"], False)
    with FlopCounterMode(display=False) as mode:
        step(*args)
    assert flops == mode.get_total_flops() > 0


def test_bilinear_extrapolation_equals_direct_round():
    """The multi-pod round's four probes over (depth, local steps) against
    a direct count of 2 pods x LOCAL_STEPS steps at full (reduced) depth
    (``chip_smoke.py`` holds mamba2-130m's and olmo-1b's full-size rounds so)."""
    cfg = get_config("olmo-1b").reduced().with_overrides(n_layers=3)
    got = dryrun.extrapolated_costs(cfg, TINY["train"], True)
    want = dryrun._costs_of(dryrun._probe_cfg(cfg, 3), TINY["train"], True, dryrun.LOCAL_STEPS)
    for key in ("flops", "bytes", "coll_bytes"):
        _close(got[key], want[key])


def test_flops_are_linear_in_depth_at_full_width():
    """olmo-1b's prefill_32k per layer: the dense projections plus the plain
    attention's full square (4 * 32 * 32768^2 * 2048 per layer)."""
    cfg = get_config("olmo-1b")
    c1, c2 = (dryrun._costs_of(dryrun._probe_cfg(cfg, d), "prefill_32k", False, 4) for d in (1, 2))
    tokens, d = 32 * 32768, cfg.d_model
    per_layer = 2 * tokens * (4 * d * d + 3 * d * cfg.d_ff) + 4 * 32 * 32768 ** 2 * d
    assert (c2["flops"] - c1["flops"]) * 256 == per_layer


# ---------------------------------------------------------------------------
# The meta route through the kernel wrappers
# ---------------------------------------------------------------------------

class _Elsewhere(torch.Tensor):
    """A CPU tensor that reports a device that is none of cuda, cpu, meta."""

    @property
    def device(self):
        return torch.device("xpu")


def _wrapper_cases(device):
    import repro_torch.kernels  # noqa: F401 (the package re-exports the functions)
    fa = sys.modules["repro_torch.kernels.flash_attention"]
    ssd = sys.modules["repro_torch.kernels.ssd_scan"]
    fr = sys.modules["repro_torch.kernels.fedavg_reduce"]
    gen = torch.Generator().manual_seed(0)

    def t(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen).to(dtype).to(device)

    q, k, v = t(2, 40, 4, 64, dtype=torch.bfloat16), t(2, 40, 2, 64, dtype=torch.bfloat16), \
        t(2, 40, 2, 64, dtype=torch.bfloat16)
    x, dt, A = t(2, 64, 3, 16), t(2, 64, 3), t(3)
    Bm, Cm = t(2, 64, 8), t(2, 64, 8)
    stacked, w = t(3, 100, dtype=torch.bfloat16), t(3).abs() + 1
    return [
        (fa.flash_attention, fa.flash_attention_plain, (q, k, v), {"causal": True, "window": 16}),
        (ssd.ssd_chunk_scan, ssd.ssd_chunk_scan_plain, (x, dt, A, Bm, Cm), {"chunk": 32}),
        (fr.fedavg_reduce, fr.fedavg_reduce_plain, (stacked, w), {}),
    ]


def _outs(y):
    return y if isinstance(y, tuple) else (y,)


@pytest.mark.parametrize("i", [0, 1, 2], ids=["flash_attention", "ssd_chunk_scan",
                                              "fedavg_reduce"])
def test_meta_route_gives_plain_shapes_and_launches_nothing(i):
    wrapper, plain, args, kw = _wrapper_cases("cpu")[i]
    want = _outs(plain(*args, **kw))
    meta_args = tuple(a.to("meta") for a in args)
    before = wrapper.launches
    got = _outs(wrapper(*meta_args, **kw))
    assert wrapper.launches == before
    assert [(g.device.type, tuple(g.shape), g.dtype) for g in got] == \
        [("meta", tuple(w_.shape), w_.dtype) for w_ in want]
    # The gradient of a meta call goes through the plain version too.
    leaves = tuple(a.detach().requires_grad_(True) for a in meta_args)
    sum(o.float().sum() for o in _outs(wrapper(*leaves, **kw))).backward()
    assert all(a.grad is not None and a.grad.shape == a.shape for a in leaves)
    assert wrapper.launches == before
    # Its checks run first: a bad input on meta raises as on the CPU.
    with pytest.raises((ValueError, TypeError)):
        wrapper(*meta_args[:-1], meta_args[-1][..., :1], **kw)


@pytest.mark.parametrize("i", [0, 1, 2], ids=["flash_attention", "ssd_chunk_scan",
                                              "fedavg_reduce"])
def test_other_devices_still_raise(i):
    wrapper, _, args, kw = _wrapper_cases("cpu")[i]
    elsewhere = tuple(torch.Tensor._make_subclass(_Elsewhere, a) for a in args)
    with pytest.raises(ValueError, match="runs on cuda, cpu or meta, not xpu"):
        wrapper(*elsewhere, **kw)


# ---------------------------------------------------------------------------
# Per-chip memory and collectives from the specs
# ---------------------------------------------------------------------------

class _Mesh:
    def __init__(self, **sizes):
        self.shape = sizes


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_per_chip_memory_and_collectives_single_pod():
    """data 2 x model 4; an FSDP embedding, a stacked row-parallel wo, a
    replicated norm scale; a (4, 8) train batch sharded over data."""
    cfg = get_config("olmo-1b").reduced()
    assert cfg.activation_dtype == torch.bfloat16
    mesh = _Mesh(data=2, model=4)
    params = {"embed": {"embedding": _meta((128, 16), torch.bfloat16)},
              "layers": {"attn": {"wo": _meta((3, 32, 16), torch.bfloat16)},
                         "norm": {"scale": _meta((3, 16), torch.float32)}}}
    specs = {"embed": {"embedding": P("model", "data")},
             "layers": {"attn": {"wo": P(None, "model", None)},
                        "norm": {"scale": P(None, None)}}}
    assert dryrun.per_chip_bytes(specs, params, mesh) == 4096 / 8 + 3072 / 4 + 192
    shape = InputShape("t", 8, 4, "train")
    c = dryrun.collective_costs(cfg, shape, False, 4, params, specs, P("data", None), mesh)
    # gather: 2 passes x 4096 / 4; wo's output all-reduce: 2 passes x 2 (ring) x
    # 3 layers x 16 tokens x 16 features x 2 B; gradients: wo 2 x 768, scale 2 x 192,
    # the embedding's reduce-scatter 512.
    assert c.bytes_by_kind == {"all-gather": 2048, "all-reduce": 6144 + 1536 + 384,
                               "reduce-scatter": 512, "all-to-all": 0,
                               "collective-permute": 0}
    assert c.counts == {"all-gather": 2, "all-reduce": 6 + 3 + 3, "reduce-scatter": 1,
                        "all-to-all": 0, "collective-permute": 0}
    # inference: one pass, no gradients
    prefill = dryrun.collective_costs(cfg, InputShape("p", 8, 4, "prefill"), False, 4, params,
                                      specs, P("data", None), mesh)
    assert prefill.bytes_by_kind["all-gather"] == 1024
    assert prefill.bytes_by_kind["all-reduce"] == 3072
    assert prefill.bytes_by_kind["reduce-scatter"] == 0


def test_per_chip_memory_and_collectives_multi_pod():
    """The same tree stacked over 2 pods, 3 local steps, batch over (pod,
    data): the FedAvg all-reduces every parameter shard once a round."""
    cfg = get_config("olmo-1b").reduced()
    mesh = _Mesh(pod=2, data=2, model=4)
    params = {"embed": {"embedding": _meta((2, 128, 16), torch.bfloat16)},
              "layers": {"attn": {"wo": _meta((2, 3, 32, 16), torch.bfloat16)},
                         "norm": {"scale": _meta((2, 3, 16), torch.float32)}}}
    specs = {"embed": {"embedding": P("pod", "model", "data")},
             "layers": {"attn": {"wo": P("pod", None, "model", None)},
                        "norm": {"scale": P("pod", None, None)}}}
    assert dryrun.per_chip_bytes(specs, params, mesh) == 512 + 768 + 192
    shape = InputShape("t", 8, 4, "train")
    c = dryrun.collective_costs(cfg, shape, True, 3, params, specs,
                                P("pod", None, "data", None), mesh)
    fedavg = 2 * (512 + 768 + 192)
    assert c.bytes_by_kind == {"all-gather": 6144, "all-reduce": 9216 + 4608 + 1152 + fedavg,
                               "reduce-scatter": 1536, "all-to-all": 0,
                               "collective-permute": 0}
    assert c.counts == {"all-gather": 6, "all-reduce": 18 + 9 + 9 + 1, "reduce-scatter": 3,
                        "all-to-all": 0, "collective-permute": 0}


# ---------------------------------------------------------------------------
# main: rows, skips, the roofline table
# ---------------------------------------------------------------------------

def _reference_row_keys():
    """``RooflineReport.to_row()``'s keys and those ``run_dryrun`` adds,
    read from the reference's source."""
    from repro.roofline.analysis import RooflineReport
    keys = set(RooflineReport(*(["x"] * 3), 1, *([0.0] * 6), "compute").to_row())
    tree = ast.parse((SRC / "repro" / "launch" / "dryrun.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "update" and getattr(node.func.value, "id", "") == "row"):
            keys |= {kw.arg for kw in node.keywords}
    assert {"fits", "collective_counts", "lower_s", "n_params_active"} <= keys
    return keys


def test_main_writes_a_row_in_the_reference_schema(tmp_path, capsys):
    out = tmp_path / "rows.jsonl"
    assert dryrun.main(["--arch", "mamba2-130m", "--shape", "decode_32k",
                        "--json", str(out)]) == 0
    (row,) = [json.loads(line) for line in out.read_text().splitlines()]
    assert set(row) == _reference_row_keys() | {"peak_memory_counts"}
    assert row["peak_memory_counts"] == "params+cache+inputs"
    assert (row["mesh"], row["chips"], row["kind"]) == ("16x16", 256, "decode")
    assert row["n_params"] == 128_983_488 and row["n_tokens"] == 128
    assert row["fits"] is True and 0 < row["peak_memory_per_chip"] < 80e9
    for key in ("hlo_flops", "hlo_bytes", "collective_bytes", "compute_s", "memory_s",
                "collective_s", "model_flops"):
        assert row[key] > 0, key
    assert row["compute_s"] == row["hlo_flops"] / 989e12
    assert row["collective_s"] == row["collective_bytes"] / 450e9
    assert "== mamba2-130m x decode_32k [16x16] ==" in capsys.readouterr().out


def test_skip_and_no_cuda_or_process_group(capsys):
    assert dryrun.main(["--arch", "whisper-small", "--shape", "long_500k"]) == 0
    assert "SKIP whisper-small x long_500k" in capsys.readouterr().out
    assert not torch.cuda.is_initialized()
    assert not torch.distributed.is_initialized()


def test_roofline_bench_reads_the_ports_rows(tmp_path, monkeypatch, capsys):
    spec = importlib.util.spec_from_file_location(
        "roofline_bench", ROOT / "benchmarks" / "roofline_bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "results").mkdir()
    assert dryrun.main(["--arch", "olmo-1b", "--shape", "long_500k",
                        "--json", "results/dryrun_single_pod.jsonl"]) == 0
    assert dryrun.main(["--arch", "mamba2-130m", "--shape", "decode_32k", "--multi-pod",
                        "--json", "results/dryrun_multi_pod.jsonl"]) == 0
    capsys.readouterr()
    rows = bench.bench_roofline_table()
    assert [r[0] for r in rows] == ["roofline_olmo-1b_long_500k_16x16",
                                    "roofline_mamba2-130m_decode_32k_2x16x16"]
    assert all("fits=True" in r[2] for r in rows)
    assert "[roofline] olmo-1b" in capsys.readouterr().err
