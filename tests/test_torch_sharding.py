"""The port's sharding rules, input specs, meshes, compute-mesh context and
``batch_iterator`` against the reference's.

Specs are compared as tuples (the port's ``PartitionSpec`` is a tuple; so
is ``jax.sharding.PartitionSpec``), leaf for leaf in the trees' shared
sorted-key order, at full size: the port's parameters and caches are
abstract on the ``meta`` device, the reference's come from
``jax.eval_shape``.  The rules read only axis sizes, so a shape-only
``FakeMesh`` stands in for the production meshes, as in the reference's
``tests/test_sharding.py``.  Placement runs on real ``DeviceMesh``es: a
gloo group of one in this process and two spawned gloo ranks
(``tests/_torch_pod_worker.py``, which imports no JAX).  The MoE layer's
group count under a ``data=2`` compute mesh is held against the
reference run in a subprocess with two forced host devices, within 1e-5
relative L2.
"""
import functools
import multiprocessing as mp
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_config
from repro.configs import long_context_config as jax_long_context_config
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.data.pipeline import batch_iterator as jax_batch_iterator
from repro.launch import specs as jax_specs
from repro.launch.steps import make_optimizer_for as jax_optimizer_for
from repro.models import get_model as jax_model
from repro.sharding import context as jax_context
from repro.sharding import rules as jax_rules
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.configs.registry import ARCHITECTURES, long_context_config, shape_supported
from repro_torch.data import SyntheticLM, batch_iterator
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh, production_mesh_shape
from repro_torch.launch.steps import make_optimizer_for, with_compute_mesh
from repro_torch.models import get_model
from repro_torch.models.moe import apply_moe, init_moe
from repro_torch.sharding import (
    PartitionSpec as P,
    axis_sizes,
    batch_specs,
    cache_specs,
    compute_mesh,
    compute_specs,
    current_compute_mesh,
    decode_token_spec,
    distribute,
    param_specs,
    to_named,
)
from repro_torch.utils.tree import tree_flatten_with_path, tree_leaves, tree_map, tree_structure, tree_unflatten

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_pod_worker import mesh_rank  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = sorted(ARCHITECTURES)


class FakeMesh:
    """Shape-only stand-in (the rules only read axis sizes)."""

    def __init__(self, **axes):
        self.shape = dict(axes)


MESH = FakeMesh(data=16, model=16)
MESH_POD = FakeMesh(pod=2, data=16, model=16)


@functools.lru_cache(maxsize=None)
def _abstract(arch):
    """(port cfg, port meta params, reference cfg, reference abstract params)."""
    tc, jc = get_config(arch), jax_config(arch)
    tp = specs.abstract_params(get_model(tc))
    jp = jax.eval_shape(lambda: jax_model(jc).init(jax.random.PRNGKey(0)))
    return tc, tp, jc, jp


def _stacked(tp, jp, n=2):
    return (tree_map(lambda x: torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device="meta"), tp),
            jax.tree.map(lambda s: jax.ShapeDtypeStruct((n,) + s.shape, s.dtype), jp))


def _jspecs(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _tspecs(tree):
    out = []

    def walk(t):
        if isinstance(t, P):
            out.append(t)
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for x in t:
                walk(x)

    walk(tree)
    return out


def _same_specs(got, want):
    g, w = _tspecs(got), _jspecs(want)
    assert len(g) == len(w) > 0
    for a, b in zip(g, w):
        assert isinstance(a, P)
        assert tuple(a) == tuple(b), (a, b)


# ---------------------------------------------------------------------------
# Parameters, optimizer state, batches, caches, inputs: equal to the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pod", [False, True], ids=["single", "pod"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, pod):
    tc, tp, jc, jp = _abstract(arch)
    if pod:
        tp, jp = _stacked(tp, jp)
    mesh = MESH_POD if pod else MESH
    _same_specs(param_specs(tp, tc, mesh, pod_axis=pod), jax_rules.param_specs(jp, jc, mesh, pod_axis=pod))


@pytest.mark.parametrize("arch", ARCHS)
def test_compute_specs_match_reference(arch):
    tc, tp, jc, jp = _abstract(arch)
    _same_specs(compute_specs(tp, tc, MESH), jax_rules.compute_specs(jp, jc, MESH))


@pytest.mark.parametrize("arch", ["olmo-1b", "jamba-1.5-large-398b", "deepseek-moe-16b"])
def test_adamw_state_specs_match_reference(arch):
    """An AdamW state's ``m`` and ``v`` leaf for leaf (their paths read
    ``.m/...`` in both packages); the port's ``step`` is an ``int`` with no
    placement.  jamba's config sets ``fsdp``."""
    tc, tp, jc, jp = _abstract(arch)
    topt, jopt = make_optimizer_for(tc), jax_optimizer_for(jc)
    tstate = topt.init(tp)
    jstate = jax.eval_shape(jopt.init, jp)
    got, want = param_specs(tstate, tc, MESH), jax_rules.param_specs(jstate, jc, MESH)
    _same_specs(got.m, want.m)
    _same_specs(got.v, want.v)
    assert got.step == 0 and tuple(want.step) == ()
    if arch == "jamba-1.5-large-398b":
        assert tc.fsdp and any("data" in tuple(s) for s in _tspecs(got.m))


@pytest.mark.parametrize("shape", sorted(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_input_specs_match_reference(arch, shape):
    tc, jc = get_config(arch), jax_config(arch)
    ts, js = INPUT_SHAPES[shape], JAX_SHAPES[shape]
    for pod in (False, True):
        _same_specs(batch_specs(tc, ts, pod_axis=pod), jax_rules.batch_specs(jc, js, pod_axis=pod))
        for name, kw in (("train_input_specs", dict(n_pods=2, local_steps=4)),
                         ("prefill_input_specs", {}), ("decode_input_specs", {})):
            got, got_specs = getattr(specs, name)(tc, ts, pod_axis=pod, **(kw if pod else {}))
            want, want_specs = getattr(jax_specs, name)(jc, js, pod_axis=pod, **(kw if pod else {}))
            assert list(got) == list(want) and list(got_specs) == list(want_specs)
            for k in want:
                assert got[k].device.type == "meta"
                assert tuple(got[k].shape) == want[k].shape, (name, k)
                assert str(got[k].dtype).removeprefix("torch.") == want[k].dtype.name, (name, k)
                assert tuple(got_specs[k]) == tuple(want_specs[k]), (name, k)


def _cache_cases():
    out = []
    for arch in ARCHS:
        for shape in ("decode_32k", "long_500k"):
            if shape_supported(get_config(arch), INPUT_SHAPES[shape]):
                out.append((arch, shape))
    return out


@pytest.mark.parametrize("arch,shape", _cache_cases())
def test_cache_specs_match_reference(arch, shape):
    """``cache_specs`` and ``decode_cache_specs`` (with and without the pod
    axis) over the full-size cache, long_500k through
    ``long_context_config``."""
    tc, jc = get_config(arch), jax_config(arch)
    if shape == "long_500k":
        tc, jc = long_context_config(tc), jax_long_context_config(jc)
    ts, js = INPUT_SHAPES[shape], JAX_SHAPES[shape]
    tcache = specs.abstract_cache(get_model(tc), tc, ts)
    jcache = jax_specs.abstract_cache(jax_model(jc), jc, js)
    assert all(t.device.type == "meta" for t in tcache.values())
    assert [tuple(t.shape) for t in tree_leaves(tcache)] == [s.shape for s in jax.tree.leaves(jcache)]
    _same_specs(cache_specs(tc, ts, tcache), jax_rules.cache_specs(jc, js, jcache))
    for pod in (False, True):
        _same_specs(specs.decode_cache_specs(tc, ts, tcache, pod_axis=pod),
                    jax_specs.decode_cache_specs(jc, js, jcache, pod_axis=pod))


@pytest.mark.parametrize("shape", sorted(INPUT_SHAPES))
def test_decode_token_spec_matches_reference(shape):
    assert tuple(decode_token_spec(INPUT_SHAPES[shape])) == tuple(
        jax_rules.decode_token_spec(JAX_SHAPES[shape]))


# ---------------------------------------------------------------------------
# The reference's structural tests (tests/test_sharding.py), on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-moe-16b", "mamba2-130m",
                                  "jamba-1.5-large-398b", "whisper-small"])
def test_sharded_dims_divisible(arch):
    tc, tp, _, _ = _abstract(arch)
    sizes = {"data": 16, "model": 16}
    for leaf, spec in zip(tree_leaves(tp), _tspecs(param_specs(tp, tc, MESH))):
        for dim, axis in zip(leaf.shape, tuple(spec)):
            if axis is None:
                continue
            total = 1
            for a in (axis if isinstance(axis, tuple) else (axis,)):
                total *= sizes[a]
            assert dim % total == 0, f"{arch}: {tuple(leaf.shape)} vs {spec}"


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "jamba-1.5-large-398b"])
def test_stacked_layer_axis_never_sharded(arch):
    tc, tp, _, _ = _abstract(arch)
    pairs = tree_flatten_with_path(tp)[0]
    for (path, _), spec in zip(pairs, _tspecs(param_specs(tp, tc, MESH))):
        names = "/".join(map(str, path))
        if any(k in names for k in ("layers", "superblocks")):
            assert spec[0] is None, f"{names}: layer axis sharded {spec}"


def test_expert_tensors_expert_parallel():
    tc, tp, _, _ = _abstract("deepseek-moe-16b")
    found = []
    pairs = tree_flatten_with_path(tp)[0]
    for (path, leaf), spec in zip(pairs, _tspecs(param_specs(tp, tc, MESH))):
        names = "/".join(map(str, path))
        if "moe" in names and leaf.dim() == 4 and leaf.shape[1] == tc.n_experts:
            assert spec[1] == "model", f"{names}: {spec}"
            found.append(names)
    assert found, "no routed expert tensors found"


def test_no_fsdp_means_no_data_axis_on_dense_weights():
    tc, tp, _, _ = _abstract("internlm2-1.8b")
    assert not tc.fsdp
    for spec in _tspecs(param_specs(tp, tc, MESH)):
        assert "data" not in tuple(spec), spec


def test_fsdp_shards_weights_over_data_at_rest():
    tc, tp, _, _ = _abstract("jamba-1.5-large-398b")
    assert tc.fsdp
    assert any("data" in tuple(s) for s in _tspecs(param_specs(tp, tc, MESH)))
    for spec in _tspecs(compute_specs(tp, tc, MESH)):
        assert "data" not in tuple(spec), spec


def test_pod_axis_prepended():
    tc, tp, _, jp = _abstract("internlm2-1.8b")
    stacked, _ = _stacked(tp, jp)
    for spec in _tspecs(param_specs(stacked, tc, MESH_POD, pod_axis=True)):
        assert spec[0] == "pod", spec


def test_batch_specs_by_arch():
    shape = INPUT_SHAPES["train_4k"]
    bs = batch_specs(get_config("internvl2-2b"), shape)
    assert bs["tokens"] == P("data", None)
    assert bs["patch_embeds"] == P("data", None, None)
    assert "frames" in batch_specs(get_config("whisper-small"), shape)


def test_cache_specs_decode_vs_long():
    cfg = get_config("internlm2-1.8b")
    model = get_model(cfg)
    specs32 = cache_specs(cfg, INPUT_SHAPES["decode_32k"], model.init_cache(128, 1024, device="meta"))
    assert specs32["k"] == P(None, "data", None, None, "model")
    specs500 = cache_specs(cfg, INPUT_SHAPES["long_500k"], model.init_cache(1, 1024, device="meta"))
    assert specs500["k"] == P(None, None, "data", None, "model")


def test_ssm_cache_specs():
    cfg = get_config("mamba2-130m")
    cache = get_model(cfg).init_cache(128, 1024, device="meta")
    got = cache_specs(cfg, INPUT_SHAPES["decode_32k"], cache)
    assert got["ssm"] == P(None, "data", None, "model", None)
    assert got["conv"] == P(None, "data", None, "model")


# ---------------------------------------------------------------------------
# Meshes, placement and the compute-mesh context
# ---------------------------------------------------------------------------

@pytest.fixture
def gloo_one(tmp_path):
    """A gloo process group of one process, destroyed after the test."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_host_meshes_on_a_group_of_one(gloo_one):
    mesh = make_host_mesh(device_type="cpu")
    assert mesh.mesh_dim_names == ("data", "model") and axis_sizes(mesh) == {"data": 1, "model": 1}
    pod = make_host_mesh(pod=1, device_type="cpu")
    assert axis_sizes(pod) == {"pod": 1, "data": 1, "model": 1}
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_host_mesh(data=2, device_type="cpu")
    with pytest.raises(ValueError, match="needs 256 ranks"):
        make_production_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="needs 512 ranks"):
        make_production_mesh(multi_pod=True, device_type="cpu")


def test_meshes_need_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_host_mesh(device_type="cpu")


def test_production_mesh_shape():
    assert production_mesh_shape() == {"data": 16, "model": 16}
    assert production_mesh_shape(multi_pod=True) == {"pod": 2, "data": 16, "model": 16}
    assert axis_sizes(FakeMesh(**production_mesh_shape(True))) == MESH_POD.shape


def test_distribute_on_a_group_of_one_keeps_every_leaf(gloo_one):
    """Reduced olmo-1b placed by ``param_specs`` on a (1, 1) mesh: every
    local shard is the whole leaf, bit for bit."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    cfg = get_config("olmo-1b").reduced()
    params = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    mesh = make_host_mesh(device_type="cpu")
    sp = param_specs(params, cfg, mesh)
    placed = distribute(params, mesh, sp)
    for leaf, d, spec in zip(tree_leaves(params), tree_leaves(placed), _tspecs(sp)):
        assert isinstance(d, DTensor)
        assert torch.equal(d.to_local(), leaf)
        assert list(d.placements) == [Shard(spec.index(a)) if a in tuple(spec) else Replicate()
                                      for a in ("data", "model")]
    assert tree_structure(placed) == tree_structure(params)


def test_to_named_multi_axis_entries_follow_mesh_order(gloo_one):
    from torch.distributed.tensor import Replicate, Shard

    mesh = make_host_mesh(pod=1, device_type="cpu")
    assert to_named(mesh, {"t": P(("pod", "data"), None, "model")})["t"] == (Shard(0), Shard(0), Shard(2))
    assert to_named(mesh, P(None)) == (Replicate(), Replicate(), Replicate())
    with pytest.raises(ValueError, match="mesh order"):
        to_named(mesh, P(("data", "pod")))
    with pytest.raises(ValueError, match="two tensor dims"):
        to_named(mesh, P("data", "data"))
    with pytest.raises(ValueError, match="names mesh axis 'expert'"):
        to_named(mesh, P("expert"))


def test_two_rank_gloo_mesh_places_each_rank_its_slice(tmp_path):
    """Two spawned gloo ranks on a ``data=2`` mesh (60 s limit of their
    own): each rank's local shard is the slice its spec names,
    ``full_tensor()`` gives the whole tensor back bit for bit, and a spec
    naming an axis the mesh lacks raises."""
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(2)]
    procs = [mp.get_context("spawn").Process(target=mesh_rank,
                                             args=(r, 2, str(tmp_path / "pg"), outs[r]))
             for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 60.0
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        assert not any(p.is_alive() for p in procs), "the mesh did not finish in 60 s"
        assert [p.exitcode for p in procs] == [0, 0]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    a, b, c = torch.arange(24.0).reshape(4, 6), torch.arange(12.0).reshape(2, 6), torch.arange(8.0)
    for r, out in enumerate(outs):
        got = torch.load(out)
        assert got["placements"] == {"a": [("shard", 0), ("shard", 1)],
                                     "b": [("shard", 1), ("replicate",)],
                                     "c": [("replicate",), ("replicate",)]}
        assert torch.equal(got["local"]["a"], a[2 * r:2 * r + 2])
        assert torch.equal(got["local"]["b"], b[:, 3 * r:3 * r + 3])
        assert torch.equal(got["local"]["c"], c)
        for k, want in (("a", a), ("b", b), ("c", c)):
            assert torch.equal(got["full"][k], want)
        assert got["missing_axis_raised"]


def test_compute_mesh_context_nests_and_restores():
    outer, inner = FakeMesh(data=2, model=1), FakeMesh(data=4, model=1)
    assert current_compute_mesh() is None
    with compute_mesh(outer):
        assert current_compute_mesh() is outer
        with compute_mesh(inner):
            assert current_compute_mesh() is inner
        assert current_compute_mesh() is outer
        with pytest.raises(KeyError):
            with compute_mesh(None):
                assert current_compute_mesh() is None
                raise KeyError("restored on the way out")
        assert current_compute_mesh() is outer
    assert current_compute_mesh() is None
    seen = with_compute_mesh(lambda x: (x, current_compute_mesh()), inner)(3)
    assert seen == (3, inner) and current_compute_mesh() is None
    # the reference's context behaves the same way
    with jax_context.compute_mesh(outer):
        assert jax_context.current_compute_mesh() is outer
    assert jax_context.current_compute_mesh() is None


# ---------------------------------------------------------------------------
# batch_iterator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [None, "float32", "bfloat16"])
def test_batch_iterator_is_byte_equal_to_reference(extra):
    jex = tex = None
    if extra == "float32":
        jex, tex = {"patch_embeds": ((3, 4), np.float32)}, {"patch_embeds": ((3, 4), np.float32)}
    elif extra == "bfloat16":
        jex = {"frames": ((5, 2), jnp.bfloat16), "x": ((2,), np.float32)}
        tex = {"frames": ((5, 2), torch.bfloat16), "x": ((2,), np.float32)}
    jit = jax_batch_iterator(JaxSyntheticLM(97, 12, seed=3), 4, seed=7, extra=jex)
    tit = batch_iterator(SyntheticLM(97, 12, seed=3), 4, seed=7, extra=tex, device="cpu")
    for _ in range(3):
        jb, tb = next(jit), next(tit)
        assert list(tb) == list(jb)
        for k in jb:
            want, got = np.asarray(jb[k]), tb[k]
            assert got.device.type == "cpu" and tuple(got.shape) == want.shape
            if got.dtype == torch.bfloat16:
                assert np.array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
            else:
                assert got.numpy().tobytes() == want.tobytes()


def test_batch_iterator_yields_dtensors_on_a_mesh(gloo_one):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = make_host_mesh(device_type="cpu")
    it = batch_iterator(SyntheticLM(50, 8), 2, seed=1, mesh=mesh)
    plain = batch_iterator(SyntheticLM(50, 8), 2, seed=1, device="cpu")
    for _ in range(2):
        b, want = next(it), next(plain)
        for k in ("tokens", "labels"):
            assert isinstance(b[k], DTensor)
            assert list(b[k].placements) == [Shard(0), Replicate()]
            assert torch.equal(b[k].to_local(), want[k])


def test_batch_iterator_defaults_to_the_card():
    import inspect

    assert inspect.signature(batch_iterator).parameters["device"].default == "cuda"


# ---------------------------------------------------------------------------
# The MoE layer's group count under a compute mesh
# ---------------------------------------------------------------------------

_MOE_REFERENCE = r"""
import sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.models.moe import apply_moe, init_moe
from repro.sharding.context import compute_mesh

arch, b, s, cf, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), float(sys.argv[4]), sys.argv[5]
cfg = get_config(arch).reduced().with_overrides(dtype="float32", param_dtype="float32")
p = init_moe(jax.random.PRNGKey(0), cfg)
x = np.random.default_rng(1).standard_normal((b, s, cfg.d_model)).astype(np.float32)
# jax.make_mesh's axis_types (the reference's make_host_mesh) needs a newer jax.
mesh = Mesh(np.array(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
with compute_mesh(mesh):
    y, aux = jax.jit(lambda p, x: apply_moe(p, x, cfg, cf))(p, x)
np.savez(out, x=x, y=np.asarray(y), aux=np.asarray(aux),
         **{f"p{i}": np.asarray(l) for i, l in enumerate(jax.tree.leaves(p))})
"""


@functools.lru_cache(maxsize=None)
def _moe_reference(arch, b, s, cf, tmp):
    out = os.path.join(tmp, f"{arch}-{b}-{s}.npz")
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    proc = subprocess.run([sys.executable, "-c", _MOE_REFERENCE, arch, str(b), str(s), str(cf), out],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("arch,b,s", [("granite-moe-1b-a400m", 2, 32),
                                      ("deepseek-moe-16b", 2, 32),
                                      ("granite-moe-1b-a400m", 1, 33)])
def test_moe_groups_from_the_compute_mesh_match_reference(arch, b, s, tmp_path_factory):
    """A ``data=2`` compute mesh splits T = 64 tokens into 2 groups of 32
    with their own capacity (8 slots an expert at capacity factor 0.5,
    against 16 for one group of 64), which changes what drops; T = 33 does
    not divide, so it stays one group.  Outputs and aux within 1e-5
    relative L2 of the reference's under the same mesh."""
    cf = 0.5
    ref = _moe_reference(arch, b, s, cf, str(tmp_path_factory.mktemp("moe")))
    cfg = get_config(arch).reduced().with_overrides(dtype="float32", param_dtype="float32")
    layout = init_moe(torch.Generator(), cfg, device="meta")
    n = len(tree_leaves(layout))
    p = tree_unflatten(tree_structure(layout), [torch.from_numpy(ref[f"p{i}"]) for i in range(n)])
    x = torch.from_numpy(ref["x"])
    with compute_mesh(FakeMesh(data=2, model=1)):
        y, aux = apply_moe(p, x, cfg, cf)
    y1, aux1 = apply_moe(p, x, cfg, cf)
    assert _rel(y.numpy(), ref["y"]) <= 1e-5
    assert _rel(aux.numpy(), ref["aux"]) <= 1e-5
    if (b * s) % 2 == 0:
        assert not torch.equal(y, y1), "two groups should drop other assignments than one"
        assert _rel(y1.numpy(), ref["y"]) > 1e-3
    else:
        assert torch.equal(y, y1)
