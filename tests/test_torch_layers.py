"""The port's model layers (``models/layers.py``, ``models/mamba2.py``,
the KV-cache codec of ``models/transformer.py``) against the reference's,
function by function, on the same numpy inputs and weights.

fp32 throughout, tolerance 2e-5 (abs and rel; the reference's fp32 kernel
tolerance): the two packages do the same fp32 arithmetic, summed in
other orders.  Trees carried over by ``params_from_numpy`` must keep
their structure (empty norm dicts included) and bf16 bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import layers as JL
from repro.models import mamba2 as JM
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import transformer as T
from repro_torch.utils.tree import tree_flatten_with_path, tree_structure

TOL = 2e-5


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol, rtol=tol)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _cfgs(arch):
    kw = dict(dtype="float32", param_dtype="float32")
    return jax_config(arch).reduced().with_overrides(**kw), \
        get_config(arch).reduced().with_overrides(**kw)


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm", "nonparametric"])
def test_norm(norm_type):
    jc, tc = (c.with_overrides(norm_type=norm_type) for c in _cfgs("olmo-1b"))
    jp = JL.init_norm(jc, 64)
    tp = L.init_norm(tc, 64, "cpu")
    assert sorted(tp) == sorted(jp)
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 5, 64) * 3 + 1
    if jp:
        jp = {k: jnp.asarray(_rand(rng, 64)) for k in jp}
        tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    _close(L.apply_norm(tp, torch.from_numpy(x), norm_type),
           JL.apply_norm(jp, jnp.asarray(x), norm_type))


def test_rope():
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 7, 3, 64)
    pos = rng.integers(0, 5000, (2, 7))
    _close(L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32), 10_000.0), 1e-4)


@pytest.mark.parametrize("window,q_chunk,q_offset", [
    (None, 1024, 0), (8, 1024, 0), (None, 16, 0), (5, 16, 0), (None, 1024, 6),
])
def test_causal_attention(window, q_chunk, q_offset):
    """Chunked over queries (q_chunk < Sq exercises the loop), windowed,
    and with shifted query positions (Sq < Sk)."""
    rng = np.random.default_rng(2)
    Sq = 40 - q_offset
    q, k, v = _rand(rng, 2, Sq, 4, 32), _rand(rng, 2, 40, 2, 32), _rand(rng, 2, 40, 2, 32)
    got = L.causal_attention(*map(torch.from_numpy, (q, k, v)), sliding_window=window,
                             q_chunk=q_chunk, q_offset=q_offset)
    want = JL.causal_attention(*map(jnp.asarray, (q, k, v)), sliding_window=window,
                               q_chunk=q_chunk, q_offset=q_offset)
    _close(got, want)


def test_full_attention():
    rng = np.random.default_rng(3)
    q, k, v = _rand(rng, 2, 9, 4, 32), _rand(rng, 2, 13, 1, 32), _rand(rng, 2, 13, 1, 32)
    _close(L.full_attention(*map(torch.from_numpy, (q, k, v))),
           JL.full_attention(*map(jnp.asarray, (q, k, v))))


@pytest.mark.parametrize("window,S,pos", [(None, 24, 10), (4, 24, 3), (4, 24, 17), (16, 24, 20)])
def test_decode_attention(window, S, pos):
    """Window 4 against a cache of 24 takes the slice path (S > 2W), window
    16 the masked path."""
    rng = np.random.default_rng(4)
    q, kc, vc = _rand(rng, 2, 1, 4, 32), _rand(rng, 2, S, 2, 32), _rand(rng, 2, S, 2, 32)
    _close(L.decode_attention(*map(torch.from_numpy, (q, kc, vc)), pos, sliding_window=window),
           JL.decode_attention(*map(jnp.asarray, (q, kc, vc)), jnp.int32(pos),
                               sliding_window=window))


def test_mlp_embed_and_heads():
    jc, tc = _cfgs("internlm2-1.8b")
    jp = {"mlp": JL.init_mlp(jax.random.PRNGKey(0), jc),
          "embed": JL.init_embedding(jax.random.PRNGKey(1), jc),
          "head": JL.init_lm_head(jax.random.PRNGKey(2), jc)}
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(5)
    x = _rand(rng, 2, 6, jc.d_model)
    toks = rng.integers(0, jc.vocab_size, (2, 6))
    _close(L.apply_mlp(tp["mlp"], torch.from_numpy(x)), JL.apply_mlp(jp["mlp"], jnp.asarray(x)))
    _close(L.embed(tp["embed"], torch.from_numpy(toks)),
           JL.embed(jp["embed"], jnp.asarray(toks, jnp.int32)))
    _close(L.unembed(tp["embed"], torch.from_numpy(x)), JL.unembed(jp["embed"], jnp.asarray(x)))
    _close(L.lm_head(tp["head"], torch.from_numpy(x)), JL.lm_head(jp["head"], jnp.asarray(x)))
    # The port's initializers give the reference's shapes, dtypes and keys.
    gen = torch.Generator().manual_seed(0)
    for mine, theirs in ((L.init_mlp(gen, tc, device="cpu"), jp["mlp"]),
                         (L.init_embedding(gen, tc, "cpu"), jp["embed"]),
                         (L.init_lm_head(gen, tc, "cpu"), jp["head"]),
                         (L.init_attention(gen, tc, "cpu"),
                          JL.init_attention(jax.random.PRNGKey(3), jc))):
        assert {k: tuple(v.shape) for k, v in mine.items()} == \
            {k: tuple(v.shape) for k, v in theirs.items()}


def test_stack_and_scan_layers():
    """stack_layers keeps the reference's tree (empty norm dicts in place,
    leaves stacked on axis 0); scan_layers walks it like lax.scan."""
    jc, tc = _cfgs("olmo-1b")
    jstack = JL.stack_layers(lambda r: JT._init_decoder_layer(r, jc, moe=False),
                             jax.random.PRNGKey(0), 3)
    tstack = L.stack_layers(lambda g: T._init_decoder_layer(g, tc, "cpu"),
                            torch.Generator().manual_seed(0), 3)
    assert repr(tree_structure(tstack)) == repr(jax.tree.structure(jstack))
    assert tstack["norm1"] == {} and tstack["attn"]["wq"].shape == (3, 256, 256)

    xs = {"w": torch.arange(12.0).reshape(3, 4), "empty": {}}

    def body(carry, x):
        return carry + x["w"].sum(), x["w"] * 2

    carry, ys = L.scan_layers(body, torch.zeros(()), xs, tc)
    jcarry, jys = jax.lax.scan(lambda c, x: (c + x["w"].sum(), x["w"] * 2), jnp.zeros(()),
                               {"w": jnp.arange(12.0).reshape(3, 4), "empty": {}})
    _close(carry, jcarry)
    _close(ys, jys)
    assert L.scan_layers(lambda c, x: (c, None), 0, xs, tc) == (0, None)


def test_grad_dtype_guard_casts_the_cotangent():
    """Identity forward; its backward hands the cotangent back in the
    primal's dtype.  (Torch's autograd already returns a leaf's gradient in
    the leaf's dtype, so the cast shows only on the backward itself.)"""
    x = torch.ones(3, dtype=torch.bfloat16, requires_grad=True)
    y = L.grad_dtype_guard(x)
    assert torch.equal(y, x) and y.dtype == torch.bfloat16
    (y.float() * 2).sum().backward()
    assert x.grad.dtype == torch.bfloat16 and torch.equal(x.grad, torch.full((3,), 2.0).bfloat16())

    class Ctx:
        dtype = torch.bfloat16

    g = L._GradDtypeGuard.backward(Ctx(), torch.full((3,), 1.5))
    assert g.dtype == torch.bfloat16 and torch.equal(g.float(), torch.full((3,), 1.5))


def test_kv_quantization():
    rng = np.random.default_rng(6)
    x = _rand(rng, 2, 1, 4, 32)
    x[0, 0, 1] = 0.0  # an all-zero head takes the 1e-8 floor
    qt, st = T._quantize_kv(torch.from_numpy(x))
    qj, sj = JT._quantize_kv(jnp.asarray(x))
    assert qt.dtype == torch.int8 and np.array_equal(qt.numpy(), np.asarray(qj))
    _close(st, sj, 0)
    _close(T._dequantize_kv(qt, st, torch.float32), JT._dequantize_kv(qj, sj, jnp.float32), 0)


def test_params_from_numpy_carries_zoo_trees():
    """A bf16 zoo tree crosses bit for bit: stacked leaves, empty norm
    dicts, and the same leaf paths; and back again."""
    jc = jax_config("olmo-1b").reduced()
    assert jc.param_dtype == "bfloat16"
    jp = JT.init_lm(jax.random.PRNGKey(0), jc)
    np_tree = jax.tree.map(np.asarray, jp)
    tp = params_from_numpy(np_tree, "cpu")
    assert repr(tree_structure(tp)) == repr(jax.tree.structure(jp))
    assert tp["layers"]["norm1"] == {} and tp["final_norm"] == {}
    jpaths = [(jax.tree_util.keystr(p), np.asarray(v)) for p, v in
              jax.tree_util.tree_flatten_with_path(jp)[0]]
    tpaths = tree_flatten_with_path(tp)[0]
    assert len(jpaths) == len(tpaths)
    for (_, want), (_, got) in zip(jpaths, tpaths):
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        assert np.array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    back = params_to_numpy(tp)
    assert np.array_equal(back["layers"]["attn"]["wq"],
                          np.asarray(jp["layers"]["attn"]["wq"], np.float32))


# ---------------------------------------------------------------------------
# Mamba-2
# ---------------------------------------------------------------------------

def test_segsum_and_causal_conv():
    rng = np.random.default_rng(7)
    a = _rand(rng, 2, 3, 8)
    got, want = M._segsum(torch.from_numpy(a)).numpy(), np.asarray(JM._segsum(jnp.asarray(a)))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    _close(np.where(np.isinf(got), 0, got), np.where(np.isinf(want), 0, want))
    x, w, b = _rand(rng, 2, 11, 6), _rand(rng, 4, 6), _rand(rng, 6)
    _close(M._causal_conv(*map(torch.from_numpy, (x, w, b))),
           JM._causal_conv(*map(jnp.asarray, (x, w, b))))


def _mamba_params():
    jc, tc = _cfgs("mamba2-130m")
    jp = JM.init_mamba(jax.random.PRNGKey(0), jc)
    rng = np.random.default_rng(8)
    # Non-trivial dt_bias, D and norm scale (the initializer gives 0 and 1).
    jp = dict(jp, dt_bias=jnp.asarray(_rand(rng, jc.ssm_heads) * 0.5),
              D=jnp.asarray(_rand(rng, jc.ssm_heads)),
              norm_scale=jnp.asarray(1 + 0.1 * _rand(rng, jc.d_inner)),
              conv_b=jnp.asarray(0.1 * _rand(rng, jc.d_inner + 2 * jc.ssm_state)))
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def test_mamba_forward_and_state():
    jc, tc, jp, tp = _mamba_params()
    assert {k: tuple(v.shape) for k, v in M.init_mamba(torch.Generator(), tc, "cpu").items()} \
        == {k: tuple(v.shape) for k, v in jp.items()}
    rng = np.random.default_rng(9)
    u = _rand(rng, 2, 64, jc.d_model)
    h0 = _rand(rng, 2, jc.ssm_heads, jc.ssm_head_dim, jc.ssm_state) * 0.1
    out, h = M.mamba_forward(tp, torch.from_numpy(u), tc, torch.from_numpy(h0), return_state=True)
    jout, jh = JM.mamba_forward(jp, jnp.asarray(u), jc, jnp.asarray(h0), return_state=True)
    _close(out, jout, 1e-4)
    _close(h, jh, 1e-4)


def test_mamba_decode_steps():
    jc, tc, jp, tp = _mamba_params()
    rng = np.random.default_rng(10)
    jcache = JM.init_mamba_cache(jc, 2, jnp.float32)
    tcache = M.init_mamba_cache(tc, 2, torch.float32, "cpu")
    for _ in range(4):
        u = _rand(rng, 2, 1, jc.d_model)
        tout, tcache = M.mamba_decode_step(tp, torch.from_numpy(u), tcache, tc)
        jout, jcache = JM.mamba_decode_step(jp, jnp.asarray(u), jcache, jc)
        _close(tout, jout, 1e-4)
    _close(tcache["ssm"], jcache["ssm"], 1e-4)
    _close(tcache["conv"], jcache["conv"], 1e-4)
