"""The port's model zoo serve path against the reference, family by
family: ``prefill`` (through ``make_prefill_step``), several
``decode_step``s with their caches (through ``make_serve_step``), the
forward-only loss, and the serve driver's greedy tokens.

Every ``dense``, ``moe``, ``vlm``, ``ssm`` and ``hybrid`` config of the repo, reduced
and in fp32, starts from the reference's weights (``ModelFamily.init`` with a
JAX key, carried over by ``params_from_numpy``) and numpy-seeded tokens.
Logits agree within 1e-4 (abs and rel): both packages do the same fp32
arithmetic, summed in other orders through two or more layers, and the
logits reach magnitudes of about 5.  Greedy tokens agree exactly.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import serve as jax_serve
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.launch.steps import make_serve_step as jax_serve_step
from repro.models import get_model as jax_model
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import get_model
from repro_torch.models import transformer as T

TOL = 1e-4
SERVED = ["internlm2-1.8b", "yi-9b", "deepseek-7b", "olmo-1b", "internvl2-2b", "mamba2-130m",
          "granite-moe-1b-a400m", "deepseek-moe-16b", "jamba-1.5-large-398b"]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _pair(arch, seed=0):
    kw = dict(dtype="float32", param_dtype="float32")
    jc = jax_config(arch).reduced().with_overrides(**kw)
    tc = get_config(arch).reduced().with_overrides(**kw)
    jm, tm = jax_model(jc), get_model(tc)
    jp = jm.init(jax.random.PRNGKey(seed))
    return jc, tc, jm, tm, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _batches(cfg, batch, seq, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, seq))
    jb = {"tokens": jnp.asarray(toks, jnp.int32), "labels": jnp.asarray(toks, jnp.int32)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    if cfg.arch_type == "vlm":
        pe = rng.standard_normal((batch, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
        jb["patch_embeds"], tb["patch_embeds"] = jnp.asarray(pe), torch.from_numpy(pe)
    return jb, tb


@pytest.mark.parametrize("arch", SERVED)
def test_prefill_decode_and_loss_match_reference(arch):
    """Prefill logits and loss, then 6 decode steps from an empty cache:
    every step's logits, and the caches after them (the int8 cache of
    deepseek-7b bit for bit in its codes)."""
    jc, tc, jm, tm, jp, tp = _pair(arch)
    seq = 2 * tc.ssm_chunk if tc.arch_type in ("ssm", "hybrid") else 20
    jb, tb = _batches(tc, 2, seq, seed=1)
    logits = make_prefill_step(tm)(tp, tb)
    want = jax_prefill_step(jm)(jp, jb)
    assert logits.dtype == torch.float32 and tuple(logits.shape) == want.shape
    _close(logits, want)
    _close(tm.loss(tp, tb), jm.loss(jp, jb))

    jcache, tcache = jm.init_cache(2, 8), tm.init_cache(2, 8, "cpu")
    assert sorted(tcache) == sorted(jcache)
    assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in tcache.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in jcache.items()}
    jstep, tstep = jax_serve_step(jm), make_serve_step(tm)
    toks = np.array(jb["tokens"])
    for t in range(6):
        tok = toks[:, t:t + 1]
        jl, jcache = jstep(jp, jcache, jnp.asarray(tok), jnp.int32(t))
        tl, tcache = tstep(tp, tcache, torch.from_numpy(tok), t)
        _close(tl, jl)
    for name in tcache:
        if tcache[name].dtype == torch.int8:
            assert np.array_equal(tcache[name].numpy(), np.asarray(jcache[name]))
        else:
            _close(tcache[name], jcache[name])


@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-7b", "granite-moe-1b-a400m",
                                  "deepseek-moe-16b"])
def test_prefill_cache_then_decode(arch):
    """lm_forward's returned cache is the reference's, and decoding one
    token on it continues the forward (the reference's own check in
    tests/test_arch_smoke.py).  MoE archs run at capacity factor E/K, so the
    forward drops no assignment, as one decoded token never does."""
    jc, tc, jm, tm, jp, tp = _pair(arch, seed=2)
    kw = dict(kv_cache_dtype="bfloat16")
    if tc.n_experts:
        kw["moe_capacity_factor"] = tc.n_experts / tc.top_k
    tc, jc = tc.with_overrides(**kw), jc.with_overrides(**kw)
    jb, tb = _batches(tc, 2, 16, seed=3)
    tl, _, tkv = T.lm_forward(tp, tb["tokens"], tc, return_cache=True)
    jl, _, jkv = JT.lm_forward(jp, jb["tokens"], jc, return_cache=True)
    _close(tkv["k"], jkv["k"])
    _close(tkv["v"], jkv["v"])
    cache = T.init_kv_cache(tc, 2, 32, "cpu")
    cache["k"][:, :, :16] = tkv["k"]
    cache["v"][:, :, :16] = tkv["v"]
    nxt = tl[:, -1:].argmax(-1)
    step, _ = T.lm_decode_step(tp, nxt, cache, 16, tc)
    full, _ = T.lm_forward(tp, torch.cat([tb["tokens"], nxt], 1), tc)
    _close(step[:, 0], full[:, -1])


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-130m"])
def test_serve_main_tokens_match_reference(arch, capsys):
    """The reference's serve driver and the port's, from the reference's
    weights and the same prompt: the same greedy tokens for every
    sequence (the reference prints the first)."""
    argv = ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "6",
            "--decode-tokens", "5"]
    assert jax_serve.main(argv) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("generated")][0]
    want_first = eval(line.split(":", 1)[1])

    jc, tc, jm, tm, jp, tp = _pair(arch)
    prompt = np.random.default_rng(0).integers(0, tc.vocab_size, (2, 6)).astype(np.int32)
    res = serve.generate(tm, tp, torch.from_numpy(prompt.astype(np.int64)), 5,
                         keep_prompt_logits=True)
    assert res.tokens[0].tolist() == want_first

    # Every sequence, and every prompt position's logits, against the
    # reference's serve_step run the same way.
    cache = jm.init_cache(2, 11)
    step = jax.jit(jax_serve_step(jm))
    jlogits = []
    for t in range(6):
        lg, cache = step(jp, cache, jnp.asarray(prompt[:, t:t + 1]), jnp.int32(t))
        jlogits.append(np.asarray(lg))
    _close(res.prompt_logits, np.concatenate(jlogits, 1))
    tok = np.argmax(jlogits[-1][:, -1], -1)[:, None].astype(np.int32)
    toks = [tok]
    for i in range(4):
        lg, cache = step(jp, cache, jnp.asarray(tok), jnp.int32(6 + i))
        tok = np.argmax(np.asarray(lg)[:, -1], -1)[:, None].astype(np.int32)
        toks.append(tok)
    assert res.tokens.tolist() == np.concatenate(toks, 1).tolist()


def test_serve_main_runs_on_cpu(capsys):
    assert serve.main(["--arch", "olmo-1b", "--reduced", "--batch", "2", "--prompt-len", "4",
                       "--decode-tokens", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "arch=olmo-1b-reduced" in out and "device=cpu" in out
    assert len(eval(out.split("generated token ids (first sequence):")[1])) == 3


@pytest.mark.parametrize("arch", SERVED)
def test_param_counts_match_reference(arch):
    jc, tc, jm, tm, jp, tp = _pair(arch)
    assert tm.param_count(tp) == jm.param_count(jp)
    assert tm.active_param_count(tp) == jm.active_param_count(jp)
    own = tm.init(torch.Generator().manual_seed(0), "cpu")
    assert tm.param_count(own) == jm.param_count(jp)


def test_zoo_entry_points_default_to_the_card():
    from repro_torch.models import api, hybrid, layers, mamba2, moe, ssm_lm

    for fn in (api.ModelFamily.init, api.ModelFamily.init_cache, T.init_lm, T.init_kv_cache,
               ssm_lm.init_ssm_lm, ssm_lm.init_ssm_cache, hybrid.init_hybrid_lm,
               hybrid.init_hybrid_cache, mamba2.init_mamba,
               mamba2.init_mamba_cache, layers.init_norm, layers.init_attention,
               layers.init_mlp, layers.init_embedding, layers.init_lm_head, moe.init_moe):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__
    parser_default = [a for a in inspect.getsource(serve.main).splitlines() if "--device" in a]
    assert 'default="cuda"' in parser_default[0]
