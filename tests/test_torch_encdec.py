"""The port's encoder-decoder family (whisper-small) against the reference.

Reduced whisper-small (2 encoder + 2 decoder layers, d 256, 4 query heads
of 64 over 2 KV heads: ``reduced()`` makes even whisper's MHA grouped; 16
frames) in fp32 starts from the reference's weights
(``init_encdec`` with a JAX key, carried over leaf by leaf with
``params_from_numpy``) and numpy-seeded frames and tokens.  Both
packages do the same fp32 arithmetic summed in other orders, so
``encode``, the prefill logits and the loss agree within 1e-5 (abs and
rel), each leaf's gradient within 2e-5 relative L2, one train step's
parameters within 1e-5 relative L2, and decode steps within 1e-5.  On
the CPU the attention is the plain version (``full_attention`` over keys
of another length than the queries in the cross-attention), as the
reference's is.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import serve as jax_serve
from repro.launch import train as jax_train
from repro.launch.steps import make_optimizer_for as jax_optimizer_for
from repro.launch.steps import make_serve_step as jax_serve_step
from repro.launch.steps import make_train_step as jax_train_step
from repro.models import encdec as JE
from repro.models import get_model as jax_model
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve, train
from repro_torch.launch.steps import make_optimizer_for, make_serve_step, make_train_step
from repro_torch.models import encdec as E
from repro_torch.models import get_model
from repro_torch.utils.tree import keystr, tree_flatten, tree_flatten_with_path, tree_unflatten

ARCH = "whisper-small"
TOL = 1e-5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _pair(dtype="float32", seed=0):
    kw = dict(dtype=dtype, param_dtype=dtype)
    jc = jax_config(ARCH).reduced().with_overrides(**kw)
    tc = get_config(ARCH).reduced().with_overrides(**kw)
    jm, tm = jax_model(jc), get_model(tc)
    jp = jm.init(jax.random.PRNGKey(seed))
    return jc, tc, jm, tm, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _batches(cfg, batch, seq, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, seq + 1))
    frames = rng.standard_normal((batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    x, y = toks[:, :-1], toks[:, 1:]
    jb = {"frames": jnp.asarray(frames, cfg.dtype), "tokens": jnp.asarray(x, jnp.int32),
          "labels": jnp.asarray(y, jnp.int32)}
    tb = {"frames": torch.from_numpy(frames).to(cfg.activation_dtype),
          "tokens": torch.from_numpy(x), "labels": torch.from_numpy(y)}
    return jb, tb


def test_config_is_the_cut_the_tests_name():
    _, tc, _, _, _, _ = _pair()
    assert (tc.arch_type, tc.n_encoder_layers, tc.n_layers, tc.d_model, tc.n_heads,
            tc.n_kv_heads, tc.hd, tc.encoder_seq) == ("encdec", 2, 2, 256, 4, 2, 64, 16)


def test_param_tree_and_counts_match_reference():
    """The port's own init has the reference's paths, shapes and dtypes,
    and both parameter counts equal the reference's."""
    jc, tc, jm, tm, jp, tp = _pair()
    own = tm.init(torch.Generator().manual_seed(0), "cpu")
    want = [(keystr(k), tuple(v.shape), str(v.dtype)[6:])
            for k, v in tree_flatten_with_path(tp)[0]]
    got = [(keystr(k), tuple(v.shape), str(v.dtype)[6:])
           for k, v in tree_flatten_with_path(own)[0]]
    assert got == want
    assert sorted(own) == ["dec_pos", "decoder", "embed", "enc_final_norm", "encoder",
                           "final_norm"]
    assert sorted(own["decoder"]) == ["cross_attn", "mlp", "norm1", "norm2", "norm_cross",
                                      "self_attn"]
    assert tm.param_count(own) == tm.param_count(tp) == jm.param_count(jp)
    assert tm.active_param_count(own) == jm.active_param_count(jp)


def test_full_width_param_count_matches_reference():
    """whisper-small at full width: 263,366,400 parameters in both
    packages (the reference's counted from shapes alone)."""
    jc = jax_config(ARCH)
    shapes = jax.eval_shape(lambda: jax_model(jc).init(jax.random.PRNGKey(0)))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    tm = get_model(get_config(ARCH))
    meta = tm.init(torch.Generator(), "meta")
    assert tm.param_count(meta) == want == 263_366_400
    assert tm.active_param_count(meta) == want


def test_sinusoidal_and_gelu_mlp_match_reference():
    _close(E._sinusoidal(24, 32), JE._sinusoidal(24, 32))
    jc, tc, jm, tm, jp, tp = _pair()
    x = np.random.default_rng(0).standard_normal((2, 5, tc.d_model)).astype(np.float32)
    mlp = jax.tree.map(lambda a: a[0], jp["encoder"]["mlp"])
    tmlp = {k: v[0] for k, v in tp["encoder"]["mlp"].items()}
    _close(E._gelu_mlp(tmlp, torch.from_numpy(x)), JE._gelu_mlp(mlp, jnp.asarray(x)))


def test_encode_prefill_and_loss_match_reference():
    jc, tc, jm, tm, jp, tp = _pair()
    jb, tb = _batches(tc, 2, 12, seed=1)
    _close(E.encode(tp, tb["frames"], tc), JE.encode(jp, jb["frames"], jc))
    logits = tm.prefill(tp, tb)
    want = jm.prefill(jp, jb)
    assert logits.dtype == torch.float32 and tuple(logits.shape) == want.shape
    _close(logits, want)
    _close(tm.loss(tp, tb), jm.loss(jp, jb))


def test_prefill_bf16_matches_reference():
    """In bf16 the two packages round at the same places but sum in other
    orders: logits within the reference's bf16 tolerance, 2e-2 of the
    largest logit."""
    jc, tc, jm, tm, jp, tp = _pair("bfloat16")
    jb, tb = _batches(tc, 2, 12, seed=2)
    got, want = tm.prefill(tp, tb), np.asarray(jm.prefill(jp, jb), np.float32)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 2e-2 * np.abs(want).max()


def test_loss_gradient_matches_reference():
    """Autograd of the port's loss (the plain attention on the CPU) against
    ``jax.grad`` of the reference's, leaf by leaf within 2e-5 relative L2."""
    jc, tc, jm, tm, jp, tp = _pair()
    jb, tb = _batches(tc, 2, 10, seed=3)
    jg = jax.grad(lambda p: jm.loss(p, jb))(jp)
    leaves, treedef = tree_flatten(tp)
    live = [t.detach().requires_grad_(True) for t in leaves]
    grads = torch.autograd.grad(tm.loss(tree_unflatten(treedef, live), tb), live)
    names = [keystr(k) for k, _ in tree_flatten_with_path(tp)[0]]
    jleaves = jax.tree.leaves(jg)
    assert len(grads) == len(jleaves)
    for name, g, w in zip(names, grads, jleaves):
        assert tuple(g.shape) == w.shape, name
        assert _rel_l2(g.numpy(), w) <= 2e-5, name


def test_train_step_matches_reference():
    jc, tc, jm, tm, jp, tp = _pair()
    jopt, topt = jax_optimizer_for(jc), make_optimizer_for(tc)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    jstep, tstep = jax.jit(jax_train_step(jm, jopt)), make_train_step(tm, topt)
    for step in range(2):
        jb, tb = _batches(tc, 2, 8, seed=10 + step)
        jp, jstate, jloss = jstep(jp, jstate, jb)
        tp, tstate, tloss = tstep(tp, tstate, tb)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=TOL)
    for a, b in zip(tree_flatten(tp)[0], jax.tree.leaves(jp)):
        assert tuple(a.shape) == b.shape and _rel_l2(a.numpy(), b) <= TOL
    assert tstate.step == 2


def _filled_caches(jc, tc, jm, tm, jp, tp, prompt, frames, max_seq):
    """Both packages' decode caches with the cross K/V that
    ``decode_forward(..., return_cache=True)`` gives for the prompt's first
    token over the frames' encoding."""
    jmem = JE.encode(jp, jnp.asarray(frames), jc)
    _, jc_fill = JE.decode_forward(jp, jnp.asarray(prompt[:, :1]), jmem, jc, return_cache=True)
    tmem = E.encode(tp, torch.from_numpy(frames), tc)
    _, tc_fill = E.decode_forward(tp, torch.from_numpy(prompt[:, :1]), tmem, tc,
                                  return_cache=True)
    for name in tc_fill:
        _close(tc_fill[name], jc_fill[name])
    jcache = jm.init_cache(prompt.shape[0], max_seq)
    jcache = dict(jcache, k_cross=jc_fill["k_cross"], v_cross=jc_fill["v_cross"])
    tcache = tm.init_cache(prompt.shape[0], max_seq, "cpu")
    assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in tcache.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in jcache.items()}
    tcache["k_cross"].copy_(tc_fill["k_cross"])
    tcache["v_cross"].copy_(tc_fill["v_cross"])
    return jcache, tcache


def test_decode_steps_from_filled_cross_cache_match_reference():
    """Six decode steps against a cross cache filled from
    ``decode_forward(return_cache=True)``: every step's logits and the
    caches after them."""
    jc, tc, jm, tm, jp, tp = _pair(seed=1)
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, tc.vocab_size, (2, 6))
    frames = rng.standard_normal((2, tc.encoder_seq, tc.d_model)).astype(np.float32)
    jcache, tcache = _filled_caches(jc, tc, jm, tm, jp, tp, prompt, frames, 8)
    jstep, tstep = jax_serve_step(jm), make_serve_step(tm)
    for t in range(6):
        tok = prompt[:, t:t + 1]
        jl, jcache = jstep(jp, jcache, jnp.asarray(tok, jnp.int32), jnp.int32(t))
        tl, tcache = tstep(tp, tcache, torch.from_numpy(tok), t)
        assert tuple(tl.shape) == (2, 1, tc.vocab_size)
        _close(tl, jl)
    for name in tcache:
        _close(tcache[name], jcache[name])


def test_prefill_agrees_with_token_by_token_serving():
    """The prefill logits of a prompt equal those of serving it token by
    token against the cross cache its own forward fills (fp32: the same
    arithmetic in another order)."""
    _, tc, _, tm, _, tp = _pair(seed=2)
    rng = np.random.default_rng(5)
    prompt = torch.from_numpy(rng.integers(0, tc.vocab_size, (2, 9)))
    frames = torch.from_numpy(rng.standard_normal((2, tc.encoder_seq, tc.d_model))
                              .astype(np.float32))
    want = tm.prefill(tp, {"frames": frames, "tokens": prompt})
    memory = E.encode(tp, frames, tc)
    _, fill = E.decode_forward(tp, prompt, memory, tc, return_cache=True)
    cache = tm.init_cache(2, 9, "cpu")
    cache["k_cross"].copy_(fill["k_cross"])
    cache["v_cross"].copy_(fill["v_cross"])
    step = make_serve_step(tm)
    got = []
    for t in range(9):
        lg, cache = step(tp, cache, prompt[:, t:t + 1], t)
        got.append(lg)
    _close(torch.cat(got, 1), want.numpy(), 1e-4)
    _close(cache["k_self"], fill["k_self"].numpy())


def test_serve_driver_from_a_filled_cross_cache_agrees_with_prefill():
    """``generate`` handed a cache whose cross K/V ``decode_forward(
    return_cache=True)`` filled serves the prompt token by token to the
    prefill's logits, and leaves the handed cache's cross K/V as they were."""
    _, tc, _, tm, _, tp = _pair(seed=3)
    rng = np.random.default_rng(6)
    prompt = torch.from_numpy(rng.integers(0, tc.vocab_size, (2, 7)))
    frames = torch.from_numpy(rng.standard_normal((2, tc.encoder_seq, tc.d_model))
                              .astype(np.float32))
    want = tm.prefill(tp, {"frames": frames, "tokens": prompt})
    _, fill = E.decode_forward(tp, prompt, E.encode(tp, frames, tc), tc, return_cache=True)
    cache = tm.init_cache(2, 10, "cpu")
    cache["k_cross"].copy_(fill["k_cross"])
    cache["v_cross"].copy_(fill["v_cross"])
    res = serve.generate(tm, tp, prompt, 3, keep_prompt_logits=True, cache=cache)
    assert tuple(res.tokens.shape) == (2, 3)
    _close(res.prompt_logits, want.numpy(), 1e-4)
    _close(cache["k_cross"], fill["k_cross"].numpy())


def test_serve_driver_tokens_match_reference(capsys):
    """The serve drivers decode against the zeroed cross cache their
    ``init_cache`` gives (the reference's serve never fills it): the same
    greedy tokens and prompt logits from the reference's weights."""
    argv = ["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len", "5",
            "--decode-tokens", "4"]
    assert jax_serve.main(argv) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("generated")][0]
    want_first = eval(line.split(":", 1)[1])
    jc, tc, jm, tm, jp, tp = _pair()
    prompt = np.random.default_rng(0).integers(0, tc.vocab_size, (2, 5))
    res = serve.generate(tm, tp, torch.from_numpy(prompt), 4, keep_prompt_logits=True)
    assert res.tokens[0].tolist() == want_first
    cache = jm.init_cache(2, 9)
    step = jax.jit(jax_serve_step(jm))
    jlogits = []
    for t in range(5):
        lg, cache = step(jp, cache, jnp.asarray(prompt[:, t:t + 1], jnp.int32), jnp.int32(t))
        jlogits.append(np.asarray(lg))
    _close(res.prompt_logits, np.concatenate(jlogits, 1))


def test_serve_main_runs_on_cpu(capsys):
    assert serve.main(["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len", "4",
                       "--decode-tokens", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"arch={ARCH}-reduced" in out and "device=cpu" in out


def test_trainer_exits_0_and_matches_reference(capsys):
    """``--arch whisper-small --reduced --device cpu``: frames drawn after
    the tokens from the same generator; the loss falls (exit 0), as the
    reference's trainer's does."""
    argv = ["--arch", ARCH, "--reduced", "--steps", "16", "--batch", "4", "--seq", "32",
            "--log-every", "8"]
    rc = train.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}-reduced" in out and "device=cpu" in out and "done: loss" in out
    assert rc == 0 == jax_train.main(argv)


def test_flash_launches_per_step_on_the_cpu_are_zero():
    """On CPU tensors the attention is the plain version: a prefill and a
    train step launch no kernel."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd

    _, tc, _, tm, _, tp = _pair()
    _, tb = _batches(tc, 2, 8, seed=6)
    before = (flash_attention.launches, flash_attention_bwd.launches)
    tm.prefill(tp, tb)
    opt = make_optimizer_for(tc)
    make_train_step(tm, opt)(tp, opt.init(tp), tb)
    assert (flash_attention.launches, flash_attention_bwd.launches) == before


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_card_matches_cpu():
    """Card only: reduced whisper-small in fp32 from the same weights on
    the card (the flash kernels: 6 forward launches a prefill, 2 + 2 x 2
    layers, and 6 backward launches a train step) and on the CPU: prefill
    logits within 1e-4, the loss within 1e-4 relative and every leaf's
    gradient within 1e-4 relative L2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.utils.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    _, tc, _, tm, _, tp = _pair(seed=3)
    _, tb = _batches(tc, 2, 40, seed=7)
    runs = {}
    for device in ("cuda", "cpu"):
        p = tree_map(lambda t: t.to(device), tp)
        b = tree_map(lambda t: t.to(device), tb)
        before = (flash_attention.launches, flash_attention_bwd.launches)
        logits = tm.prefill(p, b)
        leaves, treedef = tree_flatten(p)
        live = [t.detach().requires_grad_(True) for t in leaves]
        loss = tm.loss(tree_unflatten(treedef, live), b)
        grads = torch.autograd.grad(loss, live)
        after = (flash_attention.launches, flash_attention_bwd.launches)
        runs[device] = (logits.cpu(), float(loss), [g.cpu() for g in grads],
                        (after[0] - before[0], after[1] - before[1]))
    (cl, closs, cg, cn), (pl, ploss, pg, pn) = runs["cuda"], runs["cpu"]
    n = tc.n_encoder_layers + 2 * tc.n_layers
    assert cn == (2 * n, n) and pn == (0, 0)
    torch.testing.assert_close(cl, pl, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(closs, ploss, rtol=1e-4)
    for a, b in zip(cg, pg):
        assert _rel_l2(a.numpy(), b.numpy()) <= 1e-4


def test_entry_points_default_to_the_card():
    import inspect

    for fn in (E.init_encdec, E.init_encdec_cache, E._init_gelu_mlp):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__
