"""The port's hybrid family (jamba-1.5-large-398b) against the reference.

Reduced jamba (``reduced()``: 2 layers at ``attn_period`` 2, so one
superblock of a Mamba layer with a dense MLP and an attention layer with
an MoE of 4 experts top 2; d 256, 4 query heads of 64 over 2 KV heads, 16
SSD heads of 32, state 16, chunk 32) in fp32, and two variants of 8
layers, two superblocks each, that exercise the stacked scan over
superblocks and the per-slot cache indices: ``attn_period`` 4 (three
Mamba slots and one attention slot a superblock) and ``attn_period`` 2
with ``moe_every`` 4 (two of each).  Weights are the reference's
(``init_hybrid_lm`` with a JAX key, carried over leaf by leaf with
``params_from_numpy``), inputs numpy-seeded.  Both packages do the same
fp32 arithmetic summed in other orders, and the tolerances say how far
those orders carry:

- the routers' aux loss, the loss and the decode caches within 1e-5 (abs
  and rel);
- logits (up to about 5) within 1e-5 relative L2 over the whole tensor
  and 1e-4 (abs and rel) elementwise, the zoo's logit tolerance
  (``tests/test_torch_zoo.py``): single logits read up to 2e-5 apart
  through 2 layers and 4e-5 through 8, at 1.3e-6 and 4.9e-6 relative L2;
- each leaf's gradient within 1e-5 relative L2 for the reduced config
  and 1e-4 for the 8-layer variants: the Mamba layers' ``A_log`` and
  ``dt_bias`` gradients are sums over every position and head of terms
  that cancel, and read up to 5.6e-6 apart through 2 layers and 3.6e-5
  through 8 (mamba2-130m's own reduced ``A_log`` gradient reads 1.6e-5
  apart through 2);
- parameters after train steps within 1e-5 relative L2 as one vector
  and 1e-4 leaf by leaf: the config keeps AdamW's moments in bf16, so a
  gradient 1e-7 apart can round an element's moment to the neighbouring
  bf16 value, and ``conv_b``, which starts at zero, then reads 1.3e-5
  apart alone.

On the CPU the attention and the SSD scan are the plain versions, as the
reference's are.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import serve as jax_serve
from repro.launch import train as jax_train
from repro.launch.steps import make_serve_step as jax_serve_step
from repro.models import get_model as jax_model
from repro.models import hybrid as JH
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve, train
from repro_torch.launch.steps import make_optimizer_for, make_serve_step, make_train_step
from repro_torch.models import get_model
from repro_torch.models import hybrid as H
from repro_torch.utils.tree import keystr, tree_flatten, tree_flatten_with_path, tree_unflatten

ARCH = "jamba-1.5-large-398b"
TOL = 1e-5
VARIANTS = {   # overrides of reduced(), and each one's gradient tolerance
    "reduced": {},
    "attn_period_4": {"n_layers": 8, "attn_period": 4},
    "two_attn_slots": {"n_layers": 8, "attn_period": 2, "moe_every": 4},
}
GRAD_TOL = {"reduced": TOL, "attn_period_4": 1e-4, "two_attn_slots": 1e-4}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _close_logits(got, want):
    assert _rel_l2(got.detach().numpy(), want) <= TOL
    _close(got, want, 1e-4)


def _close_vectors(got, want):
    """Leaves of both trees, each within 1e-4 relative L2 and all of them
    as one vector within 1e-5."""
    got = [t.detach().numpy().astype(np.float64).ravel() for t in got]
    want = [np.asarray(w, np.float64).ravel() for w in want]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and _rel_l2(a, b) <= 1e-4
    assert _rel_l2(np.concatenate(got), np.concatenate(want)) <= TOL


def _pair(variant="reduced", seed=0, **extra):
    kw = dict(dtype="float32", param_dtype="float32", **VARIANTS[variant], **extra)
    jc = jax_config(ARCH).reduced().with_overrides(**kw)
    tc = get_config(ARCH).reduced().with_overrides(**kw)
    jm, tm = jax_model(jc), get_model(tc)
    jp = jm.init(jax.random.PRNGKey(seed))
    return jc, tc, jm, tm, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _batches(cfg, batch, seq, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, seq + 1))
    x, y = toks[:, :-1], toks[:, 1:]
    return ({"tokens": jnp.asarray(x, jnp.int32), "labels": jnp.asarray(y, jnp.int32)},
            {"tokens": torch.from_numpy(x), "labels": torch.from_numpy(y)})


def test_configs_are_the_cuts_the_tests_name():
    kinds = {}
    for variant in VARIANTS:
        _, tc, _, _, _, _ = _pair(variant)
        sb = H._superblock_len(tc)
        kinds[variant] = (tc.n_layers // sb, H._layer_kinds(tc, sb))
    _, tc, _, _, _, _ = _pair()
    assert (tc.arch_type, tc.d_model, tc.n_heads, tc.n_kv_heads, tc.hd, tc.n_experts, tc.top_k,
            tc.ssm_heads, tc.ssm_head_dim, tc.ssm_state, tc.ssm_chunk) == \
        ("hybrid", 256, 4, 2, 64, 4, 2, 16, 32, 16, 32)
    assert kinds == {
        "reduced": (1, [(False, False), (True, True)]),
        "attn_period_4": (2, [(False, False), (False, True), (False, False), (True, True)]),
        "two_attn_slots": (2, [(False, False), (True, False), (False, False), (True, True)]),
    }


@pytest.mark.parametrize("variant", VARIANTS)
def test_param_tree_and_counts_match_reference(variant):
    """The port's own init has the reference's paths, shapes and dtypes,
    and both parameter counts equal the reference's."""
    jc, tc, jm, tm, jp, tp = _pair(variant)
    want = [(jax.tree_util.keystr(k), v.shape, str(v.dtype))
            for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]]
    own = tm.init(torch.Generator().manual_seed(0), "cpu")
    for tree in (tp, own):
        got = [(keystr(k), tuple(v.shape), str(v.dtype)[6:])
               for k, v in tree_flatten_with_path(tree)[0]]
        assert got == want
    sb = H._superblock_len(tc)
    assert sorted(own["superblocks"]) == [f"l{i}" for i in range(sb)]
    assert all(sorted(own["superblocks"][f"l{i}"]) == ["ffn", "mixer", "norm1", "norm2"]
               for i in range(sb))
    assert tm.param_count(own) == tm.param_count(tp) == jm.param_count(jp)
    assert tm.active_param_count(own) == jm.active_param_count(jp)


def _meta_normal(gen, shape, scale, dtype, device):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("overrides,count", [
    ({"n_layers": 8}, 45_144_659_968),                     # one superblock at full width
    ({"n_layers": 8, "n_experts": 4}, 16_153_237_504),     # the card's serving cut
    ({"n_layers": 8, "d_ff": 1024}, 5_785_311_232),        # the card's training cut
])
def test_full_width_param_counts_match_reference(overrides, count, monkeypatch):
    """jamba at its published widths, one superblock deep, and the two cuts
    the card runs: the reference's count from shapes alone
    (``jax.eval_shape``) and the port's from an init on the ``meta`` device
    (its random draws replaced by empty tensors, since the full model's
    draws would take 90 GB of host memory)."""
    from repro_torch.models import layers, mamba2, moe

    jc = jax_config(ARCH).with_overrides(**overrides)
    shapes = jax.eval_shape(lambda: jax_model(jc).init(jax.random.PRNGKey(0)))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    for mod in (layers, mamba2, moe):
        monkeypatch.setattr(mod, "_normal", _meta_normal)
    tm = get_model(get_config(ARCH).with_overrides(**overrides))
    meta = tm.init(torch.Generator(), "meta")
    assert tm.param_count(meta) == want == count
    assert tm.active_param_count(meta) == count   # the reference's rule: 4-D expert leaves


@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_matches_reference(variant):
    """Logits and the routers' summed aux loss of ``hybrid_forward``, and
    the family's prefill and loss, from the same weights and tokens."""
    jc, tc, jm, tm, jp, tp = _pair(variant, seed=1)
    jb, tb = _batches(tc, 2, 2 * tc.ssm_chunk, seed=1)
    logits, aux = H.hybrid_forward(tp, tb["tokens"], tc)
    jlogits, jaux = JH.hybrid_forward(jp, jb["tokens"], jc)
    assert logits.dtype == torch.float32 and tuple(logits.shape) == jlogits.shape
    assert aux.dtype == torch.float32 and aux.shape == () and float(aux) > 0
    _close_logits(logits, jlogits)
    _close(aux, jaux)
    _close_logits(tm.prefill(tp, tb), jm.prefill(jp, jb))
    _close(tm.loss(tp, tb), jm.loss(jp, jb))


@pytest.mark.parametrize("variant", VARIANTS)
def test_loss_and_gradient_match_reference(variant):
    """Autograd of the port's loss (NLL + router_aux_coef x aux) against
    ``jax.value_and_grad`` of the reference's: the loss within 1e-5, each
    leaf's gradient within GRAD_TOL relative L2."""
    jc, tc, jm, tm, jp, tp = _pair(variant, seed=2)
    jb, tb = _batches(tc, 2, tc.ssm_chunk, seed=2)
    jloss, jg = jax.value_and_grad(lambda p: jm.loss(p, jb))(jp)
    leaves, treedef = tree_flatten(tp)
    live = [t.detach().requires_grad_(True) for t in leaves]
    loss = tm.loss(tree_unflatten(treedef, live), tb)
    grads = torch.autograd.grad(loss, live)
    _close(loss, jloss)
    names = [keystr(k) for k, _ in tree_flatten_with_path(tp)[0]]
    jleaves = jax.tree.leaves(jg)
    assert len(grads) == len(jleaves)
    for name, g, w in zip(names, grads, jleaves):
        assert tuple(g.shape) == w.shape, name
        assert _rel_l2(g.numpy(), w) <= GRAD_TOL[variant], name


@pytest.mark.parametrize("variant", VARIANTS)
def test_decode_steps_match_reference(variant):
    """The cache's keys, shapes and dtypes, then 4 decode steps from an
    empty cache: every step's logits and the caches after them (written in
    place in the port)."""
    jc, tc, jm, tm, jp, tp = _pair(variant, seed=3)
    jcache, tcache = jm.init_cache(2, 6), tm.init_cache(2, 6, "cpu")
    assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in tcache.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in jcache.items()}
    n_sb = tc.n_layers // H._superblock_len(tc)
    n_attn = sum(a for a, _ in H._layer_kinds(tc, H._superblock_len(tc)))
    assert tcache["k"].shape[:2] == (n_sb, n_attn) and tcache["ssm"].dtype == torch.float32
    toks = np.random.default_rng(3).integers(0, tc.vocab_size, (2, 4))
    jstep, tstep = jax_serve_step(jm), make_serve_step(tm)
    for t in range(4):
        tok = toks[:, t:t + 1]
        jl, jcache = jstep(jp, jcache, jnp.asarray(tok, jnp.int32), jnp.int32(t))
        tl, same = tstep(tp, tcache, torch.from_numpy(tok), t)
        assert same is tcache and tuple(tl.shape) == (2, 1, tc.vocab_size)
        _close_logits(tl, jl)
    for name in tcache:
        _close(tcache[name], jcache[name])


@pytest.mark.parametrize("variant", VARIANTS)
def test_prefill_agrees_with_token_by_token_serving(variant):
    """The prefill logits of a prompt equal those of serving it token by
    token through ``generate`` (fp32: the same arithmetic in another
    order), at the capacity factor E/K, where the prefill drops no
    assignment, as decoding one token never does."""
    _, tc, _, _, _, tp = _pair(variant, seed=4)
    tc = tc.with_overrides(moe_capacity_factor=tc.n_experts / tc.top_k)
    tm = get_model(tc)
    prompt = torch.from_numpy(np.random.default_rng(4).integers(0, tc.vocab_size,
                                                                (2, tc.ssm_chunk)))
    want = tm.prefill(tp, {"tokens": prompt})
    res = serve.generate(tm, tp, prompt, 3, keep_prompt_logits=True)
    assert tuple(res.tokens.shape) == (2, 3)
    _close(res.prompt_logits, want.numpy(), 1e-4)


def test_train_step_matches_reference():
    """Two ``make_train_step`` steps (AdamW, the config's bf16 moments)
    against the reference's: the losses within 1e-5 relative, the
    parameters as ``_close_vectors`` holds them."""
    from repro.launch.steps import make_optimizer_for as jax_optimizer_for
    from repro.launch.steps import make_train_step as jax_train_step

    jc, tc, jm, tm, jp, tp = _pair(seed=5)
    assert tc.optimizer_state_dtype == "bfloat16"
    jopt, topt = jax_optimizer_for(jc), make_optimizer_for(tc)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    jstep, tstep = jax.jit(jax_train_step(jm, jopt)), make_train_step(tm, topt)
    for step in range(2):
        jb, tb = _batches(tc, 2, tc.ssm_chunk, seed=10 + step)
        jp, jstate, jloss = jstep(jp, jstate, jb)
        tp, tstate, tloss = tstep(tp, tstate, tb)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=TOL)
    leaves, jleaves = tree_flatten(tp)[0], jax.tree.leaves(jp)
    assert [tuple(a.shape) for a in leaves] == [b.shape for b in jleaves]
    _close_vectors(leaves, jleaves)


def test_serve_driver_tokens_match_reference(capsys):
    """The reference's serve driver and the port's ``generate`` from the
    reference's weights and the same prompt: the same greedy tokens, and
    every prompt position's logits."""
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
    _close_logits(res.prompt_logits, np.concatenate(jlogits, 1))


def test_serve_main_runs_on_cpu(capsys):
    assert serve.main(["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len", "4",
                       "--decode-tokens", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"arch={ARCH}-reduced" in out and "device=cpu" in out
    assert len(eval(out.split("generated token ids (first sequence):")[1])) == 3


def test_trainer_exits_as_the_reference_does(capsys):
    """``--arch jamba-1.5-large-398b --reduced --device cpu``: the port's
    trainer runs and exits as the reference's does (0 only if the loss
    fell)."""
    argv = ["--arch", ARCH, "--reduced", "--steps", "8", "--batch", "2", "--seq", "32",
            "--log-every", "4"]
    rc = train.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}-reduced" in out and "device=cpu" in out and "done: loss" in out
    assert rc == jax_train.main(argv)


def test_kernel_launches_on_the_cpu_are_zero():
    """On CPU tensors the attention and the scan are the plain versions: a
    prefill and a train step launch no kernel."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan, ssd_intra_chunk_bwd

    wrappers = (flash_attention, flash_attention_bwd, ssd_chunk_scan, ssd_intra_chunk_bwd)
    _, tc, _, tm, _, tp = _pair()
    _, tb = _batches(tc, 2, tc.ssm_chunk, seed=6)
    before = [w.launches for w in wrappers]
    tm.prefill(tp, tb)
    opt = make_optimizer_for(tc)
    make_train_step(tm, opt)(tp, opt.init(tp), tb)
    assert [w.launches for w in wrappers] == before


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("variant", VARIANTS)
def test_card_matches_cpu(variant):
    """Card only: the variant in fp32 from the same weights on the card
    (one flash and one SSD scan launch an attention and a Mamba layer in a
    prefill, and as many backward launches in a train step's gradient) and
    on the CPU: prefill logits within 1e-4, the loss within 1e-4 relative
    and every leaf's gradient within 1e-4 relative L2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan, ssd_intra_chunk_bwd
    from repro_torch.utils.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    wrappers = (flash_attention, ssd_chunk_scan, flash_attention_bwd, ssd_intra_chunk_bwd)
    _, tc, _, tm, _, tp = _pair(variant, seed=6)
    _, tb = _batches(tc, 2, 2 * tc.ssm_chunk, seed=7)
    n_sb = tc.n_layers // H._superblock_len(tc)
    n_attn = n_sb * sum(a for a, _ in H._layer_kinds(tc, H._superblock_len(tc)))
    runs = {}
    for device in ("cuda", "cpu"):
        p = tree_map(lambda t: t.to(device), tp)
        b = tree_map(lambda t: t.to(device), tb)
        before = [w.launches for w in wrappers]
        with torch.no_grad():
            logits = tm.prefill(p, b)
        leaves, treedef = tree_flatten(p)
        live = [t.detach().requires_grad_(True) for t in leaves]
        loss = tm.loss(tree_unflatten(treedef, live), b)
        grads = torch.autograd.grad(loss, live)
        runs[device] = (logits.cpu(), float(loss), [g.cpu() for g in grads],
                        [w.launches - n for w, n in zip(wrappers, before)])
    (cl, closs, cg, cn), (pl, ploss, pg, pn) = runs["cuda"], runs["cpu"]
    n_mamba = tc.n_layers - n_attn
    assert cn == [2 * n_attn, 2 * n_mamba, n_attn, n_mamba] and pn == [0, 0, 0, 0]
    assert torch.allclose(cl, pl, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(closs, ploss, rtol=1e-4)
    for a, b in zip(cg, pg):
        assert _rel_l2(a.numpy(), b.numpy()) <= 1e-4
