"""Training the zoo: the port's ``make_train_step`` and trainer against the
reference's.

Reduced olmo-1b, mamba2-130m and granite-moe-1b-a400m in fp32 start from the reference's
weights (carried over by path) and take the same numpy-seeded batches
through both packages' ``make_train_step`` with ``make_optimizer_for``
(AdamW at 3e-4): losses after each of 3 steps within 1e-5 relative, and
every parameter leaf within 1e-5 relative L2 (||port - ref|| / ||ref||).
The leaf norm, not each element: AdamW divides by sqrt(v), so an element
whose gradient is at the rounding floor of either framework (|g| ~ 1e-9)
steps by about lr either way, and one such element in 131,072 differs by
4e-6 after 3 steps; everywhere else both do the same fp32 arithmetic
summed in other orders.  Gradient accumulation over 2 microbatches
agrees with one batch the same way.
On the CPU the attention is the plain version, differentiated by
autograd, as the reference differentiates its plain attention.
Reduced jamba-1.5-large-398b joins the trainer's and the card's tests;
its config keeps AdamW's moments in bf16, which the per-leaf 1e-5 does
not allow for, so ``tests/test_torch_hybrid.py`` holds its train steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import train as jax_train
from repro.launch.steps import make_optimizer_for as jax_optimizer_for
from repro.launch.steps import make_train_step as jax_train_step
from repro.models import get_model as jax_model
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import train
from repro_torch.launch.steps import make_optimizer_for, make_train_step
from repro_torch.models import get_model
from repro_torch.utils.tree import tree_flatten

TOL = 1e-5
FAMILIES = ["olmo-1b", "mamba2-130m", "granite-moe-1b-a400m", "jamba-1.5-large-398b"]


def _pair(arch):
    kw = dict(dtype="float32", param_dtype="float32")
    jc = jax_config(arch).reduced().with_overrides(**kw)
    tc = get_config(arch).reduced().with_overrides(**kw)
    jm, tm = jax_model(jc), get_model(tc)
    jp = jm.init(jax.random.PRNGKey(0))
    return jc, tc, jm, tm, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _batch(cfg, batch, seq, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, seq + 1))
    x, y = toks[:, :-1], toks[:, 1:]
    return ({"tokens": jnp.asarray(x, jnp.int32), "labels": jnp.asarray(y, jnp.int32)},
            {"tokens": torch.from_numpy(x), "labels": torch.from_numpy(y)})


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _assert_params_close(got, want):
    leaves, jleaves = tree_flatten(got)[0], jax.tree.leaves(want)
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        assert tuple(a.shape) == b.shape
        assert _rel_l2(a.numpy(), b) <= TOL


@pytest.mark.parametrize("arch", FAMILIES[:3])
def test_train_steps_match_reference(arch):
    jc, tc, jm, tm, jp, tp = _pair(arch)
    seq = 2 * tc.ssm_chunk if tc.arch_type in ("ssm", "hybrid") else 16
    jopt, topt = jax_optimizer_for(jc), make_optimizer_for(tc)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    jstep = jax.jit(jax_train_step(jm, jopt))
    tstep = make_train_step(tm, topt)
    for step in range(3):
        jb, tb = _batch(tc, 2, seq, seed=step)
        jp, jstate, jloss = jstep(jp, jstate, jb)
        tp, tstate, tloss = tstep(tp, tstate, tb)
        assert tloss.dtype == torch.float32 and tloss.shape == ()
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=TOL)
    _assert_params_close(tp, jp)
    assert tstate.step == 3


def test_microbatches_match_one_batch():
    _, tc, _, tm, _, tp = _pair("olmo-1b")
    _, tb = _batch(tc, 4, 16, seed=5)
    opt = make_optimizer_for(tc)
    p1, _, l1 = make_train_step(tm, opt)(tp, opt.init(tp), tb)
    p2, _, l2 = make_train_step(tm, opt, microbatches=2)(tp, opt.init(tp), tb)
    np.testing.assert_allclose(float(l2), float(l1), rtol=TOL)
    for a, b in zip(tree_flatten(p2)[0], tree_flatten(p1)[0]):
        assert _rel_l2(a.numpy(), b.numpy()) <= TOL
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(tm, opt, microbatches=3)(tp, opt.init(tp), tb)


def test_microbatch_accumulation_matches_reference():
    jc, tc, jm, tm, jp, tp = _pair("olmo-1b")
    jb, tb = _batch(tc, 4, 16, seed=6)
    jopt, topt = jax_optimizer_for(jc), make_optimizer_for(tc)
    jp2, _, jloss = jax.jit(jax_train_step(jm, jopt, microbatches=2))(jp, jopt.init(jp), jb)
    tp2, _, tloss = make_train_step(tm, topt, microbatches=2)(tp, topt.init(tp), tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=TOL)
    _assert_params_close(tp2, jp2)


def test_train_step_leaves_its_inputs_untouched():
    _, tc, _, tm, _, tp = _pair("olmo-1b")
    before = [x.clone() for x in tree_flatten(tp)[0]]
    opt = make_optimizer_for(tc)
    make_train_step(tm, opt)(tp, opt.init(tp), _batch(tc, 2, 8, seed=0)[1])
    for a, b in zip(tree_flatten(tp)[0], before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", FAMILIES)
def test_trainer_exit_code_matches_reference(arch, capsys):
    """``--reduced --device cpu``: the port's trainer exits as the
    reference's does (0 only if the loss fell) and reports both losses."""
    argv = ["--arch", arch, "--reduced", "--steps", "16", "--batch", "4", "--seq", "32",
            "--log-every", "8"]
    rc = train.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert f"arch={arch}-reduced" in out and "device=cpu" in out and "done: loss" in out
    assert rc == jax_train.main(argv)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_on_card_matches_cpu(arch):
    """Card only: one reduced fp32 train step on the card (the forward and
    backward kernels, one launch each a layer) against the same step on the
    CPU from the same weights: loss within 1e-4 relative and every leaf's
    gradient within 1e-4 relative L2; the updated parameters within 1e-4
    relative L2, leaf by leaf for olmo-1b and granite-moe-1b-a400m and as
    one vector for mamba2-130m and jamba (whose attention and Mamba layers
    launch one backward each).  AdamW's first step moves an element by
    about lr whatever its gradient's size, so an element whose gradient is
    near AdamW's eps moves by an amount the gradient's last bits decide;
    mamba2's ``conv_b`` starts at zero, so such elements are a visible
    share of its norm."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.ssd_scan import ssd_intra_chunk_bwd
    from repro_torch.utils.tree import tree_map, tree_unflatten

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced().with_overrides(dtype="float32", param_dtype="float32")
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(5), "cpu")
    seq = 2 * cfg.ssm_chunk if cfg.arch_type in ("ssm", "hybrid") else 64
    _, batch = _batch(cfg, 2, seq, seed=1)
    n_attn = (0 if cfg.arch_type == "ssm" else
              cfg.n_layers // cfg.attn_period if cfg.arch_type == "hybrid" else cfg.n_layers)
    bwds = (flash_attention_bwd, ssd_intra_chunk_bwd)
    runs = {}
    for device in ("cuda", "cpu"):
        p = tree_map(lambda t: t.to(device), params)
        b = tree_map(lambda t: t.to(device), batch)
        leaves, treedef = tree_flatten(p)
        live = [t.detach().requires_grad_(True) for t in leaves]
        grads = torch.autograd.grad(model.loss(tree_unflatten(treedef, live), b), live)
        opt = make_optimizer_for(cfg)
        before = [w.launches for w in bwds]
        new, _, loss = make_train_step(model, opt)(p, opt.init(p), b)
        runs[device] = ([t.cpu() for t in tree_flatten(new)[0]], [g.cpu() for g in grads],
                        float(loss), [w.launches - n for w, n in zip(bwds, before)])
    (got, got_g, got_loss, got_n), (want, want_g, want_loss, want_n) = runs["cuda"], runs["cpu"]
    assert (got_n, want_n) == ([n_attn, cfg.n_layers - n_attn], [0, 0])
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)
    for a, b in zip(got_g, want_g):
        assert _rel_l2(a.numpy(), b.numpy()) <= 1e-4
    if arch in ("olmo-1b", "granite-moe-1b-a400m"):
        for a, b in zip(got, want):
            assert _rel_l2(a.numpy(), b.numpy()) <= 1e-4
    else:
        assert _rel_l2(torch.cat([t.reshape(-1) for t in got]).numpy(),
                       torch.cat([t.reshape(-1) for t in want]).numpy()) <= 1e-4
