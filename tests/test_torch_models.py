"""The port's FL models against the reference's, on the reference's
initial weights (carried over path by path) and the same numpy inputs.

Forward outputs agree to 1e-5.  Loss and gradients agree to 1e-4: the
backward passes sum the same products in other orders (XLA's conv and
dot transposes vs PyTorch's), and a gradient leaf sums over the whole
batch, so fp32 rounding differences grow with the fan-in."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import fl_models as ref
from repro_torch.convert import params_from_numpy
from repro_torch.models import fl_models as port
from repro.checkpoint.serializer import _path_str
from repro_torch.utils.tree import (
    path_str,
    tree_flatten_with_path,
    tree_leaves,
    tree_structure,
    tree_unflatten,
)

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


def _femnist():
    cfg_kw = dict(n_fc=2, fc_width=64)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 62, 5).astype(np.int32)
    return (ref.FemnistConfig(**cfg_kw), port.FemnistConfig(**cfg_kw),
            ref.init_femnist_cnn, ref.femnist_forward, port.femnist_forward, x, y)


def _vgg():
    cfg_kw = dict(image_size=32, stages=((8, 2), (16, 2), (16, 1)), fc_width=32, n_classes=2)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 2, 3).astype(np.int32)
    return (ref.VGGConfig(**cfg_kw), port.VGGConfig(**cfg_kw),
            ref.init_vgg16, ref.vgg16_forward, port.vgg16_forward, x, y)


_CNNS = {"femnist": _femnist, "vgg16": _vgg}


def _carry(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


def _grads_close(tgrads, jgrads):
    pairs, _ = tree_flatten_with_path(tgrads)
    for (path, t), j in zip(pairs, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=path_str(path))


def _port_grads(loss_fn, params):
    pairs, _ = tree_flatten_with_path(params)
    live = [t.detach().requires_grad_(True) for _, t in pairs]
    tree = tree_unflatten(tree_structure(params), live)
    loss = loss_fn(tree)
    grads = torch.autograd.grad(loss, live)
    return loss.detach(), tree_unflatten(tree_structure(params), list(grads))


@pytest.mark.parametrize("name", sorted(_CNNS))
def test_cnn_forward_matches(name):
    jcfg, tcfg, init, jfwd, tfwd, x, _ = _CNNS[name]()
    jparams = init(jax.random.PRNGKey(0), jcfg)
    want = np.asarray(jax.jit(jfwd, static_argnums=2)(jparams, jnp.asarray(x), jcfg))
    got = tfwd(_carry(jparams), torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("name", sorted(_CNNS))
def test_cnn_loss_and_grads_match(name):
    jcfg, tcfg, init, jfwd, tfwd, x, y = _CNNS[name]()
    jparams = init(jax.random.PRNGKey(1), jcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: ref.softmax_cross_entropy(jfwd(p, jnp.asarray(x), jcfg), jnp.asarray(y))
    ))(jparams)
    tloss, tgrads = _port_grads(
        lambda p: port.softmax_cross_entropy(tfwd(p, torch.from_numpy(x), tcfg),
                                             torch.from_numpy(y)),
        _carry(jparams),
    )
    np.testing.assert_allclose(float(tloss), float(jloss), atol=GRAD_TOL, rtol=GRAD_TOL)
    _grads_close(tgrads, jgrads)


def _lstm_setup():
    kw = dict(vocab_size=20, embed_dim=8, hidden=16, n_layers=2)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 20, (4, 9)).astype(np.int32)
    labels = rng.integers(0, 20, (4, 9)).astype(np.int32)
    return ref.LSTMConfig(**kw), port.LSTMConfig(**kw), toks, labels


def test_lstm_forward_matches():
    jcfg, tcfg, toks, _ = _lstm_setup()
    jparams = ref.init_shakespeare_lstm(jax.random.PRNGKey(2), jcfg)
    want = np.asarray(ref.shakespeare_forward(jparams, jnp.asarray(toks), jcfg))
    got = port.shakespeare_forward(_carry(jparams), torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=FWD_TOL, rtol=FWD_TOL)


def test_lstm_loss_and_grads_match():
    jcfg, tcfg, toks, labels = _lstm_setup()
    jparams = ref.init_shakespeare_lstm(jax.random.PRNGKey(3), jcfg)
    jloss, jgrads = jax.value_and_grad(
        lambda p: ref.shakespeare_loss(p, jnp.asarray(toks), jnp.asarray(labels), jcfg)
    )(jparams)
    tloss, tgrads = _port_grads(
        lambda p: port.shakespeare_loss(p, torch.from_numpy(toks), torch.from_numpy(labels), tcfg),
        _carry(jparams),
    )
    np.testing.assert_allclose(float(tloss), float(jloss), atol=GRAD_TOL, rtol=GRAD_TOL)
    _grads_close(tgrads, jgrads)


@pytest.mark.parametrize("which", ["femnist", "vgg16", "lstm"])
def test_init_trees_match_reference_layout(which):
    """Same paths, shapes and dtypes as the reference's init (values differ:
    torch.Generator and jax.random draw other numbers)."""
    gen = torch.Generator().manual_seed(0)
    if which == "femnist":
        jcfg, tcfg = ref.FemnistConfig(n_fc=3, fc_width=32), port.FemnistConfig(n_fc=3, fc_width=32)
        j, t = ref.init_femnist_cnn(jax.random.PRNGKey(0), jcfg), port.init_femnist_cnn(gen, tcfg, "cpu")
    elif which == "vgg16":
        kw = dict(image_size=32, stages=((8, 1), (8, 1)), fc_width=16)
        j = ref.init_vgg16(jax.random.PRNGKey(0), ref.VGGConfig(**kw))
        t = port.init_vgg16(gen, port.VGGConfig(**kw), "cpu")
    else:
        kw = dict(vocab_size=11, hidden=8)
        j = ref.init_shakespeare_lstm(jax.random.PRNGKey(0), ref.LSTMConfig(**kw))
        t = port.init_shakespeare_lstm(gen, port.LSTMConfig(**kw), "cpu")
    jpairs = jax.tree_util.tree_flatten_with_path(j)[0]
    tpairs, _ = tree_flatten_with_path(t)
    assert [path_str(p) for p, _ in tpairs] == [_path_str(p) for p, _ in jpairs]
    for (_, a), (_, b) in zip(tpairs, jpairs):
        assert tuple(a.shape) == b.shape and str(a.dtype)[6:] == b.dtype.name
    assert all(leaf.device.type == "cpu" for leaf in tree_leaves(t))


def test_paper_femnist_width_parameter_count():
    """FemnistConfig() is the paper's 2 conv + 10 x 4096 FC: L = 164,187,070
    (counted from shapes, without allocating the model)."""
    cfg = port.FemnistConfig()
    feat = (cfg.image_size // 4) ** 2 * 64
    widths = [feat] + [cfg.fc_width] * cfg.n_fc + [cfg.n_classes]
    conv = 5 * 5 * 1 * 32 + 32 + 5 * 5 * 32 * 64 + 64
    dense = sum(a * b + b for a, b in zip(widths[:-1], widths[1:]))
    assert conv + dense == 164_187_070
