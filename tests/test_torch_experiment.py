"""The same ``Experiment`` chain served by both packages.

Each chain below is built once on the reference's builder and once on the
port's, and ``.serve()`` gets equivalent clients: three FEMNIST-shaped
silos (28 x 28 x 1 images, 62 classes; a reduced CNN, 2 conv + 1 x 32
FC) with the same numpy data, trained by each package's ``FLClient``
with SGD-momentum at lr 1e-3 from the reference's initial weights.  The
chains cover the in-process targets the builder makes: the barrier
(``AsyncFLServer`` with the degenerate fold), deadline rounds with a
carried silo, int8 updates and the two-level hierarchy.  After 2 rounds
the final weights agree within 1e-5 (the frameworks' gradients differ
at rounding level, ~1e-7 here), the message logs are equal byte for byte
and the trace signatures (event, round, task, attempt) are equal, as
tests/test_control_plane.py holds the builder against a hand-built
server.  The port's servers hold their weights on the device ``serve``
is given.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as rcore
from repro.data import make_classification_silos as jax_silos
from repro.federated import DeterministicSchedule as JaxDeterministic
from repro.federated import FLClient as JaxClient
from repro.models import fl_models as jm
from repro.optim import make_optimizer as jax_make_optimizer
from repro_torch import core as tcore
from repro_torch.convert import params_from_numpy
from repro_torch.data import make_classification_silos
from repro_torch.federated import AsyncFLServer, DeterministicSchedule, FLClient
from repro_torch.federated.hierarchy import HierarchicalFLServer
from repro_torch.models import fl_models as tm
from repro_torch.optim import make_optimizer
from repro_torch.utils.tree import tree_leaves

SAMPLES = [(48, 16), (32, 16), (40, 32)]
ROUNDS = 2
LR = 1e-3
PARAM_TOL = 1e-5
DELAYS = {"client_0": 1.0, "client_1": 1.5, "client_2": 6.0}

# name -> (chain on either package's Experiment, the serve kwargs that
# are package-neutral, whether the round runs on a DeterministicSchedule)
CHAINS = {
    "barrier": (lambda exp: exp, {}, False),
    "deadline": (lambda exp: exp.async_rounds(deadline=3.0, min_clients=2, escalate_after=2),
                 {"fold_cost_s": 0.01}, True),
    "int8": (lambda exp: exp.aggregation(compression="int8"), {}, False),
    "hierarchy": (lambda exp: exp.hierarchy(regions=2), {"fold_cost_s": 0.01}, False),
}


@functools.lru_cache(maxsize=None)
def _jax_clients():
    """The reference's clients, built once: an ``FLClient`` keeps no state
    across rounds, and each new one would compile its steps again."""
    cfg = jm.FemnistConfig(n_fc=1, fc_width=32)

    def loss_fn(p, b):
        return jm.softmax_cross_entropy(jm.femnist_forward(p, b[0], cfg), b[1])

    def eval_fn(p, b):
        logits = jm.femnist_forward(p, b[0], cfg)
        n = b[0].shape[0]
        return {"acc_sum": jnp.mean((jnp.argmax(logits, -1) == b[1]).astype(jnp.float32)) * n,
                "loss_sum": jm.softmax_cross_entropy(logits, b[1]) * n}

    opt = jax_make_optimizer("sgdm", LR)
    return tuple(JaxClient(s.client_id, s, loss_fn, opt, batch_size=16, eval_fn=eval_fn,
                           batch_fn=lambda b: (jnp.asarray(b[0]), jnp.asarray(b[1])))
                 for s in jax_silos(3, 62, (28, 28, 1), SAMPLES, seed=0))


def _port_clients():
    cfg = tm.FemnistConfig(n_fc=1, fc_width=32)

    def loss_fn(p, b):
        return tm.softmax_cross_entropy(tm.femnist_forward(p, b[0], cfg), b[1])

    def eval_fn(p, b):
        logits = tm.femnist_forward(p, b[0], cfg)
        n = b[0].shape[0]
        return {"acc_sum": (logits.argmax(-1) == b[1]).float().mean() * n,
                "loss_sum": tm.softmax_cross_entropy(logits, b[1]) * n}

    opt = make_optimizer("sgdm", LR)
    return [FLClient(s.client_id, s, loss_fn, opt, batch_size=16, eval_fn=eval_fn, device="cpu")
            for s in make_classification_silos(3, 62, (28, 28, 1), SAMPLES, seed=0)]


def signature(trace):
    return [(type(e).__name__, getattr(e, "round_idx", None), getattr(e, "task", None),
             getattr(e, "attempt", None)) for e in trace]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's port runs: their ops are
    small, and the suite's parallel workers would otherwise oversubscribe
    the cores many times over (each torch process starts a thread a
    core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params0():
    return jax.tree.map(np.asarray, jm.init_femnist_cnn(jax.random.PRNGKey(0),
                                                        jm.FemnistConfig(n_fc=1, fc_width=32)))


@pytest.fixture(scope="module", params=sorted(CHAINS))
def served(request, params0):
    name = request.param
    chain, kwargs, scheduled = CHAINS[name]
    jkw, tkw = dict(kwargs), dict(kwargs)
    if scheduled:
        jkw["schedule"], tkw["schedule"] = JaxDeterministic(DELAYS), DeterministicSchedule(DELAYS)
    jserver = chain(rcore.Experiment()).serve(
        list(_jax_clients()), jax.tree.map(jnp.asarray, params0), measure_round_messages=True,
        **jkw)
    tserver = chain(tcore.Experiment()).serve(
        _port_clients(), params_from_numpy(params0, device="cpu"), measure_round_messages=True,
        device="cpu", **tkw)
    return name, jserver, jserver.run(ROUNDS), tserver, tserver.run(ROUNDS)


def test_serve_builds_the_target_the_chain_names(served):
    name, jserver, _, tserver, _ = served
    assert type(tserver).__name__ == type(jserver).__name__
    assert isinstance(tserver, HierarchicalFLServer if name == "hierarchy" else AsyncFLServer)
    assert tserver.device.type == "cpu"
    assert (tserver._compression is None) == (name != "int8")


def test_served_params_agree_with_reference(served):
    _, _, jres, _, tres = served
    got, want = tree_leaves(tres.final_params), jax.tree.leaves(jres.final_params)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "cpu"
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=PARAM_TOL, atol=PARAM_TOL)
    for t, j in zip(tres.rounds, jres.rounds):
        assert t.metrics["loss"] == pytest.approx(j.metrics["loss"], rel=PARAM_TOL)
        assert (t.carried_over, t.carried_in) == (j.carried_over, j.carried_in)


def test_served_message_logs_and_traces_equal_reference(served):
    name, jserver, jres, tserver, tres = served
    assert [dataclasses.asdict(r.message_log) for r in tres.rounds] == \
        [dataclasses.asdict(r.message_log) for r in jres.rounds]
    assert signature(tserver.bus.trace) == signature(jserver.bus.trace)
    names = {n for n, *_ in signature(tserver.bus.trace)}
    if name == "deadline":
        assert tres.rounds[0].carried_over == ["client_2"]
        assert "DeadlineExpired" in names
    if name == "hierarchy":
        assert {"RegionClosed", "PartialFolded"} <= names

