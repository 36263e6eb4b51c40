"""``examples/quickstart_torch.py`` against ``examples/quickstart.py``'s chain.

The JAX side is rebuilt here from the reference's own functions, step
for step as its example runs them: ``InitialMapping(cloudlab_environment(),
til_application(n_rounds=10), alpha=0.5).solve()``, three synthetic
Shakespeare silos (``LSTMConfig(vocab_size=64, hidden=64)``) trained by
``FLClient`` with AdamW at 5e-3 for 2 local epochs, ``FLServer`` with
client checkpoints every round and server checkpoints every 2, the
server killed at round 4 and restored from the freshest checkpoint.  The
port's ``main(device="cpu")`` starts from the reference's initial
weights, carried across leaf by leaf (``repro_torch.convert``).

Per-round losses agree within 1e-5 (the two frameworks' LSTM gradients
differ at rounding level; the six rounds' largest loss difference seen
is ~1e-6), the restore source is the same, and the placement, the
message sizes and the event sequence are equal.
"""
import dataclasses
import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ClientCheckpointManager, ServerCheckpointManager
from repro.core import SERVER, InitialMapping, cloudlab_environment, til_application
from repro.data import make_lm_silos
from repro.federated import FLClient, FLServer
from repro.models.fl_models import (
    LSTMConfig,
    init_shakespeare_lstm,
    shakespeare_forward,
    shakespeare_loss,
)
from repro.optim import make_optimizer
from repro_torch.convert import params_from_numpy
from repro_torch.utils.tree import tree_leaves

EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / "quickstart_torch.py"
LOSS_TOL = 1e-5


def _load_example():
    spec = importlib.util.spec_from_file_location("quickstart_torch", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_quickstart(tmp, lc, params0):
    """``examples/quickstart.py``'s steps 2-4 on the reference."""
    sol = InitialMapping(cloudlab_environment(), til_application(n_rounds=10), alpha=0.5).solve()
    silos = make_lm_silos(3, lc.vocab_size, 24, [(96, 24)] * 3, seed=0)
    opt = make_optimizer("adamw", 5e-3)

    def loss_fn(p, batch):
        toks, labels = batch
        return shakespeare_loss(p, toks, labels, lc)

    def eval_fn(p, batch):
        toks, labels = batch
        logits = shakespeare_forward(p, toks, lc)
        pred = jnp.argmax(logits, -1)
        n = toks.shape[0]
        return {"acc_sum": jnp.mean((pred == labels).astype(jnp.float32)) * n,
                "loss_sum": shakespeare_loss(p, toks, labels, lc) * n}

    clients = [FLClient(s.client_id, s, loss_fn, opt, batch_size=24, local_epochs=2,
                        batch_fn=lambda b: (jnp.asarray(b[0]), jnp.asarray(b[1])),
                        eval_fn=eval_fn) for s in silos]
    sck = ServerCheckpointManager(os.path.join(tmp, "server_local"),
                                  os.path.join(tmp, "stable_storage"), interval_rounds=2)
    ccks = {c.client_id: ClientCheckpointManager(os.path.join(tmp, c.client_id))
            for c in clients}
    killed = []

    def fault_hook(round_idx):
        if round_idx == 4 and not killed:
            killed.append(round_idx)
            return "s"
        return None

    server = FLServer(clients, params0, server_ckpt=sck, client_ckpts=ccks,
                      fault_hook=fault_hook, measure_round_messages=True)
    res = server.run(6)
    sck.wait_for_transfers()
    return sol, server, res


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
def runs(tmp_path_factory):
    example = _load_example()
    lc = LSTMConfig(vocab_size=64, hidden=64)
    assert dataclasses.asdict(example.QUICKSTART_LSTM) == dataclasses.asdict(lc)
    params0 = init_shakespeare_lstm(jax.random.PRNGKey(0), lc)
    sol, jserver, jres = _reference_quickstart(str(tmp_path_factory.mktemp("jax")), lc, params0)
    lines = []
    out = example.main(device="cpu", lc=example.QUICKSTART_LSTM,
                       params0=params_from_numpy(jax.tree.map(np.asarray, params0), device="cpu"),
                       log=lines.append)
    return example, sol, jres, out, lines


def test_quickstart_losses_match_reference(runs):
    example, _, jres, out, _ = runs
    assert len(out.run.rounds) == len(jres.rounds) == example.N_ROUNDS
    for t, j in zip(out.run.rounds, jres.rounds):
        assert t.round_idx == j.round_idx
        assert abs(t.metrics["loss"] - j.metrics["loss"]) <= LOSS_TOL, t.round_idx
    losses = [r.metrics["loss"] for r in out.run.rounds]
    assert losses[-1] < losses[0]


def test_quickstart_recovery_matches_reference(runs):
    example, _, jres, out, lines = runs
    assert [r.restarted_from for r in out.run.rounds] == [r.restarted_from for r in jres.rounds]
    assert out.run.rounds[example.FAULT_ROUND - 1].restarted_from == "client:client_0"
    assert any("recovering from freshest checkpoint" in line for line in lines)


def test_quickstart_mapping_and_messages_match_reference(runs):
    _, sol, jres, out, _ = runs
    assert {k: (v.vm_id, v.market) for k, v in out.mapping.placement.items()} == \
        {k: (v.vm_id, v.market) for k, v in sol.placement.items()}
    assert out.mapping.evaluation.objective == sol.evaluation.objective
    assert out.mapping.vm_of(SERVER) in ("vm_121", "vm_124")
    for t, j in zip(out.run.rounds, jres.rounds):
        assert dataclasses.asdict(t.message_log) == dataclasses.asdict(j.message_log)
    assert all(x.device.type == "cpu" for x in tree_leaves(out.run.final_params))
