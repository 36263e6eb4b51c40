"""Quickstart on PyTorch: end-to-end Cross-Silo FL training with Multi-FedLS.

The PyTorch package's run of ``examples/quickstart.py``, step for step:
  1. Pre-Scheduling  — slowdown metrics for the CloudLab testbed
  2. Initial Mapping — MILP placement of server + 3 clients
  3. FL execution    — REAL federated training (Shakespeare-style LSTM on
                       synthetic silos) with FedAvg, per-round client
                       checkpoints, server checkpoints every 2 rounds
  4. Fault + recover — kills the server mid-run, restores from the
                       freshest checkpoint (paper §4.3 semantics)

It runs on the card (each barrier round folds through the hand-written
``fedavg_reduce`` kernel) unless the caller asks for the CPU:

  PYTHONPATH=src python examples/quickstart_torch.py            # the card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import dataclasses
import os
import sys
import tempfile
from typing import Any, Callable, List, Optional, Union

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.checkpoint import ClientCheckpointManager, ServerCheckpointManager
from repro_torch.core import SERVER, InitialMapping, cloudlab_environment, til_application
from repro_torch.core.initial_mapping import MappingSolution
from repro_torch.data import make_lm_silos
from repro_torch.federated import FLClient, FLRunResult, FLServer
from repro_torch.models.fl_models import (
    LSTMConfig,
    init_shakespeare_lstm,
    shakespeare_forward,
    shakespeare_loss,
)
from repro_torch.optim import make_optimizer

# The example's own reduced model; LSTMConfig() is the paper's
# Shakespeare width (embedding 8, 2 x 256 LSTM, 80 characters).
QUICKSTART_LSTM = LSTMConfig(vocab_size=64, hidden=64)
N_ROUNDS = 6
FAULT_ROUND = 4


@dataclasses.dataclass
class QuickstartResult:
    mapping: MappingSolution
    run: FLRunResult
    clients: List[FLClient]


def main(
    device: Union[str, torch.device] = "cuda",
    lc: LSTMConfig = QUICKSTART_LSTM,
    params0: Optional[Any] = None,
    log: Callable[[str], None] = print,
    post_round_hook: Optional[Callable[[int, Any], Optional[Any]]] = None,
) -> QuickstartResult:
    """Run the quickstart.  ``params0`` (a tree of tensors, any device)
    replaces the seed-0 initial weights; ``post_round_hook`` goes to the
    server (called as ``hook(round_idx, params)`` after each fold)."""
    # ---- 1+2: resource management (the paper's contribution) -------------
    env = cloudlab_environment()          # Table 2 testbed w/ Table 3/4 slowdowns
    app = til_application(n_rounds=10)
    sol = InitialMapping(env, app, alpha=0.5).solve()
    log("== Initial Mapping (paper §5.4) ==")
    log(f"  server  -> {sol.vm_of(SERVER)}")
    for c in app.clients:
        log(f"  {c.client_id} -> {sol.vm_of(c.client_id)}")
    ev = sol.evaluation
    log(f"  modeled round: {ev.makespan_s:.1f}s; 10 rounds = "
        f"{ev.makespan_s*10/60:.1f} min (paper: 22:38)")

    # ---- 3: real FL training over synthetic silos -------------------------
    log("\n== Federated training (3 silos, LSTM) ==")
    silos = make_lm_silos(3, lc.vocab_size, 24, [(96, 24)] * 3, seed=0)
    opt = make_optimizer("adamw", 5e-3)

    def loss_fn(p, batch):
        toks, labels = batch
        return shakespeare_loss(p, toks, labels, lc)

    def eval_fn(p, batch):
        toks, labels = batch
        logits = shakespeare_forward(p, toks, lc)
        pred = logits.argmax(-1)
        n = toks.shape[0]
        return {
            "acc_sum": (pred == labels.long()).float().mean() * n,
            "loss_sum": shakespeare_loss(p, toks, labels, lc) * n,
        }

    clients = [
        FLClient(s.client_id, s, loss_fn, opt, batch_size=24, local_epochs=2,
                 eval_fn=eval_fn, device=device)
        for s in silos
    ]
    if params0 is None:
        params0 = init_shakespeare_lstm(torch.Generator().manual_seed(0), lc, device=device)

    with tempfile.TemporaryDirectory() as d:
        sck = ServerCheckpointManager(
            os.path.join(d, "server_local"), os.path.join(d, "stable_storage"),
            interval_rounds=2,
        )
        ccks = {
            c.client_id: ClientCheckpointManager(os.path.join(d, c.client_id))
            for c in clients
        }

        # ---- 4: kill the server at round 4, recover, keep going ----------
        killed = []

        def fault_hook(round_idx):
            if round_idx == FAULT_ROUND and not killed:
                killed.append(round_idx)
                log("  !! server VM revoked — recovering from freshest checkpoint")
                return "s"
            return None

        server = FLServer(
            clients, params0, server_ckpt=sck, client_ckpts=ccks,
            fault_hook=fault_hook, measure_round_messages=True,
            post_round_hook=post_round_hook, device=device,
        )
        res = server.run(N_ROUNDS)
        for r in res.rounds:
            extra = f" (restored from {r.restarted_from})" if r.restarted_from else ""
            log(f"  round {r.round_idx}: loss={r.metrics['loss']:.3f} "
                f"acc={r.metrics['acc']:.3f}{extra}")
        msg = res.rounds[-1].message_log
        log(f"  round message volume: {msg.total_bytes(len(clients))/1e6:.2f} MB "
            f"({msg.s_msg_train_bytes/1e3:.0f} kB weights x3 + metrics)")
        sck.wait_for_transfers()

    first, last = res.rounds[0].metrics["loss"], res.rounds[-1].metrics["loss"]
    log(f"\nloss {first:.3f} -> {last:.3f} across {N_ROUNDS} rounds with 1 server fault: "
        f"{'OK' if last < first else 'no improvement?'}")
    return QuickstartResult(mapping=sol, run=res, clients=clients)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
