"""One cross-silo FedAvg round, worked out plainly from the round's inputs.

Every silo starts from the round's global weights, takes its local AdamW
steps over its training batches (each step's loss and gradient in the
family's plain model), and ships its update; the server's new weights
are the mean of the silos' weights, each weighted by its number of
training samples (FedAvg).  With ``update: int8`` a silo ships its delta
against the global weights through the int8 block codec and the server
adds the weighted mean of the decoded deltas to the global weights.  With
``adapters`` only the LoRA factor leaves (``.lora_`` in their name) train,
ship and fold; every other leaf stays as it was.  The evaluation loss is
the mean over every test sample of every silo at the new weights.

``fault`` plants one of the faults the correctness check must catch, in
this reference put in the program's place: ``half_batch`` (each loss,
training or evaluation, over the first half of its batch's rows) and
``answer`` (the fold leaves the leaf that moves most at its old value).

``fold_rounds`` works out the fold stage by itself, from what the
program's silos shipped into it: the weighted mean, or with a codec the
encode with each silo's error feedback carried from round to round.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from .common import AdamW, Precision, block_roundtrip, build, flat, leaves

LossFn = Callable[..., torch.Tensor]
STEPS_FOLLOWED = 3   # each silo's change is also compared after its first three steps


def _half(batch):
    return tuple(t[: max(1, t.shape[0] // 2)] for t in batch)


def fedavg_round(params0: Any, silos: List[Any], cfg: Dict[str, Any], traffic: Dict[str, Any],
                 loss_fn: LossFn, prec: Precision, fault: Optional[str] = None) -> Dict[str, Any]:
    """The round's readings: each silo's step losses and first gradient's
    norm per trained leaf, each leaf's change norm, the evaluation loss."""
    hp = cfg["optimizer"]
    opt = AdamW(hp["lr"], hp["b1"], hp["b2"], hp["eps"], hp["weight_decay"])
    lora = traffic.get("adapters")
    pairs0 = leaves(params0)
    trained = [i for i, (path, _) in enumerate(pairs0)
               if lora is None or ".lora_" in path[-1]]
    base = flat([pairs0[i][1] for i in trained]) if traffic["update"] == "int8" else None
    batch = traffic["batch"]
    n_train = [sum(b[1].shape[0] for b in s.batches(batch, "train")) for s in silos]
    W = float(sum(n_train))
    dev = pairs0[0][1].device
    acc = torch.zeros(sum(pairs0[i][1].numel() for i in trained), device=dev)
    losses: List[List[float]] = []
    grad1: List[torch.Tensor] = []
    delta3: List[torch.Tensor] = []
    for silo, n in zip(silos, n_train):
        stored = [t for _, t in pairs0]
        m = {i: torch.zeros(stored[i].shape, dtype=torch.float32, device=dev) for i in trained}
        v = {i: torch.zeros_like(m[i]) for i in trained}
        seen: List[float] = []
        step = 0
        for _ in range(traffic["local_epochs"]):
            for b in silo.batches(batch, "train"):
                step += 1
                if step == STEPS_FOLLOWED + 1:
                    delta3.append(_change([stored[i] for i in trained],
                                          [pairs0[i][1] for i in trained]))
                live = [t.detach().float().requires_grad_(i in trained)
                        for i, t in enumerate(stored)]
                tree = build(list(zip([p for p, _ in pairs0], live)), params0)
                loss = loss_fn(tree, _half(b) if fault == "half_batch" else b, cfg, prec, lora)
                grads = torch.autograd.grad(loss, [live[i] for i in trained])
                del live, tree
                seen.append(float(loss.detach()))
                if step == 1:
                    grad1.append(torch.stack([g.norm() for g in grads]))
                for i, g in zip(trained, grads):
                    stored[i], m[i], v[i] = opt.step(stored[i], g, m[i], v[i], step)
                del grads
        losses.append(seen)
        x = flat([stored[i] for i in trained])
        if traffic["update"] == "int8":
            acc.add_(block_roundtrip(x - base), alpha=n)
        else:
            acc.add_(x, alpha=n / W)
        del stored, m, v, x
    if traffic["update"] == "int8":
        acc = base + acc * torch.tensor(1.0 / W, dtype=torch.float32)
    new = [t for _, t in pairs0]
    off = 0
    for i in trained:
        t = pairs0[i][1]
        new[i] = acc[off:off + t.numel()].view(t.shape).to(t.dtype)
        off += t.numel()
    del acc
    delta = _change(new, [t for _, t in pairs0])
    if fault == "answer":
        j = int(delta.argmax())
        new[j] = pairs0[j][1]
        delta[j] = 0.0
    params1 = build(list(zip([p for p, _ in pairs0], new)), params0)
    eval_loss = evaluate(params1, silos, cfg, traffic, loss_fn, prec, fault)
    return {"losses": losses, "grad1": torch.stack(grad1).cpu(), "delta3": _stack(delta3),
            "delta": delta.cpu(), "eval_loss": eval_loss, "trained": trained, "params1": params1}


def _change(new: List[torch.Tensor], old: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack([(a.float() - b.float()).norm() for a, b in zip(new, old)]).cpu()


def _stack(rows: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack(rows) if rows else torch.zeros(0)


@torch.no_grad()
def evaluate(params: Any, silos: List[Any], cfg: Dict[str, Any], traffic: Dict[str, Any],
             loss_fn: LossFn, prec: Precision, fault: Optional[str] = None) -> float:
    total, n = 0.0, 0
    f32 = build([(p, t.float()) for p, t in leaves(params)], params)
    for silo in silos:
        for b in silo.batches(traffic["batch"], "test"):
            rows = b[1].shape[0]
            b = _half(b) if fault == "half_batch" else b
            total += float(loss_fn(f32, b, cfg, prec, traffic.get("adapters"))) * rows
            n += rows
    return total / n


@torch.no_grad()
def fold_rounds(rounds: Sequence[Dict[str, Any]], update: str, precision: str = "fp32",
                bits: int = 8, error_feedback: bool = True) -> List[torch.Tensor]:
    """The new global weights of each of a run of rounds, worked out from
    the round's global weights (``base``) and what each silo shipped into
    the fold (``silos``: (id, n_samples, weights)), all as the same codec
    blocks, (B, QBLOCK) float32 with the padding zero.

    Dense: the n_samples-weighted mean of the silos' weights, each rounded
    to ``precision`` first (the control).  With a codec, each silo encodes
    e = (w - base) + r, where r is what its codec dropped the round before
    (none at the first), keeps e - decode(e) for the next round, and the
    new weights are base plus the weighted mean of the decoded e: ``bits``
    8 is the int8 codec, 4 the control, and ``error_feedback`` False the
    fault of a silo that forgets what its codec dropped.  Each result is
    rounded to the weights' stored dtype."""
    residual: Dict[str, torch.Tensor] = {}
    q = Precision(precision).q
    out = []
    for rnd in rounds:
        base = rnd["base"]
        W = float(sum(n for _, n, _ in rnd["silos"]))
        acc = torch.zeros_like(base)
        for cid, n, w in rnd["silos"]:
            if update == "dense":
                acc.add_(q(w), alpha=n / W)
                continue
            e = w - base
            if error_feedback and cid in residual:
                e = e + residual[cid]
            d = block_roundtrip(e, bits)
            if error_feedback:
                residual[cid] = e - d
            acc.add_(d, alpha=n)
        new = acc if update == "dense" else base + acc * torch.tensor(1.0 / W)
        out.append(new.to(rnd["dtype"]).float())
    return out
