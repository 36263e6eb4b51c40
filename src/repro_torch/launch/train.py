"""Single-program trainer, the port of ``repro/launch/train.py``: train
any ported ``--arch`` on synthetic data.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
      --steps 8 --batch 2 --seq 2048

Runs on the card unless ``--device cpu`` is given (``--reduced`` is the
per-arch smoke variant in fp32, the size for the CPU).  Weights are
random, drawn from a generator seeded 0 on that device (the reference
seeds ``jax.random.PRNGKey(0)``; the two give different weights).  The
batches are the reference's: ``SyntheticLM`` with ``seed=0`` sampled by
``numpy.random.default_rng(0)``.  Exits 0 only if the last step's loss is
below the first's, as the reference does.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCHITECTURES, get_config
from ..data import SyntheticLM
from ..models import get_model
from .steps import make_optimizer_for, make_train_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHITECTURES), required=True)
    ap.add_argument("--reduced", action="store_true", help="smoke-scale variant")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced().with_overrides(dtype="float32", param_dtype="float32")
    model = get_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0), device)
    n_params = model.param_count(params)
    print(f"arch={cfg.name} params={n_params:,} device={device}")

    optimizer = make_optimizer_for(cfg)
    opt_state = optimizer.init(params)
    step_fn = make_train_step(model, optimizer)

    ds = SyntheticLM(cfg.vocab_size, args.seq, seed=0)
    rng = np.random.default_rng(0)

    def make_batch():
        toks, labels = ds.sample(rng, args.batch)
        batch = {"tokens": torch.from_numpy(toks).to(device),
                 "labels": torch.from_numpy(labels).to(device)}
        if cfg.arch_type == "vlm":
            batch["patch_embeds"] = torch.from_numpy(
                rng.standard_normal((args.batch, cfg.n_image_tokens, cfg.d_model))
            ).to(device, cfg.activation_dtype)
        return batch

    t0 = time.monotonic()
    first_loss = None
    for step in range(1, args.steps + 1):
        params, opt_state, loss = step_fn(params, opt_state, make_batch())
        if step == 1:
            first_loss = float(loss)
        if step % args.log_every == 0 or step == 1:
            print(f"step {step:5d}  loss {float(loss):.4f}  "
                  f"({(time.monotonic() - t0) / step * 1e3:.0f} ms/step)")
    final = float(loss)
    print(f"done: loss {first_loss:.4f} -> {final:.4f} "
          f"({'improved' if final < first_loss else 'NO IMPROVEMENT'})")
    return 0 if final < first_loss else 1


if __name__ == "__main__":
    raise SystemExit(main())
