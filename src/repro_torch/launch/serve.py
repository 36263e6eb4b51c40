"""Batched serving driver, the port of ``repro/launch/serve.py``: prefill a
prompt batch token by token through ``serve_step``, then decode N tokens
against the KV / state cache with the same step.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \
      --batch 4 --prompt-len 32 --decode-tokens 16

Runs on the card unless ``--device cpu`` is given.  Weights are random,
drawn from a generator seeded 0 on that device (the reference seeds
``jax.random.PRNGKey(0)``; the two give different weights, so tests hand
the reference's weights to :func:`generate`).  The prompt is the
reference's: ``numpy.random.default_rng(0)``.  Sampling with
``--temperature > 0`` draws from a torch generator seeded 1, not JAX's
bits.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..configs import ARCHITECTURES, get_config
from ..models import get_model
from ..models.api import ModelFamily
from .steps import make_serve_step


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor                   # (B, decode_tokens) generated ids
    prompt_logits: Optional[torch.Tensor]  # (B, prompt_len, V) fp32, if kept
    last_logits: torch.Tensor              # (B, 1, V) of the last step
    prefill_s: float
    decode_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: ModelFamily, params, prompt: torch.Tensor, decode_tokens: int,
             temperature: float = 0.0, keep_prompt_logits: bool = False,
             gen: Optional[torch.Generator] = None, cache=None) -> ServeResult:
    """Token-by-token prefill of ``prompt`` (B, P) through ``serve_step``,
    then ``decode_tokens`` tokens, greedy unless ``temperature > 0``.
    Each timed span ends in a device synchronize.  ``cache`` is the cache
    to start from, by default ``init_cache(B, P + decode_tokens)`` (for an
    encoder-decoder its cross K/V zeroed, as the reference's driver
    decodes); a caller may hand one whose cross K/V an encoding filled."""
    device = prompt.device
    B, P = prompt.shape
    if cache is None:
        cache = model.init_cache(B, P + decode_tokens, device)
    serve_step = make_serve_step(model)
    logits, per_pos = None, []
    _sync(device)
    t0 = time.monotonic()
    for t in range(P):
        logits, cache = serve_step(params, cache, prompt[:, t:t + 1], t)
        if keep_prompt_logits:
            per_pos.append(logits)
    _sync(device)
    prefill_s = time.monotonic() - t0

    def pick(lg: torch.Tensor) -> torch.Tensor:
        if temperature > 0:
            probs = torch.softmax(lg[:, -1].float() / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=gen)
        return torch.argmax(lg[:, -1], dim=-1)[:, None]

    tok = pick(logits)
    out = [tok]
    t0 = time.monotonic()
    for i in range(decode_tokens - 1):
        logits, cache = serve_step(params, cache, tok, P + i)
        tok = pick(logits)
        out.append(tok)
    _sync(device)
    decode_s = time.monotonic() - t0
    return ServeResult(
        tokens=torch.cat(out, dim=1),
        prompt_logits=torch.cat(per_pos, dim=1) if keep_prompt_logits else None,
        last_logits=logits, prefill_s=prefill_s, decode_s=decode_s,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHITECTURES), required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0, help="0 = greedy")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced().with_overrides(dtype="float32", param_dtype="float32")
    model = get_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0), device)
    print(f"arch={cfg.name} params={model.param_count(params):,} device={device}")

    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int64)
    ).to(device)
    res = generate(model, params, prompt, args.decode_tokens, args.temperature,
                   gen=torch.Generator(device=device).manual_seed(1))

    per_tok = res.decode_s / max(args.decode_tokens - 1, 1) * 1e3
    print(f"prefill({args.prompt_len} toks): {res.prefill_s * 1e3:.0f} ms")
    print(f"decode: {per_tok:.1f} ms/token x {args.batch} sequences")
    print("generated token ids (first sequence):", res.tokens[0].tolist())
    if not bool(torch.isfinite(res.last_logits).all()):
        raise RuntimeError("non-finite logits during decode")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
