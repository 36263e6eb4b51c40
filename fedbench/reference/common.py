"""Shared pieces of the plain reference: trees, precision, AdamW and the
block codec.

Departures from a textbook description, each deliberate:

* Trees are flattened in sorted-key order, the order the system's wire
  format and its flat aggregation buffer use; the int8 codec's blocks are
  taken over that flat vector.
* AdamW is the system's documented rule (the JAX package's
  ``optim/optimizers.py``, read and not imported): ``b2`` 0.95, weight
  decay inside the Adam step, bias corrections in float32, the update in
  float32 and the parameter rounded back to its stored dtype.
"""
from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np
import torch

QBLOCK = 8192  # elements per int8 scale block, as the wire format fixes it

Path = Tuple[str, ...]


# ---------------------------------------------------------------------------
# Trees (nested dicts of tensors, empty dicts allowed)
# ---------------------------------------------------------------------------

def leaves(tree: Any, prefix: Path = ()) -> List[Tuple[Path, torch.Tensor]]:
    """(path, tensor) pairs in sorted-key order."""
    if isinstance(tree, dict):
        out: List[Tuple[Path, torch.Tensor]] = []
        for k in sorted(tree):
            out += leaves(tree[k], prefix + (k,))
        return out
    return [(prefix, tree)]


def build(pairs: List[Tuple[Path, torch.Tensor]], like: Any) -> Any:
    """A tree shaped as ``like`` whose leaves are ``pairs``' tensors."""
    it = iter(t for _, t in pairs)

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return next(it)

    return walk(like)


def flat(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1).float() for t in tensors])


# A stored dtype by its code: a tree of several dtypes records, for each
# element it samples, the code of the dtype of the leaf it came from.
DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)


def dtype_code(dtype: torch.dtype) -> int:
    if dtype not in DTYPES:
        raise ValueError(f"no code for the stored dtype {dtype}")
    return DTYPES.index(dtype)


def round_stored(x: torch.Tensor, dtype: Any) -> torch.Tensor:
    """``x`` (float32) rounded to its stored dtype and back: ``dtype`` is
    one ``torch.dtype`` for every element, or a tensor of
    :data:`DTYPES` codes shaped as ``x``, one for each element."""
    if isinstance(dtype, torch.dtype):
        return x.to(dtype).float()
    out = x.clone()
    for code in dtype.unique().tolist():
        sel = dtype == code
        out[sel] = x[sel].to(DTYPES[code]).float()
    return out


# ---------------------------------------------------------------------------
# Precision: the reference's own (float32) and the controls below it
# ---------------------------------------------------------------------------

def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), nearest-even on the bits."""
    b = x.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    b = (b + 0xFFF + lsb) & ~0x1FFF
    return b.view(torch.float32)


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    """E4M3 with one per-tensor scale (amax to 448)."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    s = amax / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Precision:
    """How the reference rounds the operands of its products.

    ``fp32``: none (TF32 must be off: the harness turns it off).
    ``tf32`` and ``fp8``: each product's operands rounded first, the
    product then taken in float32: the control of a float32 and of a
    bfloat16 configuration.  Rounding is straight through for the
    gradient."""

    def __init__(self, name: str = "fp32") -> None:
        if name not in ("fp32", "tf32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "fp32":
            return x
        r = _round_tf32(x.detach()) if self.name == "tf32" else _round_fp8(x.detach())
        return x + (r - x.detach())

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)


# ---------------------------------------------------------------------------
# AdamW, the system's rule
# ---------------------------------------------------------------------------

class AdamW:
    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> None:
        self.lr, self.b1, self.b2, self.eps, self.wd = lr, b1, b2, eps, weight_decay

    @torch.no_grad()
    def step(self, p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
             step: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(new p in p's dtype, new m, new v), m and v in float32."""
        c1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(step))
        c2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(step))
        gf = g.float()
        m = self.b1 * m + (1 - self.b1) * gf
        v = self.b2 * v + (1 - self.b2) * gf * gf
        delta = (m / c1) / (torch.sqrt(v / c2) + self.eps) + self.wd * p.float()
        return (p.float() - self.lr * delta).to(p.dtype), m, v


# ---------------------------------------------------------------------------
# The block codec
# ---------------------------------------------------------------------------

def block_roundtrip(vec: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """What a quantized update decodes to: symmetric blocks of QBLOCK
    elements, scale absmax / (2**(bits-1) - 1), codes rounded half to even,
    an all-zero block 0.  ``bits`` 8 is the wire format's int8 codec; 4 is
    the control below it."""
    top = float(2 ** (bits - 1) - 1)
    n = vec.numel()
    nb = -(-n // QBLOCK)
    padded = vec.new_zeros(nb * QBLOCK)
    padded[:n] = vec.reshape(-1)
    blocks = padded.view(nb, QBLOCK)
    scales = blocks.abs().amax(dim=1) / top
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    codes = torch.round(blocks / safe[:, None]).clamp(-top, top)
    codes[scales == 0] = 0
    return (codes * scales[:, None]).reshape(-1)[:n].view(vec.shape)
