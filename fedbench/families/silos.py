"""Seeds, weights and silos the benchmark makes on the device.

Weights are drawn in one call per dtype from a generator on the device
and scaled leaf by leaf in place: a tree of views into one buffer.  A
silo holds its training and test rows on the device and yields the same
batches every round, as a silo's fixed private data set does.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Tuple

import torch

Spec = Dict[str, Any]   # nested dicts whose leaves are (shape, std, dtype) tuples


def sub_seed(seed: int, stream: int) -> int:
    """An independent seed for one stream (weights, data, ...) of a run."""
    return (int(seed) * 1_000_003 + 7919 * stream) % (2 ** 63)


def generator(seed: int, stream: int, device: Any) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, stream))


def spec_leaves(spec: Spec, prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], tuple]]:
    out = []
    for k in sorted(spec):
        v = spec[k]
        out += spec_leaves(v, prefix + (k,)) if isinstance(v, dict) else [(prefix + (k,), v)]
    return out


def make_weights(spec: Spec, seed: int, device: Any) -> Dict[str, Any]:
    """The tree ``spec`` describes: N(0, std) leaves (std 0 gives zeros),
    one draw per dtype."""
    pairs = spec_leaves(spec)
    gen = generator(seed, 0, device)
    views: Dict[Tuple[str, ...], torch.Tensor] = {}
    for dtype in sorted({d for _, (_, _, d) in pairs}, key=str):
        mine = [(p, s) for p, s in pairs if s[2] == dtype]
        sizes = [int(torch.Size(shape).numel()) for _, (shape, _, _) in mine]
        buf = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
        off = 0
        for (path, (shape, std, _)), n in zip(mine, sizes):
            t = buf[off:off + n].view(shape)
            t.zero_() if std == 0 else t.mul_(std)
            views[path] = t
            off += n

    def tree(node: Spec, prefix: Tuple[str, ...]) -> Dict[str, Any]:
        return {k: tree(v, prefix + (k,)) if isinstance(v, dict) else views[prefix + (k,)]
                for k, v in node.items()}

    return tree(spec, ())


class Silo:
    """One silo's rows: ``batches(batch, split)`` yields (inputs, labels)
    slices of the device tensors, in order."""

    def __init__(self, client_id: str, train: Tuple[torch.Tensor, torch.Tensor],
                 test: Tuple[torch.Tensor, torch.Tensor]) -> None:
        self.client_id = client_id
        self.train, self.test = train, test

    def batches(self, batch: int, split: str = "train") -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        x, y = self.train if split == "train" else self.test
        for lo in range(0, y.shape[0], batch):
            yield x[lo:lo + batch], y[lo:lo + batch]


def split_rows(x: torch.Tensor, y: torch.Tensor, sizes: List[List[int]]) -> List[Silo]:
    """Consecutive rows of (x, y) as silos of [n_train, n_test] each."""
    silos, off = [], 0
    for i, (n_tr, n_te) in enumerate(sizes):
        tr = (x[off:off + n_tr], y[off:off + n_tr])
        te = (x[off + n_tr:off + n_tr + n_te], y[off + n_tr:off + n_tr + n_te])
        silos.append(Silo(f"client_{i}", tr, te))
        off += n_tr + n_te
    return silos
