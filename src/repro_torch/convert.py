"""Carry parameter trees between numpy and the port, leaf by leaf.

The JAX package's parameters reach the port as numpy arrays (``np.asarray``
of each ``jax.Array``), and the port's tensors go back the same way, so
the two packages can start from the same weights and be compared path by
path.  Structure and leaf order follow :mod:`repro_torch.utils.tree`.

bfloat16 leaves arrive as numpy arrays whose dtype is named
``"bfloat16"`` (an extension dtype numpy itself does not define); they
are carried over by their raw 16-bit patterns, bit for bit.
"""
from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from .utils.tree import tree_map

Device = Union[str, torch.device]


def tensor_from_numpy(arr: Any, device: Device = "cuda") -> torch.Tensor:
    """One leaf: numpy (or anything ``np.asarray`` takes) -> tensor."""
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        bits = np.array(a, copy=True, order="C").view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """One leaf: tensor -> numpy.  bfloat16 widens to float32 (exactly:
    every bf16 value is a float32 value), since numpy has no bf16."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def params_from_numpy(tree: Any, device: Device = "cuda") -> Any:
    """A tree of numpy arrays -> the same tree of tensors on ``device``."""
    return tree_map(lambda a: tensor_from_numpy(a, device), tree)


def params_to_numpy(tree: Any) -> Any:
    """A tree of tensors -> the same tree of numpy arrays."""
    return tree_map(tensor_to_numpy, tree)
