"""AdamW's update over a step's leaves, in one pass.

An AdamW step reads each parameter, its gradient and both moments and
writes a new parameter and new moments: bound by device-memory bytes (22 B
an element for bf16 weights with fp32 moments, 28 B all fp32; olmo-1b's
1.18 B parameters at least 7.7 ms a step at 3.35 TB/s).  The plain version
spends about 23 elementwise launches on each 2^24-element slice of a leaf
and about 200 bytes an element.

On CUDA leaves :func:`adamw_step` launches the hand-written Hopper kernel
in ``csrc/adamw_step.cu`` (it replaces no TPU kernel: the reference's
AdamW is ``jnp`` code, ``repro/optim/optimizers.py:42-60``; the source says
how it is built for the bound), one launch for each (parameter dtype, state
dtype) group of leaves, with more only where a group outgrows a launch's
table of leaves.  On CPU and ``meta`` leaves it runs
:func:`adamw_step_plain`, and only there: CUDA leaves get the kernel or an
error, never the plain version.  The two agree bit for bit on the card.

The contract is the port's AdamW rule (``optim/optimizers.py``): the
arithmetic in fp32 whatever the stored dtypes, the weight decay inside the
update, out of place (fresh parameter and moment tensors; the inputs are
left as they are).  Each parameter's gradient has its shape and dtype, its
two moments its shape and one dtype, the state dtype, in which the new
moments come back.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..utils import spans

_CODE_OF = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_UPDATE_SLICE = 1 << 24   # elements of a leaf the plain version updates at once

Leaves = List[torch.Tensor]


def adamw_step_plain(p: Sequence[torch.Tensor], g: Sequence[torch.Tensor],
                     m: Sequence[torch.Tensor], v: Sequence[torch.Tensor], *, lr: float,
                     b1: float, b2: float, eps: float, weight_decay: float, c1: float,
                     c2: float) -> Tuple[Leaves, Leaves, Leaves]:
    """The plain PyTorch version: the rule elementwise in fp32 on each leaf,
    a slice of ``_UPDATE_SLICE`` elements at a time, so that its fp32
    temporaries (about 30 bytes an element) stay small beside the largest
    leaf; every element's arithmetic is the same.  Returns the new
    parameters, first moments and second moments."""
    new_p, new_m, new_v = [], [], []
    for gl, ml, vl, pl in zip(g, m, v, p):
        dt = ml.dtype
        p_new = torch.empty(pl.shape, dtype=pl.dtype, device=pl.device)
        m_new, v_new = (torch.empty(pl.shape, dtype=dt, device=pl.device) for _ in range(2))
        g1, m1, v1, p1 = (t.reshape(-1) for t in (gl, ml, vl, pl))
        for lo in range(0, pl.numel(), _UPDATE_SLICE):
            s = slice(lo, lo + _UPDATE_SLICE)
            gf = g1[s].float()
            mf = b1 * m1[s].float() + (1 - b1) * gf
            vf = b2 * v1[s].float() + (1 - b2) * gf * gf
            delta = (mf / c1) / (torch.sqrt(vf / c2) + eps) + weight_decay * p1[s].float()
            p_new.view(-1)[s] = (p1[s].float() - lr * delta).to(pl.dtype)
            m_new.view(-1)[s] = mf.to(dt)
            v_new.view(-1)[s] = vf.to(dt)
        new_p.append(p_new)
        new_m.append(m_new)
        new_v.append(v_new)
    return new_p, new_m, new_v


def _check(p, g, m, v) -> torch.device:
    if not len(p) == len(g) == len(m) == len(v):
        raise ValueError(f"{len(p)} parameters, {len(g)} gradients, {len(m)} first and "
                         f"{len(v)} second moments")
    if not p:
        return torch.device("cpu")
    device = p[0].device
    for k, (pl, gl, ml, vl) in enumerate(zip(p, g, m, v)):
        if not pl.shape == gl.shape == ml.shape == vl.shape:
            raise ValueError(f"leaf {k}: parameter {tuple(pl.shape)}, gradient "
                             f"{tuple(gl.shape)}, moments {tuple(ml.shape)} and {tuple(vl.shape)}")
        if gl.dtype != pl.dtype or vl.dtype != ml.dtype:
            raise TypeError(f"leaf {k}: parameter {pl.dtype} with gradient {gl.dtype}, "
                            f"first moment {ml.dtype} with second {vl.dtype}")
        if not pl.device == gl.device == ml.device == vl.device == device:
            raise ValueError(f"leaf {k}: parameter on {pl.device}, gradient on {gl.device}, "
                             f"moments on {ml.device} and {vl.device}; leaf 0 on {device}")
    return device


def _scalars(lr, b1, b2, eps, weight_decay, c1, c2) -> np.ndarray:
    """The nine fp32 numbers the kernel takes, each as PyTorch forms it for
    a tensor-scalar op: the Python float rounded to fp32, and a division
    by a Python scalar as a product with its fp32 reciprocal."""
    one = np.float32(1.0)
    with np.errstate(divide="ignore"):
        inv_c1, inv_c2 = one / np.float32(c1), one / np.float32(c2)
    return np.array([b1, 1 - b1, b2, 1 - b2, inv_c1, inv_c2, eps, weight_decay, lr],
                    dtype=np.float32)


def _kernel_fn():
    """The C entry point with its argument types declared (64-bit
    pointers and stream)."""
    from . import _build

    fn = _build.load("adamw_step").adamw_step_launch
    if not fn.argtypes:
        fn.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ]
        fn.restype = ctypes.c_int
    return fn


def _launch(group, scalars: np.ndarray, device: torch.device) -> Tuple[Leaves, Leaves, Leaves]:
    """One group's leaves, all of one parameter and one state dtype:
    outputs allocated, the kernel launched on the current stream."""
    # The kernel walks each leaf's elements in order: a strided leaf goes as
    # a contiguous copy, as the plain version's reshape(-1) takes it.
    p, g, m, v = ([t if t.is_contiguous() else t.contiguous() for t in ts] for ts in zip(*group))
    p_dt, s_dt = p[0].dtype, m[0].dtype
    if p_dt not in _CODE_OF or s_dt not in _CODE_OF:
        raise TypeError(f"adamw_step takes float32, bfloat16 or float16 parameters and "
                        f"state, got {p_dt} and {s_dt}")
    new_p, new_m, new_v = [], [], []
    for pl, _, _, _ in group:   # leaf by leaf, in the plain version's order
        new_p.append(torch.empty(pl.shape, dtype=p_dt, device=device))
        new_m.append(torch.empty(pl.shape, dtype=s_dt, device=device))
        new_v.append(torch.empty(pl.shape, dtype=s_dt, device=device))
    ptrs = np.array([[t.data_ptr() for t in leaf] for leaf in zip(p, g, m, v, new_p, new_m, new_v)],
                    dtype=np.uint64).reshape(-1, 7)
    numel = np.array([t.numel() for t in p], dtype=np.int64)
    launched = ctypes.c_int(0)
    fn = _kernel_fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(len(p), ptrs.ctypes.data, numel.ctypes.data, _CODE_OF[p_dt], _CODE_OF[s_dt],
                 scalars.ctypes.data, stream, ctypes.byref(launched))
    adamw_step.launches += launched.value
    if err != 0:
        raise RuntimeError(f"adamw_step kernel launch failed: CUDA error {err}")
    spans.count("optim.adamw.fused_elems", int(numel.sum()))
    return new_p, new_m, new_v


def adamw_step(p: Sequence[torch.Tensor], g: Sequence[torch.Tensor], m: Sequence[torch.Tensor],
               v: Sequence[torch.Tensor], *, lr: float, b1: float, b2: float, eps: float,
               weight_decay: float, c1: float, c2: float) -> Tuple[Leaves, Leaves, Leaves]:
    """One AdamW step over parallel lists of leaves: parameters ``p``,
    gradients ``g``, first and second moments ``m`` and ``v``; ``c1`` and
    ``c2`` are the step's bias corrections.  Returns new parameters, first
    and second moments, in the order given.

    CUDA leaves go through the kernel, launched on the current stream
    without a synchronize, one launch a (parameter dtype, state dtype)
    group; CPU and ``meta`` leaves through :func:`adamw_step_plain`."""
    device = _check(p, g, m, v)
    kw = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, c1=c1, c2=c2)
    if device.type in ("cpu", "meta"):
        return adamw_step_plain(p, g, m, v, **kw)
    if device.type != "cuda":
        raise ValueError(f"adamw_step runs on cuda, cpu or meta, not {device}")
    scalars = _scalars(**kw)
    groups: dict = {}
    for k, leaf in enumerate(zip(p, g, m, v)):
        groups.setdefault((leaf[0].dtype, leaf[2].dtype), []).append(k)
    new_p: list = [None] * len(p)
    new_m: list = [None] * len(p)
    new_v: list = [None] * len(p)
    for idx in groups.values():
        outs = _launch([(p[k], g[k], m[k], v[k]) for k in idx], scalars, device)
        for k, a, b, c in zip(idx, *outs):
            new_p[k], new_m[k], new_v[k] = a, b, c
    return new_p, new_m, new_v


# Kernel launches since the count was last set to 0 (CPU and meta calls,
# and groups of empty leaves, launch nothing and do not count).
adamw_step.launches = 0  # type: ignore[attr-defined]
