"""The paper's three FL application models (§5.1), in PyTorch:

  * TIL        — VGG16-style CNN for tumor-infiltrating-lymphocyte patches.
  * FEMNIST    — 2 conv layers followed by 10 fully-connected layers of
                 4096 neurons (62 classes).
  * Shakespeare— embedding dim 8 + 2-layer LSTM(256), next-character
                 prediction.

The port of ``repro/models/fl_models.py``.  Models are plain functions
over dicts of tensors, keyed exactly like the reference's trees, so
weights carry over path by path (:mod:`repro_torch.convert`) and every
flat layout and blob matches.  The reference's layouts are kept at the
public functions: images are NHWC and conv weights HWIO.  Inside a conv
stack the activations are NCHW (PyTorch's layout for ``conv2d``), and
they go back to NHWC before the flatten that feeds the first dense
layer, so ``fc0`` sees its inputs in the reference's order.

``init_*`` draw from an explicit ``torch.Generator`` (on the generator's
device) and place the tree on ``device``.  The same generator seed does
not give the reference's weights: tests carry those over instead.

The LoRA helpers at the end (``inject_lora``, ``lora_effective``,
``merge_lora``, ``lora_adapter_schema``, ``lora_merge_hook``) work on any
dict tree, the zoo's included: federated LoRA trains and ships only the
injected factors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Device = Union[str, torch.device]


# ---------------------------------------------------------------------------
# Common helpers
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape: Tuple[int, ...], scale: float,
            device: Device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32) * scale
    return x.to(device=device, dtype=dtype)


def _dense(gen: torch.Generator, n_in: int, n_out: int, device: Device,
           dtype: torch.dtype = torch.float32) -> Params:
    return {
        "w": _normal(gen, (n_in, n_out), math.sqrt(2.0 / n_in), device, dtype),
        "b": torch.zeros((n_out,), dtype=dtype, device=device),
    }


def _conv(gen: torch.Generator, k: int, c_in: int, c_out: int, device: Device,
          dtype: torch.dtype = torch.float32) -> Params:
    """HWIO kernel, as the reference stores it."""
    return {
        "w": _normal(gen, (k, k, c_in, c_out), math.sqrt(2.0 / (k * k * c_in)), device, dtype),
        "b": torch.zeros((c_out,), dtype=dtype, device=device),
    }


def _conv_nchw(p: Params, x: torch.Tensor) -> torch.Tensor:
    """SAME conv, stride 1: NCHW activations, HWIO weights."""
    return F.conv2d(x, p["w"].permute(3, 2, 0, 1), p["b"], padding="same")


def _maxpool(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    """k x k max pool, stride k, VALID (the ragged edge is dropped)."""
    return F.max_pool2d(x, k)


def _to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _flatten_nhwc(h: torch.Tensor) -> torch.Tensor:
    """NCHW activations -> (B, H*W*C) in the reference's NHWC order."""
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


# ---------------------------------------------------------------------------
# FEMNIST CNN (2 conv + n_fc x fc_width FC; paper: 10 x 4096)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FemnistConfig:
    n_classes: int = 62
    image_size: int = 28
    n_fc: int = 10
    fc_width: int = 4096


def init_femnist_cnn(gen: torch.Generator, cfg: FemnistConfig = FemnistConfig(),
                     device: Device = "cuda") -> Params:
    p: Params = {
        "conv1": _conv(gen, 5, 1, 32, device),
        "conv2": _conv(gen, 5, 32, 64, device),
    }
    feat = (cfg.image_size // 4) ** 2 * 64
    widths = [feat] + [cfg.fc_width] * cfg.n_fc
    for i in range(cfg.n_fc):
        p[f"fc{i}"] = _dense(gen, widths[i], widths[i + 1], device)
    p["head"] = _dense(gen, widths[-1], cfg.n_classes, device)
    return p


def femnist_forward(p: Params, x: torch.Tensor, cfg: FemnistConfig = FemnistConfig()) -> torch.Tensor:
    """x: (B, 28, 28, 1) NHWC -> logits (B, n_classes)."""
    h = _maxpool(F.relu(_conv_nchw(p["conv1"], _to_nchw(x))))
    h = _maxpool(F.relu(_conv_nchw(p["conv2"], h)))
    h = _flatten_nhwc(h)
    for i in range(cfg.n_fc):
        h = F.relu(h @ p[f"fc{i}"]["w"] + p[f"fc{i}"]["b"])
    return h @ p["head"]["w"] + p["head"]["b"]


# ---------------------------------------------------------------------------
# TIL VGG16 (13 conv + 3 FC; binary: with / without TILs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class VGGConfig:
    n_classes: int = 2
    image_size: int = 64
    # Standard VGG16 conv plan: (channels, n_convs) per stage.
    stages: Tuple[Tuple[int, int], ...] = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
    fc_width: int = 4096


def init_vgg16(gen: torch.Generator, cfg: VGGConfig = VGGConfig(),
               device: Device = "cuda") -> Params:
    p: Params = {}
    c_in = 3
    idx = 0
    for c_out, n in cfg.stages:
        for _ in range(n):
            p[f"conv{idx}"] = _conv(gen, 3, c_in, c_out, device)
            c_in = c_out
            idx += 1
    feat = (cfg.image_size // 2 ** len(cfg.stages)) ** 2 * cfg.stages[-1][0]
    p["fc0"] = _dense(gen, feat, cfg.fc_width, device)
    p["fc1"] = _dense(gen, cfg.fc_width, cfg.fc_width, device)
    p["head"] = _dense(gen, cfg.fc_width, cfg.n_classes, device)
    return p


def vgg16_forward(p: Params, x: torch.Tensor, cfg: VGGConfig = VGGConfig()) -> torch.Tensor:
    """x: (B, H, W, 3) NHWC -> logits."""
    h = _to_nchw(x)
    idx = 0
    for _, n in cfg.stages:
        for _ in range(n):
            h = F.relu(_conv_nchw(p[f"conv{idx}"], h))
            idx += 1
        h = _maxpool(h)
    h = _flatten_nhwc(h)
    h = F.relu(h @ p["fc0"]["w"] + p["fc0"]["b"])
    h = F.relu(h @ p["fc1"]["w"] + p["fc1"]["b"])
    return h @ p["head"]["w"] + p["head"]["b"]


# ---------------------------------------------------------------------------
# Shakespeare LSTM (embedding 8, 2 x LSTM(256), next-char prediction)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LSTMConfig:
    vocab_size: int = 80
    embed_dim: int = 8
    hidden: int = 256
    n_layers: int = 2


def _init_lstm_layer(gen: torch.Generator, n_in: int, hidden: int, device: Device) -> Params:
    scale = 1.0 / math.sqrt(hidden)
    return {
        "wx": _normal(gen, (n_in, 4 * hidden), scale, device),
        "wh": _normal(gen, (hidden, 4 * hidden), scale, device),
        "b": torch.zeros((4 * hidden,), dtype=torch.float32, device=device),
    }


def init_shakespeare_lstm(gen: torch.Generator, cfg: LSTMConfig = LSTMConfig(),
                          device: Device = "cuda") -> Params:
    p: Params = {"embed": _normal(gen, (cfg.vocab_size, cfg.embed_dim), 0.1, device)}
    n_in = cfg.embed_dim
    for i in range(cfg.n_layers):
        p[f"lstm{i}"] = _init_lstm_layer(gen, n_in, cfg.hidden, device)
        n_in = cfg.hidden
    p["head"] = _dense(gen, cfg.hidden, cfg.vocab_size, device)
    return p


def _lstm_scan(p: Params, x: torch.Tensor, hidden: int) -> torch.Tensor:
    """x: (B, S, n_in) -> (B, S, hidden); gates ordered i, f, g, o."""
    B = x.shape[0]
    h = torch.zeros((B, hidden), dtype=x.dtype, device=x.device)
    c = torch.zeros((B, hidden), dtype=x.dtype, device=x.device)
    hs = []
    for t in range(x.shape[1]):
        gates = x[:, t] @ p["wx"] + h @ p["wh"] + p["b"]
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1)


def shakespeare_forward(p: Params, tokens: torch.Tensor, cfg: LSTMConfig = LSTMConfig()) -> torch.Tensor:
    """tokens: (B, S) -> logits (B, S, vocab)."""
    h = p["embed"][tokens.long()]
    for i in range(cfg.n_layers):
        h = _lstm_scan(p[f"lstm{i}"], h, cfg.hidden)
    return h @ p["head"]["w"] + p["head"]["b"]


def shakespeare_loss(p: Params, tokens: torch.Tensor, labels: torch.Tensor,
                     cfg: LSTMConfig = LSTMConfig()) -> torch.Tensor:
    logp = F.log_softmax(shakespeare_forward(p, tokens, cfg), dim=-1)
    return -logp.gather(-1, labels.long()[..., None]).mean()



# ---------------------------------------------------------------------------
# LoRA adapters (federated fine-tuning of a frozen base)
# ---------------------------------------------------------------------------
# `inject_lora` adds a rank-r pair of factors beside each target weight
# (`<key>.lora_a`, `<key>.lora_b`); `lora_effective` is the forward-ready
# tree with every target replaced by `w + scale * a @ b` (the factors stay
# in the tree, so the structure — and the ravel plan — is unchanged and
# gradients reach the factors through the merged weight); `merge_lora`
# folds the product into the base and zeros `b`, the periodic server-side
# merge.

LORA_A_SUFFIX = ".lora_a"
LORA_B_SUFFIX = ".lora_b"


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    """Low-rank adapter spec.

    ``targets`` are exact leaf-key names (``("w",)`` for the FL models'
    dense layers, ``("wq", "wv")`` for zoo attention blocks); a target
    leaf must be a 2-D ``(n_in, n_out)`` matrix or a stacked 3-D
    ``(n_layers, n_in, n_out)`` batch of them.  ``merge_every`` is
    advisory metadata for the server-side merge hook (0 = never)."""

    rank: int = 8
    alpha: float = 16.0
    targets: Tuple[str, ...] = ("w",)
    merge_every: int = 0

    def __post_init__(self) -> None:
        if self.rank < 1:
            raise ValueError("LoRA rank must be >= 1")
        if not self.targets:
            raise ValueError("LoRA needs at least one target leaf key")

    @property
    def scale(self) -> float:
        return float(self.alpha) / float(self.rank)


def _is_lora_target(key: str, leaf: Any, cfg: LoRAConfig) -> bool:
    return (key in cfg.targets and isinstance(leaf, torch.Tensor)
            and leaf.dim() in (2, 3) and leaf.is_floating_point())


def inject_lora(params: Any, gen: torch.Generator, cfg: LoRAConfig = LoRAConfig()) -> Any:
    """Add ``<key>.lora_a`` / ``<key>.lora_b`` siblings for each target.

    ``a`` is Gaussian (0.01 std, drawn from ``gen``), ``b`` zeros — the
    standard init that leaves the injected model's forward equal to the
    base's until training moves ``b``.  Factors are fp32 whatever the
    base dtype, on the base leaf's device.  Raises if no leaf matched (a
    typo'd target would otherwise silently train the empty set).  The
    same seed does not give the reference's ``a``: tests carry it over."""
    n_injected = 0

    def walk(node: Any) -> Any:
        nonlocal n_injected
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            out[k] = walk(v)
            if _is_lora_target(k, v, cfg):
                *batch, n_in, n_out = v.shape
                a = torch.randn((*batch, n_in, cfg.rank), generator=gen,
                                device=gen.device, dtype=torch.float32) * 0.01
                out[f"{k}{LORA_A_SUFFIX}"] = a.to(v.device)
                out[f"{k}{LORA_B_SUFFIX}"] = torch.zeros((*batch, cfg.rank, n_out),
                                                         dtype=torch.float32, device=v.device)
                n_injected += 1
        return out

    injected = walk(params)
    if n_injected == 0:
        raise ValueError(f"no leaf matched LoRA targets {cfg.targets!r}; nothing injected")
    return injected


def _with_adapters(params: Any, cfg: LoRAConfig, zero_b: bool) -> Any:
    """Each target with factors replaced by ``w + scale * a @ b`` (in fp32,
    cast back to w's dtype); with ``zero_b`` each ``b`` becomes zeros."""

    def walk(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            a = node.get(f"{k}{LORA_A_SUFFIX}")
            b = node.get(f"{k}{LORA_B_SUFFIX}")
            if a is not None and b is not None and not k.endswith((LORA_A_SUFFIX, LORA_B_SUFFIX)):
                delta = cfg.scale * torch.matmul(a.float(), b.float())
                out[k] = (v.float() + delta).to(v.dtype)
            elif zero_b and k.endswith(LORA_B_SUFFIX):
                out[k] = torch.zeros_like(v)
            else:
                out[k] = walk(v)
        return out

    return walk(params)


def lora_effective(params: Any, cfg: LoRAConfig = LoRAConfig()) -> Any:
    """The forward-ready tree: targets replaced by ``w + scale * a @ b``.

    Differentiable: training takes gradients of ``loss(lora_effective(p))``
    with respect to the factors; with a masked optimizer
    (:func:`repro_torch.optim.masked`) only the factor leaves move.  The
    factors stay in the returned tree (forwards ignore them), so the
    structure matches the injected tree exactly."""
    return _with_adapters(params, cfg, zero_b=False)


def merge_lora(params: Any, cfg: LoRAConfig = LoRAConfig()) -> Any:
    """Fold each adapter product into its base weight and zero ``b``: the
    effective weights are unchanged (``a @ 0 = 0``) and the adapters
    restart from a clean slate — the periodic server-side merge (see
    :func:`lora_merge_hook`)."""
    return _with_adapters(params, cfg, zero_b=True)


def lora_adapter_schema() -> Any:
    """The adapter-FL update schema: one group over the ``.lora_`` leaves.

    ``AsyncFLServer(schema=...)`` then folds and ships ONLY the adapters
    group; the base stays server-side."""
    from ..federated.agg_engine import UpdateSchema

    return UpdateSchema({"adapters": ".lora_"})


def lora_merge_hook(cfg: LoRAConfig, every: Optional[int] = None):
    """A ``post_round_hook`` that merges adapters every N rounds.

    ``every`` defaults to ``cfg.merge_every``; a hook built with
    ``every=0`` never merges (returns None every round)."""
    n = cfg.merge_every if every is None else int(every)

    def hook(round_idx: int, params: Any) -> Any:
        if n > 0 and round_idx % n == 0:
            return merge_lora(params, cfg)
        return None

    return hook
