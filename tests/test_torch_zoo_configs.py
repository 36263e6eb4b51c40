"""The port's model configs against the reference's: every field of every
architecture, its ``reduced()`` variant, the derived properties, the
dtype mapping and the registry functions."""
import dataclasses

import pytest
import torch

from repro.configs import ARCHITECTURES as JAX_ARCHS
from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import registry as jax_registry
from repro_torch.configs import ARCHITECTURES, INPUT_SHAPES, get_config, get_shape
from repro_torch.configs import registry
from repro_torch.configs.base import torch_dtype

ARCH_IDS = sorted(JAX_ARCHS)


def test_same_architectures():
    assert sorted(ARCHITECTURES) == ARCH_IDS
    assert registry.LONG_CONTEXT_WINDOW == jax_registry.LONG_CONTEXT_WINDOW


def _fields(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("variant", ["full", "reduced", "long", "lora"])
def test_every_field_matches(arch, variant):
    mine, theirs = ARCHITECTURES[arch], JAX_ARCHS[arch]
    if variant == "reduced":
        mine, theirs = mine.reduced(), theirs.reduced()
    elif variant == "long":
        mine = registry.long_context_config(mine)
        theirs = jax_registry.long_context_config(theirs)
    elif variant == "lora":
        mine, theirs = mine.with_lora(4), theirs.with_lora(4)
    assert _fields(mine) == _fields(theirs)
    for prop in ("hd", "d_inner", "ssm_heads", "lora_enabled"):
        assert getattr(mine, prop) == getattr(theirs, prop), prop
    for i in range(mine.n_layers):
        assert mine.is_moe_layer(i) == theirs.is_moe_layer(i)
        assert mine.is_attention_layer(i) == theirs.is_attention_layer(i)
    # The dtype strings map to the torch dtypes of the same names.
    assert str(mine.activation_dtype) == f"torch.{theirs.activation_dtype.name}"
    assert str(mine.weight_dtype) == f"torch.{theirs.weight_dtype.name}"


def test_overrides_and_shapes():
    cfg = get_config("olmo-1b").reduced().with_overrides(dtype="float32", param_dtype="float32")
    assert cfg.activation_dtype == torch.float32 and cfg.weight_dtype == torch.float32
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}
    for name in INPUT_SHAPES:
        for arch in ARCH_IDS:
            assert registry.shape_supported(get_config(arch), get_shape(name)) == \
                jax_registry.shape_supported(JAX_ARCHS[arch], JAX_SHAPES[name])


def test_unknown_names_raise():
    with pytest.raises(KeyError, match="unknown --arch"):
        get_config("gpt-5")
    with pytest.raises(KeyError, match="unknown --shape"):
        get_shape("long_1m")
    with pytest.raises(ValueError, match="unknown dtype"):
        torch_dtype("float8")
