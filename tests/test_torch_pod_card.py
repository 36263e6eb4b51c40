"""Card-only tests of the pod round and of placement on an NCCL mesh.

This file imports no JAX, so it collects on the card's machine with
``--noconftest``; every test is marked ``gpu`` and skips without a card.
The CPU runs of the same paths, against the reference, are in
``tests/test_torch_pod_fedavg.py`` and ``tests/test_torch_sharding.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.federated import init_pod_state, make_fl_round_step, make_train_step
from repro_torch.kernels.fedavg_reduce import fedavg_reduce
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
from repro_torch.launch.steps import make_optimizer_for
from repro_torch.models import get_model
from repro_torch.utils.tree import tree_leaves, tree_map

N_PODS, LOCAL_STEPS, PER_POD, SEQ = 2, 2, 2, 64


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _setup():
    cfg = get_config("olmo-1b").reduced().with_overrides(dtype="float32", param_dtype="float32")
    model, opt = get_model(cfg), make_optimizer_for(cfg)
    sp, so = init_pod_state(model, opt, torch.Generator().manual_seed(3), N_PODS, "cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (N_PODS, LOCAL_STEPS, PER_POD, SEQ + 1))
    batch = {"tokens": torch.from_numpy(toks[..., :-1].copy()),
             "labels": torch.from_numpy(toks[..., 1:].copy())}
    return cfg, model, opt, sp, so, batch


def _rel(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


@pytest.mark.gpu
def test_pod_round_on_card_matches_cpu():
    """Reduced olmo-1b fp32: the card's round (flash forward and backward
    once a layer a step, one ``fedavg_reduce``) within 1e-4 of the CPU's."""
    _need_card()
    cfg, model, opt, sp, so, batch = _setup()
    cpu_p, _, cpu_loss = make_fl_round_step(model, opt, LOCAL_STEPS)(sp, so, batch)
    to_card = lambda t: t.cuda()  # noqa: E731
    card_sp = tree_map(to_card, sp)
    before = (fedavg_reduce.launches, flash_attention.launches, flash_attention_bwd.launches)
    card_p, _, card_loss = make_fl_round_step(model, opt, LOCAL_STEPS)(
        card_sp, opt.init(card_sp), {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    after = (fedavg_reduce.launches, flash_attention.launches, flash_attention_bwd.launches)
    n = N_PODS * LOCAL_STEPS * cfg.n_layers
    assert tuple(a - b for a, b in zip(after, before)) == (1, n, n)
    assert abs(float(card_loss) - float(cpu_loss)) <= 1e-4 * abs(float(cpu_loss))
    for a, b in zip(tree_leaves(card_p), tree_leaves(cpu_p)):
        assert a.is_cuda and _rel(a.cpu(), b) <= 1e-4


@pytest.mark.gpu
def test_pod_round_on_card_is_bit_equal_to_sequential_twin():
    _need_card()
    cfg, model, opt, sp, so, batch = _setup()
    sp = tree_map(lambda t: t.cuda(), sp)
    so = opt.init(sp)
    batch = {k: v.cuda() for k, v in batch.items()}
    step = make_train_step(model, opt)
    finals = []
    for pod in range(N_PODS):
        p = tree_map(lambda x: x[pod], sp)
        o = type(so)(so.step, *(tree_map(lambda x: x[pod], t) for t in so[1:]))
        for s in range(LOCAL_STEPS):
            p, o, _ = step(p, o, {k: v[pod, s] for k, v in batch.items()})
        finals.append(p)
    from repro_torch.federated import fedavg_stacked

    want = fedavg_stacked(tree_map(lambda *xs: torch.stack(xs), *finals), torch.ones(N_PODS))
    got, _, _ = make_fl_round_step(model, opt, LOCAL_STEPS)(sp, so, batch)
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        for pod in range(N_PODS):
            assert torch.equal(g[pod], w)


@pytest.mark.gpu
def test_distribute_on_an_nccl_group_of_one(tmp_path):
    _need_card()
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import distribute, param_specs

    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'pg'}", world_size=1,
                            rank=0, device_id=torch.device("cuda", 0))
    try:
        mesh = make_host_mesh(data=1, model=1)
        cfg = get_config("olmo-1b").reduced()
        params = get_model(cfg).init(torch.Generator(device="cuda").manual_seed(0), "cuda")
        placed = distribute(params, mesh, param_specs(params, cfg, mesh))
        for t, d in zip(tree_leaves(params), tree_leaves(placed)):
            assert d.to_local().is_cuda and torch.equal(d.to_local(), t)
        with pytest.raises(ValueError, match="needs 2 ranks"):
            make_host_mesh(data=2)
    finally:
        dist.destroy_process_group()
