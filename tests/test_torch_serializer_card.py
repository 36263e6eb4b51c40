"""Card-only tests of the weight blob's staged path: CUDA leaves reach the
host through the calling thread's pinned chunks (``serialize_pytree``).

This file imports no JAX, so it collects on the card's machine with
``--noconftest``; every test is marked ``gpu`` and skips without a card.
The blob's bytes against the reference's are held on the CPU in
``tests/test_torch_checkpoint.py``; here a CUDA tree's blob is held
against the blob of its ``.cpu()`` copy, which takes no staging.
"""
import threading

import pytest
import torch

from repro_torch.checkpoint import serializer
from repro_torch.checkpoint.serializer import serialize_pytree
from repro_torch.utils import spans
from repro_torch.utils.tree import tree_leaves, tree_map

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    yield
    spans.disable()
    spans.take()


def _tree(seed, n=4096):
    """Mixed dtypes on the card: bf16, fp32, a transposed (non-contiguous)
    view, fp8, int64, bool, a 0-d and a 0-element leaf."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn(n // 64, 64, generator=g, device="cuda")
    return {
        "w": w,
        "bf16": [w.to(torch.bfloat16), (w * 3).to(torch.bfloat16)[:, 1:]],
        "t": w.t(),
        "fp8": w.to(torch.float8_e4m3fn),
        "ids": torch.arange(n // 3, device="cuda") * seed,
        "mask": w[0] > 0,
        "scalar": w[0, 0].clone(),
        "none": torch.zeros(0, 5, device="cuda"),
    }


def _cpu(tree):
    return tree_map(lambda t: t.cpu(), tree)


def _data_bytes(tree):
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def test_cuda_blob_is_its_cpu_copys():
    tree = _tree(1)
    blob = serialize_pytree(tree)
    assert type(blob) is bytes
    assert blob == serialize_pytree(_cpu(tree))


def test_leaves_across_staging_chunks():
    # Leaves larger than a pinned chunk, and odd-sized ones that end inside
    # one, so copies split across chunks and both chunks are reused.
    g = torch.Generator(device="cuda").manual_seed(6)
    big = torch.randn(3 * serializer._CHUNK // 4 + 7, generator=g, device="cuda")
    tree = {"big": big, "odd": [big[: 1000 + i].to(torch.bfloat16) for i in range(9)],
            "t": big[: 4099 * 1001].view(4099, 1001).t(), "tail": big[:-3]}
    assert serialize_pytree(tree) == serialize_pytree(_cpu(tree))


def test_empty_cuda_leaves():
    tree = {"b": torch.zeros(0, device="cuda"), "c": torch.zeros(3, 0, device="cuda")}
    assert serialize_pytree(tree) == serialize_pytree(_cpu(tree))


def test_blobs_do_not_share_the_staging_buffer():
    # Each blob must read the same after later calls have reused the
    # thread's pinned chunks for other trees.
    trees = [_tree(2), _tree(3, n=1 << 16), _tree(4)]
    want = [serialize_pytree(_cpu(t)) for t in trees]
    got = [serialize_pytree(t) for t in trees]
    assert got == want


def test_threads_serialize_at_once():
    trees = [_tree(10 + i, n=1 << 14) for i in range(4)]
    want = [serialize_pytree(_cpu(t)) for t in trees]
    start = threading.Barrier(len(trees))
    got = [[] for _ in trees]

    def work(i):
        start.wait(timeout=30)
        for _ in range(25):
            got[i].append(serialize_pytree(trees[i]))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(len(trees))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for i, blobs in enumerate(got):
        assert len(blobs) == 25 and all(b == want[i] for b in blobs)


def test_staged_counter():
    tree = _tree(5)
    spans.enable()
    with spans.span("fl.round", round=1):
        serialize_pytree(tree)
    with spans.span("fl.round", round=2):
        serialize_pytree(_cpu(tree))
    taken = spans.take()
    spans.disable()
    staged = taken.counters["fl.bytes.staged"]
    assert staged[1] == _data_bytes(tree)
    assert staged.get(2, 0) == 0
