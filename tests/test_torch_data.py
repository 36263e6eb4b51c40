"""The port's data sources yield byte-identical batches to the
reference's for the same seeds."""
import numpy as np
import pytest

from repro.data import make_classification_silos as jax_cls_silos
from repro.data import make_lm_silos as jax_lm_silos
from repro_torch.data import make_classification_silos, make_lm_silos


def _assert_batches_identical(a_iter, b_iter):
    a, b = list(a_iter), list(b_iter)
    assert len(a) == len(b) and a
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            assert u.dtype == v.dtype and u.shape == v.shape
            assert u.tobytes() == v.tobytes()


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("seed", [0, 7])
def test_classification_silos_identical(split, seed):
    args = (3, 62, (28, 28, 1), [(70, 20), (33, 9), (64, 32)])
    ours = make_classification_silos(*args, alpha=0.5, seed=seed)
    ref = jax_cls_silos(*args, alpha=0.5, seed=seed)
    for s, r in zip(ours, ref):
        assert s.client_id == r.client_id and s.n_train == r.n_train
        np.testing.assert_array_equal(s.class_probs, r.class_probs)
        _assert_batches_identical(s.batches(32, split), r.batches(32, split))


@pytest.mark.parametrize("split", ["train", "test"])
def test_lm_silos_identical(split):
    args = (2, 64, 24, [(50, 12), (24, 24)])
    for s, r in zip(make_lm_silos(*args, seed=3), jax_lm_silos(*args, seed=3)):
        assert s.client_id == r.client_id
        _assert_batches_identical(s.batches(24, split), r.batches(24, split))


def test_silo_count_mismatch_raises():
    with pytest.raises(ValueError):
        make_classification_silos(2, 10, (4,), [(8, 2)])
