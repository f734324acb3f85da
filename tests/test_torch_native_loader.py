"""The port's native prefetching batch loader
(``elephas_tpu_torch/data/native_loader.py``) against the JAX package's.

The reference's ``tests/data/test_native_loader.py`` cases (completeness,
determinism per seed, epoch restarts under three threads, n-d features,
validation) run on the port's binding, and the two packages' loaders give
the same batches, byte for byte, for one seed: both bind the unchanged
``native/data_loader.cpp``.
"""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
import numpy as np
import pytest

from elephas_tpu.data.native_loader import NativeBatchLoader as JNativeBatchLoader
from elephas_tpu_torch.data import NativeBatchLoader


def _data(n=257, d=5, c=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.normal(size=(n, c)).astype(np.float32)
    return x, y


def test_epoch_is_complete_shuffled_permutation():
    x, y = _data()
    with NativeBatchLoader(x, y, batch_size=32) as dl:
        got_x, got_y, sizes = [], [], []
        for xb, yb in dl.epoch(seed=7):
            assert xb.shape[1:] == x.shape[1:]
            got_x.append(xb)
            got_y.append(yb)
            sizes.append(xb.shape[0])
        gx = np.concatenate(got_x)
        gy = np.concatenate(got_y)
    assert gx.shape == x.shape
    assert sizes[-1] == 257 % 32
    order = np.lexsort(gx.T)
    base = np.lexsort(x.T)
    np.testing.assert_array_equal(gx[order], x[base])
    np.testing.assert_array_equal(gy[order], y[base])
    assert not np.array_equal(gx, x)


def test_deterministic_per_seed_and_varies_across_seeds():
    x, y = _data(n=96)
    with NativeBatchLoader(x, y, batch_size=16) as dl:
        a = [xb.copy() for xb, _ in dl.epoch(seed=3)]
        b = [xb.copy() for xb, _ in dl.epoch(seed=3)]
        c = [xb.copy() for xb, _ in dl.epoch(seed=4)]
    for xa, xb_ in zip(a, b):
        np.testing.assert_array_equal(xa, xb_)
    assert any(not np.array_equal(xa, xc) for xa, xc in zip(a, c))


@pytest.mark.parametrize("seed", [0, 11])
def test_batches_equal_the_reference_loaders_byte_for_byte(seed):
    """One dataset, one seed, three prefetch threads: the port's batches
    are the reference's, byte for byte, in order, over two epochs."""
    x, y = _data(n=203, d=7, c=2, seed=seed)
    runs = []
    for cls in (JNativeBatchLoader, NativeBatchLoader):
        with cls(x, y, batch_size=24, n_prefetch=3, n_threads=3) as dl:
            runs.append([(xb.tobytes(), yb.tobytes(), xb.shape, yb.shape)
                         for e in (seed, seed + 1) for xb, yb in dl.epoch(seed=e)])
    assert runs[0] == runs[1]
    assert len(runs[1]) == 2 * 9


def test_many_epochs_stress():
    """Epoch restarts (abandoned mid-epoch iterators included) must not
    deadlock or corrupt batches."""
    x, y = _data(n=128, d=3, c=2)
    x[:, 0] = np.arange(128)
    with NativeBatchLoader(x, y, batch_size=16, n_prefetch=3, n_threads=3) as dl:
        for e in range(30):
            it = dl.epoch(seed=e)
            if e % 3 == 1:
                next(it)
                continue
            ids = np.concatenate([xb[:, 0] for xb, _ in it])
            np.testing.assert_array_equal(np.sort(ids), np.arange(128))


def test_nd_features_roundtrip():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(40, 4, 3)).astype(np.float32)
    y = rng.normal(size=(40, 2)).astype(np.float32)
    with NativeBatchLoader(x, y, batch_size=8) as dl:
        for xb, yb in dl.epoch(seed=0):
            assert xb.shape[1:] == (4, 3)
            for row_x, row_y in zip(xb, yb):
                src = np.where((y == row_y).all(axis=1))[0]
                assert len(src) == 1
                np.testing.assert_array_equal(row_x, x[src[0]])


def test_validation():
    x, y = _data(n=8)
    with pytest.raises(ValueError, match="row counts"):
        NativeBatchLoader(x, y[:4], batch_size=2)
    with pytest.raises(ValueError, match="empty"):
        NativeBatchLoader(x[:0], y[:0], batch_size=2)
    with pytest.raises(ValueError, match="batch_size"):
        NativeBatchLoader(x, y, batch_size=0)
    dl = NativeBatchLoader(x, y, batch_size=2)
    dl.close()
    with pytest.raises(RuntimeError, match="closed"):
        next(dl.epoch(0))
