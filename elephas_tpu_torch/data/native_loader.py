"""ctypes bindings for the native (C++) prefetching batch loader (port of
``elephas_tpu/data/native_loader.py``).

``native/data_loader.cpp`` (the same unchanged source the JAX package
binds): C++ worker threads Fisher-Yates-shuffle and gather permuted rows
into a ring of preallocated batch slots, and the Python consumer copies
ready batches out. The shared library compiles on first use with the
system ``g++`` through :mod:`elephas_tpu_torch.native_build` (``make`` into
``native/build/libedl.so``), so both packages load the same library and
draw the same batches for a seed.
"""

from __future__ import annotations

import ctypes
from typing import Iterator, Tuple

import numpy as np

from ..native_build import load_native_library

_F32P = ctypes.POINTER(ctypes.c_float)


def _configure(lib: ctypes.CDLL) -> None:
    lib.dl_open.restype = ctypes.c_void_p
    lib.dl_open.argtypes = [_F32P, _F32P] + [ctypes.c_int64] * 6
    lib.dl_start_epoch.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.dl_next.restype = ctypes.c_int64
    lib.dl_next.argtypes = [ctypes.c_void_p, _F32P, _F32P]
    lib.dl_close.argtypes = [ctypes.c_void_p]


def _load_library() -> ctypes.CDLL:
    return load_native_library("libedl.so", _configure)


class NativeBatchLoader:
    """Prefetching shuffled batch iterator over in-memory ``(x, y)`` arrays.

    ``epoch(seed)`` yields ``(x_batch, y_batch)`` float32 views COPIED per
    batch (safe to hand to ``torch.from_numpy``); the final batch may be
    short. The loader pins the input arrays for its lifetime; use as a
    context manager or call :meth:`close`.
    """

    def __init__(self, x: np.ndarray, y: np.ndarray, batch_size: int,
                 n_prefetch: int = 4, n_threads: int = 2):
        if x.shape[0] != y.shape[0]:
            raise ValueError(
                f"row counts differ: x {x.shape[0]} vs y {y.shape[0]}"
            )
        if x.shape[0] == 0:
            raise ValueError("empty dataset")
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        lib = _load_library()
        # own contiguous float32 copies — the C++ side reads raw pointers
        self._x = np.ascontiguousarray(x, dtype=np.float32).reshape(
            x.shape[0], -1
        )
        self._y = np.ascontiguousarray(y, dtype=np.float32).reshape(
            y.shape[0], -1
        )
        self._x_shape = tuple(x.shape[1:])
        self._y_shape = tuple(y.shape[1:])
        self.batch_size = int(batch_size)
        self.n = int(x.shape[0])
        f32p = ctypes.POINTER(ctypes.c_float)
        self._h = lib.dl_open(
            self._x.ctypes.data_as(f32p), self._y.ctypes.data_as(f32p),
            self.n, self._x.shape[1], self._y.shape[1],
            self.batch_size, int(n_prefetch), int(n_threads),
        )
        if not self._h:
            raise RuntimeError("dl_open failed")
        self._lib = lib

    def epoch(self, seed: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield one shuffled epoch of batches (deterministic per seed).

        Each batch is a fresh array filled directly by the C++ side (single
        copy per batch — no staging buffer), sliced to the true row count.
        """
        if self._h is None:
            raise RuntimeError("loader is closed")
        self._lib.dl_start_epoch(self._h, int(seed))
        while True:
            xb = np.empty((self.batch_size, self._x.shape[1]), np.float32)
            yb = np.empty((self.batch_size, self._y.shape[1]), np.float32)
            rows = self._lib.dl_next(
                self._h, xb.ctypes.data_as(_F32P), yb.ctypes.data_as(_F32P)
            )
            if rows <= 0:
                return
            yield (xb[:rows].reshape((rows,) + self._x_shape),
                   yb[:rows].reshape((rows,) + self._y_shape))

    def close(self) -> None:
        if self._h is not None:
            self._lib.dl_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # best-effort; explicit close preferred
        try:
            self.close()
        except Exception:
            pass
