"""numpy ↔ MLlib linalg conversions (a copy of ``elephas_tpu/mllib/adapter.py``).

Rebuild of reference ``elephas/mllib/adapter.py:~1`` (``to_matrix``,
``from_matrix``, ``to_vector``, ``from_vector``) against the local
:mod:`~elephas_tpu.mllib.linalg` facade.
"""

from __future__ import annotations

import numpy as np

from .linalg import DenseMatrix, DenseVector, Matrices, Vectors


def to_matrix(np_array: np.ndarray) -> DenseMatrix:
    """2-D numpy array → MLlib ``DenseMatrix`` (column-major values)."""
    arr = np.asarray(np_array)
    if arr.ndim != 2:
        raise ValueError(f"to_matrix expects a 2-D array, got shape {arr.shape}")
    return Matrices.dense(arr.shape[0], arr.shape[1], arr.flatten(order="F"))


def from_matrix(matrix: DenseMatrix) -> np.ndarray:
    """MLlib ``DenseMatrix`` → 2-D numpy array."""
    return matrix.toArray()


def to_vector(np_array: np.ndarray) -> DenseVector:
    """1-D numpy array → MLlib ``DenseVector``."""
    arr = np.asarray(np_array)
    if arr.ndim != 1:
        raise ValueError(f"to_vector expects a 1-D array, got shape {arr.shape}")
    return Vectors.dense(arr)


def from_vector(vector: DenseVector) -> np.ndarray:
    """MLlib ``DenseVector`` → 1-D numpy array."""
    return vector.toArray()
