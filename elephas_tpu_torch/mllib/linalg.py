"""``pyspark.mllib.linalg`` / ``regression.LabeledPoint`` facade.

A copy of ``elephas_tpu/mllib/linalg.py``.

The reference's MLlib skin (``elephas/spark_model.py:~200`` ``SparkMLlibModel``
and ``elephas/mllib/adapter.py:~1``) speaks LabeledPoint RDDs and MLlib
``Vector``/``Matrix`` values. There is no JVM here, so these are thin numpy
carriers with the same names and accessors user code touches
(``DenseVector.toArray()``, ``DenseMatrix(numRows, numCols, values)``,
``LabeledPoint(label, features)``).
"""

from __future__ import annotations

import numpy as np


class DenseVector:
    def __init__(self, values):
        self._values = np.asarray(values, dtype=np.float64).reshape(-1)

    def toArray(self) -> np.ndarray:
        return np.array(self._values)

    @property
    def values(self) -> np.ndarray:
        return self._values

    def __len__(self):
        return len(self._values)

    def __getitem__(self, i):
        return self._values[i]

    def __iter__(self):
        return iter(self._values)

    def __eq__(self, other):
        return isinstance(other, DenseVector) and np.array_equal(
            self._values, other._values
        )

    def __repr__(self):
        return f"DenseVector({self._values.tolist()})"


class DenseMatrix:
    """Column-major dense matrix, matching MLlib's storage convention."""

    def __init__(self, numRows: int, numCols: int, values):
        self.numRows = int(numRows)
        self.numCols = int(numCols)
        self._values = np.asarray(values, dtype=np.float64).reshape(-1)
        if self._values.size != self.numRows * self.numCols:
            raise ValueError("values size does not match numRows*numCols")

    def toArray(self) -> np.ndarray:
        # MLlib DenseMatrix is column-major (Fortran order).
        return self._values.reshape((self.numRows, self.numCols), order="F")

    @property
    def values(self) -> np.ndarray:
        return self._values

    def __eq__(self, other):
        return (
            isinstance(other, DenseMatrix)
            and self.numRows == other.numRows
            and self.numCols == other.numCols
            and np.array_equal(self._values, other._values)
        )

    def __repr__(self):
        return f"DenseMatrix({self.numRows}, {self.numCols})"


class Vectors:
    @staticmethod
    def dense(*values) -> DenseVector:
        if len(values) == 1 and np.ndim(values[0]) >= 1:
            return DenseVector(values[0])
        return DenseVector(values)


class Matrices:
    @staticmethod
    def dense(numRows: int, numCols: int, values) -> DenseMatrix:
        return DenseMatrix(numRows, numCols, values)


class LabeledPoint:
    """``pyspark.mllib.regression.LabeledPoint`` facade."""

    def __init__(self, label, features):
        self.label = float(label)
        self.features = (
            features if isinstance(features, DenseVector) else DenseVector(features)
        )

    def __repr__(self):
        return f"LabeledPoint({self.label}, {self.features})"

    def __eq__(self, other):
        return (
            isinstance(other, LabeledPoint)
            and self.label == other.label
            and self.features == other.features
        )
