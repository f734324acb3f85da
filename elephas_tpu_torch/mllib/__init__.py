"""MLlib facade (copies of ``elephas_tpu/mllib``)."""

from .adapter import from_matrix, from_vector, to_matrix, to_vector
from .linalg import DenseMatrix, DenseVector, LabeledPoint, Matrices, Vectors

__all__ = [
    "DenseMatrix",
    "DenseVector",
    "LabeledPoint",
    "Matrices",
    "Vectors",
    "to_matrix",
    "from_matrix",
    "to_vector",
    "from_vector",
]
