"""DataFrame → simple RDD conversion.

Rebuild of reference ``elephas/ml/adapter.py:~1``
(``df_to_simple_rdd(df, categorical, nb_classes, features_col, label_col)``):
selects the feature/label columns, densifies MLlib vectors, one-hot encodes
categorical labels, and yields an RDD of ``(x, y)`` pairs for
``SparkModel.fit``.

A copy of ``elephas_tpu/ml/adapter.py`` (framework-free, so the port keeps
its own copy instead of importing the JAX package).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..data.dataframe import DataFrame
from ..data.rdd import RDD
from ..mllib.linalg import DenseVector
from ..utils.rdd_utils import encode_label


def _to_array(features) -> np.ndarray:
    if isinstance(features, DenseVector):
        return features.toArray().astype("float32")
    return np.asarray(features, dtype="float32")


def df_to_simple_rdd(df: DataFrame, categorical: bool = False,
                     nb_classes: Optional[int] = None,
                     features_col: str = "features",
                     label_col: str = "label") -> RDD:
    """DataFrame rows → RDD of ``(features ndarray, label)`` pairs."""
    if categorical and nb_classes is None:
        nb_classes = (
            int(max(float(r[label_col]) for r in df.select(label_col).collect())) + 1
        )

    selected = df.select(features_col, label_col)

    def convert(row):
        x = _to_array(row[features_col])
        label = float(row[label_col])
        if categorical:
            y = encode_label(label, nb_classes)
        else:
            y = np.float32(label)
        return (x, y)

    return selected.rdd.map(convert)
