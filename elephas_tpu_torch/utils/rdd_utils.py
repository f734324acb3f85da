"""Data → RDD conversions (a copy of ``elephas_tpu/utils/rdd_utils.py``).

Rebuild of reference ``elephas/utils/rdd_utils.py:~1``: ``to_simple_rdd``,
``to_labeled_point``, ``from_labeled_point``, ``lp_to_simple_rdd``,
``encode_label`` — same signatures and semantics, over the local facade RDD
and MLlib-lite types instead of pyspark.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..data.rdd import RDD, SparkContext
from ..mllib.adapter import from_vector
from ..mllib.linalg import LabeledPoint


def to_simple_rdd(sc: SparkContext, features: np.ndarray, labels: np.ndarray,
                  num_slices: Optional[int] = None) -> RDD:
    """Zip feature/label arrays into an RDD of ``(x, y)`` sample pairs.

    Reference: ``rdd_utils.to_simple_rdd`` — ``sc.parallelize(zip(features,
    labels))``. Each element is one sample; workers re-densify per partition
    (reference ``elephas/worker.py:~25``).
    """
    features = np.asarray(features)
    labels = np.asarray(labels)
    if len(features) != len(labels):
        raise ValueError(
            f"features ({len(features)}) and labels ({len(labels)}) lengths differ"
        )
    pairs = list(zip(features, labels))
    return sc.parallelize(pairs, num_slices)


def encode_label(label: float, nb_classes: int) -> np.ndarray:
    """One-hot encode a scalar class label. Reference: ``rdd_utils.encode_label``."""
    encoded = np.zeros(int(nb_classes), dtype=np.float32)
    encoded[int(label)] = 1.0
    return encoded


def to_labeled_point(sc: SparkContext, features: np.ndarray, labels: np.ndarray,
                     categorical: bool = False) -> RDD:
    """Feature/label arrays → RDD[LabeledPoint].

    Reference: ``rdd_utils.to_labeled_point``. For ``categorical`` labels the
    LabeledPoint stores the argmax class index (labels may be one-hot or
    scalar class ids).
    """
    features = np.asarray(features)
    labels = np.asarray(labels)
    points = []
    for x, y in zip(features, labels):
        if categorical:
            y_val = float(np.argmax(y)) if np.ndim(y) >= 1 else float(y)
        else:
            y_val = float(y)
        points.append(LabeledPoint(y_val, np.asarray(x).reshape(-1)))
    return sc.parallelize(points)


def from_labeled_point(rdd: RDD, categorical: bool = False,
                       nb_classes: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """RDD[LabeledPoint] → dense ``(features, labels)`` numpy arrays.

    Reference: ``rdd_utils.from_labeled_point`` (one-hot labels when
    ``categorical``).
    """
    points = rdd.collect()
    features = np.asarray([from_vector(lp.features) for lp in points])
    if categorical:
        if nb_classes is None:
            nb_classes = int(max(lp.label for lp in points)) + 1
        labels = np.asarray([encode_label(lp.label, nb_classes) for lp in points])
    else:
        labels = np.asarray([lp.label for lp in points])
    return features, labels


def lp_to_simple_rdd(lp_rdd: RDD, categorical: bool = False,
                     nb_classes: Optional[int] = None) -> RDD:
    """RDD[LabeledPoint] → RDD[(x, y)], one-hot when categorical.

    Reference: ``rdd_utils.lp_to_simple_rdd`` — the bridge
    ``SparkMLlibModel.fit`` uses (``elephas/spark_model.py:~210``).
    """
    if categorical and nb_classes is None:
        nb_classes = int(max(lp.label for lp in lp_rdd.collect())) + 1

    if categorical:
        return lp_rdd.map(
            lambda lp: (from_vector(lp.features), encode_label(lp.label, nb_classes))
        )
    return lp_rdd.map(lambda lp: (from_vector(lp.features), np.float32(lp.label)))
