"""Host-side helpers of the port: RDD conversions and serialization
(copies of the JAX package's framework-free modules)."""

from .rdd_utils import (encode_label, from_labeled_point, lp_to_simple_rdd,
                        to_labeled_point, to_simple_rdd)
from .serialization import (dict_to_model, load_weights_npz, model_to_dict,
                            save_weights_npz)

__all__ = ["dict_to_model", "encode_label", "from_labeled_point",
           "load_weights_npz", "lp_to_simple_rdd", "model_to_dict",
           "save_weights_npz", "to_labeled_point", "to_simple_rdd"]
