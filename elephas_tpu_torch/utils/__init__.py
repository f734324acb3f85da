"""Host-side helpers of the port: parameter arithmetic, RDD conversions,
serialization, checkpoints and the socket wire (copies or ports of the JAX
package's modules of the same names)."""

from .checkpoint import (load_checkpoint, load_pytree, load_sharded_pytree,
                         place_like, save_checkpoint, save_pytree,
                         save_sharded_pytree)
from .functional_utils import (add_params, divide_by, get_neutral, mean_params,
                               scale_params, subtract_params)
from .rdd_utils import (encode_label, from_labeled_point, lp_to_simple_rdd,
                        to_labeled_point, to_simple_rdd)
from .serialization import (dict_to_model, load_weights_npz, model_to_dict,
                            save_weights_npz)
from .sockets import determine_master, receive, receive_all, send

__all__ = ["add_params", "subtract_params", "get_neutral", "divide_by",
           "scale_params", "mean_params", "to_simple_rdd", "to_labeled_point",
           "from_labeled_point", "lp_to_simple_rdd", "encode_label",
           "model_to_dict", "dict_to_model", "save_checkpoint", "load_checkpoint",
           "save_pytree", "load_pytree", "save_sharded_pytree",
           "load_sharded_pytree", "place_like", "determine_master", "send",
           "receive", "receive_all", "load_weights_npz", "save_weights_npz"]
