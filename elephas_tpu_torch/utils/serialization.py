"""Model (de)serialization (port of ``elephas_tpu/utils/serialization.py``).

``model_to_dict`` gives the reference's wire format, ``{'model': <Keras
JSON config>, 'weights': [np.ndarray, ...]}``, for any object with
``to_json()`` and ``get_weights()`` (a Keras model, read duck-typed, or the
port's adapter). ``dict_to_model`` is its inverse and returns the port's
:class:`~elephas_tpu_torch.models.adapters.KerasModelAdapter`; old
artifacts whose ``'model'`` is a YAML config (the reference's ``to_yaml``)
are converted to JSON first. Also the npz weight persistence.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np


def model_to_dict(model) -> Dict[str, Any]:
    """Model → ``{'model': <json str>, 'weights': [np.ndarray, ...]}``."""
    return {
        "model": model.to_json(),
        "weights": [np.asarray(w) for w in model.get_weights()],
    }


def yaml_config_to_json(config: str) -> str:
    """Old-style ``model.to_yaml()`` architecture string → JSON config (the
    same config structure, serialized as YAML)."""
    try:
        import yaml
    except ImportError as e:  # pragma: no cover - PyYAML is normally present
        raise ValueError(
            "this artifact stores a YAML model config (reference to_yaml "
            "format) and PyYAML is not installed to convert it"
        ) from e
    return json.dumps(yaml.safe_load(config))


def dict_to_model(d: Dict[str, Any], custom_objects: Optional[dict] = None,
                  device="cuda"):
    """Inverse of :func:`model_to_dict`: the port's adapter over the config
    and weights; also accepts the reference's old YAML-config dicts."""
    from ..models.adapters import KerasModelAdapter

    config = d["model"]
    if not config.lstrip().startswith("{"):  # JSON configs are objects;
        config = yaml_config_to_json(config)  # YAML ones start with a key
    return KerasModelAdapter.from_json(config, weights=d["weights"],
                                       custom_objects=custom_objects, device=device)


def save_weights_npz(path: str, weights: List[np.ndarray]) -> None:
    """Persist a weight list as an ordered npz archive, atomically (temp
    sibling + fsync + rename)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **{f"w{i}": np.asarray(w)
                           for i, w in enumerate(weights)})
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_weights_npz(path: str) -> List[np.ndarray]:
    with np.load(path) as data:
        return [data[f"w{i}"] for i in range(len(data.files))]
