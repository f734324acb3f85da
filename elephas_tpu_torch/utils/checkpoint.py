"""Mid-training checkpoint / resume (port of ``elephas_tpu/utils/checkpoint.py``).

A checkpoint is a directory: ``weights.npz`` (the ordered weight list, keys
``w0…``), the optimizer state, and ``meta.json`` (progress). ``weights.npz``
and ``meta.json`` are byte-compatible with the JAX package's, so weights
cross between the two packages in both directions.

The optimizer state goes into the port's own files, with no pickle:
``opt_leaves.npz`` holds the leaves (``l0…``) and ``opt_state.json`` the
structure (dicts, lists, tuples and the port's optimizer-state NamedTuples,
by name; each leaf a numpy array or a torch tensor, by kind and dtype).
A parameter dict is written by position, in ``weights.npz``'s order
(:func:`params_by_position`), and takes the loading model's names again
(:func:`params_by_name`): Keras numbers its layers per process, so the
model that resumes may name its parameters otherwise than the one that
saved them. The trainable and the non-trainable dicts (the replica
stacks of BatchNormalization's statistics) are two groups of names, each
written with its group's number.
The JAX package's checkpoints pickle a JAX treedef (``opt_treedef.pkl``)
beside its ``opt_state.npz``; unpickling it needs JAX, so
:func:`load_checkpoint` does not read it: it warns and returns no optimizer
state, and a resumed fit restarts its optimizer. The port's own names
differ from those two, so the JAX package reads a port checkpoint's
weights and meta and finds no optimizer state there.

Durability: every file is written ATOMICALLY — to a temp sibling, flushed,
fsynced, then ``os.replace``d into place (:func:`atomic_write`) — and
``meta.json`` is renamed last (the commit point). A crash at ANY instant
therefore leaves each file either absent, the previous complete version,
or the new complete version — never torn — so :func:`has_checkpoint` and
:func:`load_checkpoint` always see a readable directory.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import warnings
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from .serialization import load_weights_npz

SHARDED_ITEM = "ROADMAP queue 1 item 6 (orbax-style sharded checkpoints over a mesh)"


@contextlib.contextmanager
def atomic_write(path: str):
    """Write ``path`` via temp sibling + flush + fsync + ``os.replace``.

    Yields the (binary) file object for the temp sibling. On success the
    sibling atomically replaces ``path``; on error it is removed and
    ``path`` is untouched — a crash mid-write can never leave a torn file
    where a reader expects a complete one. Same-directory sibling, so the
    replace never crosses filesystems.
    """
    tmp = f"{path}.tmp.{os.getpid()}"
    f = open(tmp, "wb")
    try:
        yield f
        f.flush()
        os.fsync(f.fileno())
        f.close()
        os.replace(tmp, path)
    except BaseException:
        f.close()
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
    # Best-effort directory fsync: makes the rename itself durable against
    # power loss, not just process death. Not all filesystems allow it.
    with contextlib.suppress(OSError):
        dir_fd = os.open(os.path.dirname(os.path.abspath(path)) or ".",
                         os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)


# -- trees without pickle -------------------------------------------------------


class Positional(list):
    """A parameter dict's values in the model's parameter order; ``group``
    is the index of the name list it was keyed by."""

    def __init__(self, values=(), group: int = 0):
        super().__init__(values)
        self.group = group


def params_by_position(tree: Any, *groups: List[str]) -> Any:
    """``tree`` with each dict keyed by one of the model's name lists
    ``groups`` (the trainable names, then the non-trainable ones) as a
    :class:`Positional` list of its values in that list's order (that of
    ``weights.npz``)."""
    if isinstance(tree, dict):
        for g, names in enumerate(groups):
            if len(tree) == len(names) and set(tree) == set(names):
                return Positional((params_by_position(tree[k], *groups) for k in names), g)
        return {k: params_by_position(v, *groups) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(params_by_position(v, *groups) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_by_position(v, *groups) for v in tree)
    return tree


def params_by_name(tree: Any, *groups: List[str]) -> Any:
    """The inverse of :func:`params_by_position`: each :class:`Positional`
    list a dict keyed by its group's names, which must count as many
    entries."""
    if isinstance(tree, Positional):
        names = groups[tree.group]
        if len(tree) != len(names):
            raise ValueError(f"checkpoint holds {len(tree)} parameters, the model "
                             f"{len(names)}")
        return {k: params_by_name(v, *groups) for k, v in zip(names, tree)}
    if isinstance(tree, dict):
        return {k: params_by_name(v, *groups) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(params_by_name(v, *groups) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_by_name(v, *groups) for v in tree)
    return tree


def _is_lora(tree: Any) -> bool:
    """A LoRA node (:class:`~elephas_tpu_torch.models.lora.LoRATensor`),
    saved as its ``w``, ``a``, ``b`` and ``alpha``."""
    from ..models.lora import LoRATensor

    return isinstance(tree, LoRATensor)


def _flatten(tree: Any, leaves: List[np.ndarray]) -> Any:
    """The JSON structure of ``tree``, appending its leaves to ``leaves``."""
    if isinstance(tree, Positional):
        node = {"params": [_flatten(v, leaves) for v in tree]}
        return {**node, "group": tree.group} if tree.group else node
    if isinstance(tree, torch.Tensor):
        leaves.append(tree.detach().cpu().numpy())
        return {"leaf": len(leaves) - 1, "kind": "torch"}
    if _is_lora(tree):
        children, alpha = tree.tree_flatten()
        return {"lora": [_flatten(c, leaves) for c in children],
                "alpha": float(alpha)}
    if isinstance(tree, dict):
        keys = list(tree)
        if not all(isinstance(k, str) for k in keys):
            raise TypeError(f"checkpoint trees take string dict keys, got {keys}")
        return {"dict": keys, "items": [_flatten(tree[k], leaves) for k in keys]}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = type(tree)
        if not cls.__module__.startswith("elephas_tpu_torch."):
            raise TypeError(f"checkpoint trees take the port's NamedTuples only, "
                            f"got {cls.__module__}.{cls.__qualname__}")
        return {"namedtuple": f"{cls.__module__}:{cls.__qualname__}",
                "items": [_flatten(v, leaves) for v in tree]}
    if isinstance(tree, (list, tuple)):
        return {"list" if isinstance(tree, list) else "tuple":
                [_flatten(v, leaves) for v in tree]}
    arr = np.asarray(tree)
    if arr.dtype.kind not in "biufc":  # bool/int/uint/float/complex only
        raise TypeError(
            "checkpoint trees must hold numeric array leaves; got a "
            f"non-numeric leaf of type {type(tree).__name__} (dtype {arr.dtype})")
    leaves.append(arr)
    return {"leaf": len(leaves) - 1, "kind": "numpy"}


def _unflatten(node: Any, leaves: List[np.ndarray]) -> Any:
    if "leaf" in node:
        arr = leaves[node["leaf"]]
        return torch.from_numpy(arr) if node["kind"] == "torch" else arr
    if "params" in node:
        return Positional((_unflatten(v, leaves) for v in node["params"]),
                          node.get("group", 0))
    if "lora" in node:
        from ..models.lora import LoRATensor

        return LoRATensor.tree_unflatten(
            node["alpha"], [_unflatten(v, leaves) for v in node["lora"]])
    if "dict" in node:
        return {k: _unflatten(v, leaves) for k, v in zip(node["dict"], node["items"])}
    if "namedtuple" in node:
        module, qualname = node["namedtuple"].split(":")
        if not module.startswith("elephas_tpu_torch."):
            raise ValueError(f"checkpoint names a type outside the port: {module}")
        cls = importlib.import_module(module)
        for part in qualname.split("."):
            cls = getattr(cls, part)
        return cls(*(_unflatten(v, leaves) for v in node["items"]))
    if "list" in node:
        return [_unflatten(v, leaves) for v in node["list"]]
    return tuple(_unflatten(v, leaves) for v in node["tuple"])


def _save_tree(directory: str, tree: Any, leaves_name: str, structure_name: str) -> None:
    leaves: List[np.ndarray] = []
    structure = _flatten(tree, leaves)
    with atomic_write(os.path.join(directory, leaves_name)) as f:
        np.savez(f, **{f"l{i}": leaf for i, leaf in enumerate(leaves)})
    with atomic_write(os.path.join(directory, structure_name)) as f:
        f.write(json.dumps(structure).encode("utf-8"))


def _load_tree(directory: str, leaves_name: str, structure_name: str) -> Any:
    with np.load(os.path.join(directory, leaves_name)) as data:
        leaves = [data[f"l{i}"] for i in range(len(data.files))]
    with open(os.path.join(directory, structure_name)) as f:
        structure = json.load(f)
    return _unflatten(structure, leaves)


# -- checkpoints ------------------------------------------------------------------


def save_checkpoint(directory: str, weights: List[np.ndarray],
                    meta: Dict[str, Any], opt_state: Any = None) -> None:
    """Write ``weights``, ``opt_state`` (if any) and, last, ``meta``."""
    os.makedirs(directory, exist_ok=True)
    if opt_state is not None:
        _save_tree(directory, opt_state, "opt_leaves.npz", "opt_state.json")
    with atomic_write(os.path.join(directory, "weights.npz")) as f:
        np.savez(f, **{f"w{i}": np.asarray(w) for i, w in enumerate(weights)})
    # meta.json renames last: its appearance is the checkpoint's commit point
    with atomic_write(os.path.join(directory, "meta.json")) as f:
        f.write(json.dumps(meta).encode("utf-8"))


def save_pytree(path: str, tree: Any) -> None:
    """Checkpoint a tree of numeric arrays and tensors (param dicts,
    optimizer states, worker stacks) into the directory ``path``:
    ``leaves.npz`` + ``structure.json``. Non-numeric leaves are rejected at
    save time (they would only fail at resume)."""
    os.makedirs(path, exist_ok=True)
    _save_tree(path, tree, "leaves.npz", "structure.json")


def load_pytree(path: str) -> Any:
    """Load a :func:`save_pytree` checkpoint: torch leaves as CPU tensors,
    numpy leaves as arrays."""
    return _load_tree(path, "leaves.npz", "structure.json")


def place_like(template: Any, host_tree: Any) -> Any:
    """Put each leaf of ``host_tree`` where the matching ``template`` leaf
    lives — the resume half of :func:`save_pytree`: a tensor leaf of the
    template takes the host leaf onto its device in its dtype; any other
    leaf passes through."""
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(host_tree).to(device=template.device, dtype=template.dtype)
    if _is_lora(template):
        return type(template).tree_unflatten(template.alpha, [
            place_like(t, h) for t, h in zip(template.tree_flatten()[0],
                                             host_tree.tree_flatten()[0])])
    if isinstance(template, dict):
        return {k: place_like(template[k], host_tree[k]) for k in template}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(place_like(t, h) for t, h in zip(template, host_tree)))
    if isinstance(template, (list, tuple)):
        return type(template)(place_like(t, h) for t, h in zip(template, host_tree))
    return host_tree


def save_sharded_pytree(path: str, tree: Any) -> None:
    """The reference writes each array shard from the process that owns it
    (orbax over a device mesh); the port has no mesh of processes yet."""
    raise NotImplementedError(f"save_sharded_pytree waits for {SHARDED_ITEM}")


def load_sharded_pytree(path: str, template: Any = None) -> Any:
    """See :func:`save_sharded_pytree`."""
    raise NotImplementedError(f"load_sharded_pytree waits for {SHARDED_ITEM}")


def load_checkpoint(directory: str) -> Tuple[List[np.ndarray], Dict[str, Any], Any]:
    """Returns ``(weights, meta, opt_state_or_None)``. A JAX-package
    checkpoint's optimizer state (a pickled JAX treedef) is not read: it
    warns and gives ``None``, and the resumed fit restarts its optimizer."""
    weights = load_weights_npz(os.path.join(directory, "weights.npz"))
    with open(os.path.join(directory, "meta.json")) as f:
        meta = json.load(f)
    opt_state = None
    if os.path.exists(os.path.join(directory, "opt_state.json")):
        opt_state = _load_tree(directory, "opt_leaves.npz", "opt_state.json")
    elif os.path.exists(os.path.join(directory, "opt_treedef.pkl")):
        warnings.warn(
            f"checkpoint {directory}: the optimizer state was written by the "
            "JAX package (a pickled JAX treedef), which the port does not read; "
            "the weights load and the optimizer restarts",
            RuntimeWarning, stacklevel=2)
    return weights, meta, opt_state


def has_checkpoint(directory: str) -> bool:
    """True only for a checkpoint :func:`load_checkpoint` can actually
    read: ``meta.json`` must parse AND ``weights.npz`` must exist.

    ``meta.json`` is written last (the commit point), so its mere presence
    USUALLY implies a complete checkpoint — but a crash mid-write of a
    non-atomic writer leaves a truncated meta, and an auto-resume probe must
    treat any such partial directory as "no checkpoint".
    """
    meta_path = os.path.join(directory, "meta.json")
    if not os.path.exists(meta_path):
        return False
    if not os.path.exists(os.path.join(directory, "weights.npz")):
        return False
    try:
        with open(meta_path) as f:
            json.load(f)
    except (json.JSONDecodeError, OSError):
        return False
    return True
