"""Parallel building blocks of the port: the single-device
mixture-of-experts FFN (``expert.py``), the device list (``mesh.py``) and
the data-parallel training engine of the MLP fit (``engine.py``)."""

from .engine import CompiledTrainer, FitResult, epoch_permutation
from .expert import EXPERT_AXIS, MoEFeedForward, build_ep_train_step, build_mesh_ep
from .mesh import DeviceMesh, build_mesh

__all__ = ["CompiledTrainer", "DeviceMesh", "EXPERT_AXIS", "FitResult",
           "MoEFeedForward", "build_ep_train_step", "build_mesh", "build_mesh_ep",
           "epoch_permutation"]
