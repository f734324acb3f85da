"""Parallel building blocks of the port: the single-device
mixture-of-experts FFN (``expert.py``), the device list (``mesh.py``), the
data-parallel training engine of the MLP fit (``engine.py``) and the elastic
host pool over emulated host processes (``elastic.py``, ``emulation.py``)."""

from .elastic import ElasticConfig, ElasticHostPool
from .emulation import EmulationBackend
from .engine import CompiledTrainer, FitResult, epoch_permutation
from .expert import EXPERT_AXIS, MoEFeedForward, build_ep_train_step, build_mesh_ep
from .mesh import DeviceMesh, build_mesh

__all__ = ["CompiledTrainer", "DeviceMesh", "EXPERT_AXIS", "ElasticConfig",
           "ElasticHostPool", "EmulationBackend", "FitResult",
           "MoEFeedForward", "build_ep_train_step", "build_mesh", "build_mesh_ep",
           "epoch_permutation"]
