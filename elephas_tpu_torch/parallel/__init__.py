"""Parallel building blocks of the port: so far the single-device
mixture-of-experts FFN (``expert.py``)."""

from .expert import MoEFeedForward, build_ep_train_step, build_mesh_ep

__all__ = ["MoEFeedForward", "build_ep_train_step", "build_mesh_ep"]
