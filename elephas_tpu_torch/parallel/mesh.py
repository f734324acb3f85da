"""Device lists for the data-parallel engine (port of
``elephas_tpu/parallel/mesh.py``).

The reference's "cluster" is a 1-D ``jax.sharding.Mesh`` over the local
devices with one ``"data"`` axis. This slice of the port runs on one
device: :func:`build_mesh` returns a list of one ``torch.device``, and
more than one raises :class:`NotImplementedError` until the multi-GPU
process groups land (ROADMAP queue 1 item 6).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .. import DeviceLike, resolve_device

DATA_AXIS = "data"
MULTI_DEVICE_ITEM = "ROADMAP queue 1 item 6 (process groups over several GPUs)"


class DeviceMesh:
    """The devices data-parallel workers are spread over (one, so far),
    along one named axis (``axis_names``, as a JAX ``Mesh`` has)."""

    def __init__(self, devices: Sequence[torch.device], axis_name: str = DATA_AXIS):
        self.devices: List[torch.device] = list(devices)
        self.axis_names = (axis_name,)
        if len(self.devices) != 1:
            raise NotImplementedError(
                f"a mesh of {len(self.devices)} devices waits for {MULTI_DEVICE_ITEM}")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def build_mesh(num_devices: Optional[int] = None,
               devices: Optional[Sequence[DeviceLike]] = None,
               axis_name: str = DATA_AXIS, *,
               device: DeviceLike = "cuda") -> DeviceMesh:
    """A 1-D data-parallel mesh with the reference's signature: ``devices``
    if given, else the port's ``device`` (keyword-only); ``axis_name``
    names its axis."""
    devs = [resolve_device(d) for d in devices] if devices is not None \
        else [resolve_device(device)]
    if num_devices is not None:
        if num_devices > len(devs):
            raise NotImplementedError(
                f"a mesh of {num_devices} devices waits for {MULTI_DEVICE_ITEM}")
        devs = devs[:num_devices]
    return DeviceMesh(devs, axis_name)
