"""Batched and sharded checking on the device, the counterpart of the
reference's ``jepsen_tpu.parallel``: many histories decided as one search
(``check_batch``), and one history's frontier sharded over a mesh
(``frontier.check_encoded_sharded``).

A :class:`Mesh` here is D shards of one search on ONE device: the shards
are the members of a batch, and the reference's collectives between chips
are kernels between the shards' buffers. A transport across several GPUs
(NCCL collectives or peer copies) comes with a later slice of the port; a
mesh over more than one device is refused."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from ..devices import resolve_device


class Mesh:
    """Named axes over shards that all sit on ``device``. ``shape[axis]``
    is an axis' size, as on the reference's ``jax.sharding.Mesh``."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], device):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} does not match axes "
                             f"{tuple(axis_names)}")
        if any(int(n) < 1 for n in shape):
            raise ValueError(f"mesh shape {tuple(shape)} has an empty axis")
        self.axis_names = tuple(axis_names)
        self.shape = {a: int(n) for a, n in zip(axis_names, shape)}
        self.device = torch.device(device)

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"


def make_mesh(n_devices: Optional[int] = None, shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("dp", "mp"), device=None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``n_devices`` shards (default: ``shape``'s, else 1;
    ``shape`` defaults to ``(n, 1)``) on one device: the GPU unless ``device="cpu"``. ``devices``
    names a device per shard; they must all be one device, since the
    transport across several GPUs comes with a later slice of the port."""
    if devices is not None:
        distinct = {str(torch.device(d)) for d in devices}
        if len(distinct) > 1:
            raise ValueError(
                f"a mesh over {len(distinct)} devices ({sorted(distinct)}) needs the "
                "multi-GPU transport (NCCL collectives or peer copies), which comes "
                "with a later slice of the port; lay the shards on one device")
        if distinct:
            device = device if device is not None else distinct.pop()
        if n_devices is None:
            n_devices = len(devices)
    if shape is None:
        shape = (1 if n_devices is None else int(n_devices), 1)
    shape = tuple(int(x) for x in shape)
    if n_devices is not None and math.prod(shape) != int(n_devices):
        raise ValueError(f"mesh shape {shape} does not hold {n_devices} shards")
    return Mesh(shape, tuple(axis_names[:len(shape)]), resolve_device(device))


from .batch import check_batch, check_encoded_batch, check_histories  # noqa: E402

__all__ = ["Mesh", "check_batch", "check_encoded_batch", "check_histories", "make_mesh"]
