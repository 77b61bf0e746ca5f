"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The torch device an entry point runs on.

    ``None`` means the GPU: ``cuda`` when one is present, and an error when
    none is — the port never moves to the CPU unless the caller asks for it
    with ``device="cpu"``.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch version on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def mesh_device(mesh, device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device a mesh's shards sit on, resolved. ``device``, when given,
    must name that device, or this raises ``ValueError``."""
    have = mesh.device
    if device is not None:
        want = torch.device(device)
        if want.type != have.type or (want.index or 0) != (have.index or 0):
            raise ValueError(f"device {want} is not the mesh's device {have}")
    return resolve_device(have)
