"""Where the port's constructors put their tensors.

The port runs on the card unless the caller asks for the CPU. Every
constructor that makes tensors from host data (``PointCloud.from_numpy``,
``convert.pointcloud_from_numpy`` / ``pose_from_numpy``, ``se3.identity`` /
``from_xyz_ypr``, the ``empty`` pairing blocks) takes ``device=None`` to
mean ``default_device()``; everything downstream follows its inputs.

``default_device()`` is ``cuda`` until ``set_default_device`` says
otherwise. It never looks whether a card is present and never gives way to
the CPU: without a card and without a request for the CPU, torch's own
error surfaces at the first allocation.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

_requested: Optional[torch.device] = None


def default_device() -> torch.device:
    """The device of a constructor called without ``device=``."""
    return torch.device("cuda") if _requested is None else _requested


def set_default_device(device: Union[None, str, torch.device]) -> None:
    """Ask for ``device`` (e.g. ``"cpu"``, ``"cuda:1"``) wherever a
    constructor is called without one; ``None`` withdraws the request."""
    global _requested
    _requested = None if device is None else torch.device(device)


def resolve(device: Union[None, str, torch.device]) -> torch.device:
    """``device`` itself, or the default when it is None."""
    return default_device() if device is None else torch.device(device)
