"""Filter pipeline base machinery.

Port of ``mp2p_icp_tpu/filters/base.py`` (reference: FilterBase.h:53-103,
``FilterBase::filter`` and ``apply_filter_pipeline`` running the filters in
definition order). A filter is a frozen config whose ``__call__`` maps a
``{name: PointCloud}`` dict to a new dict; runtime variables (the twist of
the frame, the robot pose) arrive as a dict of numbers or 0-d tensors on
the layers' device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable

from mp2p_icp_tpu_torch.core.pointcloud import PointCloud


@dataclasses.dataclass(frozen=True)
class FilterBase:
    """Base for all filters. Subclasses implement __call__(layers) -> layers."""

    def __call__(self, layers: Dict[str, PointCloud], variables=None):
        raise NotImplementedError


def apply_filter_pipeline(filters: Iterable[FilterBase], layers, variables=None):
    """Run the filters in order on a layers dict and return the new dict
    (reference: FilterBase.cpp:33-98)."""
    if not isinstance(layers, dict):
        raise NotImplementedError(
            f"layers are passed as a dict of PointCloud; {type(layers).__name__} "
            "input (MetricMap) is not ported yet"
        )
    layers = dict(layers)
    for f in filters:
        layers = f(layers, variables)
    return layers
