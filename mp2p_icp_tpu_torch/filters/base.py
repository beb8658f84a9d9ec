"""Filter pipeline base machinery.

Port of ``mp2p_icp_tpu/filters/base.py`` (reference: FilterBase.h:53-103,
``FilterBase::filter`` and ``apply_filter_pipeline`` running the filters in
definition order). A filter is a frozen config whose ``__call__`` maps a
``{name: PointCloud}`` dict to a new dict; the pipeline also takes a
``MetricMap``, which it updates in place. Runtime variables (the twist of
the frame, the robot pose) arrive as a dict of numbers or 0-d tensors on
the layers' device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable

from mp2p_icp_tpu_torch.core.metric_map import MetricMap
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud


@dataclasses.dataclass(frozen=True)
class FilterBase:
    """Base for all filters. Subclasses implement __call__(layers) -> layers."""

    def __call__(self, layers: Dict[str, PointCloud], variables=None):
        raise NotImplementedError


def apply_filter_pipeline(filters: Iterable[FilterBase], mm, variables=None):
    """Run the filters in order (reference: FilterBase.cpp:33-98) on a
    layers dict (returns the new dict) or a MetricMap (its layers are
    replaced, extracted planes under the reserved "_planes" key become its
    planes, and the map is returned)."""
    if not isinstance(mm, (dict, MetricMap)):
        raise TypeError(f"a map is a dict of layers or a MetricMap, not {type(mm).__name__}")
    layers = dict(mm.layers if isinstance(mm, MetricMap) else mm)
    for f in filters:
        layers = f(layers, variables)
    if not isinstance(mm, MetricMap):
        return layers
    planes = layers.pop("_planes", None)
    if planes is not None:
        mm.planes = planes
    mm.layers = layers
    return mm
