from mp2p_icp_tpu_torch.filters.base import FilterBase, apply_filter_pipeline  # noqa: F401
from mp2p_icp_tpu_torch.filters.decimate_voxels import (  # noqa: F401
    DecimateMethod,
    FilterDecimateVoxels,
)
from mp2p_icp_tpu_torch.filters.by_range import FilterByRange  # noqa: F401
from mp2p_icp_tpu_torch.filters.bounding_box import FilterBoundingBox  # noqa: F401
from mp2p_icp_tpu_torch.filters.by_ring import FilterByRing  # noqa: F401
from mp2p_icp_tpu_torch.filters.by_intensity import (  # noqa: F401
    FilterByIntensity,
    FilterNormalizeIntensity,
)
from mp2p_icp_tpu_torch.filters.deskew import FilterDeskew  # noqa: F401
from mp2p_icp_tpu_torch.filters.adjust_timestamps import (  # noqa: F401
    FilterAdjustTimestamps,
    TimestampAdjustMethod,
)
from mp2p_icp_tpu_torch.filters.merge import FilterMerge  # noqa: F401
from mp2p_icp_tpu_torch.filters.estimate_normals import FilterEstimateNormals  # noqa: F401
from mp2p_icp_tpu_torch.filters.delete_layer import FilterDeleteLayer  # noqa: F401
from mp2p_icp_tpu_torch.filters.curvature import FilterCurvature  # noqa: F401
from mp2p_icp_tpu_torch.filters.edge_generators import (  # noqa: F401
    GeneratorEdgesFromCurvature,
    GeneratorEdgesFromRangeImage,
)
from mp2p_icp_tpu_torch.filters.edges_planes import FilterEdgesPlanes  # noqa: F401
from mp2p_icp_tpu_torch.filters.pole_detector import FilterPoleDetector  # noqa: F401
