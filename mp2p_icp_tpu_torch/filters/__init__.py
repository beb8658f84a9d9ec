from mp2p_icp_tpu_torch.filters.base import FilterBase, apply_filter_pipeline  # noqa: F401
from mp2p_icp_tpu_torch.filters.decimate_voxels import (  # noqa: F401
    DecimateMethod,
    FilterDecimateVoxels,
)
from mp2p_icp_tpu_torch.filters.deskew import FilterDeskew  # noqa: F401
from mp2p_icp_tpu_torch.filters.merge import FilterMerge  # noqa: F401
