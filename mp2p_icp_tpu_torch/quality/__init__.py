from mp2p_icp_tpu_torch.quality.paired_ratio import QualityPairedRatio  # noqa: F401
from mp2p_icp_tpu_torch.quality.range_image import QualityRangeImageSimilarity  # noqa: F401
from mp2p_icp_tpu_torch.quality.voxels import QualityVoxels  # noqa: F401
