from mp2p_icp_tpu_torch.quality.paired_ratio import QualityPairedRatio  # noqa: F401
