from mp2p_icp_tpu_torch.utils.profiler import Profiler, profile_scope  # noqa: F401
