from mp2p_icp_tpu_torch.pipeline.yaml_loader import (  # noqa: F401
    filter_pipeline_from_yaml,
    filter_pipeline_from_yaml_file,
    icp_pipeline_from_yaml,
    icp_pipeline_from_yaml_file,
    load_icp_config_file,
)
from mp2p_icp_tpu_torch.pipeline.plugins import (  # noqa: F401
    load_plugin,
    register_filter,
    register_matcher,
    register_quality,
    register_solver,
)
