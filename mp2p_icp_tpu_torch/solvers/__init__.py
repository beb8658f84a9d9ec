from mp2p_icp_tpu_torch.solvers.robust import RobustKernel, robust_sqrt_weight  # noqa: F401
from mp2p_icp_tpu_torch.solvers.horn import optimal_tf_horn  # noqa: F401
from mp2p_icp_tpu_torch.solvers.gauss_newton import (  # noqa: F401
    GNParams,
    optimal_tf_gauss_newton,
)
