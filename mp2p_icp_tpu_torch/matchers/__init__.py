from mp2p_icp_tpu_torch.matchers.base import (  # noqa: F401
    LayerMatch,
    MatchContext,
    MatchState,
    Matcher,
)
from mp2p_icp_tpu_torch.matchers.distance_threshold import (  # noqa: F401
    MatcherPointsDistanceThreshold,
)
from mp2p_icp_tpu_torch.matchers.adaptive import MatcherAdaptive  # noqa: F401
from mp2p_icp_tpu_torch.matchers.inlier_ratio import MatcherPointsInlierRatio  # noqa: F401
from mp2p_icp_tpu_torch.matchers.point2line import MatcherPoint2Line  # noqa: F401
from mp2p_icp_tpu_torch.matchers.point2plane import MatcherPoint2Plane  # noqa: F401
