"""Point ops of the port: FPS and the stripe ball query (hand-written CUDA
kernels with plain PyTorch versions beside them), grouping and
three-NN interpolation."""

from bridgeqa_tpu_torch.ops.grouping import (
    ball_query_stripes,
    group_all,
    group_points,
    query_and_group,
)
from bridgeqa_tpu_torch.ops.interpolate import three_interpolate, three_nn
from bridgeqa_tpu_torch.ops.sampling import (
    furthest_point_sample,
    furthest_point_sample_with_xyz,
    gather_points,
)

__all__ = [
    "ball_query_stripes",
    "furthest_point_sample",
    "furthest_point_sample_with_xyz",
    "gather_points",
    "group_all",
    "group_points",
    "query_and_group",
    "three_interpolate",
    "three_nn",
]
