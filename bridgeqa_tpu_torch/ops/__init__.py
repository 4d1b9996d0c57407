"""Point ops of the port: FPS and the stripe and exact ball queries
(hand-written CUDA kernels with plain PyTorch versions beside them),
grouping and three-NN interpolation, and the row gather. The fused transformer paths
live in ``scoring_layer``, ``vocab_loss`` and ``vit_block``."""

from bridgeqa_tpu_torch.ops.gather import gather_rows
from bridgeqa_tpu_torch.ops.grouping import (
    ball_query,
    ball_query_exact,
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
    "ball_query",
    "ball_query_exact",
    "ball_query_stripes",
    "furthest_point_sample",
    "furthest_point_sample_with_xyz",
    "gather_points",
    "gather_rows",
    "group_all",
    "group_points",
    "query_and_group",
    "three_interpolate",
    "three_nn",
]
