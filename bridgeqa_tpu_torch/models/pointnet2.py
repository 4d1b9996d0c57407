"""PointNet++ set abstraction and feature propagation (counterpart of
``bridgeqa_tpu/models/pointnet2.py``), channel-last: features (B, N, C),
grouped tensors (B, M, S, 3 + C)."""

import torch
from torch import nn

from bridgeqa_tpu_torch.models.layers import SharedMLP
from bridgeqa_tpu_torch.ops import (
    ball_query_stripes,
    furthest_point_sample_with_xyz,
    group_points,
    three_interpolate,
    three_nn,
)
from bridgeqa_tpu_torch.ops.grouping import MAX_KERNEL_FEATS


class PointnetSAModuleVotes(nn.Module):
    """FPS -> stripe ball query and grouping (recentred xyz over the radius,
    then the features) -> shared MLP -> max pool over the ball. Every caller
    of the JAX module passes ``use_xyz`` and ``normalize_xyz`` and max
    pooling, so those are fixed here.

    The stripe path of the JAX module (the one its chip runs): with 1 to 4
    feature channels the ball query gathers them in its own sweep, wider
    features go through ``group_points``."""

    def __init__(self, in_features: int, mlp, npoint: int, radius: float, nsample: int):
        super().__init__()
        if nsample % 2:
            raise ValueError(f"the stripe ball query needs an even nsample, got {nsample}")
        self.npoint = npoint
        self.radius = radius
        self.nsample = nsample
        self.mlp_module = SharedMLP(3 + in_features, mlp)

    def forward(self, xyz: torch.Tensor, features: torch.Tensor | None = None,
                bn_momentum: float = 0.1):
        """xyz (B, N, 3); features (B, N, C) or None. Returns new_xyz
        (B, npoint, 3), new_features (B, npoint, mlp[-1]), inds (B, npoint)
        int32."""
        inds, new_xyz = furthest_point_sample_with_xyz(xyz, self.npoint)
        nf = 0 if features is None else features.shape[-1]
        if 0 < nf <= MAX_KERNEL_FEATS:
            _, rel, grouped = ball_query_stripes(self.radius, self.nsample, xyz, new_xyz, features)
        else:
            idx, rel, _ = ball_query_stripes(self.radius, self.nsample, xyz, new_xyz)
            grouped = group_points(features, idx) if nf else None
        rel = rel / self.radius
        x = rel if grouped is None else torch.cat([rel.to(grouped.dtype), grouped], dim=-1)
        new_features = self.mlp_module(x, bn_momentum).amax(dim=2)
        return new_xyz, new_features, inds


class PointnetFPModule(nn.Module):
    """3-NN inverse-distance interpolation, then a shared MLP over
    ``[interpolated, unknown_feats]``."""

    def __init__(self, in_features: int, mlp):
        super().__init__()
        self.mlp = SharedMLP(in_features, mlp)

    def forward(self, unknown, known, unknown_feats, known_feats, bn_momentum: float = 0.1):
        dist, idx = three_nn(unknown, known)
        dist_recip = 1.0 / (dist + 1e-8)
        weight = dist_recip / dist_recip.sum(dim=2, keepdim=True)
        interpolated = three_interpolate(known_feats, idx, weight)
        if unknown_feats is not None:
            interpolated = torch.cat([interpolated, unknown_feats.to(interpolated.dtype)], dim=-1)
        return self.mlp(interpolated, bn_momentum)
