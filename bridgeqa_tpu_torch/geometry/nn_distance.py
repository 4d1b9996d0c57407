"""Chamfer nearest-neighbour distance and the Huber loss (counterpart of
``bridgeqa_tpu/geometry/nn_distance.py``), used by the vote and centre
losses."""

import torch

from bridgeqa_tpu_torch.ops.grouping import pairwise_sqdist


def huber_loss(error: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """0.5 x^2 for |x| <= delta, else 0.5 delta^2 + delta (|x| - delta)."""
    abs_error = error.abs()
    quadratic = abs_error.clamp(max=delta)
    linear = abs_error - quadratic
    return 0.5 * quadratic**2 + delta * linear


def nn_distance(pc1: torch.Tensor, pc2: torch.Tensor, l1smooth: bool = False, delta: float = 1.0,
                l1: bool = False):
    """Nearest neighbours both ways between pc1 (B, N, C) and pc2 (B, M, C):
    (dist1 (B, N), idx1 (B, N), dist2 (B, M), idx2 (B, M)), each the least
    distance to the other set and its first argmin, under the squared L2
    distance (in f32, ``pairwise_sqdist``), the Huber one (``l1smooth``) or
    L1 (``l1``)."""
    if l1smooth or l1:
        diff = pc1[:, :, None, :] - pc2[:, None, :, :]
        pc_dist = (huber_loss(diff, delta) if l1smooth else diff.abs()).sum(dim=-1)
    else:
        pc_dist = pairwise_sqdist(pc1, pc2)
    dist1, idx1 = pc_dist.min(dim=2)
    dist2, idx2 = pc_dist.min(dim=1)
    return dist1, idx1, dist2, idx2
