"""The VoteNet detector of the reference, plain PyTorch, eval mode.

Frozen from ``bridgeqa_tpu_torch/models/{pointnet2,backbone,voting,proposal,
detector}.py`` and ``geometry/boxes.py::decode_pred_box``, on the stripe
ball query (the port's rule on every device), with the kernel calls replaced
by ``points.py``.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from qa_bench.reference import points
from qa_bench.reference.nn import BatchNorm, Dense, SharedMLP

_CORNER_SIGNS = ((1, 1, 1), (1, -1, 1), (-1, -1, 1), (-1, 1, 1),
                 (1, 1, -1), (1, -1, -1), (-1, -1, -1), (-1, 1, -1))


class SetAbstraction(nn.Module):
    """FPS, stripe ball query and grouping (recentred xyz over the radius,
    then the features), shared MLP, max over the ball."""

    def __init__(self, in_features: int, mlp, npoint: int, radius: float, nsample: int):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.mlp_module = SharedMLP(3 + in_features, mlp)

    def forward(self, xyz, features=None):
        inds, new_xyz = points.furthest_point_sample(xyz, self.npoint)
        idx, rel = points.ball_query_stripes(self.radius, self.nsample, xyz, new_xyz)
        rel = rel / self.radius
        if features is not None:
            grouped = points.group_points(features, idx)
            rel = torch.cat([rel.to(grouped.dtype), grouped], dim=-1)
        x = rel
        return new_xyz, self.mlp_module(x).amax(dim=2), inds


class FeaturePropagation(nn.Module):
    def __init__(self, in_features: int, mlp):
        super().__init__()
        self.mlp = SharedMLP(in_features, mlp)

    def forward(self, unknown, known, unknown_feats, known_feats):
        dist, idx = points.three_nn(unknown, known)
        recip = 1.0 / (dist + 1e-8)
        weight = recip / recip.sum(dim=2, keepdim=True)
        x = points.three_interpolate(known_feats, idx, weight)
        return self.mlp(torch.cat([x, unknown_feats.to(x.dtype)], dim=-1))


class Backbone(nn.Module):
    def __init__(self, input_feature_dim, width, depth, seed_feat_dim, npoints, nsamples):
        super().__init__()
        w, d = width, depth
        self.sa1 = SetAbstraction(input_feature_dim, [64 * w] * d + [128 * w], npoints[0], 0.2,
                                  nsamples[0])
        self.sa2 = SetAbstraction(128 * w, [128 * w] * d + [256 * w], npoints[1], 0.4, nsamples[1])
        self.sa3 = SetAbstraction(256 * w, [128 * w] * d + [256 * w], npoints[2], 0.8, nsamples[2])
        self.sa4 = SetAbstraction(256 * w, [128 * w] * d + [256 * w], npoints[3], 1.2, nsamples[3])
        self.fp1 = FeaturePropagation(512 * w, [256 * w, 256 * w])
        self.fp2 = FeaturePropagation(512 * w, [256 * w, seed_feat_dim])

    def forward(self, point_clouds):
        xyz = point_clouds[..., :3]
        feats = point_clouds[..., 3:] if point_clouds.shape[-1] > 3 else None
        xyz1, f1, _ = self.sa1(xyz, feats)
        xyz2, f2, _ = self.sa2(xyz1, f1)
        xyz3, f3, _ = self.sa3(xyz2, f2)
        xyz4, f4, _ = self.sa4(xyz3, f3)
        return xyz2, self.fp2(xyz2, xyz3, f2, self.fp1(xyz3, xyz4, f3, f4))


class Voting(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.c = c
        self.conv1, self.bn1 = Dense(c, c), BatchNorm(c)
        self.conv2, self.bn2 = Dense(c, c), BatchNorm(c)
        self.conv3 = Dense(c, 3 + c)

    def forward(self, seed_xyz, seed_features):
        net = F.relu(self.bn1(self.conv1(seed_features)))
        net = self.conv3(F.relu(self.bn2(self.conv2(net))))
        return seed_xyz + net[..., 0:3], seed_features + net[..., 3:]


def decode_boxes(center, heading_scores, heading_residuals, size_scores, size_residuals,
                 mean_size, num_heading_bin):
    """Argmax heading and size class with their residuals -> (B, K, 8, 3)."""
    hcls = heading_scores.argmax(dim=-1)
    hres = heading_residuals.gather(-1, hcls[..., None])[..., 0]
    scls = size_scores.argmax(dim=-1)
    sres = size_residuals.gather(-2, scls[..., None, None].expand(*scls.shape, 1, 3))[..., 0, :]
    angle = hcls.float() * (2.0 * math.pi / float(num_heading_bin)) + hres
    angle = -torch.where(angle > math.pi, angle - 2.0 * math.pi, angle)
    box_size = mean_size[scls] + sres
    c, s = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    signs = torch.tensor(_CORNER_SIGNS, dtype=torch.float32, device=center.device)
    corners = signs * (box_size[..., None, :] / 2.0)
    x, y, z = corners[..., 0], corners[..., 1], corners[..., 2]
    return torch.stack([c * x + s * z, y, -s * x + c * z], dim=-1) + center[..., None, :]


class Proposal(nn.Module):
    def __init__(self, num_class, num_heading_bin, num_size_cluster, num_proposal, seed_feat_dim,
                 proposal_size):
        super().__init__()
        p = proposal_size
        self.nh, self.ns = num_heading_bin, num_size_cluster
        self.register_buffer("mean_size", torch.empty(num_size_cluster, 3), persistent=False)
        self.vote_aggregation = SetAbstraction(seed_feat_dim, [p, p, p], num_proposal, 0.3, 16)
        self.proposal_mlp = SharedMLP(p, [p, p])
        self.proposal_out = Dense(p, 2 + 3 + num_heading_bin * 2 + num_size_cluster * 4
                                  + num_class)

    def forward(self, xyz, features):
        agg_xyz, agg_features, _ = self.vote_aggregation(xyz, features)
        net = self.proposal_out(self.proposal_mlp(agg_features))
        nh, ns = self.nh, self.ns
        b, k, _ = net.shape
        objectness = net[..., 0:2]
        center = agg_xyz + net[..., 2:5]
        heading_scores = net[..., 5:5 + nh]
        heading_res = net[..., 5 + nh:5 + 2 * nh] * (math.pi / nh)
        size_scores = net[..., 5 + 2 * nh:5 + 2 * nh + ns]
        size_res = (net[..., 5 + 2 * nh + ns:5 + 2 * nh + 4 * ns].reshape(b, k, ns, 3)
                    * self.mean_size[None, None])
        sem = net[..., 5 + 2 * nh + 4 * ns:]
        return {
            "aggregated_vote_features": agg_features,
            "objectness_scores": objectness,
            "center": center,
            "sem_cls_scores": sem,
            "bbox_corner": decode_boxes(center, heading_scores, heading_res, size_scores,
                                        size_res, self.mean_size, nh),
            "bbox_mask": objectness.argmax(dim=-1),
        }


class Detector(nn.Module):
    """Module names as the port's ``VoteNetDetector``."""

    def __init__(self, c: dict):
        super().__init__()
        self.backbone_net = Backbone(c["input_feature_dim"], c["pointnet_width"],
                                     c["pointnet_depth"], c["seed_feat_dim"],
                                     c["backbone_sa_npoints"], c["backbone_sa_nsamples"])
        self.vgen = Voting(c["seed_feat_dim"])
        self.proposal = Proposal(c["num_object_class"], c["num_heading_bin"],
                                 c["num_size_cluster"], c["num_proposal"], c["seed_feat_dim"],
                                 c["proposal_size"])

    def forward(self, point_clouds):
        seed_xyz, seed_features = self.backbone_net(point_clouds)
        vote_xyz, vote_features = self.vgen(seed_xyz, seed_features)
        norm = torch.linalg.vector_norm(vote_features, dim=-1, keepdim=True)
        vote_features = vote_features / torch.where(norm == 0.0, 1.0, norm)
        return self.proposal(vote_xyz, vote_features)
