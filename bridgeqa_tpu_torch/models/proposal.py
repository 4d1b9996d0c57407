"""Vote aggregation, proposal head and box decoding (counterpart of
``bridgeqa_tpu/models/proposal.py``)."""

import math

import numpy as np
import torch
from torch import nn

from bridgeqa_tpu_torch.geometry.boxes import decode_pred_box
from bridgeqa_tpu_torch.models.layers import Dense, SharedMLP
from bridgeqa_tpu_torch.models.pointnet2 import PointnetSAModuleVotes


class ProposalModule(nn.Module):
    def __init__(self, num_class: int, num_heading_bin: int, num_size_cluster: int,
                 mean_size_arr: np.ndarray, num_proposal: int = 256, seed_feat_dim: int = 256,
                 proposal_size: int = 128, radius: float = 0.3, nsample: int = 16):
        super().__init__()
        p = proposal_size
        self.num_heading_bin = num_heading_bin
        self.num_size_cluster = num_size_cluster
        # torch.tensor (not from_numpy) follows a torch.device context
        self.register_buffer("mean_size", torch.tensor(np.asarray(mean_size_arr, np.float32)),
                             persistent=False)
        self.vote_aggregation = PointnetSAModuleVotes(seed_feat_dim, [p, p, p], num_proposal,
                                                      radius, nsample)
        self.proposal_mlp = SharedMLP(p, [p, p])
        out_dim = 2 + 3 + num_heading_bin * 2 + num_size_cluster * 4 + num_class
        self.proposal_out = Dense(p, out_dim, init="kaiming")

    def forward(self, xyz, features, bn_momentum: float = 0.1):
        """xyz (B, K, 3) votes, features (B, K, C) -> dict of proposal fields."""
        agg_xyz, agg_features, fps_inds = self.vote_aggregation(xyz, features, bn_momentum)
        out = {
            "aggregated_vote_xyz": agg_xyz,
            "aggregated_vote_features": agg_features,
            "aggregated_vote_inds": fps_inds,
        }
        net = self.proposal_out(self.proposal_mlp(agg_features, bn_momentum))
        out.update(self.decode_scores(net, agg_xyz))
        return out

    def decode_scores(self, net, base_xyz):
        """Split the head channels (objectness, centre, heading, size,
        semantic class) and decode corners."""
        nh, ns = self.num_heading_bin, self.num_size_cluster
        b, k, _ = net.shape
        objectness_scores = net[..., 0:2]
        center = base_xyz + net[..., 2:5]
        heading_scores = net[..., 5:5 + nh]
        heading_residuals_normalized = net[..., 5 + nh:5 + 2 * nh]
        size_scores = net[..., 5 + 2 * nh:5 + 2 * nh + ns]
        size_residuals_normalized = net[..., 5 + 2 * nh + ns:5 + 2 * nh + 4 * ns].reshape(b, k, ns, 3)
        sem_cls_scores = net[..., 5 + 2 * nh + 4 * ns:]
        heading_residuals = heading_residuals_normalized * (math.pi / nh)
        size_residuals = size_residuals_normalized * self.mean_size[None, None]
        out = {
            "objectness_scores": objectness_scores,
            "center": center,
            "heading_scores": heading_scores,
            "heading_residuals_normalized": heading_residuals_normalized,
            "heading_residuals": heading_residuals,
            "size_scores": size_scores,
            "size_residuals_normalized": size_residuals_normalized,
            "size_residuals": size_residuals,
            "sem_cls_scores": sem_cls_scores,
        }
        out["bbox_corner"] = decode_pred_box(center, heading_scores, heading_residuals, size_scores,
                                             size_residuals, self.mean_size, nh)
        out["bbox_mask"] = objectness_scores.argmax(dim=-1)
        out["bbox_sems"] = sem_cls_scores.argmax(dim=-1)
        return out
