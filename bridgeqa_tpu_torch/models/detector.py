"""VoteNet detector: backbone + voting + proposals (counterpart of
``bridgeqa_tpu/models/detector.py``)."""

import numpy as np
import torch
from torch import nn

from bridgeqa_tpu_torch.models.backbone import Pointnet2Backbone
from bridgeqa_tpu_torch.models.proposal import ProposalModule
from bridgeqa_tpu_torch.models.voting import VotingModule


class VoteNetDetector(nn.Module):
    def __init__(self, num_class: int, num_heading_bin: int, num_size_cluster: int,
                 mean_size_arr: np.ndarray, input_feature_dim: int = 0, num_proposal: int = 256,
                 vote_factor: int = 1, seed_feat_dim: int = 256, proposal_size: int = 128,
                 width: int = 1, depth: int = 2, sa_npoints=(2048, 1024, 512, 256),
                 sa_nsamples=(64, 32, 16, 16)):
        super().__init__()
        self.backbone_net = Pointnet2Backbone(input_feature_dim, width, depth, seed_feat_dim,
                                              sa_npoints, sa_nsamples)
        self.vgen = VotingModule(vote_factor, seed_feat_dim)
        self.proposal = ProposalModule(num_class, num_heading_bin, num_size_cluster, mean_size_arr,
                                       num_proposal, seed_feat_dim, proposal_size)

    def forward(self, point_clouds, bn_momentum: float = 0.1):
        """point_clouds (B, N, 3 + C) -> dict of detector outputs. In train
        mode every BatchNorm normalises with the batch statistics and moves
        its running ones by ``bn_momentum`` (JAX's ``detector(..., train=,
        bn_momentum=)``)."""
        out = self.backbone_net(point_clouds, bn_momentum)
        out["seed_inds"] = out["fp2_inds"]
        out["seed_xyz"] = out["fp2_xyz"]
        out["seed_features"] = out["fp2_features"]
        vote_xyz, vote_features = self.vgen(out["seed_xyz"], out["seed_features"], bn_momentum)
        # L2 norm over the features; an all-zero row stays zero instead of 0/0
        norm = torch.linalg.vector_norm(vote_features, dim=-1, keepdim=True)
        vote_features = vote_features / torch.where(norm == 0.0, 1.0, norm)
        out["vote_xyz"] = vote_xyz
        out["vote_features"] = vote_features
        out.update(self.proposal(vote_xyz, vote_features, bn_momentum))
        return out
