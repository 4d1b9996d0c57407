"""Hough voting (counterpart of ``bridgeqa_tpu/models/voting.py``)."""

import torch.nn.functional as F
from torch import nn

from bridgeqa_tpu_torch.models.layers import BatchNorm, Dense


class VotingModule(nn.Module):
    def __init__(self, vote_factor: int, seed_feature_dim: int):
        super().__init__()
        c = seed_feature_dim
        self.vote_factor = vote_factor
        self.seed_feature_dim = c
        # the reference's raw Conv1d keeps its bias next to BN
        self.conv1 = Dense(c, c, init="kaiming")
        self.bn1 = BatchNorm(c)
        self.conv2 = Dense(c, c, init="kaiming")
        self.bn2 = BatchNorm(c)
        self.conv3 = Dense(c, (3 + c) * vote_factor, init="kaiming")

    def forward(self, seed_xyz, seed_features, bn_momentum: float = 0.1):
        """seed_xyz (B, S, 3), seed_features (B, S, C) -> vote_xyz
        (B, S * vote_factor, 3), vote_features (B, S * vote_factor, C)."""
        b, num_seed, _ = seed_xyz.shape
        c = self.seed_feature_dim
        num_vote = num_seed * self.vote_factor
        net = F.relu(self.bn1(self.conv1(seed_features), bn_momentum))
        net = F.relu(self.bn2(self.conv2(net), bn_momentum))
        net = self.conv3(net).reshape(b, num_seed, self.vote_factor, 3 + c)
        vote_xyz = (seed_xyz[:, :, None, :] + net[..., 0:3]).reshape(b, num_vote, 3)
        vote_features = (seed_features[:, :, None, :] + net[..., 3:]).reshape(b, num_vote, c)
        return vote_xyz, vote_features
