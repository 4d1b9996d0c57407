"""PointNet++ backbone, 4 SA + 2 FP (counterpart of
``bridgeqa_tpu/models/backbone.py``)."""

from torch import nn

from bridgeqa_tpu_torch.models.pointnet2 import PointnetFPModule, PointnetSAModuleVotes


class Pointnet2Backbone(nn.Module):
    def __init__(self, input_feature_dim: int = 0, width: int = 1, depth: int = 2,
                 seed_feat_dim: int = 256, sa_npoints=(2048, 1024, 512, 256),
                 sa_nsamples=(64, 32, 16, 16)):
        super().__init__()
        w, d = width, depth
        np1, np2, np3, np4 = sa_npoints
        ns1, ns2, ns3, ns4 = sa_nsamples
        self.sa1 = PointnetSAModuleVotes(input_feature_dim, [64 * w] * d + [128 * w], np1, 0.2, ns1)
        self.sa2 = PointnetSAModuleVotes(128 * w, [128 * w] * d + [256 * w], np2, 0.4, ns2)
        self.sa3 = PointnetSAModuleVotes(256 * w, [128 * w] * d + [256 * w], np3, 0.8, ns3)
        self.sa4 = PointnetSAModuleVotes(256 * w, [128 * w] * d + [256 * w], np4, 1.2, ns4)
        self.fp1 = PointnetFPModule(512 * w, [256 * w, 256 * w])
        self.fp2 = PointnetFPModule(512 * w, [256 * w, seed_feat_dim])

    def forward(self, point_clouds, bn_momentum: float = 0.1):
        """point_clouds (B, N, 3 + input_feature_dim) -> dict of the sa1..sa4
        and fp2 xyz/features (+ inds), channel-last."""
        xyz = point_clouds[..., :3]
        features = point_clouds[..., 3:] if point_clouds.shape[-1] > 3 else None
        out = {}
        xyz1, feat1, inds1 = self.sa1(xyz, features, bn_momentum)
        out["sa1_inds"], out["sa1_xyz"], out["sa1_features"] = inds1, xyz1, feat1
        xyz2, feat2, inds2 = self.sa2(xyz1, feat1, bn_momentum)
        out["sa2_inds"], out["sa2_xyz"], out["sa2_features"] = inds2, xyz2, feat2
        xyz3, feat3, _ = self.sa3(xyz2, feat2, bn_momentum)
        out["sa3_xyz"], out["sa3_features"] = xyz3, feat3
        xyz4, feat4, _ = self.sa4(xyz3, feat3, bn_momentum)
        out["sa4_xyz"], out["sa4_features"] = xyz4, feat4

        feat_fp1 = self.fp1(xyz3, xyz4, feat3, feat4, bn_momentum)
        out["fp2_features"] = self.fp2(xyz2, xyz3, feat2, feat_fp1, bn_momentum)
        out["fp2_xyz"] = xyz2
        out["fp2_inds"] = inds1[:, : xyz2.shape[1]]  # indices into the raw cloud
        return out
