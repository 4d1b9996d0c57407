"""2D -> 3D back-projection of per-frame features onto scene points
(counterpart of ``bridgeqa_tpu/tools/projection.py``).

Each scene point is projected into every selected frame; a hit counts where
it lands inside the frame, at a depth between 0.1 and 4.0 m, within 0.05 m
of the frame's depth there (the feature grid is 41x32, the reference
driver's defaults). The frame's ENet features at the hit pixel are gathered
and max-pooled across views into the 128 ``use_multiview`` channels of each
point.

The JAX package maps one view's projection over the views with ``vmap``;
here the views are one batched (V, N) computation on the points' device.
Numerics kept from JAX: the pose is inverted in f32 (``torch.linalg.inv``),
``torch.round`` rounds half to even as ``jnp.round`` does, a depth within
1e-6 of 0 is replaced as at ``projection.py:81``, and the features are
gathered by plain indexing (``features[v, u]``), as in JAX (``:67``).
"""

import numpy as np
import torch

DEPTH_MIN = 0.1
DEPTH_MAX = 4.0
ACCURACY = 0.05
FEATURE_DIMS = (41, 32)  # (W, H) of the ENet feature map


def adjust_intrinsic(intrinsic, image_dims_old, image_dims_new):
    """Rescale a pinhole intrinsic matrix to a new image resolution
    (``projection.py``'s resize handling). intrinsic: (4, 4) numpy."""
    intrinsic = np.array(intrinsic, dtype=np.float64)
    sx = image_dims_new[0] / image_dims_old[0]
    sy = image_dims_new[1] / image_dims_old[1]
    intrinsic[0, 0] *= sx
    intrinsic[1, 1] *= sy
    intrinsic[0, 2] *= (image_dims_new[0] - 1) / (image_dims_old[0] - 1)
    intrinsic[1, 2] *= (image_dims_new[1] - 1) / (image_dims_old[1] - 1)
    return intrinsic


class ProjectionHelper:
    """Depth-consistent point -> pixel projection at the feature
    resolution. Every method takes tensors on one device and may take a
    leading views axis on the poses, depths and maps."""

    def __init__(self, intrinsic, depth_min=DEPTH_MIN, depth_max=DEPTH_MAX,
                 image_dims=FEATURE_DIMS, accuracy=ACCURACY):
        """intrinsic: (4, 4) at ``image_dims`` resolution. image_dims (W, H)."""
        self.intrinsic = np.asarray(intrinsic, np.float32)
        self.depth_min = depth_min
        self.depth_max = depth_max
        self.image_dims = image_dims
        self.accuracy = accuracy

    def project(self, points, camera_to_world, depth):
        """points (N, 3) world; camera_to_world (..., 4, 4); depth (..., H,
        W) at the feature resolution. Returns (uv (..., N, 2) int32 [u, v],
        valid (..., N) bool)."""
        return _project(points, camera_to_world, depth,
                        torch.as_tensor(self.intrinsic, device=points.device), self.depth_min,
                        self.depth_max, self.accuracy, self.image_dims)

    def project_features(self, points, camera_to_world, depth, features):
        """Gather each point's features from each view; invalid points get 0.

        features (..., H, W, C) -> ((..., N, C), valid (..., N))."""
        uv, valid = self.project(points, camera_to_world, depth)
        gathered = _at_pixels(features, uv)
        return torch.where(valid[..., None], gathered, 0.0), valid


def _at_pixels(maps, uv):
    """maps (..., H, W[, C]) at the pixels uv (..., N, 2) -> (..., N[, C])."""
    lead = uv.shape[:-2]
    views = torch.arange(int(np.prod(lead, dtype=np.int64)), device=uv.device).reshape(
        *lead, 1)
    flat = maps.reshape(-1, *maps.shape[len(lead):])
    return flat[views, uv[..., 1].long(), uv[..., 0].long()]


def _project(points, camera_to_world, depth, intrinsic, depth_min, depth_max, accuracy,
             image_dims):
    w, h = image_dims
    world_to_camera = torch.linalg.inv(camera_to_world)
    ones = torch.ones((points.shape[0], 1), dtype=points.dtype, device=points.device)
    pcam = (torch.cat([points, ones], dim=1) @ world_to_camera.transpose(-1, -2))[..., :3]
    z = pcam[..., 2]
    fx, fy = intrinsic[0, 0], intrinsic[1, 1]
    cx, cy = intrinsic[0, 2], intrinsic[1, 2]
    safe_z = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    u = torch.round(fx * pcam[..., 0] / safe_z + cx).to(torch.int32)
    v = torch.round(fy * pcam[..., 1] / safe_z + cy).to(torch.int32)
    in_bounds = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    in_range = (z >= depth_min) & (z <= depth_max)
    uv = torch.stack([u.clamp(0, w - 1), v.clamp(0, h - 1)], dim=-1)
    d = _at_pixels(depth, uv)
    consistent = torch.abs(d - z) <= accuracy
    return uv, in_bounds & in_range & consistent


def aggregate_multiview(per_view_feats, per_view_valid, mode: str = "maxpool"):
    """Combine per-view point features (V, N, C) and valid (V, N) into (N, C).

    ``maxpool`` matches the reference's ``enet_feats_maxpool`` artifacts;
    ``mean`` averages over valid views."""
    valid = per_view_valid[..., None]
    if mode == "maxpool":
        masked = torch.where(valid, per_view_feats, -torch.inf)
        out = masked.amax(dim=0)
        return torch.where(torch.isfinite(out), out, 0.0)
    if mode == "mean":
        s = torch.where(valid, per_view_feats, 0.0).sum(dim=0)
        n = valid.sum(dim=0)
        return s / n.clamp(min=1)
    raise ValueError(mode)


def project_scene_multiview(helper: ProjectionHelper, points, poses, depths, features,
                            mode: str = "maxpool"):
    """The whole scene: points (N, 3), poses (V, 4, 4), depths (V, H, W),
    features (V, H, W, C), tensors on one device -> (N, C)."""
    feats, valids = helper.project_features(points, poses, depths, features)
    return aggregate_multiview(feats, valids, mode)
