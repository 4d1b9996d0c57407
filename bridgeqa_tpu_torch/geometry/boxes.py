"""Box parameter decoding on the device (counterpart of the decode part of
``bridgeqa_tpu/geometry/boxes.py``)."""

import math

import torch

# corner sign pattern of utils/box_util.py:299-321 (x: l, y: w, z: h)
_CORNER_SIGNS = (
    (1, 1, 1), (1, -1, 1), (-1, -1, 1), (-1, 1, 1),
    (1, 1, -1), (1, -1, -1), (-1, -1, -1), (-1, 1, -1),
)


def heading_class_residual_to_angle(heading_class, heading_residual, num_heading_bin: int):
    """Bin centre + residual, wrapped to (-pi, pi]."""
    angle = heading_class.float() * (2.0 * math.pi / float(num_heading_bin)) + heading_residual
    return torch.where(angle > math.pi, angle - 2.0 * math.pi, angle)


def params_to_obb(center, heading_class, heading_residual, size_class, size_residual,
                  mean_size_arr, num_heading_bin: int = 1):
    """(..., 7) boxes [cx, cy, cz, l, w, h, -angle]."""
    angle = heading_class_residual_to_angle(heading_class, heading_residual, num_heading_bin)
    box_size = mean_size_arr[size_class] + size_residual
    return torch.cat([center, box_size, -angle[..., None]], dim=-1)


def get_3d_box_batch(box_size, heading_angle, center):
    """Box parameters -> (..., 8, 3) corners, rotated about z by the
    reference's roty convention (``get_3d_box_batch``)."""
    c = torch.cos(heading_angle)[..., None]
    s = torch.sin(heading_angle)[..., None]
    signs = torch.tensor(_CORNER_SIGNS, dtype=torch.float32, device=box_size.device)
    corners = signs * (box_size[..., None, :] / 2.0)
    x, y, z = corners[..., 0], corners[..., 1], corners[..., 2]
    rx = c * x + s * z
    rz = -s * x + c * z
    return torch.stack([rx, y, rz], dim=-1) + center[..., None, :]


def decode_pred_box(center, heading_scores, heading_residuals, size_scores, size_residuals,
                    mean_size_arr, num_heading_bin: int = 1):
    """Argmax heading and size class, their residuals, then the corners.

    center (B, K, 3); heading_scores/residuals (B, K, NH); size_scores
    (B, K, NS); size_residuals (B, K, NS, 3); mean_size_arr (NS, 3) ->
    (B, K, 8, 3)."""
    hcls = heading_scores.argmax(dim=-1)
    hres = heading_residuals.gather(-1, hcls[..., None])[..., 0]
    scls = size_scores.argmax(dim=-1)
    sres = size_residuals.gather(-2, scls[..., None, None].expand(*scls.shape, 1, 3))[..., 0, :]
    obb = params_to_obb(center, hcls, hres, scls, sres, mean_size_arr, num_heading_bin)
    return get_3d_box_batch(obb[..., 3:6], obb[..., 6], obb[..., 0:3])
