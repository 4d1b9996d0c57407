"""Box parameter decoding and 3D IoU on the device (counterpart of
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


def box3d_min_max(corners):
    """(..., 8, 3) corners -> ((..., 3) min, (..., 3) max)."""
    return corners.amin(dim=-2), corners.amax(dim=-2)


def aabb_iou(min1, max1, min2, max2):
    """Axis-aligned IoU from min/max extents, with the reference's 1e-8 in
    the denominator."""
    lo = torch.maximum(min1, min2)
    hi = torch.minimum(max1, max2)
    inter = (hi - lo).clamp(min=0.0).prod(dim=-1)
    vol1 = (max1 - min1).prod(dim=-1)
    vol2 = (max2 - min2).prod(dim=-1)
    return inter / (vol1 + vol2 - inter + 1e-8)


def box3d_iou_batch(corners1, corners2):
    """Axis-aligned 3D IoU of the boxes' corners (``box3d_iou_batch``)."""
    return aabb_iou(*box3d_min_max(corners1), *box3d_min_max(corners2))


def _clip_polygon_area(rect1, rect2):
    """Area of the intersection of counter-clockwise quads rect1 and rect2
    (..., 4, 2): Sutherland-Hodgman clipping of rect1 by rect2's four edges,
    batched with a fixed vertex buffer of 8 (a convex-convex quad
    intersection has at most 8 vertices; slot 8 takes the candidates that
    are dropped), as the JAX function. A polygon that empties has area 0.
    Returns (...)."""
    buf = 8
    shape = rect1.shape[:-2]
    r1 = rect1.reshape(-1, 4, 2).float()
    r2 = rect2.reshape(-1, 4, 2).float()
    p = r1.shape[0]
    rows = torch.arange(p, device=r1.device)
    slot = torch.arange(buf, device=r1.device)
    verts = torch.cat([r1, r1.new_zeros(p, buf - 4, 2)], dim=1)
    n = torch.full((p,), 4, dtype=torch.int64, device=r1.device)
    for e in range(4):
        cp1, cp2 = r2[:, (e - 1) % 4], r2[:, e]  # the edge (rect2[e-1], rect2[e])
        valid = slot[None] < n[:, None]
        prev = torch.roll(verts, 1, dims=1)
        prev[:, 0] = verts[rows, (n - 1).clamp(min=0)]  # the last valid vertex

        def side(q):  # strictly inside, as the reference
            return ((cp2[:, None, 0] - cp1[:, None, 0]) * (q[..., 1] - cp1[:, None, 1])
                    - (cp2[:, None, 1] - cp1[:, None, 1]) * (q[..., 0] - cp1[:, None, 0])) > 0

        ins, ins_prev = side(verts), side(prev)
        dc = cp1 - cp2
        dp = prev - verts
        denom = dc[:, None, 0] * dp[..., 1] - dc[:, None, 1] * dp[..., 0]
        safe = torch.where(denom.abs() < 1e-12, 1.0, denom)
        n1 = cp1[:, 0] * cp2[:, 1] - cp1[:, 1] * cp2[:, 0]
        n2 = prev[..., 0] * verts[..., 1] - prev[..., 1] * verts[..., 0]
        inter = (n1[:, None, None] * dp - n2[..., None] * dc[:, None, :]) / safe[..., None]
        # per input vertex, in the reference's order: the crossing, then the
        # vertex itself when inside
        flags = torch.stack([valid & (ins != ins_prev), valid & ins], dim=2).reshape(p, 2 * buf)
        cands = torch.stack([inter, verts], dim=2).reshape(p, 2 * buf, 2)
        pos = flags.cumsum(dim=1) - 1
        idx = torch.where(flags & (pos < buf), pos, buf)
        verts = r1.new_zeros(p, buf + 1, 2).scatter(
            1, idx[..., None].expand(-1, -1, 2), cands)[:, :buf]
        n = flags.sum(dim=1)
    # shoelace, with the empty slots pinned to vertex 0 (their edges add 0)
    verts = torch.where((slot[None] < n.clamp(min=1)[:, None])[..., None], verts, verts[:, :1])
    x, y = verts[..., 0], verts[..., 1]
    area = 0.5 * (x * torch.roll(y, -1, dims=1) - torch.roll(x, -1, dims=1) * y).sum(dim=1).abs()
    return torch.where(n >= 3, area, 0.0).reshape(shape)


def box3d_iou_oriented(corners1, corners2):
    """Rotated-box 3D IoU (``box3d_iou_oriented``): the top faces' footprint
    intersection in (x, y) by polygon clipping times the vertical overlap in
    z, over volumes from edge lengths. corners (..., 8, 3) in the
    ``get_3d_box_batch`` convention, broadcast; returns (...)."""
    corners1, corners2 = torch.broadcast_tensors(corners1.float(), corners2.float())
    shape = corners1.shape[:-2]
    a = corners1.reshape(-1, 8, 3)
    b = corners2.reshape(-1, 8, 3)
    top = [3, 2, 1, 0]  # counter-clockwise in (x, y)
    inter_area = _clip_polygon_area(a[:, top, :2], b[:, top, :2])
    zmax = torch.minimum(a[:, 0, 2], b[:, 0, 2])
    zmin = torch.maximum(a[:, 4, 2], b[:, 4, 2])
    inter_vol = inter_area * (zmax - zmin).clamp(min=0.0)

    def vol(c):
        return ((c[:, 0] - c[:, 1]).pow(2).sum(-1).sqrt() * (c[:, 1] - c[:, 2]).pow(2).sum(-1).sqrt()
                * (c[:, 0] - c[:, 4]).pow(2).sum(-1).sqrt())

    return (inter_vol / (vol(a) + vol(b) - inter_vol + 1e-8)).reshape(shape)


def box3d_iou_auto(corners1, corners2, *, num_heading_bin: int = 1):
    """The axis-aligned IoU for a single heading bin (every heading is 0
    there, as the reference treats it), the rotated one otherwise."""
    if num_heading_bin == 1:
        return box3d_iou_batch(corners1, corners2)
    return box3d_iou_oriented(corners1, corners2)


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
