"""Farthest-point sampling and point gathering.

Counterpart of ``bridgeqa_tpu/ops/sampling.py``. On a CUDA tensor
``furthest_point_sample_with_xyz`` launches the hand-written kernel in
``csrc/fps.cu``; on a CPU tensor it runs ``fps_plain``, the plain PyTorch
version of the same recurrence. Semantics (the reference CUDA kernel's, as
the Pallas kernel keeps them): first index 0; NaN coordinates scrubbed to 0
once; points with ``|p|^2 <= 1e-3`` are padding, never selected and never
updating the distance buffer; the buffer starts at 1e10; ties go to the
lowest index. An all-padding cloud selects index 0 throughout.
"""

import torch

from bridgeqa_tpu_torch.ops import cuda_lib

PADDING_NORM_SQ = 1e-3
INIT_DIST = 1e10

# kernel launches since the last reset (chip_smoke.py reads and resets it)
launches = 0


def furthest_point_sample_with_xyz(xyz: torch.Tensor, npoint: int):
    """xyz (B, N, 3) -> (idx (B, npoint) int32, coords (B, npoint, 3) f32).

    Coordinates are cast to f32 on entry, as the JAX op does; the returned
    coordinates are the NaN-scrubbed coordinates of each pick."""
    global launches
    if xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"xyz must be (B, N, 3), got {tuple(xyz.shape)}")
    b, n, _ = xyz.shape
    if npoint <= 0 or n == 0:
        raise ValueError(f"need npoint > 0 and a non-empty cloud, got npoint={npoint}, n={n}")
    xyz = xyz.float().contiguous()
    if xyz.device.type == "cpu":
        return fps_plain(xyz, npoint)
    if xyz.device.type != "cuda":
        raise ValueError(f"unsupported device {xyz.device}")
    idx = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    coords = torch.empty((b, npoint, 3), dtype=torch.float32, device=xyz.device)
    temp = torch.empty((b, n), dtype=torch.float32, device=xyz.device)
    rc = cuda_lib.lib().bq_fps(xyz.data_ptr(), temp.data_ptr(), idx.data_ptr(),
                               coords.data_ptr(), b, n, npoint,
                               cuda_lib.stream_handle(xyz.device))
    cuda_lib.check(rc, "bq_fps")
    launches += 1
    return idx, coords


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) -> (B, npoint) int32 indices."""
    return furthest_point_sample_with_xyz(xyz, npoint)[0]


def fps_plain(xyz: torch.Tensor, npoint: int):
    """Plain PyTorch FPS on any device; the kernel's reference.

    Same arithmetic as the Pallas kernel (``_fps_kernel``): each distance is
    ``dx*dx + dy*dy + dz*dz`` as separate, rounded operations, left to
    right."""
    xyz = xyz.float()
    x, y, z = xyz.unbind(-1)
    valid = x * x + y * y + z * z > PADDING_NORM_SQ  # NaN -> padding
    x, y, z = (torch.nan_to_num(c, nan=0.0, posinf=torch.inf, neginf=-torch.inf) for c in (x, y, z))
    # padding rows hold -1 < any distance, so the running min keeps them there
    temp = torch.where(valid, torch.full_like(x, INIT_DIST), torch.full_like(x, -1.0))
    b = xyz.shape[0]
    idx = torch.zeros((b, npoint), dtype=torch.int64, device=xyz.device)
    best = torch.zeros((b, 1), dtype=torch.int64, device=xyz.device)
    for j in range(1, npoint):
        dx = x - x.gather(1, best)
        dy = y - y.gather(1, best)
        dz = z - z.gather(1, best)
        temp = torch.minimum(temp, dx * dx + dy * dy + dz * dz)
        best = temp.argmax(dim=1, keepdim=True)  # first maximum
        idx[:, j] = best[:, 0]
    coords = torch.stack([c.gather(1, idx) for c in (x, y, z)], dim=-1)
    return idx.to(torch.int32), coords


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[b, m, c] = points[b, idx[b, m], c]`` for points (B, N, C), idx (B, M)."""
    c = points.shape[-1]
    return points.gather(1, idx.long()[..., None].expand(-1, -1, c))
