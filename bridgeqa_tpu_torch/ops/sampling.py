"""Farthest-point sampling and point gathering.

Counterpart of ``bridgeqa_tpu/ops/sampling.py``. On a CUDA tensor
``furthest_point_sample_with_xyz`` launches the hand-written kernel in
``csrc/fps.cu``; on a CPU tensor it runs ``fps_plain``, the plain PyTorch
version of the same recurrence. Semantics (the reference CUDA kernel's, as
the Pallas kernel keeps them): first index 0; NaN coordinates scrubbed to 0
once; points with ``|p|^2 <= 1e-3`` are padding, never selected and never
updating the distance buffer; the buffer starts at 1e10; ties go to the
lowest index. An all-padding cloud selects index 0 throughout.

The kernel spreads each cloud over a thread-block cluster whose size it
picks from the cloud's length and the card's occupancy (``last_cluster``
keeps the last launch's size and how many clusters of it the card holds at
once). Where a gradient is wanted of
the coordinates, the picked coordinates are gathered again in the graph from
the indices (``gather_points``), so that autograd scatters their cotangents
onto the picked rows, as the JAX op's ``_fps_pallas_bwd`` does; the indices
take no gradient.
"""

import ctypes

import torch

from bridgeqa_tpu_torch.ops import cuda_lib
from bridgeqa_tpu_torch.utils.profiling import count

PADDING_NORM_SQ = 1e-3
INIT_DIST = 1e10

# (cluster size, clusters of that size the card holds at once) of the last
# kernel launch
last_cluster = None


def furthest_point_sample_with_xyz(xyz: torch.Tensor, npoint: int, *,
                                   cluster_size: int | None = None):
    """xyz (B, N, 3) -> (idx (B, npoint) int32, coords (B, npoint, 3) f32).

    Coordinates are cast to f32 on entry, as the JAX op does; the returned
    coordinates are the NaN-scrubbed coordinates of each pick.
    ``cluster_size`` (2, 4, 8 or 16) sets the kernel's cluster size instead
    of its own choice, for the card tests and chip_smoke's sweep."""
    global last_cluster
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
    scratch = torch.empty((b, 4, n), dtype=torch.float32, device=xyz.device)
    size, coresident = ctypes.c_int(), ctypes.c_int()
    rc = cuda_lib.lib().bq_fps(xyz.data_ptr(), scratch.data_ptr(), idx.data_ptr(),
                               coords.data_ptr(), b, n, npoint, cluster_size or 0,
                               ctypes.byref(size), ctypes.byref(coresident),
                               cuda_lib.stream_handle(xyz.device))
    cuda_lib.check(rc, "bq_fps")
    count("kernel/fps")
    last_cluster = (size.value, coresident.value)
    if torch.is_grad_enabled() and xyz.requires_grad:
        # the same values, in the graph
        coords = torch.nan_to_num(gather_points(xyz, idx), nan=0.0, posinf=torch.inf,
                                  neginf=-torch.inf)
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
