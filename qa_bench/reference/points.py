"""Plain PyTorch point operations of the reference.

Frozen from the plain versions in ``bridgeqa_tpu_torch/ops/``: ``fps_plain``
(``sampling.py``), ``ball_query_stripes_plain``, ``stripe_plan``,
``pairwise_sqdist`` and ``group_points`` (``grouping.py``), ``three_nn``
and ``three_interpolate`` (``interpolate.py``). They state the selection
rules the port's kernels keep (first FPS index 0; ``|p|^2 <= 1e-3`` is
padding; the stripe rule of the ball query) with each distance rounded as
separate operations, so the kernels' picks can be held to them exactly.
"""

import numpy as np
import torch

PADDING_NORM_SQ = 1e-3
INIT_DIST = 1e10
BIG = 2**30
PLAIN_BLOCK = 256


def furthest_point_sample(xyz: torch.Tensor, npoint: int):
    """(B, N, 3) -> (idx (B, npoint) int32, coords (B, npoint, 3))."""
    xyz = xyz.float()
    x, y, z = xyz.unbind(-1)
    valid = x * x + y * y + z * z > PADDING_NORM_SQ
    x, y, z = (torch.nan_to_num(c, nan=0.0, posinf=torch.inf, neginf=-torch.inf)
               for c in (x, y, z))
    temp = torch.where(valid, torch.full_like(x, INIT_DIST), torch.full_like(x, -1.0))
    b = xyz.shape[0]
    idx = torch.zeros((b, npoint), dtype=torch.int64, device=xyz.device)
    best = torch.zeros((b, 1), dtype=torch.int64, device=xyz.device)
    for j in range(1, npoint):
        dx = x - x.gather(1, best)
        dy = y - y.gather(1, best)
        dz = z - z.gather(1, best)
        temp = torch.minimum(temp, dx * dx + dy * dy + dz * dz)
        best = temp.argmax(dim=1, keepdim=True)
        idx[:, j] = best[:, 0]
    coords = torch.stack([c.gather(1, idx) for c in (x, y, z)], dim=-1)
    return idx.to(torch.int32), coords


def stripe_plan(n: int, nsample: int) -> tuple[int, int]:
    q2 = (nsample // 2) * 128
    np2 = -(-n // q2) * q2
    q1 = nsample * 128
    np1 = -(-n // q1) * q1
    return (1, np1) if np1 == np2 else (2, np2)


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = a.float(), b.float()
    d2 = torch.zeros(a.shape[:-1] + (b.shape[-2],), dtype=torch.float32, device=a.device)
    for k in range(a.shape[-1]):
        diff = a[..., k][..., :, None] - b[..., k][..., None, :]
        d2 = d2 + diff * diff
    return d2


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    b, m, s = idx.shape
    c = points.shape[-1]
    flat = points.gather(1, idx.long().reshape(b, m * s, 1).expand(-1, -1, c))
    return flat.reshape(b, m, s, c)


def ball_query_stripes(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor):
    """Stripe ball query: (idx (B, M, nsample), rel (B, M, nsample, 3))."""
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    picks, np_padded = stripe_plan(n, nsample)
    stripes = nsample // picks
    w = np_padded // stripes
    xyz_p = torch.cat([xyz, xyz.new_full((b, np_padded - n, 3), 1e9)], dim=1)
    r2 = float(np.float32(radius * radius))
    lidx = torch.arange(w, dtype=torch.int64, device=xyz.device)
    base = torch.arange(stripes, dtype=torch.int64, device=xyz.device) * w
    idx_blocks, rel_blocks = [], []
    for s in range(0, m, PLAIN_BLOCK):
        centers = new_xyz[:, s:s + PLAIN_BLOCK]
        blk = centers.shape[1]
        mask = (pairwise_sqdist(centers, xyz_p) < r2).reshape(b, blk, stripes, w)
        found = mask.any(-1)
        gfst = torch.where(found, torch.where(mask, lidx, BIG).amin(-1) + base, BIG)
        if picks == 2:
            glst = torch.where(found, torch.where(mask, lidx, -1).amax(-1) + base, BIG)
            idxs = torch.stack([gfst, glst], dim=-1).reshape(b, blk, nsample)
        else:
            idxs = gfst
        first_all = gfst.amin(-1, keepdim=True)
        found_any = first_all < BIG
        missing = idxs >= BIG
        idx_final = torch.where(missing, torch.where(found_any, first_all, 0), idxs)
        sel = xyz_p.gather(1, idx_final.reshape(b, -1, 1).expand(-1, -1, 3))
        rel = sel.reshape(b, blk, nsample, 3) - centers[:, :, None, :]
        rel = torch.where((missing & ~found_any)[..., None], 0.0, rel)
        idx_blocks.append(idx_final)
        rel_blocks.append(rel)
    return torch.cat(idx_blocks, dim=1).to(torch.int32), torch.cat(rel_blocks, dim=1)


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    d2 = pairwise_sqdist(unknown, known)
    dists, idxs = [], []
    for _ in range(3):
        i = d2.argmin(dim=-1, keepdim=True)
        dists.append(d2.gather(-1, i)[..., 0])
        idxs.append(i[..., 0])
        d2 = d2.scatter(-1, i, torch.inf)
    return torch.stack(dists, -1).clamp_min(0.0).sqrt(), torch.stack(idxs, -1)


def three_interpolate(points: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor):
    b, n, k = idx.shape
    c = points.shape[-1]
    gathered = points.gather(1, idx.reshape(b, n * k, 1).expand(-1, -1, c)).reshape(b, n, k, c)
    return (gathered * weight[..., None].to(gathered.dtype)).sum(dim=2)
