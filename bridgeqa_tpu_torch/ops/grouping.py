"""Stripe ball query and grouping.

Counterpart of ``bridgeqa_tpu/ops/grouping.py``, stripe mode only (the rule
the JAX package runs on its chip). On a CUDA tensor ``ball_query_stripes``
launches the hand-written kernel in ``csrc/ball_query_stripes.cu``; on a CPU
tensor it runs ``ball_query_stripes_plain``, which follows
``_ball_query_stripes_xla``:

- the cloud is padded to the length ``stripe_plan`` gives and cut into
  stripes; padding points never qualify;
- a point qualifies when ``d2 < r^2``, ``d2 = dx*dx + dy*dy + dz*dz``,
  ``dx = p - c``;
- one pick per stripe (its first qualifier) or two (its first and last);
- a slot whose stripe is empty takes the first qualifier of the whole ball,
  a ball with no qualifier takes index 0, with rel 0 and point 0's
  features.
"""

import ctypes

import numpy as np
import torch

from bridgeqa_tpu_torch.ops import cuda_lib

BIG = 2**30
# feature channels the kernel extracts in its own sweep (as the JAX kernel)
MAX_KERNEL_FEATS = 4
# centres per distance tile of the plain version
_PLAIN_BLOCK = 256

# kernel launches since the last reset (chip_smoke.py reads and resets it)
launches = 0
# what the last kernel launch was, as its C entry reports it: {"kernel":
# "staged" (stripes staged in shared memory) or "warp" (a warp per centre),
# "blocks", "centres_per_warp", "staged_whole" (the cloud staged once)}
last_launch = None
# centres a warp of the staged kernel may be set to test
CENTRES_PER_WARP = (1, 2, 4, 8)


def stripe_plan(n: int, nsample: int) -> tuple[int, int]:
    """(picks per stripe, padded point count), as ``_stripe_plan``: one pick
    from each of ``nsample`` stripes when the 128-point quantum needs no
    extra padding, else first and last of ``nsample / 2`` wider stripes."""
    q2 = (nsample // 2) * 128
    np2 = -(-n // q2) * q2
    q1 = nsample * 128
    np1 = -(-n // q1) * q1
    return (1, np1) if np1 == np2 else (2, np2)


def _r2(radius: float) -> float:
    # the JAX op compares against float32(radius * radius)
    return float(np.float32(radius * radius))


def ball_query_stripes(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor,
                       feats: torch.Tensor | None = None, *, centres_per_warp: int | None = None):
    """Stripe ball query with in-sweep grouping.

    xyz (B, N, 3), new_xyz (B, M, 3), feats (B, N, F) with F <= 4 or None.
    Returns (idx (B, M, nsample) int32, rel (B, M, nsample, 3) f32,
    grouped feats (B, M, nsample, F) f32 or None). Inputs are cast to f32 on
    entry, as the JAX op does under any compute dtype.
    ``centres_per_warp`` (1, 2, 4 or 8) runs the kernel that stages the
    stripes with that many centres a warp instead of its own choice, at any
    cloud size, for the card tests."""
    global launches, last_launch
    if nsample % 2:
        raise ValueError(f"the stripe rule needs an even nsample, got {nsample}")
    if centres_per_warp is not None and centres_per_warp not in CENTRES_PER_WARP:
        raise ValueError(f"centres_per_warp must be one of {CENTRES_PER_WARP}, "
                         f"got {centres_per_warp}")
    if xyz.dim() != 3 or xyz.shape[-1] != 3 or new_xyz.dim() != 3 or new_xyz.shape[-1] != 3:
        raise ValueError(f"xyz and new_xyz must be (B, N, 3), got {tuple(xyz.shape)}, "
                         f"{tuple(new_xyz.shape)}")
    if new_xyz.shape[0] != xyz.shape[0] or new_xyz.device != xyz.device:
        raise ValueError("xyz and new_xyz need the same batch and device")
    if feats is not None:
        if feats.dim() != 3 or feats.shape[:2] != xyz.shape[:2] or feats.device != xyz.device:
            raise ValueError(f"feats must be (B, N, F) beside xyz, got {tuple(feats.shape)} on "
                             f"{feats.device}")
        if not 0 < feats.shape[-1] <= MAX_KERNEL_FEATS:
            raise ValueError(f"at most {MAX_KERNEL_FEATS} feature channels, got {feats.shape[-1]}")
    xyz = xyz.float().contiguous()
    new_xyz = new_xyz.float().contiguous()
    feats = None if feats is None else feats.float().contiguous()
    if xyz.device.type == "cpu":
        return ball_query_stripes_plain(radius, nsample, xyz, new_xyz, feats)
    if xyz.device.type != "cuda":
        raise ValueError(f"unsupported device {xyz.device}")
    cuda_lib.refuse_grad("ball_query_stripes", xyz, new_xyz, feats)
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    nf = 0 if feats is None else feats.shape[-1]
    picks, np_padded = stripe_plan(n, nsample)
    stripes = nsample // picks
    dev = xyz.device
    idx = torch.empty((b, m, nsample), dtype=torch.int32, device=dev)
    rel = torch.empty((b, m, nsample, 3), dtype=torch.float32, device=dev)
    fout = torch.empty((b, m, nsample, nf), dtype=torch.float32, device=dev) if nf else None
    record = (ctypes.c_int * 4)()
    rc = cuda_lib.lib().bq_ball_query_stripes(
        xyz.data_ptr(), new_xyz.data_ptr(), feats.data_ptr() if nf else None,
        idx.data_ptr(), rel.data_ptr(), fout.data_ptr() if nf else None,
        b, n, m, nsample, stripes, np_padded // stripes, picks, nf, _r2(radius),
        centres_per_warp or 0, record, cuda_lib.stream_handle(dev))
    cuda_lib.check(rc, "bq_ball_query_stripes")
    launches += 1
    last_launch = dict(kernel="staged" if record[0] else "warp", blocks=record[1],
                       centres_per_warp=record[2], staged_whole=bool(record[3]))
    return idx, rel, fout


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_k (a[..., i, k] - b[..., j, k])^2, one coordinate at a time in the
    JAX order (``pairwise_sqdist``)."""
    d2 = torch.zeros(a.shape[:-1] + (b.shape[-2],), dtype=torch.float32, device=a.device)
    for k in range(a.shape[-1]):
        diff = a[..., k][..., :, None] - b[..., k][..., None, :]
        d2 = d2 + diff * diff
    return d2


def ball_query_stripes_plain(radius: float, nsample: int, xyz: torch.Tensor,
                             new_xyz: torch.Tensor, feats: torch.Tensor | None = None):
    """Plain PyTorch stripe ball query on any device; the kernel's
    reference. Centres run in blocks of ``_PLAIN_BLOCK`` so the
    (B, block, N) distance tile stays bounded."""
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    picks, np_padded = stripe_plan(n, nsample)
    stripes = nsample // picks
    w = np_padded // stripes
    # padding points sit far away (1e9, as the JAX op pads) and never qualify
    xyz_p = torch.cat([xyz, xyz.new_full((b, np_padded - n, 3), 1e9)], dim=1)
    r2 = _r2(radius)
    lidx = torch.arange(w, dtype=torch.int64, device=xyz.device)
    base = torch.arange(stripes, dtype=torch.int64, device=xyz.device) * w
    idx_blocks, rel_blocks = [], []
    for s in range(0, m, _PLAIN_BLOCK):
        centers = new_xyz[:, s:s + _PLAIN_BLOCK]
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
    idx = torch.cat(idx_blocks, dim=1)
    rel = torch.cat(rel_blocks, dim=1)
    fout = group_points(feats, idx) if feats is not None else None
    return idx.to(torch.int32), rel, fout


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[b, m, s, c] = points[b, idx[b, m, s], c]``: (B, N, C), (B, M, S)
    -> (B, M, S, C)."""
    b, m, s = idx.shape
    c = points.shape[-1]
    flat = points.gather(1, idx.long().reshape(b, m * s, 1).expand(-1, -1, c))
    return flat.reshape(b, m, s, c)


def query_and_group(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor,
                    features: torch.Tensor | None = None, *, use_xyz: bool = True,
                    normalize_xyz: bool = False, ret_grouped_xyz: bool = False):
    """Stripe branch of ``query_and_group``: (B, M, nsample, 3 + C) grouped
    features, the recentred xyz first when ``use_xyz``."""
    idx, grouped_xyz, _ = ball_query_stripes(radius, nsample, xyz, new_xyz)
    if normalize_xyz:
        grouped_xyz = grouped_xyz / radius
    if features is not None:
        grouped = group_points(features, idx)
        new_features = (torch.cat([grouped_xyz.to(grouped.dtype), grouped], dim=-1)
                        if use_xyz else grouped)
    else:
        if not use_xyz:
            raise ValueError("cannot group with neither features nor xyz")
        new_features = grouped_xyz
    if ret_grouped_xyz:
        return new_features, grouped_xyz
    return new_features


def group_all(xyz: torch.Tensor, features: torch.Tensor | None = None, *, use_xyz: bool = True,
              ret_grouped_xyz: bool = False):
    """One group holding every point: (B, 1, N, 3 + C)."""
    grouped_xyz = xyz[:, None]
    if features is not None:
        grouped = features[:, None]
        new_features = (torch.cat([grouped_xyz.to(grouped.dtype), grouped], dim=-1)
                        if use_xyz else grouped)
    else:
        new_features = grouped_xyz
    if ret_grouped_xyz:
        return new_features, grouped_xyz
    return new_features
