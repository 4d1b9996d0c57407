"""Ball query and grouping.

Counterpart of ``bridgeqa_tpu/ops/grouping.py``. Two selection rules, each a
hand-written kernel on the card with its plain version beside it:

- stripes (the rule the JAX package runs on its chip, and the port's rule on
  both devices): on a CUDA tensor ``ball_query_stripes`` launches
  ``csrc/ball_query_stripes.cu``; on a CPU tensor it runs
  ``ball_query_stripes_plain``, which follows ``_ball_query_stripes_xla``:

  - the cloud is padded to the length ``stripe_plan`` gives and cut into
    stripes; padding points never qualify;
  - a point qualifies when ``d2 < r^2``, ``d2 = dx*dx + dy*dy + dz*dz``,
    ``dx = p - c``;
  - one pick per stripe (its first qualifier) or two (its first and last);
  - a slot whose stripe is empty takes the first qualifier of the whole
    ball, a ball with no qualifier takes index 0, with rel 0 and point 0's
    features.

- exact (the reference's scan order, ``_ball_query_exact``): the first
  ``nsample`` qualifiers in ascending point order, the rest of the slots
  filled with the first qualifier, all 0 for a ball with none. On a CUDA
  tensor ``ball_query_exact`` launches ``csrc/ball_query_exact.cu``; on a
  CPU tensor it runs ``ball_query_exact_plain``.

``ball_query`` and ``query_and_group`` pick the rule as the JAX functions do
on their chip: stripes, unless ``FORCE_MODE`` is "exact", the caller asks
for the exact query, or ``nsample`` is odd (the stripe rule needs it even).

Gradients. On the card the stripe query is an autograd Function whose
backward is the hand-written kernel in ``csrc/ball_query_backward.cu``: the
rel and grouped-feature cotangents scattered onto the picked points, their
negated sum onto each centre (the JAX op's custom VJP,
``_ball_query_stripes_bwd`` and ``_ball_query_stripes_feats_bwd``). On the
CPU autograd runs through the plain version, as XLA differentiates
``_ball_query_stripes_xla`` on JAX's CPU. The two differ on an all-empty
ball, as the JAX package's two paths do: its slots hold index 0 and rel 0,
and the kernel's VJP still sends their cotangents to point 0 and the
centre, where the plain version's rel is a constant 0 and takes none. On
the model path every centre is one of its cloud's points, so no ball is
empty and the two agree. The exact query gives indices only, so it has no
backward: its callers group with ``group_points``, a gather that autograd
differentiates (as JAX differentiates ``take_along_axis``).
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

# kernel launches since the last reset, forward and backward (chip_smoke.py
# reads and resets them)
launches = 0
backward_launches = 0
# what the last kernel launch was, as its C entry reports it: {"kernel":
# "staged" (stripes staged in shared memory) or "warp" (a warp per centre),
# "blocks", "centres_per_warp", "staged_whole" (the cloud staged once)}
last_launch = None
# what the last backward launch was, as its C entry reports it: {"blocks",
# "cluster" (blocks a cloud, a thread-block cluster above 1), "threads"}
last_backward_launch = None
# launches of the exact query's kernel since the last reset, and what the
# last one was: {"blocks", "warps_per_block", "centres_per_warp",
# "tile_points" (points a stage holds), "stages" (tiles in flight)}
exact_launches = 0
last_exact_launch = None
# test and ablation hook, as the JAX package's: None or "stripes" keep the
# stripe rule, "exact" forces the exact query everywhere
FORCE_MODE = None
# centres a warp of the staged kernel may be set to test
CENTRES_PER_WARP = (1, 2, 4, 8)
# the exact kernel's block (csrc/ball_query_exact.cu: kWarps, kTile,
# kStages): 8 warps, two stages of 1024 points as float4s in shared memory
EXACT_WARPS = 8
EXACT_TILE = 1024
EXACT_STAGES = 2
# the backward kernel's block (csrc/ball_query_backward.cu: kThreads)
BACKWARD_THREADS = 1024


def exact_plan(b: int, m: int, sms: int) -> dict:
    """The exact kernel's launch for ``b`` clouds of ``m`` centres on a card
    of ``sms`` SMs. A warp serves C centres, the largest of 8, 4, 2 that
    still gives every SM a block (else 1); a block of ``EXACT_WARPS`` warps
    serves 8 C consecutive centres of one cloud, so a cloud takes ``groups``
    blocks: block k serves cloud k // groups, and its warp w the centres
    (k % groups) * 8 C + w C + i, i < C, below m."""
    c = next((c for c in (8, 4, 2) if b * -(-m // (EXACT_WARPS * c)) >= sms), 1)
    groups = -(-m // (EXACT_WARPS * c))
    return dict(centres_per_warp=c, groups=groups, blocks=b * groups,
                warps_per_block=EXACT_WARPS, shared_bytes=EXACT_STAGES * EXACT_TILE * 16)


def backward_plan(b: int, n: int, m: int, nsample: int) -> dict:
    """The backward kernel's launch for ``b`` clouds of ``n`` points and
    ``m`` centres of ``nsample`` slots. A cloud takes k blocks (a
    thread-block cluster where k > 1): block r zeroes the cloud's outputs
    of points [r P, (r + 1) P) (P = ceil(n / k)) and of centres
    [r Q, (r + 1) Q) (Q = ceil(m / k)), and serves those centres' slots. k
    is the largest of 8, 4, 2 that leaves a block at least a slot a thread
    (else 1). The kernel keeps no sums in shared memory: it adds in global
    memory."""
    k = next((k for k in (8, 4, 2) if -(-m // k) * nsample >= BACKWARD_THREADS), 1)
    return dict(blocks_per_cloud=k, points_per_block=-(-n // k), centres_per_block=-(-m // k),
                blocks=b * k, threads=BACKWARD_THREADS)


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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


def ball_query(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor, *,
               exact: bool | None = None) -> torch.Tensor:
    """Radius neighbourhood query: (B, M, nsample) int32 indices into N.
    The rule of the JAX ``ball_query`` on its chip: ``FORCE_MODE`` "exact"
    forces the exact query, "stripes" the stripe rule where ``nsample`` is
    even; otherwise the exact query where ``exact`` is set or ``nsample`` is
    odd, else stripes."""
    if FORCE_MODE == "exact":
        exact = True
    elif FORCE_MODE == "stripes" and nsample % 2 == 0:
        return ball_query_stripes(radius, nsample, xyz, new_xyz)[0]
    if exact or nsample % 2:
        return ball_query_exact(radius, nsample, xyz, new_xyz)
    return ball_query_stripes(radius, nsample, xyz, new_xyz)[0]


def ball_query_exact(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor) -> torch.Tensor:
    """The exact scan-order query: for each centre the first ``nsample``
    points with ``d2 < r^2`` in ascending point order, the remaining slots
    filled with the first of them, all 0 where none qualifies. xyz (B, N, 3),
    new_xyz (B, M, 3), cast to f32 and detached (the output is an index);
    returns (B, M, nsample) int32. On a CUDA tensor one launch of
    ``csrc/ball_query_exact.cu`` as ``exact_plan`` lays it out; on a CPU
    tensor ``ball_query_exact_plain``."""
    global exact_launches, last_exact_launch
    _check_clouds(xyz, new_xyz)
    if nsample < 1:
        raise ValueError(f"nsample must be positive, got {nsample}")
    xyz = xyz.detach().float().contiguous()
    new_xyz = new_xyz.detach().float().contiguous()
    if xyz.device.type == "cpu":
        return ball_query_exact_plain(radius, nsample, xyz, new_xyz)
    cuda_lib.check_cuda("ball_query_exact", torch.float32, xyz, new_xyz)
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    plan = exact_plan(b, m, _sms(xyz.device))
    idx = torch.empty((b, m, nsample), dtype=torch.int32, device=xyz.device)
    record = (ctypes.c_int * 5)()
    rc = cuda_lib.lib().bq_ball_query_exact(
        xyz.data_ptr(), new_xyz.data_ptr(), idx.data_ptr(), b, n, m, nsample, _r2(radius),
        plan["centres_per_warp"], plan["groups"], record, cuda_lib.stream_handle(xyz.device))
    cuda_lib.check(rc, "bq_ball_query_exact")
    if record[0]:
        exact_launches += 1
        last_exact_launch = dict(blocks=record[0], warps_per_block=record[1],
                                 centres_per_warp=record[2], tile_points=record[3],
                                 stages=record[4])
    return idx


def ball_query_exact_plain(radius: float, nsample: int, xyz: torch.Tensor,
                           new_xyz: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch exact query on any device; the kernel's reference.
    For each block of ``_PLAIN_BLOCK`` centres: the (B, block, N) distance
    tile, its mask, each qualifier's rank in point order (a running count),
    and slot s takes the point where the count first reaches s + 1."""
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    r2 = _r2(radius)
    slots = torch.arange(1, nsample + 1, dtype=torch.int32, device=xyz.device)
    blocks = []
    for s in range(0, m, _PLAIN_BLOCK):
        centers = new_xyz[:, s:s + _PLAIN_BLOCK]
        blk = centers.shape[1]
        rank = (pairwise_sqdist(centers, xyz) < r2).cumsum(-1, dtype=torch.int32)
        total = rank[..., -1:]
        idx = torch.searchsorted(rank, slots.expand(b, blk, nsample).contiguous())
        idx = torch.where(slots <= total, idx, idx[..., :1])
        blocks.append(torch.where(total > 0, idx, 0))
    return torch.cat(blocks, dim=1).to(torch.int32)


def _check_clouds(xyz: torch.Tensor, new_xyz: torch.Tensor) -> None:
    if xyz.dim() != 3 or xyz.shape[-1] != 3 or new_xyz.dim() != 3 or new_xyz.shape[-1] != 3:
        raise ValueError(f"xyz and new_xyz must be (B, N, 3), got {tuple(xyz.shape)}, "
                         f"{tuple(new_xyz.shape)}")
    if new_xyz.shape[0] != xyz.shape[0] or new_xyz.device != xyz.device:
        raise ValueError("xyz and new_xyz need the same batch and device")


def ball_query_stripes(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor,
                       feats: torch.Tensor | None = None, *, centres_per_warp: int | None = None):
    """Stripe ball query with in-sweep grouping.

    xyz (B, N, 3), new_xyz (B, M, 3), feats (B, N, F) with F <= 4 or None.
    Returns (idx (B, M, nsample) int32, rel (B, M, nsample, 3) f32,
    grouped feats (B, M, nsample, F) f32 or None). Inputs are cast to f32 on
    entry, as the JAX op does under any compute dtype. On the card, where a
    gradient is wanted of xyz, new_xyz or feats, the backward kernel gives
    it (``ball_query_stripes_backward``).
    ``centres_per_warp`` (1, 2, 4 or 8) runs the kernel that stages the
    stripes with that many centres a warp instead of its own choice, at any
    cloud size, for the card tests."""
    if nsample % 2:
        raise ValueError(f"the stripe rule needs an even nsample, got {nsample}")
    if centres_per_warp is not None and centres_per_warp not in CENTRES_PER_WARP:
        raise ValueError(f"centres_per_warp must be one of {CENTRES_PER_WARP}, "
                         f"got {centres_per_warp}")
    _check_clouds(xyz, new_xyz)
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
    if feats is None:
        idx, rel = _BallQueryStripes.apply(xyz, new_xyz, None, radius, nsample, centres_per_warp)
        return idx, rel, None
    return _BallQueryStripes.apply(xyz, new_xyz, feats, radius, nsample, centres_per_warp)


class _BallQueryStripes(torch.autograd.Function):
    """The kernel's forward and ``ball_query_stripes_backward`` as its
    backward (JAX's ``custom_vjp`` around the Pallas kernel)."""

    @staticmethod
    def forward(ctx, xyz, new_xyz, feats, radius, nsample, centres_per_warp):
        idx, rel, fout = _launch(radius, nsample, xyz, new_xyz, feats, centres_per_warp)
        ctx.save_for_backward(idx)
        ctx.n = xyz.shape[1]
        ctx.mark_non_differentiable(idx)
        return (idx, rel) if fout is None else (idx, rel, fout)

    @staticmethod
    def backward(ctx, _g_idx, g_rel, g_grouped=None):
        (idx,) = ctx.saved_tensors
        g_xyz, g_center, g_feats = ball_query_stripes_backward(idx, g_rel, g_grouped, ctx.n)
        return g_xyz, g_center, g_feats, None, None, None


def _launch(radius, nsample, xyz, new_xyz, feats, centres_per_warp):
    global launches, last_launch
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


def ball_query_stripes_backward(idx: torch.Tensor, g_rel: torch.Tensor,
                                g_grouped: torch.Tensor | None, n: int):
    """Cotangents of the stripe ball query's inputs from those of its
    outputs: idx (B, M, S) int32 from the forward, g_rel (B, M, S, 3),
    g_grouped (B, M, S, F) or None, n the cloud's length. Returns (g_xyz
    (B, N, 3), g_center (B, M, 3), g_feats (B, N, F) or None), f32: the rel
    and feature cotangents added onto the points each slot picked and the
    rel cotangents' negated sum on each centre. On a CUDA tensor one launch
    of ``csrc/ball_query_backward.cu`` as ``backward_plan`` lays it out,
    which zeroes the outputs itself and adds onto them (f32 reductions in
    an order that varies, so not bitwise repeatable); on a CPU tensor
    ``ball_query_stripes_backward_plain``."""
    global backward_launches, last_backward_launch
    b, m, s = idx.shape
    if tuple(g_rel.shape) != (b, m, s, 3) or (g_grouped is not None and (
            g_grouped.dim() != 4 or tuple(g_grouped.shape[:3]) != (b, m, s)
            or not 0 < g_grouped.shape[-1] <= MAX_KERNEL_FEATS)):
        raise ValueError(f"cotangents {tuple(g_rel.shape)}, "
                         f"{None if g_grouped is None else tuple(g_grouped.shape)} do not fit "
                         f"idx {tuple(idx.shape)}")
    g_rel = g_rel.float().contiguous()
    g_grouped = None if g_grouped is None else g_grouped.float().contiguous()
    if idx.device.type == "cpu":
        return ball_query_stripes_backward_plain(idx, g_rel, g_grouped, n)
    if idx.dtype != torch.int32:
        raise ValueError(f"ball_query_stripes_backward: idx must be int32, got {idx.dtype}")
    tensors = [idx.contiguous(), g_rel] + ([g_grouped] if g_grouped is not None else [])
    cuda_lib.check_cuda("ball_query_stripes_backward", torch.float32, *tensors)
    nf = 0 if g_grouped is None else g_grouped.shape[-1]
    plan = backward_plan(b, n, m, s)
    g_xyz = torch.empty((b, n, 3), dtype=torch.float32, device=idx.device)
    g_center = torch.empty((b, m, 3), dtype=torch.float32, device=idx.device)
    g_feats = torch.empty((b, n, nf), dtype=torch.float32, device=idx.device) if nf else None
    record = (ctypes.c_int * 3)()
    rc = cuda_lib.lib().bq_ball_query_backward(
        tensors[0].data_ptr(), g_rel.data_ptr(), g_grouped.data_ptr() if nf else None,
        g_xyz.data_ptr(), g_center.data_ptr(), g_feats.data_ptr() if nf else None,
        b, n, m, s, nf, plan["blocks_per_cloud"], plan["points_per_block"],
        plan["centres_per_block"], record, cuda_lib.stream_handle(idx.device))
    cuda_lib.check(rc, "bq_ball_query_backward")
    if record[0]:
        backward_launches += 1
        last_backward_launch = dict(blocks=record[0], cluster=record[1], threads=record[2])
    return g_xyz, g_center, g_feats


def ball_query_stripes_backward_plain(idx, g_rel, g_grouped, n: int):
    """Plain PyTorch version of ``ball_query_stripes_backward`` on any
    device (``index_add_`` over the flattened clouds, and a sum); the
    kernel's reference, used by the tests."""
    b, m, s = idx.shape
    rows = (idx.long() + n * torch.arange(b, device=idx.device)[:, None, None]).reshape(-1)
    g_xyz = g_rel.new_zeros((b * n, 3)).index_add_(0, rows, g_rel.reshape(-1, 3))
    g_center = -g_rel.sum(dim=2)
    g_feats = None
    if g_grouped is not None:
        nf = g_grouped.shape[-1]
        g_feats = g_grouped.new_zeros((b * n, nf)).index_add_(0, rows, g_grouped.reshape(-1, nf))
        g_feats = g_feats.reshape(b, n, nf)
    return g_xyz.reshape(b, n, 3), g_center, g_feats


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_k (a[..., i, k] - b[..., j, k])^2 in f32, one coordinate at a time
    in the JAX order (``pairwise_sqdist``)."""
    a, b = a.float(), b.float()
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
                    normalize_xyz: bool = False, ret_grouped_xyz: bool = False,
                    sample_uniformly: bool = False, generator: torch.Generator | None = None):
    """Ball query, grouping and recentring (the JAX ``query_and_group``):
    (B, M, nsample, 3 + C) grouped features, the recentred xyz first when
    ``use_xyz``. The stripe query gives the recentred xyz itself; otherwise
    (``FORCE_MODE`` "exact", an odd ``nsample`` or ``sample_uniformly``) the
    indices come from ``ball_query``, are resampled over each ball's unique
    points with ``generator`` where ``sample_uniformly`` asks
    (``_resample_uniform``), and the xyz is gathered and recentred: a ball
    with no qualifier groups point 0, less the centre."""
    if FORCE_MODE != "exact" and nsample % 2 == 0 and not sample_uniformly:
        idx, grouped_xyz, _ = ball_query_stripes(radius, nsample, xyz, new_xyz)
    else:
        idx = ball_query(radius, nsample, xyz, new_xyz)
        if sample_uniformly:
            if generator is None:
                raise ValueError("sample_uniformly needs a generator")
            idx = _resample_uniform(idx, generator, nsample)
        grouped_xyz = group_points(xyz, idx) - new_xyz[:, :, None, :]
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


def _resample_uniform(idx: torch.Tensor, generator: torch.Generator, nsample: int) -> torch.Tensor:
    """Each ball's unique indices, ascending, in its first slots; the other
    slots drawn uniformly (with replacement) from them, by ``generator`` (on
    ``idx``'s device). The JAX ``_resample_uniform``'s rule, after the
    reference's loop over ``torch.unique``; no model calls it."""
    sorted_idx = idx.sort(dim=-1).values
    is_first = torch.ones_like(sorted_idx, dtype=torch.bool)
    is_first[..., 1:] = sorted_idx[..., 1:] != sorted_idx[..., :-1]
    num_unique = is_first.sum(dim=-1, keepdim=True)
    order = torch.argsort((~is_first).to(torch.int8), dim=-1, stable=True)
    uniq = sorted_idx.gather(-1, order)
    draws = torch.rand(idx.shape, generator=generator, device=idx.device)
    pick = (draws * num_unique).long().minimum(num_unique - 1)
    slot = torch.arange(nsample, device=idx.device)
    return torch.where(slot < num_unique, uniq, uniq.gather(-1, pick))


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
