"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA card and ``nvcc`` and skip without them. On the card:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine does not have; this file imports none.) On the edge cases
``chip_smoke.py`` does not draw:

- the point kernels must agree with their plain versions bitwise: NaN
  coordinates, an all-padding cloud, 4 feature channels, both stripe plans,
  clouds shorter than one stripe quantum; the ball query's planted cases
  (d2 == r2, a centre on a point, duplicates across stripes, warps and
  blocks, empty balls) at the launch it picks and at 1, 2, 4 and 8 centres
  a warp; FPS at every cluster size, with
  duplicates whose tie crosses the clusters' merge, batches of 20 and 32,
  clusters in waves, and slices in global memory;
- the scoring kernels (GEMM, both attentions, LayerNorm, vocabulary
  reductions) must agree with theirs within a tolerance, in f32 and bf16:
  rows and vocabularies that are no tile multiple, 7, 80 and 130 question
  keys, all but one key masked, and attention shapes that take the
  tensor-core kernel (bf16, head width 64) and the CUDA-core one;
- the ViT kernels likewise: the GEMM's residual epilogue, LayerNorm without
  a residual and keeping the sum, the attention over 1, 17, 64, 65, 577, 833,
  901 and 1025 tokens (65, 577, 833 and 1025 leave one valid key in the last
  tile), and a whole block;
- the f32 kernels on the tensor cores (3xTF32) against an f64 reference
  within 1e-5 of the largest output, where one TF32 pass would miss by an
  order of magnitude: the GEMM at BLIP-ITM's 36928 rows and at K 3072, the
  ViT attention at 1, 65, 577 and 901 tokens, the scoring attentions at the
  main path's shapes and at answers of 1, 5 and 128 and 7, 80 and 130
  question keys (a single visible key's context is its value bit for bit),
  and the vocabulary pass at the main path's 22528 x 30524 x 768; the f32
  GEMM and vocabulary pass at any K, at odd N and at 4-byte alignment (their
  4-byte copies);
- the bf16 GEMM's TMA edges: M, N and K that are no multiple of the tile or
  of the 64-wide box, with GELU and with the residual; its GELU against the
  erf GELU at every |x| up to 6, within two f32 ulp or one bf16 rounding;
- the bf16 GEMM and ViT attention launched from several host threads at
  once (ctypes releases the GIL), bit for bit as from one;
- the row gather must copy bit for bit, with rows that fill no block and
  1, 3, 4 and 131 channels, and refuse indices out of range;
- the vocabulary pass's runs past the vocabulary, labels at its first and
  last word, logits scaled x30;
- every wrapper but the ball query's refuses an input that wants a
  gradient under grad, FPS's coordinates carry one, and a backward through
  the tiny rank slice (bf16, the detector frozen) reaches the ViT's and both
  decoders' weights;
- the ball query's backward kernel against its plain version (planted
  duplicates and empty balls, 0 to 4 feature channels, SA1's size; 1e-5 of
  the largest value, the reductions add in another order) at shapes that
  take each blocks a cloud the plan gives (1, 2, 4, 8); one hot point that
  every slot of every centre picks, with sums exact by construction and
  every other point exactly 0.0 in outputs from torch.empty over memory
  filled with NaN; the autograd Function's gradients against the plain
  forward's autograd, which ``torch.autograd.gradcheck`` holds to finite
  differences in f64, and a tiny train step on the card against the CPU;
- the feed's pinned copy to the card, bit for bit and without a host sync;
- the exact scan-order ball query (``csrc/ball_query_exact.cu``) bitwise
  against its plain version, each case at the batches that take each
  centres a warp the plan gives it (1, 2, 4, 8), the launch the plan's:
  odd and even nsample (1 too), planted d2 == r2, a centre on a point,
  duplicates, empty, short and full balls (the early stop), clouds of
  exactly one 1024-point tile and of one more point, centres that fill no
  block, and a dense cloud where every warp and block stop in the first
  tile; and an exact-mode SA module's gradients on the card against the
  CPU.
f32: 1e-3 absolute (both sides accumulate in f32, in another order). bf16
outputs: 2^-6 of the largest output, about two steps of bf16 (both round
once from f32, and a sum taken in another order can flip a rounding, or the
rounding of an exp or a softmax weight before the product with V).
"""

import copy
import threading

import numpy as np
import pytest
import torch

from bridgeqa_tpu_torch.ops import gather, grouping, sampling, scoring_layer, vit_block, vocab_loss

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    return torch.device("cuda", 0)


def _cloud(rng, b, n, scale=2.0):
    return ((rng.rand(b, n, 3) - 0.5) * scale).astype(np.float32)


@pytest.mark.parametrize("n,npoint", [(300, 64), (5000, 700), (70000, 16)])
def test_fps_kernel_matches_plain(card, n, npoint):
    """n = 70000 does not fit the distance buffer in shared memory and takes
    the global-memory path."""
    rng = np.random.RandomState(n)
    xyz = _cloud(rng, 4, n)
    xyz[0, n - n // 5:] = 0.0  # trailing padding
    xyz[1, 10:40] = xyz[1, 40:70]  # ties
    xyz[1, 5] = [np.nan, 0.3, 0.1]  # NaN: padding, scrubbed
    xyz[2, 0] = [0.2, np.nan, 0.0]  # NaN in the first pick
    xyz[3] = 0.0  # all padding
    t = torch.from_numpy(xyz).to(card)
    before = sampling.launches
    idx, coords = sampling.furthest_point_sample_with_xyz(t, npoint)
    assert sampling.launches == before + 1
    pidx, pcoords = sampling.fps_plain(t, npoint)
    torch.cuda.synchronize()
    assert torch.equal(idx, pidx)
    assert torch.equal(coords, pcoords)
    assert (idx[3] == 0).all()


def _fps_cloud(rng, b, n):
    """Cloud 0 with trailing padding and exact duplicates in two halves of
    the cloud (two different blocks' slices at any cluster size), placed
    farthest from point 0 so that the first pick is a tie that crosses the
    merge; cloud 1 with ties and scattered NaN padding; cloud 2 with a NaN
    in the first pick; cloud 3 all padding."""
    xyz = _cloud(rng, b, n)
    xyz[0, n - n // 5:] = 0.0
    if n >= 8:
        xyz[0, [n // 4, n // 2 + 1]] = [3.0, 3.0, 3.0]
    if b > 1:
        xyz[1, 10:40] = xyz[1, 40:70] if n >= 70 else xyz[1, 10:40]
        xyz[1, min(5, n - 1)] = [np.nan, 0.3, 0.1]
    if b > 2:
        xyz[2, 0] = [0.2, np.nan, 0.0]
    if b > 3:
        xyz[3] = 0.0
    return xyz


def _fps_matches_plain(xyz, npoint, **kw):
    before = sampling.launches
    idx, coords = sampling.furthest_point_sample_with_xyz(xyz, npoint, **kw)
    assert sampling.launches == before + 1
    pidx, pcoords = sampling.fps_plain(xyz, npoint)
    torch.cuda.synchronize()
    assert torch.equal(idx, pidx)
    assert torch.equal(coords, pcoords)
    return idx


@pytest.mark.parametrize("b,n,npoint", [(3, 5, 7), (4, 300, 64), (4, 40000, 256),
                                        (4, 40001, 256), (20, 5000, 128), (32, 5000, 128),
                                        (2, 70000, 16), (2, 400000, 8)])
def test_fps_cluster_kernel_matches_plain(card, b, n, npoint):
    """Bitwise at n below one block's threads, n ragged against the
    cluster's slices, batches of 20 and 32 (more clusters; the cluster size
    falls, or the clusters run in waves, as the occupancy says), and slices
    that do not fit shared memory (400000 points: the global-memory slices
    at any cluster size)."""
    xyz = torch.from_numpy(_fps_cloud(np.random.RandomState(n + b), b, n)).to(card)
    idx = _fps_matches_plain(xyz, npoint)
    size, coresident = sampling.last_cluster
    assert size in (2, 4, 8, 16) and coresident >= 1
    assert size == 2 or n >= size * 256  # at least one point per thread of a block
    if n >= 8:  # the duplicate pair: the lower index wins the tie
        assert int(idx[0, 1]) == n // 4
    if b > 3:
        assert (idx[3] == 0).all()


@pytest.mark.parametrize("size", [2, 4, 8, 16])
def test_fps_every_cluster_size_matches_plain(card, size):
    xyz = torch.from_numpy(_fps_cloud(np.random.RandomState(size), 4, 40001)).to(card)
    _fps_matches_plain(xyz, 200, cluster_size=size)
    assert sampling.last_cluster[0] == size


def test_fps_waves_match_plain(card):
    """More clusters of 16 than the card holds at once: they run in
    waves."""
    xyz = torch.from_numpy(_fps_cloud(np.random.RandomState(6), 4, 40000)).to(card)
    sampling.furthest_point_sample_with_xyz(xyz, 2, cluster_size=16)
    waves = sampling.last_cluster[1] + 1
    xyz = torch.from_numpy(_fps_cloud(np.random.RandomState(7), waves, 40000)).to(card)
    _fps_matches_plain(xyz, 64, cluster_size=16)


def test_fps_coordinates_carry_the_gradient(card):
    """Under grad the picked coordinates are gathered in the graph: the same
    values as the kernel's, and the gradient of the plain version on the
    CPU (the JAX op's scatter onto the picked rows), within 1e-5: the
    all-padding cloud's 100 picks of row 0 add their cotangents in another
    order on the card."""
    xyz = _fps_cloud(np.random.RandomState(8), 4, 3000)
    xyz[2, 0] = 0.5  # a finite first pick: the gradient of a NaN is 0 on both sides
    g = torch.from_numpy(np.random.RandomState(9).randn(4, 100, 3).astype(np.float32))
    grads = []
    for device in (card, torch.device("cpu")):
        t = torch.from_numpy(xyz).to(device).requires_grad_()
        with torch.enable_grad():
            idx, coords = sampling.furthest_point_sample_with_xyz(t, 100)
            (coords * g.to(device)).sum().backward()
        grads.append(t.grad.cpu())
        if device == card:
            with torch.no_grad():
                assert torch.equal(coords, sampling.furthest_point_sample_with_xyz(t, 100)[1])
    torch.testing.assert_close(grads[0], grads[1], atol=1e-5, rtol=0)


@pytest.mark.parametrize("n,nsample,nf", [(1024, 8, 0), (900, 8, 4), (600, 16, 1), (100, 16, 2),
                                           (40000, 64, 1)])
def test_ball_query_kernel_matches_plain(card, n, nsample, nf):
    rng = np.random.RandomState(n + nf)
    xyz = _cloud(rng, 3, n)
    xyz[0, : n // 3] = xyz[0, n // 3: 2 * (n // 3)]  # duplicates
    ctr = _cloud(rng, 3, 48)
    ctr[:, :4] += 10.0  # empty balls
    feats = torch.from_numpy(rng.randn(3, n, nf).astype(np.float32)).to(card) if nf else None
    args = (0.35, nsample, torch.from_numpy(xyz).to(card), torch.from_numpy(ctr).to(card), feats)
    before = grouping.launches
    out = grouping.ball_query_stripes(*args)
    assert grouping.launches == before + 1
    ref = grouping.ball_query_stripes_plain(*args)
    torch.cuda.synchronize()
    for got, want in zip(out, ref):
        assert (got is None and want is None) or torch.equal(got, want)
    assert (out[0][:, :4] == 0).all()


def _ball_query_matches_plain(card, radius, nsample, xyz, ctr, feats, centres_per_warp=None):
    args = (radius, nsample, torch.from_numpy(xyz).to(card), torch.from_numpy(ctr).to(card),
            None if feats is None else torch.from_numpy(feats).to(card))
    before = grouping.launches
    out = grouping.ball_query_stripes(*args, centres_per_warp=centres_per_warp)
    assert grouping.launches == before + 1
    ref = grouping.ball_query_stripes_plain(*args)
    torch.cuda.synchronize()
    for got, want in zip(out, ref):
        assert (got is None and want is None) or torch.equal(got, want)
    return out


@pytest.mark.parametrize("shape", range(5))
def test_ball_query_main_path_shapes(card, shape):
    """Each of the main path's five shapes (``chip_smoke.BQ_SHAPES``) at
    batch 2, with chip_smoke's clouds: padding, duplicates, empty balls."""
    import chip_smoke

    _, n, m, nsample, radius, nf = chip_smoke.BQ_SHAPES[shape]
    rng = np.random.RandomState(40 + shape)
    xyz = chip_smoke.make_cloud(rng, 2, n)
    ctr = xyz[:, rng.permutation(n)[:m]].copy()
    ctr[:, :4] += 100.0  # empty balls
    feats = rng.rand(2, n, nf).astype(np.float32) if nf else None
    out = _ball_query_matches_plain(card, radius, nsample, xyz, ctr, feats)
    assert (out[0][:, :4] == 0).all()


# (points, nsample, picks): clouds of up to 512 points (one warp per centre
# unless the centres a warp are set), clouds staged whole (up to 2048
# points), stripe by stripe, and in several pieces a stripe (70000 points:
# stripes of 8832); both stripe plans
_EDGE_CLOUDS = [(512, 4, 1), (300, 16, 2), (1024, 8, 1), (600, 16, 2), (5000, 8, 1),
                (5000, 16, 2), (70000, 16, 2)]


def _planted_edges(card, n, nsample, picks, nf, centres_per_warp=None):
    """100 centres of 2 clouds (more than one block takes at any centres a
    warp): a point at exactly d2 == r2 (not in the ball), a centre on a
    point, duplicate points on both sides of a stripe boundary, duplicate
    centres on both sides of every block's and every warp's centre group
    (a block holds 8, 16, 32 or 64 centres), empty balls in one warp beside
    centres that are not, and a warp of 8 centres whose balls are all
    empty."""
    assert grouping.stripe_plan(n, nsample)[0] == picks
    width = grouping.stripe_plan(n, nsample)[1] // (nsample // picks)
    rng = np.random.RandomState(n + nf)
    xyz = _cloud(rng, 2, n)
    ctr = _cloud(rng, 2, 100)
    ctr[:, 0] = [0.25, 0.0, 0.0]
    xyz[:, :5] = 3.0  # out of its ball: point 6 is its first in stripe 0
    xyz[:, 5] = [0.75, 0.0, 0.0]  # d2 = 0.25 = r2 exactly: not in the ball
    xyz[:, 6] = [0.25, 0.0, 0.0]  # the centre on a point
    xyz[:, width] = xyz[:, width - 1]  # duplicates across the first stripe boundary
    ctr[:, 1] = xyz[:, width]  # a centre on them
    bounds = (2, 4, 8, 16, 32, 64)  # where warps of 2, 4, 8 and blocks of 8 ... 64 end
    for k in bounds:
        ctr[:, k] = ctr[:, k - 1]
    ctr[:, 40:44] += 10.0  # empty balls
    ctr[:, 72:80] += 10.0  # a whole warp of 8 empty balls
    feats = rng.randn(2, n, nf).astype(np.float32) if nf else None
    idx, rel, _ = _ball_query_matches_plain(card, 0.5, nsample, xyz, ctr, feats, centres_per_warp)
    for empty in (slice(40, 44), slice(72, 80)):
        assert (idx[:, empty] == 0).all() and (rel[:, empty] == 0).all()
    assert not (idx[:, 0] == 5).any() and (idx[:, 0] == 6).any()
    for k in bounds:
        assert torch.equal(idx[:, k], idx[:, k - 1])


@pytest.mark.parametrize("nf", range(5))
@pytest.mark.parametrize("n,nsample,picks", _EDGE_CLOUDS)
def test_ball_query_edges(card, n, nsample, picks, nf):
    """The planted cases (``_planted_edges``) at the launch the call picks
    itself, with 0-4 feature channels."""
    _planted_edges(card, n, nsample, picks, nf)


@pytest.mark.parametrize("c", grouping.CENTRES_PER_WARP)
@pytest.mark.parametrize("n,nsample,picks", _EDGE_CLOUDS)
def test_ball_query_edges_at_every_centre_count(card, n, nsample, picks, c):
    """The planted cases with the staged kernel set to 1, 2, 4 and 8
    centres a warp, at every cloud size (the smallest ones too, which the
    call itself gives a warp per centre), both stripe plans: the early exit
    once all of a warp's centres have their first qualifier, and each
    centre's first and last, at every width."""
    _planted_edges(card, n, nsample, picks, 2, centres_per_warp=c)
    launch = grouping.last_launch
    assert launch["kernel"] == "staged" and launch["centres_per_warp"] == c
    assert launch["blocks"] == 2 * -(-100 // (8 * c))
    assert launch["staged_whole"] == (n <= 2048)


def test_wrappers_refuse_bad_inputs(card):
    xyz = torch.zeros(2, 64, 3, device=card)
    with pytest.raises(ValueError):
        grouping.ball_query_stripes(0.2, 8, xyz, xyz, torch.zeros(2, 64, 5, device=card))
    with pytest.raises(ValueError):
        grouping.ball_query_stripes(0.2, 8, xyz, xyz.cpu())
    with pytest.raises(ValueError):
        sampling.furthest_point_sample_with_xyz(xyz[..., :2], 4)


DTYPES = [torch.float32, torch.bfloat16]


def _randn(rng, *shape, scale=1.0, dtype=torch.float32, device="cpu"):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(device, dtype)


def _assert_close(got, want, what):
    err = float((got.float() - want.float()).abs().max())
    if got.dtype == torch.bfloat16:
        tol = 2.0**-6 * float(want.float().abs().max())
    else:
        tol = 1e-3
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


def _counted(name, fn):
    before = dict(scoring_layer.launches)
    out = fn()
    assert scoring_layer.launches[name] == before[name] + 1
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n,k,gelu", [(300, 200, 72, False), (257, 136, 768, True),
                                        (1000, 768, 3072, False), (5, 8, 8, True)])
def test_scoring_gemm_matches_plain(card, dtype, m, n, k, gelu):
    rng = np.random.RandomState(m + n + k)
    x = _randn(rng, m, k, dtype=dtype, device=card)
    w = _randn(rng, n, k, scale=0.05, dtype=dtype, device=card)
    b = _randn(rng, n, scale=0.1, device=card)
    got = _counted("scoring_gemm", lambda: scoring_layer.scoring_gemm(x, w, b, gelu))
    _assert_close(got, scoring_layer.scoring_gemm_plain(x, w, b, gelu), "gemm")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("la,seqs,heads,hd", [(12, 37, 12, 64), (5, 3, 2, 64), (1, 9, 2, 16),
                                              (128, 2, 2, 64), (12, 11, 3, 34)])
def test_self_attention_matches_plain(card, dtype, la, seqs, heads, hd):
    rng = np.random.RandomState(la * seqs)
    qkv = _randn(rng, la * seqs, 3 * heads * hd, dtype=dtype, device=card)
    got = _counted("scoring_attention",
                   lambda: scoring_layer.self_attention(qkv, la=la, heads=heads))
    _assert_close(got, scoring_layer.self_attention_plain(qkv, la=la, heads=heads), "self")
    # head width 64 takes a tensor-core kernel: the bf16 pipeline where the
    # window (la + 15 keys) is at most 128, the f32 kernel at any la;
    # everything else the CUDA-core kernel
    pipeline = (0 if hd != 64 else 2 if dtype == torch.float32 else 1 if la + 15 <= 128 else 0)
    assert scoring_layer.last_attention_launch["pipeline"] == pipeline


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lk", [7, 80, 130])
def test_cross_attention_matches_plain(card, dtype, lk):
    """Three questions of 240 rows each (no multiple of the 128-row tile):
    all keys valid, all but one masked, half masked."""
    rng = np.random.RandomState(lk)
    nq, rows_per_q, heads, hd = 3, 240, 12, 64
    h = heads * hd
    qc = _randn(rng, nq * rows_per_q, h, dtype=dtype, device=card)
    ck = _randn(rng, nq, lk, h, dtype=dtype, device=card)
    cv = _randn(rng, nq, lk, h, dtype=dtype, device=card)
    mask = np.ones((nq, lk), bool)
    mask[1, 1:] = False
    mask[2, lk // 2:] = False
    cbias = torch.from_numpy(np.where(mask, 0.0, scoring_layer.NEG).astype(np.float32)).to(card)
    got = _counted("scoring_attention",
                   lambda: scoring_layer.cross_attention(qc, ck, cv, cbias, heads=heads))
    want = scoring_layer.cross_attention_plain(qc, ck, cv, cbias, heads=heads)
    _assert_close(got, want, f"cross, lk {lk}")
    # at most 128 keys: the bf16 pipeline or the f32 tensor-core kernel
    pipeline = 0 if lk > 128 else 1 if dtype == torch.bfloat16 else 2
    assert scoring_layer.last_attention_launch["pipeline"] == pipeline
    # the question with one valid key copies that key's value
    _assert_close(got[rows_per_q:2 * rows_per_q], cv[1, :1].expand(rows_per_q, h), "one key")


def _assert_pipeline_launch(rows_heads: int):
    """The last attention call ran the tensor-core pipeline: a persistent
    grid no larger than the blocks the card holds at once, a ring of 2-4
    stages, shared memory within a block's 227 KB (and within two blocks'
    share of an SM where two are resident), and units whose tiles cover
    every (row, head)."""
    launch = scoring_layer.last_attention_launch
    assert launch["pipeline"] == 1 and launch["threads"] == 9 * 32
    assert 1 <= launch["resident"] and launch["blocks"] <= launch["resident"] * launch["sms"]
    assert launch["blocks"] <= launch["units"] and 2 <= launch["stages"] <= 4
    assert launch["smem"] <= 232448 and launch["resident"] * (launch["smem"] + 1024) <= 233472
    assert launch["units"] * launch["seg"] * launch["tile_rows"] >= rows_heads


@pytest.mark.parametrize("seqs", [1001, 2048])
def test_self_attention_pipeline_matches_plain(card, seqs):
    """The tensor-core pipeline at 12 heads of 64 and answers of 12: 1001
    answers leave a last tile of one answer and a short last segment;
    2048 answers are the main path's 24576 rows."""
    la, heads = 12, 12
    rng = np.random.RandomState(seqs)
    qkv = _randn(rng, la * seqs, 3 * heads * 64, dtype=torch.bfloat16, device=card)
    got = _counted("scoring_attention",
                   lambda: scoring_layer.self_attention(qkv, la=la, heads=heads))
    _assert_close(got, scoring_layer.self_attention_plain(qkv, la=la, heads=heads), "self")
    _assert_pipeline_launch(la * seqs * heads)


@pytest.mark.parametrize("nq,rows_per_q", [(300, 36), (5, 200), (8, 3072)])
def test_cross_attention_pipeline_matches_plain(card, nq, rows_per_q):
    """The tensor-core pipeline at 12 heads of 64 and 80 keys: 300 questions
    of 36 rows (more units than the persistent grid has blocks, so they
    wrap), 5 of 200 (a 72-row last tile), and the main path's 8 of 3072.
    Question 1 has one valid key, question 2 half of them, the others a
    random count."""
    lk, heads = 80, 12
    h = heads * 64
    rng = np.random.RandomState(nq)
    qc = _randn(rng, nq * rows_per_q, h, dtype=torch.bfloat16, device=card)
    ck = _randn(rng, nq, lk, h, dtype=torch.bfloat16, device=card)
    cv = _randn(rng, nq, lk, h, dtype=torch.bfloat16, device=card)
    valid = rng.randint(1, lk + 1, nq)
    valid[1], valid[2] = 1, lk // 2
    mask = np.arange(lk)[None, :] < valid[:, None]
    cbias = torch.from_numpy(np.where(mask, 0.0, scoring_layer.NEG).astype(np.float32)).to(card)
    got = _counted("scoring_attention",
                   lambda: scoring_layer.cross_attention(qc, ck, cv, cbias, heads=heads))
    _assert_close(got, scoring_layer.cross_attention_plain(qc, ck, cv, cbias, heads=heads),
                  f"cross, {nq} questions of {rows_per_q}")
    _assert_close(got[rows_per_q:2 * rows_per_q], cv[1, :1].expand(rows_per_q, h), "one key")
    _assert_pipeline_launch(nq * rows_per_q * heads)
    launch = scoring_layer.last_attention_launch
    assert nq != 300 or launch["units"] > launch["blocks"]  # 300 questions: units wrap


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,cols", [(1001, 768), (3, 130)])
def test_add_layernorm_matches_plain(card, dtype, rows, cols):
    rng = np.random.RandomState(rows + cols)
    a = _randn(rng, rows, cols, dtype=dtype, device=card)
    r = _randn(rng, rows, cols, scale=2.0, dtype=dtype, device=card)
    scale = _randn(rng, cols, device=card) + 1.0
    bias = _randn(rng, cols, scale=0.1, device=card)
    got = _counted("scoring_layernorm",
                   lambda: scoring_layer.add_layernorm(a, r, scale, bias, 1e-12))
    _assert_close(got, scoring_layer.add_layernorm_plain(a, r, scale, bias, 1e-12), "layernorm")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,vocab,hdim", [(1000, 203, 64), (300, 30524, 768), (7, 5, 8)])
def test_vocab_reductions_match_plain(card, dtype, rows, vocab, hdim):
    rng = np.random.RandomState(rows + vocab)
    h = _randn(rng, rows, hdim, dtype=dtype, device=card)
    table = _randn(rng, vocab, hdim, scale=0.05, dtype=dtype, device=card)
    bias = _randn(rng, vocab, scale=0.1, device=card)
    labels = torch.from_numpy(rng.randint(0, vocab, rows).astype(np.int32)).to(card)
    before = vocab_loss.launches
    got = vocab_loss.lm_vocab_reductions(h, table, bias, labels)
    assert vocab_loss.launches == before + 1
    want = vocab_loss.lm_vocab_reductions_plain(h, table, bias, labels)
    for name, a, b in zip(("lse", "sum_logits", "target_logit"), got, want):
        err = float((a - b).abs().max())
        assert err <= 1e-3 * max(1.0, float(b.abs().max())), f"{name}: {err}"


def _vocab_check(h, table, bias, labels, **kw):
    before = vocab_loss.launches
    got = vocab_loss.lm_vocab_reductions(h, table, bias, labels, **kw)
    assert vocab_loss.launches == before + 1
    want = vocab_loss.lm_vocab_reductions_plain(h, table, bias, labels)
    for name, a, b in zip(("lse", "sum_logits", "target_logit"), got, want):
        err = float((a - b).abs().max())
        assert err <= 1e-3 * max(1.0, float(b.abs().max())), f"{name}: {err}"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,vocab,hdim,scale", [(333, 5, 768, 1.0), (129, 203, 8, 1.0),
                                                   (1001, 30524, 64, 1.0), (777, 203, 64, 30.0),
                                                   (200, 30524, 768, 30.0)])
def test_vocab_reductions_edges(card, dtype, rows, vocab, hdim, scale):
    """Rows that fill no 128-row panel, vocabularies of one, two and 239
    tiles whose last tile is mostly padding, widths of one box and of many,
    labels at the first and the last word, and logits scaled x30 (the
    running max moves far)."""
    rng = np.random.RandomState(rows + vocab + hdim)
    h = _randn(rng, rows, hdim, scale=scale, dtype=dtype, device=card)
    table = _randn(rng, vocab, hdim, scale=0.05 * 8 / hdim**0.5, dtype=dtype, device=card)
    bias = _randn(rng, vocab, scale=0.5, device=card)
    labels = rng.randint(0, vocab, rows).astype(np.int32)
    labels[::3] = 0
    labels[1::3] = vocab - 1
    _vocab_check(h, table, bias, torch.from_numpy(labels).to(card))


@pytest.mark.parametrize("dtype", DTYPES)
def test_vocab_reductions_run_past_vocab(card, dtype):
    """Runs of two tiles over a vocabulary of 203 words (two tiles of 128
    words in either type): the last runs lie wholly past it."""
    rng = np.random.RandomState(17)
    h = _randn(rng, 300, 64, dtype=dtype, device=card)
    table = _randn(rng, 203, 64, scale=0.1, dtype=dtype, device=card)
    bias = _randn(rng, 203, scale=0.5, device=card)
    labels = torch.from_numpy(rng.randint(0, 203, 300).astype(np.int32)).to(card)
    _vocab_check(h, table, bias, labels, split=(4 if dtype == torch.bfloat16 else 3, 2))


def test_kernels_refuse_inputs_that_want_a_gradient(card):
    """Under grad, a wrapper raises for an input that wants a gradient
    instead of handing autograd a result cut from the graph; without grad
    the same call runs. The ball query has a backward kernel and gives a
    result in the graph."""
    x = torch.randn(16, 64, device=card)
    w = torch.randn(32, 64, device=card, requires_grad=True)
    b = torch.zeros(32, device=card)
    qkv = torch.randn(2, 10, 3 * 128, device=card, requires_grad=True)
    xyz = torch.rand(2, 512, 3, device=card, requires_grad=True)
    labels = torch.zeros(16, dtype=torch.int32, device=card)
    calls = [lambda: scoring_layer.scoring_gemm(x, w, b),
             lambda: scoring_layer.add_layernorm(w, None, x[0], x[0], 1e-6),
             lambda: scoring_layer.self_attention(qkv[0].reshape(10, -1).contiguous(), la=5,
                                                  heads=2),
             lambda: vit_block.vit_attention(qkv, heads=2),
             lambda: vocab_loss.lm_vocab_reductions(x, w, b, labels),
             lambda: gather.gather_rows(w, labels)]
    for fn in calls:
        with torch.enable_grad(), pytest.raises(RuntimeError, match="no backward"):
            fn()
        with torch.no_grad():
            fn()
    with torch.enable_grad():
        _, rel, _ = grouping.ball_query_stripes(0.2, 8, xyz, xyz[:, :16].contiguous())
    assert rel.requires_grad and rel.grad_fn is not None


def test_backward_through_the_rank_slice(card, monkeypatch):
    """A backward through the tiny rank slice on the card, bf16, the
    detector frozen (the train step, ``test_train_step_on_the_card_matches_the_cpu``,
    trains it): neither fused path runs under grad, and the ViT's and both
    decoders' weights get gradients."""
    from bridgeqa_tpu_torch.models import blip_vqa3d, bridgeqa, med
    from bridgeqa_tpu_torch.models.layers import init_weights, set_compute_dtype

    m = med.MedConfig(vocab_size=120, hidden_size=128, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=256, max_position_embeddings=64,
                      encoder_width=128)
    blip = blip_vqa3d.BlipVQA3DConfig(med=m, image_size=32, num_answers=30, scene_size=32,
                                      bos_token_id=110, vit="custom", vit_custom_embed_dim=128,
                                      vit_custom_depth=1, vit_custom_heads=2)
    cfg = bridgeqa.BridgeQAConfig(num_answers=30, num_proposal=32, hidden_size=32, blip=blip,
                                  mcan_num_layers=1, mcan_flat_out_size=64,
                                  mcan_flat_mlp_size=32, input_feature_dim=1)
    monkeypatch.setattr(vit_block, "FUSED_MODE", "auto")
    model = init_weights(bridgeqa.BridgeQA(cfg, device=card), torch.Generator(card).manual_seed(0))
    set_compute_dtype(model.eval(), torch.bfloat16)
    model.detector.requires_grad_(False)
    rng = np.random.RandomState(3)
    pc = ((rng.rand(2, 2048, 3) - 0.5) * 6.0).astype(np.float32)
    answers = rng.randint(1, 100, (30, 5))
    answers[:, 0] = 110
    batch = dict(point_clouds=np.concatenate([pc, pc[..., 2:] + 3.0], -1),
                 images=rng.rand(2, 32, 32, 3).astype(np.float32),
                 question_ids=rng.randint(1, 100, (2, 12)),
                 question_mask=np.ones((2, 12), np.int32), answer_list_ids=answers,
                 answer_list_mask=np.ones((30, 5), np.int32))
    batch = {k: torch.from_numpy(v).to(card) for k, v in batch.items()}
    before = (dict(scoring_layer.launches), vit_block.launches, vocab_loss.launches)
    with torch.enable_grad():
        out = model(batch, inference="rank", k_test=8)
        scored = out["answer_scores_2d"] != -1e4
        (out["answer_scores_2d"][scored].sum() + out["answer_scores_scene"][scored].sum()).backward()
    assert (dict(scoring_layer.launches), vit_block.launches, vocab_loss.launches) == before
    params = dict(model.named_parameters())
    for name in ("blip_model.visual_encoder.blocks_0.attn.qkv.weight",
                 "blip_model.text_decoder.bert.encoder.layer_0.crossattention.self.query.weight",
                 "blip_model.text_decoder_scene.bert.encoder.layer_0.crossattention.self.query."
                 "weight"):
        g = params[name].grad
        assert g is not None and g.dtype == torch.float32, name
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0, name


def test_scoring_wrappers_refuse_bad_inputs(card):
    x = torch.zeros(16, 64, device=card)
    w = torch.zeros(32, 64, device=card)
    b = torch.zeros(32, device=card)
    with pytest.raises(ValueError):  # mixed devices
        scoring_layer.scoring_gemm(x, w.cpu(), b)
    with pytest.raises(ValueError):  # not contiguous
        scoring_layer.scoring_gemm(x, torch.zeros(64, 32, device=card).T, b)
    with pytest.raises(ValueError):  # no kernel for float16
        scoring_layer.scoring_gemm(x.half(), w.half(), b)
    with pytest.raises(ValueError):  # bf16 needs widths that are multiples of 8
        scoring_layer.scoring_gemm(x[:, :60].bfloat16().contiguous(),
                                   w[:, :60].bfloat16().contiguous(), b)
    with pytest.raises(ValueError):
        scoring_layer.self_attention(torch.zeros(3 * 64, 12, device=card).T, la=12, heads=2)
    with pytest.raises(ValueError):
        scoring_layer.cross_attention(torch.zeros(8, 64, device=card), torch.zeros(2, 5, 64),
                                      torch.zeros(2, 5, 64), torch.zeros(2, 5), heads=2)
    with pytest.raises(ValueError):
        scoring_layer.add_layernorm(x, x, torch.ones(64, device=card).bfloat16(),
                                    torch.zeros(64, device=card), 1e-12)
    with pytest.raises(ValueError):
        vocab_loss.lm_vocab_reductions(x, w, b, torch.zeros(16, dtype=torch.int64, device=card))


# ------------------------------------------------------------ the ViT block

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n,k,gelu", [(7208, 768, 3072, False), (37, 136, 72, True)])
def test_scoring_gemm_residual_matches_plain(card, dtype, m, n, k, gelu):
    rng = np.random.RandomState(m + k)
    x = _randn(rng, m, k, dtype=dtype, device=card)
    w = _randn(rng, n, k, scale=0.05, dtype=dtype, device=card)
    b = _randn(rng, n, scale=0.5, device=card)
    res = _randn(rng, m, n, scale=2.0, dtype=dtype, device=card)
    got = _counted("scoring_gemm", lambda: scoring_layer.scoring_gemm(x, w, b, gelu, res))
    want = scoring_layer.scoring_gemm_plain(x, w, b, gelu, res)
    _assert_close(got, want, "gemm + residual")
    _assert_close(got - res, scoring_layer.scoring_gemm_plain(x, w, b, gelu), "residual dropped")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("epilogue", ["gelu", "residual"])
@pytest.mark.parametrize("m,n,k", [(7208, 136, 8), (1000, 8, 776), (5, 200, 72),
                                   (7208, 2304, 776), (1000, 3072, 72)])
def test_scoring_gemm_tma_edges(card, dtype, epilogue, m, n, k):
    """The bf16 kernel's TMA boxes past the edges: M no multiple of the
    128-row tile, N no multiple of 256 (or of the 128-wide tile, or of the
    64-wide store box), K no multiple of the 64-wide load box."""
    rng = np.random.RandomState(m + 3 * n + 7 * k)
    x = _randn(rng, m, k, dtype=dtype, device=card)
    w = _randn(rng, n, k, scale=0.05, dtype=dtype, device=card)
    b = _randn(rng, n, scale=0.5, device=card)
    gelu = epilogue == "gelu"
    res = None if gelu else _randn(rng, m, n, scale=2.0, dtype=dtype, device=card)
    got = _counted("scoring_gemm", lambda: scoring_layer.scoring_gemm(x, w, b, gelu, res))
    _assert_close(got, scoring_layer.scoring_gemm_plain(x, w, b, gelu, res), f"gemm, {epilogue}")
    if res is not None:
        _assert_close(got - res, scoring_layer.scoring_gemm_plain(x, w, b), "residual dropped")


@pytest.mark.parametrize("dtype", DTYPES)
def test_scoring_gemm_gelu_is_exact(card, dtype):
    """The epilogue's GELU (a branch-free erf) at every |x| up to 6, taken
    through an identity product so that the sum is exact: within 2 f32 ulp
    of the erf GELU in f32 (erf's error times |x| / 2 where erf nears -1),
    within one bf16 rounding in bf16."""
    x = torch.linspace(-6.0, 6.0, 4096 * 8, dtype=torch.float64).reshape(4096, 8).to(dtype)
    w = torch.eye(8, dtype=dtype)
    b = torch.zeros(8)
    got = _counted("scoring_gemm", lambda: scoring_layer.scoring_gemm(
        x.to(card), w.to(card), b.to(card), True)).cpu().double()
    xd = x.double()
    want = 0.5 * xd * (1.0 + torch.erf(xd / 2.0**0.5))
    ulp = 2.0**-23 if dtype == torch.float32 else 2.0**-8
    tol = 2 * ulp * want.abs() + 2.0**-23 * xd.abs()
    assert ((got - want).abs() <= tol).all(), float(((got - want).abs() - tol).max())


def test_kernels_from_threads(card):
    """The C entries are called through ctypes, which releases the GIL, so
    host threads launching at once share the GEMM's tensor-map cache and the
    per-device shared-memory attribute record. Every thread's results equal,
    bit for bit, those of the same calls made from one thread."""
    rng = np.random.RandomState(5)
    calls = []
    for m, n, k in [(300, 200, 72), (1000, 768, 776), (5, 136, 8)]:
        x = _randn(rng, m, k, dtype=torch.bfloat16, device=card)
        w = _randn(rng, n, k, scale=0.05, dtype=torch.bfloat16, device=card)
        b = _randn(rng, n, scale=0.1, device=card)
        calls.append(lambda x=x, w=w, b=b: scoring_layer.scoring_gemm(x, w, b, True))
    qkv = _randn(rng, 2, 65, 3 * 3 * vit_block.HEAD_DIM, dtype=torch.bfloat16, device=card)
    calls.append(lambda: vit_block.vit_attention(qkv, heads=3))
    want = [fn() for fn in calls]
    got = [[] for _ in calls]

    def run(i):
        for _ in range(50):
            got[i].append(calls[i]())

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(calls))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    for i, (ref, outs) in enumerate(zip(want, got)):
        assert len(outs) == 50, f"call {i}: a thread raised"
        assert all(torch.equal(o, ref) for o in outs), f"call {i}"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,cols,mode", [(1001, 768, "plain"), (3, 130, "plain"),
                                            (1001, 768, "sum"), (3, 130, "sum")])
def test_layernorm_vit_modes_match_plain(card, dtype, rows, cols, mode):
    """LayerNorm with no residual, and LayerNorm(a + r) keeping the sum."""
    rng = np.random.RandomState(rows * cols)
    a = _randn(rng, rows, cols, dtype=dtype, device=card)
    r = _randn(rng, rows, cols, scale=2.0, dtype=dtype, device=card) if mode == "sum" else None
    scale = _randn(rng, cols, scale=0.5, device=card) + 1.0
    bias = _randn(rng, cols, scale=0.5, device=card)
    keep = mode == "sum"
    got = _counted("scoring_layernorm",
                   lambda: scoring_layer.add_layernorm(a, r, scale, bias, 1e-6, keep_sum=keep))
    want = scoring_layer.add_layernorm_plain(a, r, scale, bias, 1e-6, keep_sum=keep)
    if keep:
        assert torch.equal(got[0], want[0])  # the sum is rounded once on both sides
        got, want = got[1], want[1]
    _assert_close(got, want, f"layernorm, {mode}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 17, 64, 65, 577, 833, 901, 1025])
def test_vit_attention_matches_plain(card, dtype, n):
    rng = np.random.RandomState(n)
    b, heads = 2, 3
    qkv = _randn(rng, b, n, 3 * heads * vit_block.HEAD_DIM, dtype=dtype, device=card)
    before = vit_block.launches
    got = vit_block.vit_attention(qkv, heads=heads)
    assert vit_block.launches == before + 1
    _assert_close(got, vit_block.vit_attention_plain(qkv, heads=heads), f"vit attention, n {n}")
    if n == 1:  # one key: the context is its value
        assert torch.equal(got, qkv[..., 2 * heads * vit_block.HEAD_DIM:])


F32_ROUTE_TOL = 1e-5  # of the largest output, against f64


def _route_err(got, exact):
    return float((got.double() - exact).abs().max() / exact.abs().max())


@pytest.mark.parametrize("m,n,k,gelu,residual", [(36928, 2304, 768, False, False),
                                                 (36928, 768, 3072, False, True),
                                                 (1000, 3072, 768, True, False)])
def test_scoring_gemm_f32_keeps_f32_accuracy(card, m, n, k, gelu, residual):
    rng = np.random.RandomState(m + n + k)
    x = _randn(rng, m, k, device=card)
    w = _randn(rng, n, k, scale=0.02, device=card)
    b = _randn(rng, n, scale=0.5, device=card)
    res = _randn(rng, m, n, scale=2.0, device=card) if residual else None
    got = _counted("scoring_gemm", lambda: scoring_layer.scoring_gemm(x, w, b, gelu, res))
    _assert_close(got, scoring_layer.scoring_gemm_plain(x, w, b, gelu, res), "f32 gemm")
    y = x.double() @ w.double().T + b.double()
    y = 0.5 * y * (1.0 + torch.erf(y * 0.5**0.5)) if gelu else y
    y = y if res is None else res.double() + y
    assert _route_err(got, y) <= F32_ROUTE_TOL


@pytest.mark.parametrize("n", [1, 65, 577, 901])
def test_vit_attention_f32_keeps_f32_accuracy(card, n):
    rng = np.random.RandomState(n + 1)
    heads = 12
    qkv = _randn(rng, 3, n, 3 * heads * vit_block.HEAD_DIM, device=card)
    got = vit_block.vit_attention(qkv, heads=heads)
    q, k, v = qkv.double().view(3, n, 3, heads, vit_block.HEAD_DIM).permute(2, 0, 3, 1, 4)
    ctx = torch.softmax(q @ k.transpose(-1, -2) / vit_block.HEAD_DIM**0.5, dim=-1) @ v
    assert _route_err(got, ctx.transpose(1, 2).reshape(got.shape)) <= F32_ROUTE_TOL


@pytest.mark.parametrize("n", [130, 131])
@pytest.mark.parametrize("k", [1, 3, 75, 777, 768])
def test_scoring_gemm_f32_any_k(card, k, n):
    """K no multiple of 4 and x, w at a 4-byte offset take the kernel's
    4-byte copies; 37 rows and 130 or 131 columns fill no tile; the
    residual lies at a 4-byte offset."""
    rng = np.random.RandomState(k + n)
    m = 37
    xs = _randn(rng, m * k + 1, device=card)
    ws = _randn(rng, n * k + 1, scale=0.05, device=card)
    x, w = xs[1:].view(m, k), ws[1:].view(n, k)
    b = _randn(rng, n, scale=0.5, device=card)
    res = _randn(rng, m * n + 1, scale=2.0, device=card)[1:].view(m, n)
    for gelu, r in ((True, None), (False, res)):
        got = _counted("scoring_gemm", lambda: scoring_layer.scoring_gemm(x, w, b, gelu, r))
        _assert_close(got, scoring_layer.scoring_gemm_plain(x, w, b, gelu, r), f"f32 gemm, k {k}")


def _assert_f32_attention_launch(rows_heads: int):
    """The last attention call ran the f32 tensor-core kernel: a persistent
    grid no larger than the blocks the card holds at once, 8 warps, shared
    memory within a block's 227 KB (and within two blocks' share of an SM
    where two are resident), and units whose tiles cover every (row, head)."""
    launch = scoring_layer.last_attention_launch
    assert launch["pipeline"] == 2 and launch["threads"] == 8 * 32
    assert 1 <= launch["resident"] and launch["blocks"] <= launch["resident"] * launch["sms"]
    assert launch["blocks"] <= launch["units"] and launch["stages"] == 0
    assert launch["smem"] <= 232448 and launch["resident"] * (launch["smem"] + 1024) <= 233472
    assert launch["units"] * launch["seg"] * launch["tile_rows"] >= rows_heads


def _self_attention_f64(qkv, la, heads):
    r, h3 = qkv.shape
    hd = h3 // 3 // heads
    q, k, v = qkv.double().view(r // la, la, 3, heads, hd).permute(2, 0, 3, 1, 4)
    causal = torch.tril(torch.ones(la, la, dtype=torch.bool, device=qkv.device))
    s = (q @ k.transpose(-1, -2) / hd**0.5).masked_fill(~causal, float("-inf"))
    return (torch.softmax(s, dim=-1) @ v).permute(0, 2, 1, 3).reshape(r, h3 // 3)


def _cross_attention_f64(qc, ck, cv, cbias, heads):
    r, h = qc.shape
    nq, lk, _ = ck.shape
    hd = h // heads
    q = qc.double().view(nq, r // nq, heads, hd).transpose(1, 2)
    k, v = (x.double().view(nq, lk, heads, hd).transpose(1, 2) for x in (ck, cv))
    s = q @ k.transpose(-1, -2) / hd**0.5 + cbias.double()[:, None, None, :]
    return (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(r, h)


@pytest.mark.parametrize("la,seqs", [(12, 2048), (1, 300), (5, 301), (128, 20)])
def test_self_attention_f32_keeps_f32_accuracy(card, la, seqs):
    """The f32 tensor-core kernel at 12 heads of 64: answers of 12 (2048 of
    them, the main path's 24576 rows), of 1 (no key but the row's own), of 5
    (windows across three answers) and of 128 (a tile of one answer; the
    last warps' windows take two 64-key steps, rescaled between them).
    Within 1e-5 of the largest output against
    f64; the first row of every answer sees only itself, so its context is
    its own value bit for bit."""
    heads = 12
    h = heads * 64
    rng = np.random.RandomState(la + seqs)
    qkv = _randn(rng, la * seqs, 3 * h, device=card)
    got = _counted("scoring_attention",
                   lambda: scoring_layer.self_attention(qkv, la=la, heads=heads))
    _assert_f32_attention_launch(la * seqs * heads)
    assert _route_err(got, _self_attention_f64(qkv, la, heads)) <= F32_ROUTE_TOL
    assert torch.equal(got.view(seqs, la, h)[:, 0], qkv.view(seqs, la, 3 * h)[:, 0, 2 * h:])


@pytest.mark.parametrize("nq,rows_per_q", [(8, 3072), (5, 200)])
@pytest.mark.parametrize("lk", [7, 80, 130])
def test_cross_attention_f32_keeps_f32_accuracy(card, lk, nq, rows_per_q):
    """f32 cross attention at 12 heads of 64: the main path's 8 questions of
    3072 rows and 5 of 200 (a 72-row last tile), against 7, 80 and 130 keys
    with a -1e9 bias on some (question 1 has one valid key, question 2 half
    of them, the others a random count). Up to 128 keys take the f32
    tensor-core kernel, 130 the CUDA-core one. Within 1e-5 of the largest
    output against f64; the question with one valid key gives that key's
    value on every row, bit for bit."""
    heads = 12
    h = heads * 64
    rng = np.random.RandomState(lk + nq)
    qc = _randn(rng, nq * rows_per_q, h, device=card)
    ck, cv = _randn(rng, nq, lk, h, device=card), _randn(rng, nq, lk, h, device=card)
    valid = rng.randint(1, lk + 1, nq)
    valid[1], valid[2] = 1, max(1, lk // 2)
    mask = np.arange(lk)[None, :] < valid[:, None]
    cbias = torch.from_numpy(np.where(mask, 0.0, scoring_layer.NEG).astype(np.float32)).to(card)
    got = _counted("scoring_attention",
                   lambda: scoring_layer.cross_attention(qc, ck, cv, cbias, heads=heads))
    if lk <= 128:
        _assert_f32_attention_launch(nq * rows_per_q * heads)
    else:
        assert scoring_layer.last_attention_launch["pipeline"] == 0
    assert _route_err(got, _cross_attention_f64(qc, ck, cv, cbias, heads)) <= F32_ROUTE_TOL
    assert torch.equal(got[rows_per_q:2 * rows_per_q], cv[1, :1].expand(rows_per_q, h))


def test_vocab_reductions_f32_keeps_f32_accuracy(card):
    """The f32 vocabulary pass at the main path's (22528, 30524, 768)
    against logits taken in f64 (in row chunks): lse and the target logit
    within 1e-5 of their largest value, each row's sum of logits within 1e-5
    of its sum of |logit|."""
    rows, vocab, hdim = 22528, 30524, 768
    rng = np.random.RandomState(22)
    h = _randn(rng, rows, hdim, device=card)
    table = _randn(rng, vocab, hdim, scale=0.05, device=card)
    bias = _randn(rng, vocab, scale=0.5, device=card)
    labels = torch.from_numpy(rng.randint(0, vocab, rows).astype(np.int32)).to(card)
    lse, sumlog, tgt = vocab_loss.lm_vocab_reductions(h, table, bias, labels)
    want = {k: [] for k in ("lse", "sum", "tgt", "abs")}
    t64, b64 = table.double(), bias.double()
    for s in range(0, rows, 2048):
        logits = h[s:s + 2048].double() @ t64.T + b64
        want["lse"].append(torch.logsumexp(logits, dim=-1))
        want["sum"].append(logits.sum(dim=-1))
        want["tgt"].append(logits.gather(1, labels[s:s + 2048].long()[:, None])[:, 0])
        want["abs"].append(logits.abs().sum(dim=-1))
        del logits
    want = {k: torch.cat(v) for k, v in want.items()}
    assert _route_err(lse, want["lse"]) <= F32_ROUTE_TOL
    assert _route_err(tgt, want["tgt"]) <= F32_ROUTE_TOL
    assert float(((sumlog.double() - want["sum"]).abs() / want["abs"]).max()) <= F32_ROUTE_TOL


@pytest.mark.parametrize("hdim", [3, 75, 768])
def test_vocab_reductions_f32_any_k(card, hdim):
    """Widths no multiple of 4, and h and the table at a 4-byte offset, take
    the f32 kernel's 4-byte copies; 300 rows and 203 words fill no tile."""
    rng = np.random.RandomState(hdim)
    rows, vocab = 300, 203
    h = _randn(rng, rows * hdim + 1, device=card)[1:].view(rows, hdim)
    table = _randn(rng, vocab * hdim + 1, scale=0.1, device=card)[1:].view(vocab, hdim)
    bias = _randn(rng, vocab, scale=0.5, device=card)
    labels = torch.from_numpy(rng.randint(0, vocab, rows).astype(np.int32)).to(card)
    _vocab_check(h, table, bias, labels)


@pytest.mark.parametrize("dtype", DTYPES)
def test_vit_block_matches_plain(card, dtype):
    """A whole block at embed 128, 2 heads, 37 tokens; biases and LayerNorm
    parameters away from 0 and (1, 0)."""
    rng = np.random.RandomState(11)
    h, mlp = 128, 512
    x = _randn(rng, 3, 37, h, dtype=dtype, device=card)
    ws = [_randn(rng, *shape, scale=0.05, dtype=dtype, device=card)
          for shape in ((3 * h, h), (h, h), (mlp, h), (h, mlp))]
    bs = [_randn(rng, w.shape[0], scale=0.5, device=card) for w in ws]
    lns = [_randn(rng, h, scale=0.5, device=card) + shift for shift in (1.0, 0.0, 1.0, 0.0)]
    args = (x, ws[0], bs[0], ws[1], bs[1], lns[0], lns[1], ws[2], bs[2], ws[3], bs[3], lns[2],
            lns[3])
    got = vit_block.vit_block(*args, heads=2, eps=1e-6)
    _assert_close(got, vit_block.vit_block_plain(*args, heads=2, eps=1e-6), "vit block")


def test_vit_wrappers_refuse_bad_inputs(card):
    qkv = torch.zeros(2, 10, 3 * 128, device=card)
    with pytest.raises(ValueError):  # not contiguous
        vit_block.vit_attention(torch.zeros(2, 3 * 128, 10, device=card).transpose(1, 2), heads=2)
    with pytest.raises(ValueError):  # no kernel for float16
        vit_block.vit_attention(qkv.half(), heads=2)
    with pytest.raises(ValueError):  # head width 32
        vit_block.vit_attention(qkv, heads=4)
    with pytest.raises(ValueError):  # a residual of another shape
        scoring_layer.scoring_gemm(torch.zeros(4, 8, device=card), torch.zeros(8, 8, device=card),
                                   torch.zeros(8, device=card),
                                   residual=torch.zeros(4, 16, device=card))


# ------------------------------------------------------------ the gather

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,c,r", [(1000, 1, 3001), (40000, 3, 5003), (2048, 4, 777),
                                   (2048, 131, 1037)])
def test_gather_rows_matches_torch_gather(card, dtype, n, c, r):
    rng = np.random.RandomState(n + c)
    table = _randn(rng, 3, n, c, dtype=dtype, device=card)
    idx = torch.from_numpy(rng.randint(0, n, (3, r)).astype(np.int32)).to(card)
    before = gather.launches
    got = gather.gather_rows(table, idx)
    assert gather.launches == before + 1
    assert torch.equal(got, gather.gather_rows_plain(table, idx))
    one = gather.gather_rows(table[1], idx[1].long())
    assert torch.equal(one, table[1][idx[1].long()])


def test_gather_rows_refuses_bad_inputs(card):
    table = torch.zeros(2, 50, 4, device=card)
    idx = torch.zeros(2, 7, dtype=torch.int32, device=card)
    with pytest.raises(IndexError):
        gather.gather_rows(table, idx + 50)
    with pytest.raises(IndexError):
        gather.gather_rows(table, idx - 1)
    with pytest.raises(ValueError):  # float indices
        gather.gather_rows(table, idx.float())
    with pytest.raises(ValueError):  # no kernel for float16
        gather.gather_rows(table.half(), idx)
    with pytest.raises(ValueError):  # not contiguous
        gather.gather_rows(torch.zeros(2, 4, 50, device=card).transpose(1, 2), idx)
    with pytest.raises(ValueError):  # mixed devices
        gather.gather_rows(table, idx.cpu())


def _tiny_generate_model(card_dtype=None):
    """The tiny rank slice's config (hidden 128, 2 heads), weights drawn on
    the CPU, the 2D decoder's LM head bias sharpened (random weights give
    near-uniform logits whose beam choices a sum in another order can flip)."""
    from bridgeqa_tpu_torch.models import blip_vqa3d, bridgeqa, med
    from bridgeqa_tpu_torch.models.layers import init_weights

    m = med.MedConfig(vocab_size=200, hidden_size=128, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=256, max_position_embeddings=64,
                      encoder_width=128)
    blip = blip_vqa3d.BlipVQA3DConfig(med=m, image_size=32, num_answers=30, scene_size=32,
                                      bos_token_id=110, vit="custom", vit_custom_embed_dim=128,
                                      vit_custom_depth=1, vit_custom_heads=2)
    cfg = bridgeqa.BridgeQAConfig(num_answers=30, num_proposal=32, hidden_size=32, blip=blip,
                                  mcan_num_layers=1, input_feature_dim=1)
    model = init_weights(bridgeqa.BridgeQA(cfg, device="cpu"), torch.Generator().manual_seed(4))
    bias = model.blip_model.text_decoder.cls.bias
    with torch.no_grad():
        bias += torch.from_numpy(np.random.RandomState(1).randn(200).astype(np.float32) * 4.0)
    return model.eval()


def test_generate_on_the_card_matches_the_cpu(card, monkeypatch):
    """The tiny generate forward (2 x 3 beams, 8 tokens) in f32 through the
    card's kernels against the plain versions on the CPU: the ids equal,
    the heads within the f32 rule; the detector and ViT kernels launched,
    the scoring attentions and the vocabulary pass not."""
    import copy

    cpu_model = _tiny_generate_model()
    card_model = copy.deepcopy(cpu_model).to(card)
    rng = np.random.RandomState(6)
    pc = ((rng.rand(2, 2048, 3) - 0.5) * 6.0).astype(np.float32)
    batch = dict(point_clouds=np.concatenate([pc, pc[..., 2:] + 3.0], -1),
                 images=rng.rand(2, 32, 32, 3).astype(np.float32),
                 question_ids=rng.randint(1, 100, (2, 12)),
                 question_mask=np.ones((2, 12), np.int32))
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    kw = dict(inference="generate", num_beams=3, max_length=8)
    with torch.inference_mode():
        monkeypatch.setattr(vit_block, "FUSED_MODE", "force")
        want = cpu_model(batch, **kw)
        monkeypatch.setattr(vit_block, "FUSED_MODE", "auto")
        before = (dict(scoring_layer.launches), vit_block.launches, vocab_loss.launches,
                  sampling.launches, grouping.launches)
        got = card_model({k: v.to(card) for k, v in batch.items()}, **kw)
        torch.cuda.synchronize()
    assert torch.equal(got["generated_ids"].cpu(), want["generated_ids"])
    for key in ("lang_scores", "cluster_ref"):
        _assert_close(got[key].cpu(), want[key], key)
    assert scoring_layer.launches["scoring_attention"] == before[0]["scoring_attention"]
    assert scoring_layer.launches["scoring_gemm"] > before[0]["scoring_gemm"]
    assert vit_block.launches > before[1] and vocab_loss.launches == before[2]
    assert sampling.launches > before[3] and grouping.launches > before[4]


def test_bf16_decode_step_matches_f32(card):
    """Three KV-cached decode steps of a 2-layer decoder at full width
    (hidden 768, 12 heads, 30524 words) in bf16 against the same weights in
    f32, 10 beam rows over 80 question tokens: the logits within the bf16
    rule (of the f32 logits' largest)."""
    import copy

    from bridgeqa_tpu_torch.models import med
    from bridgeqa_tpu_torch.models.layers import init_weights, set_compute_dtype

    cfg = med.MedConfig(num_hidden_layers=2)
    gen = torch.Generator(card).manual_seed(9)
    f32 = init_weights(med.BertLMHeadModel(cfg).to(card), gen).eval()
    bf16 = set_compute_dtype(copy.deepcopy(f32), torch.bfloat16)
    rng = np.random.RandomState(9)
    states = _randn(rng, 10, 80, 768, device=card)
    mask = torch.ones(10, 80, dtype=torch.int32, device=card)
    mask[5:, 60:] = 0
    tokens = torch.from_numpy(rng.randint(1, 30000, (3, 10, 1))).to(card)
    with torch.inference_mode():
        c32 = f32.init_cache(states, mask, 20)
        c16 = bf16.init_cache(states.to(torch.bfloat16), mask, 20)
        assert c16["layers"][0]["self_k"].dtype == torch.bfloat16
        for tok in tokens:
            want, c32 = f32.decode_step(tok, c32)
            got, c16 = bf16.decode_step(tok, c16)
            err = float((got.float() - want).abs().max())
            assert err <= 2.0**-6 * float(want.abs().max()), err


def test_decode_loop_makes_no_host_sync(card):
    """The cached beam search issues its 2 x 3 beams' 7 steps through the
    tiny model's decoder without waiting for the card once: under
    ``torch.cuda.set_sync_debug_mode("error")`` any synchronising call
    raises."""
    from bridgeqa_tpu_torch.models.generation import beam_search_cached, interleave_streams

    blip = _tiny_generate_model().blip_model.to(card)
    rng = np.random.RandomState(7)
    h2d = _randn(rng, 2, 12, 128, device=card)
    h3d = _randn(rng, 2, 12, 128, device=card)
    mask = torch.ones(2 * 6, 12, dtype=torch.int32, device=card)
    c = blip.cfg
    with torch.inference_mode():
        cache = blip.text_decoder.init_cache(interleave_streams(h2d, h3d, 3), mask, 8)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ids, scores = beam_search_cached(
                blip.text_decoder.decode_step, cache, 2, 6, bos_token_id=c.bos_token_id,
                eos_token_id=c.sep_token_id, pad_token_id=c.pad_token_id, max_length=8)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert ids.shape == (2, 6, 8) and bool(torch.isfinite(scores).all())


# ------------------------------------------------------------ training

# parameters whose gradient is 0 by construction: a softmax ignores a key
# bias (the med-BERT's and the grounding SGA's) and the grounding head's
# output bias, and a BatchNorm takes out a bias added before it
ZERO_GRADIENT = ("attention.self.key.bias", "crossattention.self.key.bias", "linear_k.bias",
                 "vgen.conv1.bias", "vgen.conv2.bias", "object_cls.fc2.bias")

def _bq_case(rng, b, n, m, nf, card):
    """Duplicates, padding, and the first four centres far from every point
    (all-empty balls)."""
    xyz = _cloud(rng, b, n)
    dup = min(32, n // 2)
    xyz[:, n // 2:n // 2 + dup] = xyz[:, :dup]
    xyz[:, -8:] = 0.0
    ctr = xyz[:, rng.permutation(n)[:m]].copy()
    ctr[:, :4] += 50.0
    feats = rng.rand(b, n, nf).astype(np.float32) if nf else None
    t = [torch.from_numpy(a).to(card) for a in (xyz, ctr)]
    return t[0], t[1], None if feats is None else torch.from_numpy(feats).to(card)


# (points, centres, nsample, feature channels, the blocks a cloud
# ``backward_plan`` gives them): the train step's shape (a cluster of 4),
# SA1's size (8), fewer centres (a lone block, a cluster of 2), and 0 to 4
# feature channels
_BACKWARD_CASES = [(1024, 256, 16, 0, 4), (1024, 64, 16, 0, 1), (1024, 128, 16, 0, 2),
                   (5000, 512, 64, 1, 8), (700, 100, 32, 4, 2), (700, 130, 32, 3, 4),
                   (40, 32, 8, 2, 1), (40000, 2048, 64, 1, 8)]


@pytest.mark.parametrize("n,m,nsample,nf,k", _BACKWARD_CASES)
def test_ball_query_backward_kernel_matches_plain(card, n, m, nsample, nf, k):
    rng = np.random.RandomState(n + nf)
    xyz, ctr, feats = _bq_case(rng, 3, n, m, nf, card)
    with torch.no_grad():
        idx, _, _ = grouping.ball_query_stripes(0.2, nsample, xyz, ctr, feats)
    assert bool((idx[:, :4] == 0).all())
    g_rel = torch.randn(3, m, nsample, 3, device=card)
    g_grouped = torch.randn(3, m, nsample, nf, device=card) if nf else None
    before = grouping.backward_launches
    got = grouping.ball_query_stripes_backward(idx, g_rel, g_grouped, n)
    assert grouping.backward_launches == before + 1
    plan = grouping.backward_plan(3, n, m, nsample)
    assert plan["blocks_per_cloud"] == k
    assert grouping.last_backward_launch == dict(blocks=3 * k, cluster=k,
                                                 threads=grouping.BACKWARD_THREADS)
    want = grouping.ball_query_stripes_backward_plain(idx, g_rel, g_grouped, n)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * float(w.abs().max()))
    assert float(got[0][:, 0].abs().sum()) > 0  # the empty balls' slots reach point 0


@pytest.mark.parametrize("m,k", [(64, 1), (128, 2), (256, 4), (512, 8)])
@pytest.mark.parametrize("nf", [0, 1, 2, 3, 4])
def test_ball_query_backward_hot_point(card, nf, m, k):
    """Every slot of every centre picks one point (each add of a warp, and
    of every block of a cluster, lands on the same words), and the outputs
    come from torch.empty over memory just filled with NaN: the hot point's
    sums are exact (the cotangents are multiples of 1/8, whose sums round in
    no order), and every other point reads exactly 0.0. The centre counts
    take each blocks a cloud ``backward_plan`` gives: 1, 2, 4 and 8."""
    b, n, ns, hot = 2, 3000, 16, 1234
    assert grouping.backward_plan(b, n, m, ns)["blocks_per_cloud"] == k
    idx = torch.full((b, m, ns), hot, dtype=torch.int32, device=card)
    gen = torch.Generator(device=card).manual_seed(nf)
    g_rel = torch.randint(-8, 9, (b, m, ns, 3), generator=gen, device=card).float() / 8
    g_grouped = (torch.randint(-8, 9, (b, m, ns, nf), generator=gen, device=card).float() / 8
                 if nf else None)
    # the caching allocator hands these blocks back to the outputs
    garbage = [torch.full(shape, float("nan"), device=card)
               for shape in ((b, n, 3), (b, m, 3), (b, n, nf))]
    del garbage
    g_xyz, g_center, g_feats = grouping.ball_query_stripes_backward(idx, g_rel, g_grouped, n)
    assert grouping.last_backward_launch["cluster"] == k
    want = grouping.ball_query_stripes_backward_plain(idx, g_rel, g_grouped, n)
    torch.cuda.synchronize()
    assert torch.equal(g_xyz, want[0]) and torch.equal(g_center, want[1])
    assert torch.equal(g_xyz[:, hot], g_rel.sum(dim=(1, 2)))
    others = torch.ones(n, dtype=torch.bool, device=card)
    others[hot] = False
    assert bool((g_xyz[:, others] == 0).all())
    if nf:
        assert torch.equal(g_feats, want[2])
        assert bool((g_feats[:, others] == 0).all())
    else:
        assert g_feats is None


def test_ball_query_gradients_match_the_plain_autograd(card):
    """The card's Function against autograd through the plain forward, on
    balls that are not empty (where the two rules agree), and
    ``torch.autograd.gradcheck`` of the plain forward in f64 on the CPU
    (the distances are taken in f32, the rel and the gathered features in
    f64, so its finite differences hold)."""
    rng = np.random.RandomState(3)
    xyz, ctr, feats = _bq_case(rng, 2, 600, 48, 2, card)
    ctr = ctr[:, 4:].contiguous()  # no empty balls
    inputs = [t.clone().requires_grad_() for t in (xyz, ctr, feats)]
    _, rel, grouped = grouping.ball_query_stripes(0.3, 16, *inputs)
    cot = [torch.randn_like(rel), torch.randn_like(grouped)]
    got = torch.autograd.grad([rel, grouped], inputs, cot)
    plain = [t.clone().requires_grad_() for t in (xyz, ctr, feats)]
    _, prel, pgrouped = grouping.ball_query_stripes_plain(0.3, 16, *plain)
    want = torch.autograd.grad([prel, pgrouped], plain, cot)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * float(w.abs().max()))

    small = [t[:1, :].cpu().double() for t in (xyz[:, :200], ctr[:, :12], feats[:, :200])]
    small = [t.contiguous().requires_grad_() for t in small]

    def fn(a, c, f):
        _, r, gf = grouping.ball_query_stripes_plain(0.3, 16, a, c, f)
        return r, gf

    assert torch.autograd.gradcheck(fn, small, eps=1e-6, atol=1e-6)


# (points, centres, nsample, radius): odd and even nsample (1 too), clouds
# shorter than a warp, of exactly one 1024-point tile, of one tile and one
# point, and of several tiles, centres that fill no block at any C (m of
# 8 C - 1 and 8 C + 1 for C = 8), radii that leave most balls short and ones
# that fill them (the early stop)
_EXACT_CASES = [(20, 5, 3, 0.5), (300, 100, 7, 0.35), (1025, 37, 16, 0.35), (5000, 64, 63, 0.3),
                (5000, 64, 32, 2.5), (40000, 100, 64, 0.2), (1024, 63, 16, 0.35),
                (1025, 65, 1, 0.35), (1024, 65, 3, 2.5), (2049, 2048, 32, 0.3)]
# the SMs of an H100 SXM, for which the batches below are chosen
_H100_SMS = 132


def _exact_batches(m: int, sms: int = _H100_SMS) -> list[int]:
    """The fewest clouds at which ``exact_plan`` gives ``m`` centres each
    centres a warp (8, 4, 2, 1) it gives them at some batch."""
    first = {}
    for b in range(1, 2 * sms + 1):
        first.setdefault(grouping.exact_plan(b, m, sms)["centres_per_warp"], b)
    return sorted(first.values())


_EXACT_RUNS = [(*case, b) for case in _EXACT_CASES for b in _exact_batches(case[1])]


def test_exact_runs_take_every_centres_a_warp(card):
    """On this card the runs below take the exact kernel at each C."""
    sms = grouping._sms(card)
    assert {grouping.exact_plan(b, m, sms)["centres_per_warp"]
            for _, m, _, _, b in _EXACT_RUNS} == set(grouping.CENTRES_PER_WARP)


@pytest.mark.parametrize("n,m,nsample,radius,b", _EXACT_RUNS)
def test_ball_query_exact_kernel_matches_plain(card, n, m, nsample, radius, b):
    """The planted cases: a point at exactly d2 == r2 (not in the ball), a
    centre on a point, duplicates, empty balls, centres past the first
    block's; each case at the batches that take each C the plan gives it.
    The launch is the plan's."""
    rng = np.random.RandomState(n + nsample)
    xyz = _cloud(rng, b, n)
    xyz[0, : n // 3] = xyz[0, n // 3: 2 * (n // 3)]  # duplicates
    xyz[:, 1] = [0.25 + radius, 0.0, 0.0]  # d2 == r2 from centre 0 (radius 0.5: exactly)
    xyz[:, 2] = [0.25, 0.0, 0.0]  # centre 0 sits on it
    ctr = xyz[:, rng.randint(0, n, m)].copy()
    ctr[:, 0] = [0.25, 0.0, 0.0]
    ctr[:, 3:5] += 100.0  # empty balls
    args = (radius, nsample, torch.from_numpy(xyz).to(card), torch.from_numpy(ctr).to(card))
    before = grouping.exact_launches
    idx = grouping.ball_query_exact(*args)
    assert grouping.exact_launches == before + 1
    plan = grouping.exact_plan(b, m, grouping._sms(card))
    assert grouping.last_exact_launch == dict(
        blocks=plan["blocks"], warps_per_block=plan["warps_per_block"],
        centres_per_warp=plan["centres_per_warp"], tile_points=grouping.EXACT_TILE,
        stages=grouping.EXACT_STAGES)
    want = grouping.ball_query_exact_plain(*args)
    torch.cuda.synchronize()
    assert idx.dtype == torch.int32 and torch.equal(idx, want)
    assert (idx[:, 3:5] == 0).all()
    assert (idx[:, 0] == 2).any()


@pytest.mark.parametrize("b", _exact_batches(300))
def test_ball_query_exact_dense_cloud_stops_early(card, b):
    """A cloud in a 0.2 m cube with no empty ball: every centre finds its
    nsample qualifiers in the first tile, so every warp and block stops
    early; bitwise the plain version's, at the batches that take each C."""
    rng = np.random.RandomState(b)
    xyz = _cloud(rng, b, 5000, scale=0.2)
    ctr = xyz[:, rng.permutation(5000)[:300]].copy()
    args = (0.3, 32, torch.from_numpy(xyz).to(card), torch.from_numpy(ctr).to(card))
    idx = grouping.ball_query_exact(*args)
    want = grouping.ball_query_exact_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(idx, want)
    assert int(idx.max()) < 1024  # every slot from the first tile


def test_exact_sa_module_gradients_match_the_cpu(card, monkeypatch):
    """An SA module under ``FORCE_MODE = "exact"`` (the exact kernel on the
    card, its plain version on the CPU, the gather in the graph), f64
    parameters and features, BatchNorm in train mode: the output and the
    gradients of the features, the points and every parameter within 1e-6
    relative L2 of the CPU's (the two devices sum products in another
    order); the stripe kernels launch nothing."""
    from bridgeqa_tpu_torch.models.layers import init_weights
    from bridgeqa_tpu_torch.models.pointnet2 import PointnetSAModuleVotes

    monkeypatch.setattr(grouping, "FORCE_MODE", "exact")
    rng = np.random.RandomState(6)
    xyz = torch.from_numpy(_cloud(rng, 2, 3000)).double()
    feats = torch.from_numpy(rng.randn(2, 3000, 6)).double()
    cpu = PointnetSAModuleVotes(6, [16, 32], 256, 0.3, 16).double()
    init_weights(cpu, torch.Generator().manual_seed(0))
    on_card = copy.deepcopy(cpu).to(card)
    results = []
    for module, dev in ((cpu, "cpu"), (on_card, card)):
        module.train()
        x = xyz.to(dev).detach().requires_grad_()
        f = feats.to(dev).detach().requires_grad_()
        before = grouping.exact_launches, grouping.launches
        _, out, _ = module(x, f)
        out.square().sum().backward()
        launched = (grouping.exact_launches - before[0], grouping.launches - before[1])
        assert launched == ((1, 0) if dev == card else (0, 0)), launched
        grads = [x.grad, f.grad] + [p.grad for p in module.parameters()]
        results.append([out.detach().cpu()] + [g.detach().cpu() for g in grads])
    for got, want in zip(results[1], results[0]):
        assert float((got - want).norm() / want.norm()) < 1e-6


def test_train_step_on_the_card_matches_the_cpu(card):
    """A tiny train step (dropout 0, BatchNorm in train mode) with FPS, the
    ball query and its backward on the card: the losses within 1e-4 relative
    and every gradient within 1e-3 relative L2 of the CPU's, but those 0 by
    construction (``ZERO_GRADIENT``), which must stay within 1e-5 of the
    largest gradient. The model runs in f64 (the point kernels in f32 on
    both sides): in f32 the detector's BatchNorm gradients carry more than
    1e-3 of rounding against f64 on either device, so f32 against f32
    cannot hold 1e-3 (``chip_smoke.py::phase_train_reference`` prints how
    much)."""
    import copy

    from bridgeqa_tpu_torch.models import blip_vqa3d, bridgeqa, med
    from bridgeqa_tpu_torch.models.layers import init_weights
    from bridgeqa_tpu_torch.train.optim import build_optimizer
    from bridgeqa_tpu_torch.train.step import train_step

    m = med.MedConfig(vocab_size=120, hidden_size=128, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=256, max_position_embeddings=64,
                      encoder_width=128, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    blip = blip_vqa3d.BlipVQA3DConfig(med=m, image_size=32, num_answers=30, scene_size=32,
                                      bos_token_id=110, vit="custom", vit_custom_embed_dim=128,
                                      vit_custom_depth=1, vit_custom_heads=2,
                                      vit_drop_path_rate=0.0, adapter_pdrop=0.0)
    cfg = bridgeqa.BridgeQAConfig(num_answers=30, num_proposal=32, hidden_size=32, blip=blip,
                                  mcan_num_layers=1, input_feature_dim=1, head_pdrop=0.0,
                                  mcan_pdrop=0.0, backbone_sa_npoints=(512, 256, 128, 64))
    cpu = init_weights(bridgeqa.BridgeQA(cfg, device="cpu"),
                       torch.Generator().manual_seed(0)).double()
    gpu = copy.deepcopy(cpu).to(card)
    rng = np.random.RandomState(4)
    b, n = 2, 2048
    pc = ((rng.rand(b, n, 3) - 0.5) * 6.0).astype(np.float32)
    answers = rng.randint(1, 100, (b, 5))
    answers[:, 0] = 110
    batch = dict(
        point_clouds=np.concatenate([pc, pc[..., 2:] + 3.0], -1),
        images=rng.rand(b, 32, 32, 3).astype(np.float32),
        question_ids=rng.randint(1, 100, (b, 12)), question_mask=np.ones((b, 12), np.int32),
        answer_ids=answers, answer_mask=np.ones((b, 5), np.int32),
        vote_label=(rng.randn(b, n, 9) * 0.1).astype(np.float32),
        vote_label_mask=rng.randint(0, 2, (b, n)).astype(np.float32),
        center_label=(rng.randn(b, 4, 3)).astype(np.float32),
        box_label_mask=np.ones((b, 4), np.float32),
        sem_cls_label=rng.randint(0, 18, (b, 4)), size_class_label=rng.randint(0, 18, (b, 4)),
        size_residual_label=(rng.randn(b, 4, 3) * 0.1).astype(np.float32),
        heading_class_label=np.zeros((b, 4), np.int64),
        heading_residual_label=np.zeros((b, 4), np.float32),
        ref_center_label=rng.randn(b, 3).astype(np.float32),
        ref_heading_class_label=np.zeros((b,), np.int64),
        ref_heading_residual_label=np.zeros((b,), np.float32),
        ref_size_class_label=rng.randint(0, 18, (b,)),
        ref_size_residual_label=(rng.randn(b, 3) * 0.1).astype(np.float32),
        ref_obj_mask=np.ones((b,), np.float32), object_cat=rng.randint(0, 18, (b,)))
    batch = {k: torch.from_numpy(v).double() if v.dtype.kind == "f" else torch.from_numpy(v)
             for k, v in batch.items()}
    before = (sampling.launches, grouping.launches, grouping.backward_launches)
    want = train_step(cpu, build_optimizer(cpu), batch)
    got = train_step(gpu, build_optimizer(gpu), {k: v.to(card) for k, v in batch.items()})
    after = (sampling.launches, grouping.launches, grouping.backward_launches)
    assert [a - b0 for a, b0 in zip(after, before)] == [5, 5, 1]
    for key in ("loss", "vote_loss", "objectness_loss", "box_loss", "answer_loss"):
        assert abs(float(got[key]) - float(want[key])) <= 1e-4 * abs(float(want[key])), key
    grads = {name: p.grad for name, p in cpu.named_parameters()}
    largest = max(float(g.norm()) for g in grads.values())
    for name, p in gpu.named_parameters():
        w, g = grads[name], p.grad.cpu()
        if name.endswith(ZERO_GRADIENT):  # rounding noise on both devices
            assert max(float(w.norm()), float(g.norm())) <= 1e-5 * largest, name
        else:
            assert float((g - w).norm() / w.norm()) <= 1e-3, name


def test_feed_pinned_copy_is_the_host_batch(card):
    """The feed's batches reach the card through pinned memory, bit for bit,
    host fields kept, with no host sync in the copies (sync debug mode
    "error" around the iteration)."""
    from bridgeqa_tpu_torch.data import device_feed

    rng = np.random.RandomState(0)
    batches = [{"point_clouds": rng.rand(4, 40000, 4).astype(np.float32),
                "question_ids": rng.randint(0, 30000, (4, 80)).astype(np.int32),
                "answers": [f"a{i}" for i in range(4)]} for _ in range(3)]
    host = device_feed.host_tensors(batches[0], pin=True)
    assert host["point_clouds"].is_pinned() and host["question_ids"].is_pinned()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = list(device_feed.device_batches(batches, card))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert len(got) == 3
    for g, w in zip(got, batches):
        assert g["answers"] == w["answers"]
        for k in ("point_clouds", "question_ids"):
            assert g[k].device == card and g[k].dtype == torch.from_numpy(w[k]).dtype
            np.testing.assert_array_equal(g[k].cpu().numpy(), w[k])
