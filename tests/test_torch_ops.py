"""The port's point ops (``bridgeqa_tpu_torch.ops``) against the JAX package.

On the CPU each op runs its plain PyTorch version, which is what the CUDA
kernels are held to bitwise on the card (``chip_smoke.py``). Here the plain
versions are held to the JAX functions on the same numpy inputs:

- FPS against the Pallas kernel in interpret mode and against
  ``_fps_single``: indices and coordinates exact (the same f32 operations in
  the same order, so any difference is a semantic one);
- the stripe ball query against ``_ball_query_stripes_impl`` in interpret
  mode and ``_ball_query_stripes_xla``: indices, rel and feature values
  exact, for the same reason;
- ``three_nn`` / ``three_interpolate`` at atol 1e-6 (f32; the sums may round
  in another order).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridgeqa_tpu.ops import grouping as jgrouping
from bridgeqa_tpu.ops import interpolate as jinterp
from bridgeqa_tpu.ops import sampling as jsampling
from bridgeqa_tpu_torch.ops import grouping, interpolate, sampling


def csrc_constants(name: str) -> dict:
    """The ``constexpr int`` constants of ``bridgeqa_tpu_torch/csrc/<name>``,
    evaluated in order (a constant may use the ones before it)."""
    text = (Path(grouping.__file__).resolve().parents[1] / "csrc" / name).read_text()
    consts = {}
    for key, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", text, flags=re.M):
        consts[key] = eval(expr, {}, dict(consts))
    return consts


def _cloud(rng, b, n, scale=2.0):
    return ((rng.rand(b, n, 3) - 0.5) * scale).astype(np.float32)


def _fps_cloud(rng, b=4, n=300):
    """Clouds with padding points, exact duplicates (ties), NaNs and one
    all-padding cloud."""
    xyz = _cloud(rng, b, n)
    xyz[0, 250:] = 0.0  # trailing padding
    xyz[1, 10:40] = xyz[1, 40:70]  # duplicated points tie in the argmax
    xyz[1, 5] = [np.nan, 0.3, 0.1]  # NaN point: padding, scrubbed
    xyz[2, ::7] = 0.0  # scattered padding
    xyz[3] = 0.0  # all padding
    xyz[3, 3] = [1e-3, 1e-3, 1e-3]  # |p|^2 = 3e-6 <= 1e-3: still padding
    return xyz


class TestFPS:
    @pytest.mark.parametrize("npoint", [1, 64])
    def test_matches_pallas_kernel(self, npoint):
        xyz = _fps_cloud(np.random.RandomState(0))
        idx, coords = sampling.furthest_point_sample_with_xyz(torch.from_numpy(xyz), npoint)
        jidx, jcoords = jsampling._fps_pallas_impl(jnp.asarray(xyz), npoint, interpret=True)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(coords.numpy(), np.asarray(jcoords))
        assert idx.dtype == torch.int32 and (idx[3] == 0).all()

    def test_matches_fps_single(self):
        import jax

        xyz = _fps_cloud(np.random.RandomState(1))
        idx, coords = sampling.furthest_point_sample_with_xyz(torch.from_numpy(xyz), 48)
        jidx = np.asarray(jax.vmap(lambda p: jsampling._fps_single(p, 48))(jnp.asarray(xyz)))
        np.testing.assert_array_equal(idx.numpy(), jidx)
        # _fps_single returns unscrubbed coordinates; no NaN point is picked
        want = np.take_along_axis(xyz, jidx[..., None].astype(np.int64), axis=1)
        np.testing.assert_array_equal(coords.numpy(), want)

    def test_gather_points(self):
        rng = np.random.RandomState(2)
        pts = rng.randn(2, 50, 5).astype(np.float32)
        idx = rng.randint(0, 50, (2, 7)).astype(np.int32)
        got = sampling.gather_points(torch.from_numpy(pts), torch.from_numpy(idx))
        np.testing.assert_array_equal(got.numpy(), np.take_along_axis(pts, idx[..., None], 1))


class TestStripeBallQuery:
    @pytest.mark.parametrize("n,nsample,picks,nf", [
        (1024, 8, 1, 0),   # one pick per stripe, no padding
        (1024, 8, 1, 4),   # ... with four feature channels
        (900, 8, 1, 1),    # one pick, N padded to 1024
        (600, 16, 2, 1),   # first and last, N padded to 1024
        (512, 16, 2, 0),   # SA4-like: 512 padded to 1024
        (300, 16, 2, 4),
    ])
    def test_matches_pallas_kernel_and_xla(self, n, nsample, picks, nf):
        rng = np.random.RandomState(n + nsample + nf)
        assert grouping.stripe_plan(n, nsample)[0] == picks
        xyz = _cloud(rng, 3, n)
        xyz[0, : n // 3] = xyz[0, n // 3: 2 * (n // 3)]  # duplicates
        ctr = _cloud(rng, 3, 40)
        ctr[:, :4] += 10.0  # empty balls
        feats = rng.randn(3, n, nf).astype(np.float32) if nf else None
        radius = 0.35

        idx, rel, fout = grouping.ball_query_stripes(
            radius, nsample, torch.from_numpy(xyz), torch.from_numpy(ctr),
            None if feats is None else torch.from_numpy(feats))
        jargs = (radius, nsample, jnp.asarray(xyz), jnp.asarray(ctr))
        jfeats = None if feats is None else jnp.asarray(feats)
        for out in (jgrouping._ball_query_stripes_impl(*jargs, jfeats, interpret=True),
                    jgrouping._ball_query_stripes_xla(*jargs, jfeats)):
            np.testing.assert_array_equal(idx.numpy(), np.asarray(out[0]))
            np.testing.assert_array_equal(rel.numpy(), np.stack(out[1], -1))
            if nf:
                np.testing.assert_array_equal(fout.numpy(), np.stack(out[2], -1))
            else:
                assert fout is None
        i = idx.numpy()
        assert (i[:, :4] == 0).all() and (rel.numpy()[:, :4] == 0).all()  # empty balls
        if nf:  # empty balls carry point 0's features
            np.testing.assert_array_equal(fout.numpy()[:, :4],
                                          np.broadcast_to(feats[:, None, None, 0], (3, 4, nsample, nf)))
        assert (i > 0).any() and (i < n).all()

    def test_query_and_group_and_group_all(self, monkeypatch):
        rng = np.random.RandomState(5)
        xyz = _cloud(rng, 2, 256)
        ctr = _cloud(rng, 2, 16)
        feats = rng.randn(2, 256, 6).astype(np.float32)
        monkeypatch.setattr(jgrouping, "FORCE_MODE", "stripes")
        want = jgrouping.query_and_group(0.4, 8, jnp.asarray(xyz), jnp.asarray(ctr),
                                         jnp.asarray(feats), normalize_xyz=True)
        got = grouping.query_and_group(0.4, 8, torch.from_numpy(xyz), torch.from_numpy(ctr),
                                       torch.from_numpy(feats), normalize_xyz=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        got_all = grouping.group_all(torch.from_numpy(xyz), torch.from_numpy(feats))
        np.testing.assert_array_equal(got_all.numpy(),
                                      np.asarray(jgrouping.group_all(jnp.asarray(xyz), jnp.asarray(feats))))


def test_ball_query_kernel_smem():
    """A block of the staged kernel keeps two pieces of a stripe (x, y, z)
    and the slots of each of its warps' centres, at most 8 a warp, within
    the 48 KB a static shared-memory allocation may take."""
    consts = csrc_constants("ball_query_stripes.cu")
    assert (2 * consts["kChunk"] * 3 * 4 + consts["kWarps"] * max(grouping.CENTRES_PER_WARP)
            * consts["kMaxSlots"] * 4) <= 48 * 1024


@pytest.mark.parametrize("c", [0, 3, 16])
def test_ball_query_refuses_bad_centres_per_warp(c):
    """The kernel takes 1, 2, 4 or 8 centres a warp; the wrapper refuses any
    other count before it looks at the device."""
    xyz = torch.zeros(1, 64, 3)
    with pytest.raises(ValueError, match="centres_per_warp"):
        grouping.ball_query_stripes(0.2, 4, xyz, xyz[:, :8], centres_per_warp=c)


def test_point_plans_match_the_kernels_constants():
    """The plan helpers' block geometry is the kernels' own."""
    exact = csrc_constants("ball_query_exact.cu")
    assert (exact["kWarps"], exact["kTile"], exact["kStages"]) == (
        grouping.EXACT_WARPS, grouping.EXACT_TILE, grouping.EXACT_STAGES)
    assert csrc_constants("ball_query_backward.cu")["kThreads"] == grouping.BACKWARD_THREADS


def _sms_for(b, m, c):
    """The SM count at which ``exact_plan`` gives ``b`` clouds of ``m``
    centres C = ``c`` where any count does: the most blocks C leaves (one
    more than C = 2 leaves, for C = 1)."""
    if c == 1:
        return b * -(-m // 16) + 1
    return b * -(-m // (8 * c))


@pytest.mark.parametrize("c", [1, 2, 4, 8])
@pytest.mark.parametrize("b", [1, 2, 3])
def test_exact_plan_covers_every_centre_once(b, c):
    """Each block's warps take C consecutive centres each, 8 C a block; over
    the plan's blocks every centre of every cloud is taken exactly once, for
    m of 1, 7, 8 C - 1, 8 C + 1 and 2048, on a card whose SM count makes the
    plan pick C (or, where no count does, as few centres a block as the
    plan gives m)."""
    for m in sorted({1, 7, 8 * c - 1, 8 * c + 1, 2048}):
        plan = grouping.exact_plan(b, m, _sms_for(b, m, c))
        cw, groups = plan["centres_per_warp"], plan["groups"]
        # C is unreachable only where a larger C takes as many blocks
        assert cw == c or (cw > c and groups == -(-m // (8 * c)))
        assert plan["blocks"] == b * groups and groups * 8 * cw - m < 8 * cw
        taken = np.zeros((b, m), dtype=np.int64)
        for k in range(plan["blocks"]):
            for w in range(plan["warps_per_block"]):
                for i in range(cw):
                    centre = (k % groups) * 8 * cw + w * cw + i
                    if centre < m:
                        taken[k // groups, centre] += 1
        assert (taken == 1).all(), (m, plan)
    assert grouping.exact_plan(b, 2048, _sms_for(b, 2048, c))["centres_per_warp"] == c


def test_exact_plan_gives_every_sm_a_block():
    """C is the largest of 8, 4, 2 that still leaves a block for each of
    the card's 132 SMs, else 1: at the main path's shapes (batch 8) 8, 4, 2,
    1 and 1."""
    import chip_smoke as cs

    got = [grouping.exact_plan(cs.BATCH, m, 132)["centres_per_warp"]
           for _, _, m, _, _, _ in cs.BQ_SHAPES]
    assert got == [8, 4, 2, 1, 1]
    for _, _, m, _, _, _ in cs.EXACT_SHAPES:
        plan = grouping.exact_plan(cs.BATCH, m, 132)
        assert plan["blocks"] >= 132 or plan["centres_per_warp"] == 1


def _ranges(k, share, total):
    """How often each of ``total`` items falls in the blocks' ranges
    [r share, (r + 1) share) of r < k, cut at ``total``."""
    taken = np.zeros(total, dtype=np.int64)
    for r in range(k):
        taken[r * share:min((r + 1) * share, total)] += 1
    return taken


# (points, centres, nsample, the blocks a cloud the plan gives): each count
# twice, with clouds of one point to SA1's 40000 and fewer points than blocks
_BACKWARD_PLANS = [(1, 1, 16, 1), (40, 7, 8, 1), (1024, 128, 16, 2), (1025, 65, 32, 2),
                   (1024, 256, 16, 4), (17, 63, 64, 4), (40000, 2048, 64, 8),
                   (3, 2048, 16, 8)]


@pytest.mark.parametrize("n,m,nsample,k", _BACKWARD_PLANS)
def test_backward_plan_covers_every_point_and_centre_once(n, m, nsample, k):
    """The blocks of a cloud split its points and its centres: every point
    and every centre in exactly one block's range, at shapes that take each
    blocks a cloud the plan gives."""
    plan = grouping.backward_plan(2, n, m, nsample)
    kb = plan["blocks_per_cloud"]
    assert kb == k and plan["blocks"] == 2 * kb
    assert (_ranges(kb, plan["points_per_block"], n) == 1).all()
    assert (_ranges(kb, plan["centres_per_block"], m) == 1).all()


def test_point_plans_fit_the_card():
    """At every shape the main path, chip_smoke.py and the card tests give
    the two kernels: the exact kernel's two stages within the 48 KB of a
    static shared-memory allocation (so within the 227 KB a block may take);
    the backward's blocks a cloud (the cluster; it keeps no sums in shared
    memory) at most 8, a portable cluster."""
    import chip_smoke as cs
    from tests import test_torch_cuda as card

    exact = ([(cs.BATCH, m) for _, _, m, _, _, _ in cs.BQ_SHAPES + cs.EXACT_SHAPES]
             + [(b, m) for _, m, _, _, b in card._EXACT_RUNS]
             + [(b, 300) for b in card._exact_batches(300)])
    for b, m in exact:
        assert grouping.exact_plan(b, m, 132)["shared_bytes"] <= 48 * 1024 <= 227 * 1024
    backward = ([(cs.TRAIN_BATCH, n, m, ns) for _, n, m, ns, _, _, _ in cs.BQ_BACKWARD_SHAPES]
                + [(cs.BATCH, n, m, ns) for _, n, m, ns, _, _ in cs.BQ_SHAPES]
                + [(3, n, m, ns) for n, m, ns, _, _ in card._BACKWARD_CASES]
                + [(2, 3000, m, 16) for m in (64, 128, 256, 512)])
    for b, n, m, ns in backward:
        plan = grouping.backward_plan(b, n, m, ns)
        assert plan["threads"] == grouping.BACKWARD_THREADS
        assert plan["blocks_per_cloud"] in (1, 2, 4, 8)


def test_backward_plan_regime():
    """A lone block a cloud only where a cloud has fewer slots than a
    block's 1024 threads twice over; else the largest cluster of 8, 4, 2
    that leaves a block a slot a thread: the train step's vote aggregation
    (256 centres of 16 slots) takes clusters of 4, SA1 (2048 of 64) of 8, at
    any batch."""
    import chip_smoke as cs

    for _, n, m, ns, _, nf, _ in cs.BQ_BACKWARD_SHAPES + [("small", 40, 32, 8, 0, 2, 0)]:
        for b in (1, cs.BATCH, cs.TRAIN_BATCH, 200):
            kb = grouping.backward_plan(b, n, m, ns)["blocks_per_cloud"]
            assert (kb == 1) == (m * ns < 2 * grouping.BACKWARD_THREADS), (n, m, ns, kb)
            assert -(-m // kb) * ns >= grouping.BACKWARD_THREADS or kb == 1
            assert kb == 8 or -(-m // (2 * kb)) * ns < grouping.BACKWARD_THREADS
    assert grouping.backward_plan(16, 1024, 256, 16)["blocks_per_cloud"] == 4
    assert grouping.backward_plan(16, 40000, 2048, 64)["blocks_per_cloud"] == 8
    assert grouping.backward_plan(3, 40, 32, 8)["blocks_per_cloud"] == 1


def test_three_nn_and_interpolate():
    rng = np.random.RandomState(3)
    unknown = _cloud(rng, 2, 200)
    known = _cloud(rng, 2, 40)
    known[0, 5] = known[0, 6]  # a tie
    dist, idx = interpolate.three_nn(torch.from_numpy(unknown), torch.from_numpy(known))
    jdist, jidx = jinterp.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), atol=1e-6, rtol=0)

    feats = rng.randn(2, 40, 9).astype(np.float32)
    w = rng.rand(2, 200, 3).astype(np.float32)
    got = interpolate.three_interpolate(torch.from_numpy(feats), idx, torch.from_numpy(w))
    want = jinterp.three_interpolate(jnp.asarray(feats), jidx, jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_cuda_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on CUDA never silently runs
    the plain version."""
    xyz = torch.zeros(1, 8, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sampling.furthest_point_sample_with_xyz(xyz, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        grouping.ball_query_stripes(0.2, 4, xyz, xyz)
