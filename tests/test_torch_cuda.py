"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA card and ``nvcc`` and skip without them. On the card:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine does not have; this file imports none.) The kernels must agree
with the plain versions bitwise, on the edge cases ``chip_smoke.py`` does
not draw: NaN coordinates, an all-padding cloud, 4 feature channels, both
stripe plans, clouds shorter than one stripe quantum.
"""

import numpy as np
import pytest
import torch

from bridgeqa_tpu_torch.ops import grouping, sampling

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


def test_wrappers_refuse_bad_inputs(card):
    xyz = torch.zeros(2, 64, 3, device=card)
    with pytest.raises(ValueError):
        grouping.ball_query_stripes(0.2, 8, xyz, xyz, torch.zeros(2, 64, 5, device=card))
    with pytest.raises(ValueError):
        grouping.ball_query_stripes(0.2, 8, xyz, xyz.cpu())
    with pytest.raises(ValueError):
        sampling.furthest_point_sample_with_xyz(xyz[..., :2], 4)
