"""The port's exact scan-order ball query and the code paths that take it,
against the JAX package on the CPU, same numpy inputs.

- ``ball_query_exact_plain`` (what ``csrc/ball_query_exact.cu`` is held to
  bitwise on the card) against ``_ball_query_exact``: indices exact, for odd
  and even ``nsample``, empty, short and full balls, duplicate points and
  clouds whose length is no multiple of 128 or 32;
- ``ball_query``'s mode rule against JAX's on its chip under every
  ``FORCE_MODE`` (JAX's stripe kernel through its bitwise XLA emulation);
- the exact branch of ``query_and_group`` within 1e-6 (the gather and the
  recentring are exact; the division by the radius rounds alike), and
  ``_resample_uniform``'s rule;
- an SA module with an odd ``nsample`` and the detector with both
  ``FORCE_MODE``s "exact": indices exact, floats within 1e-4 (f32 matrix
  products summed in another order), as ``tests/test_torch_detector.py``
  holds the stripe path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridgeqa_tpu.models import pointnet2 as jpointnet2
from bridgeqa_tpu.models.detector import VoteNetDetector as JaxDetector
from bridgeqa_tpu.ops import grouping as jgrouping
from bridgeqa_tpu_torch.convert import load_jax_variables
from bridgeqa_tpu_torch.models import pointnet2
from bridgeqa_tpu_torch.models.detector import VoteNetDetector
from bridgeqa_tpu_torch.ops import grouping
from bridgeqa_tpu_torch.utils import profiling
from tests.test_torch_detector import KW, _with_height
from tests.synthetic import make_batch


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _clouds(rng, b, n, m, scale=2.0):
    """Clouds with duplicates and padding points at the origin, and centres
    drawn from them with the first two moved far away (empty balls)."""
    xyz = ((rng.rand(b, n, 3) - 0.5) * scale).astype(np.float32)
    dup = max(1, n // 10)
    xyz[:, dup:2 * dup] = xyz[:, :dup]
    xyz[:, n - n // 20:] = 0.0
    ctr = xyz[:, rng.permutation(n)[:m]].copy()
    ctr[:, :2] += 50.0
    return xyz, ctr


# (batch, points, centres, nsample, radius): odd and even nsample; short
# balls (most hold fewer than nsample), full balls (early stop), N no
# multiple of 128 or of 32, nsample above N
CASES = [(2, 1000, 64, 7, 0.3), (2, 1000, 64, 16, 0.3), (3, 129, 17, 63, 0.9),
         (2, 300, 40, 5, 2.5), (1, 50, 9, 64, 0.5), (2, 2048, 256, 32, 0.2)]


@pytest.mark.parametrize("case", CASES, ids=[f"b{c[0]}-n{c[1]}-m{c[2]}-ns{c[3]}" for c in CASES])
def test_exact_plain_matches_jax_bitwise(case):
    b, n, m, ns, r = case
    xyz, ctr = _clouds(np.random.RandomState(n + ns), b, n, m)
    want = np.asarray(jgrouping._ball_query_exact(r, ns, jnp.asarray(xyz), jnp.asarray(ctr)))
    before = profiling.counts()["kernel/ball_query_exact"]
    got = grouping.ball_query_exact(r, ns, _t(xyz), _t(ctr))
    assert got.dtype == torch.int32 and got.shape == (b, m, ns)
    np.testing.assert_array_equal(got.numpy(), want)
    # the CPU runs the plain version
    assert profiling.counts()["kernel/ball_query_exact"] == before
    assert (want[:, :2] == 0).all()  # the empty balls


@pytest.fixture
def jax_on_its_chip(monkeypatch):
    """The JAX ``ball_query`` as it selects on its chip: the default backend
    reads "tpu", and its stripe kernel runs as ``_ball_query_stripes_xla``
    (bitwise equal to it, ``tests/test_ops.py``)."""
    calls = []

    def stripes(radius, nsample, xyz, new_xyz):
        calls.append(nsample)
        return jgrouping._ball_query_stripes_xla(radius, nsample, xyz, new_xyz)

    monkeypatch.setattr(jgrouping.jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jgrouping, "_ball_query_stripes", stripes)
    return calls


@pytest.mark.parametrize("mode", [None, "stripes", "exact"])
def test_ball_query_mode_rule_matches_jax(mode, monkeypatch, jax_on_its_chip):
    xyz, ctr = _clouds(np.random.RandomState(3), 2, 500, 32)
    monkeypatch.setattr(jgrouping, "FORCE_MODE", mode)
    monkeypatch.setattr(grouping, "FORCE_MODE", mode)
    for ns in (8, 9):
        for exact in (None, True, False):
            want = jgrouping.ball_query(0.4, ns, jnp.asarray(xyz), jnp.asarray(ctr), exact=exact)
            got = grouping.ball_query(0.4, ns, _t(xyz), _t(ctr), exact=exact)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"mode {mode}, nsample {ns}, exact {exact}")
    # the JAX side took the stripe rule for even nsample unless forced exact
    assert jax_on_its_chip == ([] if mode == "exact" else [8] * (3 if mode == "stripes" else 2))


@pytest.mark.parametrize("ns,mode", [(8, "exact"), (7, None)])
def test_query_and_group_exact_branch_matches_jax(ns, mode, monkeypatch, jax_on_its_chip):
    rng = np.random.RandomState(5)
    xyz, ctr = _clouds(rng, 2, 256, 16)
    feats = rng.randn(2, 256, 6).astype(np.float32)
    monkeypatch.setattr(jgrouping, "FORCE_MODE", mode)
    monkeypatch.setattr(grouping, "FORCE_MODE", mode)
    want, want_xyz = jgrouping.query_and_group(0.4, ns, jnp.asarray(xyz), jnp.asarray(ctr),
                                               jnp.asarray(feats), normalize_xyz=True,
                                               ret_grouped_xyz=True)
    got, got_xyz = grouping.query_and_group(0.4, ns, _t(xyz), _t(ctr), _t(feats),
                                            normalize_xyz=True, ret_grouped_xyz=True)
    assert not jax_on_its_chip  # the exact branch on both sides
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_xyz.numpy(), np.asarray(want_xyz), atol=1e-6, rtol=0)
    # an empty ball groups point 0, less the centre (not 0, as stripes do)
    np.testing.assert_allclose(got_xyz.numpy()[:, 0, 0], (xyz[:, 0] - ctr[:, 0]) / 0.4, atol=1e-6)


def test_resample_uniform_keeps_the_unique_points_first():
    """Each ball's unique indices, ascending, first (as JAX's); the other
    slots drawn from them, by the generator (the same generator state gives
    the same draws). ``query_and_group`` resamples what ``ball_query``
    gives (stripes at an even nsample)."""
    rng = np.random.RandomState(8)
    xyz, ctr = _clouds(rng, 2, 300, 24)
    idx = grouping.ball_query(0.3, 12, _t(xyz), _t(ctr))
    got = grouping._resample_uniform(idx, torch.Generator().manual_seed(1), 12)
    again = grouping._resample_uniform(idx, torch.Generator().manual_seed(1), 12)
    want = np.asarray(jgrouping._resample_uniform(jnp.asarray(idx.numpy()), jax.random.PRNGKey(0),
                                                  12))
    assert torch.equal(got, again)
    for ball, out, jout in zip(idx.reshape(-1, 12).numpy(), got.reshape(-1, 12).numpy(),
                               want.reshape(-1, 12)):
        uniq = np.unique(ball)
        k = len(uniq)
        np.testing.assert_array_equal(out[:k], uniq)
        np.testing.assert_array_equal(jout[:k], uniq)
        assert set(out[k:]) <= set(uniq)
    assert (got != idx).any()  # short balls were resampled
    with pytest.raises(ValueError, match="generator"):
        grouping.query_and_group(0.3, 12, _t(xyz), _t(ctr), sample_uniformly=True)
    grouped = grouping.query_and_group(0.3, 12, _t(xyz), _t(ctr), sample_uniformly=True,
                                       generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(
        grouped.numpy(), grouping.group_points(_t(xyz), got).numpy() - ctr[:, :, None])


def test_sa_module_with_odd_nsample_matches_jax(monkeypatch):
    """An odd nsample takes the exact query even where the stripe rule is
    the default, on both sides (JAX's ``ball_query`` sends it there on its
    chip too)."""
    monkeypatch.setattr(jgrouping, "FORCE_MODE", "stripes")
    rng = np.random.RandomState(4)
    xyz = rng.rand(2, 512, 3).astype(np.float32) * 2.0
    feats = rng.randn(2, 512, 5).astype(np.float32)
    jmodule = jpointnet2.PointnetSAModuleVotes(mlp=(16, 24), npoint=64, radius=0.3, nsample=7,
                                               normalize_xyz=True)
    args = (jnp.asarray(xyz), jnp.asarray(feats))
    variables = jmodule.init(jax.random.PRNGKey(0), *args, train=False)
    jxyz, jfeat, jinds = jmodule.apply(variables, *args, train=False)
    module = load_jax_variables(pointnet2.PointnetSAModuleVotes(5, [16, 24], 64, 0.3, 7),
                                variables).eval()
    kernels = ("kernel/ball_query_exact", "kernel/ball_query_stripes")
    before = [profiling.counts()[k] for k in kernels]
    with torch.no_grad():
        new_xyz, new_feat, inds = module(_t(xyz), _t(feats))
    assert [profiling.counts()[k] for k in kernels] == before
    np.testing.assert_array_equal(inds.numpy(), np.asarray(jinds))
    np.testing.assert_array_equal(new_xyz.numpy(), np.asarray(jxyz))
    np.testing.assert_allclose(new_feat.numpy(), np.asarray(jfeat), atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def exact_detector():
    pc = _with_height(make_batch(np.random.RandomState(11), batch_size=2, num_points=2048)
                      ["point_clouds"])
    jmodel = JaxDetector(**KW)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgrouping, "FORCE_MODE", "exact")
        mp.setattr(grouping, "FORCE_MODE", "exact")
        variables = jax.jit(lambda key, x: jmodel.init(key, x, train=False))(
            jax.random.PRNGKey(0), jnp.asarray(pc))
        jout = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, jnp.asarray(pc))
        model = load_jax_variables(VoteNetDetector(**KW), variables).eval()
        with torch.no_grad():
            out = model(_t(pc))
    return out, {k: np.asarray(v) for k, v in jout.items()}


def test_exact_detector_indices_match_jax(exact_detector):
    out, jout = exact_detector
    assert set(out) == set(jout)
    keys = [k for k, v in jout.items() if np.issubdtype(v.dtype, np.integer)]
    assert {"sa1_inds", "sa2_inds", "fp2_inds", "aggregated_vote_inds", "bbox_mask"} <= set(keys)
    for k in keys:
        np.testing.assert_array_equal(out[k].numpy(), jout[k], err_msg=k)


def test_exact_detector_floats_match_jax(exact_detector):
    out, jout = exact_detector
    for k, v in jout.items():
        if np.issubdtype(v.dtype, np.integer):
            continue
        got = out[k].float().numpy()
        assert np.isfinite(got).all(), k
        np.testing.assert_allclose(got, v, atol=1e-4, rtol=0, err_msg=k)


def test_exact_wrapper_refuses_other_devices():
    xyz = torch.zeros(1, 8, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        grouping.ball_query_exact(0.2, 3, xyz, xyz)
