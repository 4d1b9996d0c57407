"""The port's ``VoteNetDetector`` against the JAX detector, same weights.

JAX runs with ``grouping.FORCE_MODE = "stripes"``: its SA modules then take
the stripe path its chip runs, through ``_ball_query_stripes_xla`` (bitwise
equal to the Pallas kernel, ``tests/test_ops.py``), with the height channel
gathered in the ball query's own sweep (``input_feature_dim=1``). The port
runs its plain point ops here.

Index outputs must be exact. Float outputs agree to atol 1e-4: both sides
compute in f32, but matrix products and the PlaneDense split sum in another
order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridgeqa_tpu.data.scannet_config import ScannetDatasetConfig
from bridgeqa_tpu.models.detector import VoteNetDetector as JaxDetector
from bridgeqa_tpu.ops import grouping as jgrouping
from bridgeqa_tpu_torch.convert import load_jax_variables
from bridgeqa_tpu_torch.models.detector import VoteNetDetector
from tests.synthetic import make_batch

DC = ScannetDatasetConfig()
KW = dict(num_class=DC.num_class, num_heading_bin=DC.num_heading_bin,
          num_size_cluster=DC.num_size_cluster, mean_size_arr=DC.mean_size_arr,
          input_feature_dim=1, num_proposal=32, sa_npoints=(512, 256, 128, 64),
          sa_nsamples=(16, 16, 8, 8))


def _with_height(pc):
    height = pc[..., 2:3] - pc[..., 2:3].min(axis=1, keepdims=True)
    return np.concatenate([pc, height], axis=-1).astype(np.float32)


@pytest.fixture(scope="module")
def outputs():
    pc = _with_height(make_batch(np.random.RandomState(11), batch_size=2, num_points=2048)
                      ["point_clouds"])
    jmodel = JaxDetector(**KW)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgrouping, "FORCE_MODE", "stripes")
        variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(pc), train=False)
        jout = jmodel.apply(variables, jnp.asarray(pc), train=False)
    model = load_jax_variables(VoteNetDetector(**KW), variables).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(pc))
    return out, {k: np.asarray(v) for k, v in jout.items()}


def test_same_keys(outputs):
    out, jout = outputs
    assert set(out) == set(jout)


def test_index_outputs_exact(outputs):
    out, jout = outputs
    keys = [k for k, v in jout.items() if np.issubdtype(v.dtype, np.integer)]
    assert {"sa1_inds", "sa2_inds", "fp2_inds", "aggregated_vote_inds", "bbox_mask"} <= set(keys)
    for k in keys:
        np.testing.assert_array_equal(out[k].numpy(), jout[k], err_msg=k)


def test_float_outputs_close(outputs):
    out, jout = outputs
    for k, v in jout.items():
        if np.issubdtype(v.dtype, np.integer):
            continue
        got = out[k].float().numpy()
        assert np.isfinite(got).all(), k
        np.testing.assert_allclose(got, v, atol=1e-4, rtol=0, err_msg=k)
