"""The port's transformer modules and its whole rank slice against the JAX
package, same weights (``bridgeqa_tpu_torch.convert.load_jax_variables``),
same numpy inputs, everything in f32 on the CPU.

Float outputs agree to atol 1e-4: both sides compute in f32, but matrix
products, LayerNorm statistics and softmax sums are taken in another order.
Index-like outputs (which answers were scored) must be exact.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridgeqa_tpu.data.scannet_config import ScannetDatasetConfig
from bridgeqa_tpu.models import blip_vqa3d as jblip
from bridgeqa_tpu.models import bridgeqa as jbridgeqa
from bridgeqa_tpu.models import med as jmed
from bridgeqa_tpu.models import vit as jvit
from bridgeqa_tpu.ops import grouping as jgrouping
from bridgeqa_tpu_torch.convert import load_jax_variables
from bridgeqa_tpu_torch.models import blip_vqa3d, bridgeqa, med, vit
from tests.synthetic import make_batch

ATOL = 1e-4
TINY_MED = jmed.MedConfig(vocab_size=120, hidden_size=64, num_hidden_layers=2,
                          num_attention_heads=4, intermediate_size=128,
                          max_position_embeddings=64, encoder_width=64, fused_scoring="off")
TINY_BLIP = jblip.BlipVQA3DConfig(med=TINY_MED, image_size=32, num_answers=30, scene_size=32,
                                  bos_token_id=110, vit="custom", vit_custom_embed_dim=64,
                                  vit_custom_depth=2, vit_custom_heads=4, vit_drop_path_rate=0.0)


def _port_cfg(cls, jcfg, **nested):
    """The port's config with the JAX config's values (the field names must
    match one to one)."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    assert set(kw) == {f.name for f in dataclasses.fields(cls)}, cls
    kw.update(nested)
    return cls(**kw)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, what):
    got = got.detach().float().numpy()
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=ATOL, rtol=0, err_msg=what)


def test_vit_matches_jax():
    rng = np.random.RandomState(0)
    img = rng.rand(2, 32, 32, 3).astype(np.float32)
    jmodel = jvit.VisionTransformer(img_size=32, embed_dim=64, depth=2, num_heads=4)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(img))
    want = jmodel.apply(variables, jnp.asarray(img))
    model = load_jax_variables(vit.VisionTransformer(32, 16, 64, 2, 4), variables)
    with torch.no_grad():
        _close(model(_t(img)), want, "vit")


def test_twin_encoder_matches_jax():
    rng = np.random.RandomState(1)
    ids = rng.randint(1, 100, (2, 9))
    mask = np.ones((2, 9), np.int32)
    mask[1, 6:] = 0
    img = rng.randn(2, 5, 64).astype(np.float32)
    img_mask = np.ones((2, 5), np.int32)
    scene = rng.randn(2, 7, 64).astype(np.float32)
    scene_mask = (rng.rand(2, 7) > 0.3).astype(np.int32)
    args = (ids, mask, img, img_mask, scene, scene_mask)
    jmodel = jmed.BertModelTwin(TINY_MED)
    variables = jmodel.init(jax.random.PRNGKey(1), *map(jnp.asarray, args), deterministic=True)
    (w2d, w3d), _ = jmodel.apply(variables, *map(jnp.asarray, args), deterministic=True)
    model = load_jax_variables(med.BertModelTwin(_port_cfg(med.MedConfig, TINY_MED)), variables)
    with torch.no_grad():
        h2d, h3d = model(*map(_t, args))
    _close(h2d, w2d, "hidden_2d")
    _close(h3d, w3d, "hidden_3d")


@pytest.mark.parametrize("chunk", [None, 3])
def test_lm_decoder_matches_jax(chunk):
    """Grouped cross-attention (4 answers per question) and the
    label-smoothed loss, unchunked and in chunks smaller than the batch."""
    rng = np.random.RandomState(2)
    b, g, la = 2, 4, 5
    ids = rng.randint(1, 100, (b * g, la))
    ids[:, 0] = 110
    atts = np.ones_like(ids)
    ids[1, 3:] = 0  # padding -> ignored labels
    atts[1, 3:] = 0
    labels = np.where(ids == 0, -100, ids)
    q = rng.randn(b, 7, 64).astype(np.float32)
    qmask = np.ones((b, 7), np.int32)
    qmask[0, 5:] = 0
    jmodel = jmed.BertLMHeadModel(TINY_MED)
    jargs = tuple(map(jnp.asarray, (ids, atts, q, qmask)))
    variables = jmodel.init(jax.random.PRNGKey(2), *jargs, labels=jnp.asarray(labels),
                            deterministic=True)
    wlogits, wloss = jmodel.apply(variables, *jargs, labels=jnp.asarray(labels),
                                  deterministic=True, loss_chunk_size=chunk)
    model = load_jax_variables(med.BertLMHeadModel(_port_cfg(med.MedConfig, TINY_MED)), variables)
    with torch.no_grad():
        logits, loss = model(*map(_t, (ids, atts, q, qmask)), labels=_t(labels),
                             loss_chunk_size=chunk)
    _close(loss, wloss, "loss")
    if chunk is None:
        _close(logits, wlogits, "logits")
    else:
        assert logits is None and wlogits is None


def test_top_k_stable_matches_lax_top_k():
    x = np.array([[0.5, 0.2, 0.5, 0.5, 0.1, 0.2]], np.float32)
    want = np.asarray(jax.lax.top_k(jnp.asarray(x), 4)[1])
    np.testing.assert_array_equal(blip_vqa3d.top_k_stable(_t(x), 4).numpy(), want)


def _qa_batch(rng, b=2, num_points=2048, lq=12, la=5, a_all=30):
    pc = make_batch(rng, batch_size=b, num_points=num_points)["point_clouds"]
    height = pc[..., 2:3] - pc[..., 2:3].min(axis=1, keepdims=True)
    answer_list_ids = rng.randint(1, 100, (a_all, la))
    answer_list_ids[:, 0] = 110
    return dict(
        point_clouds=np.concatenate([pc, height], axis=-1).astype(np.float32),
        images=rng.rand(b, 32, 32, 3).astype(np.float32),
        question_ids=rng.randint(1, 100, (b, lq)),
        question_mask=np.ones((b, lq), np.int32),
        answer_list_ids=answer_list_ids,
        answer_list_mask=np.ones((a_all, la), np.int32),
    )


@pytest.fixture(scope="module")
def slice_outputs():
    """The whole rank slice at the tiny config of ``tests/test_bridgeqa.py``
    with a height channel; JAX on its chip's stripe ball query."""
    jcfg = jbridgeqa.BridgeQAConfig(num_answers=30, num_proposal=32, hidden_size=32,
                                    blip=TINY_BLIP, mcan_num_layers=1, mcan_flat_out_size=64,
                                    mcan_flat_mlp_size=32, input_feature_dim=1)
    mean_size = ScannetDatasetConfig().mean_size_arr
    batch = _qa_batch(np.random.RandomState(7))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = jbridgeqa.BridgeQA(jcfg, mean_size_arr=mean_size)
    kw = dict(train=False, inference="rank", k_test=8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgrouping, "FORCE_MODE", "stripes")  # read while tracing
        # one jit each: init op by op takes ~3x longer on the CPU
        variables = jax.jit(functools.partial(jmodel.init, **kw))(jax.random.PRNGKey(0), jbatch)
        jout = jax.jit(functools.partial(jmodel.apply, **kw))(variables, jbatch)
    tcfg = _port_cfg(bridgeqa.BridgeQAConfig, jcfg,
                     blip=_port_cfg(blip_vqa3d.BlipVQA3DConfig, TINY_BLIP,
                                    med=_port_cfg(med.MedConfig, TINY_MED)))
    model = load_jax_variables(bridgeqa.BridgeQA(tcfg, mean_size, device="cpu"), variables)
    with torch.no_grad():
        out = model({k: _t(v) for k, v in batch.items()}, inference="rank", k_test=8)
    return out, {k: np.asarray(v) for k, v in jout.items()}


def test_slice_scores_the_same_answers(slice_outputs):
    out, jout = slice_outputs
    for key in ("answer_scores_2d", "answer_scores_scene"):
        scored = jout[key] != -1e4
        assert scored.sum(axis=1).tolist() == [8, 8], key
        np.testing.assert_array_equal(out[key].numpy() != -1e4, scored, err_msg=key)
        np.testing.assert_allclose(out[key].numpy()[scored], jout[key][scored], atol=ATOL, rtol=0,
                                   err_msg=key)
    # exp of the scores: relative error of the log-prob error (1e-4)
    np.testing.assert_allclose(out["answer_scores"].numpy(), jout["answer_scores"], rtol=1e-3,
                               atol=0)


def test_slice_heads_match(slice_outputs):
    out, jout = slice_outputs
    assert out["answer_scores"].shape == (2, 30) and out["cluster_ref"].shape == (2, 32)
    for key in ("lang_scores", "cluster_ref"):
        _close(out[key], jout[key], key)
    for key in ("bbox_mask", "aggregated_vote_inds", "sa1_inds"):
        np.testing.assert_array_equal(out[key].numpy(), jout[key], err_msg=key)
