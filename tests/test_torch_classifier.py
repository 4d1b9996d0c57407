"""Classifier mode (``use_text_decoder=False``) and the twin encoder's
attention dumps (``output_attentions``) of the port against the JAX package,
at the tiny config of ``tests/test_torch_train.py``.

- Classifier mode in eval mode, with and without ``answer_cls_2d3d``, and
  in train mode (BatchNorm on the batch's statistics, dropout off): every
  head within 1e-5 in f32, same weights and numpy inputs.
- One training step of classifier mode in f64, dropout off: losses within
  1e-5 relative, gradients within 1e-4 relative L2 per tensor (as
  ``tests/test_torch_train.py`` holds the decoder path).
- The rank forward's dumps (``2d/3d_self/cross_attention``) within 1e-5 in
  f32, and the answer scores with dumps bitwise those without.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridgeqa_tpu.data.scannet_config import ScannetDatasetConfig
from bridgeqa_tpu.models import bridgeqa as jbridgeqa
from bridgeqa_tpu.ops import grouping as jgrouping
from bridgeqa_tpu_torch.convert import export_jax_variables
from bridgeqa_tpu_torch.data import scannet_config
from bridgeqa_tpu_torch.losses import get_loss
from bridgeqa_tpu_torch.train.optim import label_params
from tests.test_torch_train import (  # noqa: F401  (jax_x64 is a fixture)
    GRAD_RTOL,
    LOSS_RTOL,
    _leaves,
    _lookup,
    _np_tree,
    grad_tree,
    jax_loss_fn,
    jax_train_config,
    jax_x64,
    perturbed_model,
    port_config,
    rel_l2,
    train_batch,
)

ATOL = 1e-5
ATTENTION_KEYS = ("2d_self_attention", "3d_self_attention", "2d_cross_attention",
                  "3d_cross_attention")
SCORE_KEYS = ("answer_scores", "answer_scores_2d", "answer_scores_scene")


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _close(got, want, what, atol=ATOL):
    got = got.detach().double().numpy()
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, np.asarray(want, np.float64), atol=atol, rtol=0, err_msg=what)


def classifier_config(two_d3d: bool):
    """The tiny JAX config in classifier mode, the classifiers' dropout 0."""
    jcfg = jax_train_config(use_text_decoder=False)
    blip = dataclasses.replace(jcfg.blip, answer_pdrop=0.0, use_scene_classifier_2d3d=two_d3d)
    return dataclasses.replace(jcfg, blip=blip)


def classifier_batch(seed: int = 7) -> dict:
    batch = train_batch(seed)
    rng = np.random.RandomState(seed + 100)
    batch["answer_cat"] = rng.randint(0, 30, (batch["point_clouds"].shape[0],)).astype(np.int32)
    return batch


def _f32(batch):
    return {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in batch.items()}


def _jax_apply(jcfg, variables, batch, **kw):
    jmodel = jbridgeqa.BridgeQA(jcfg, mean_size_arr=ScannetDatasetConfig().mean_size_arr)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgrouping, "FORCE_MODE", "stripes")  # read while tracing
        return jax.jit(functools.partial(jmodel.apply, **kw))(
            variables, {k: jnp.asarray(v) for k, v in batch.items()})


@pytest.mark.parametrize("train,two_d3d", [(False, False), (False, True), (True, True)],
                         ids=["eval", "eval-2d3d", "train-2d3d"])
def test_classifier_mode_matches_jax(train, two_d3d):
    """The heads score the whole vocabulary, in train mode as in eval mode
    (JAX takes ``classify`` ahead of every inference mode)."""
    jcfg = classifier_config(two_d3d)
    model = perturbed_model(port_config(jcfg))
    variables = export_jax_variables(model)
    batch = _f32(classifier_batch())
    kw = dict(train=True, mutable=["batch_stats"]) if train else dict(train=False)
    jout = _jax_apply(jcfg, variables, batch, **kw)
    jout = jout[0] if train else jout
    model.train(train)
    with torch.no_grad():
        out = model({k: _t(v) for k, v in batch.items()}, inference="rank")
    assert set(out) == set(jout)
    assert out["answer_scores"].shape == (2, 30) and ("answer_scores_2d3d" in out) == two_d3d
    for key in SCORE_KEYS + ("answer_scores_2d3d", "lang_scores", "cluster_ref"):
        if key in jout:
            _close(out[key], jout[key], key)
    heads = [out[k] for k in ("answer_scores_2d", "answer_scores_scene", "answer_scores_2d3d")
             if k in out]
    torch.testing.assert_close(out["answer_scores"], sum(heads) / len(heads), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def classifier_train_pair(jax_x64):
    """One training forward, get_loss and backward of classifier mode (with
    ``answer_cls_2d3d``) on both sides in f64, dropout off."""
    jcfg = classifier_config(True)
    dc = ScannetDatasetConfig()
    model = perturbed_model(port_config(jcfg)).double()
    variables = export_jax_variables(model)
    batch = classifier_batch()
    jmodel = jbridgeqa.BridgeQA(jcfg, mean_size_arr=dc.mean_size_arr)
    (jloss, (jend, _)), jgrads = jax.jit(
        jax.value_and_grad(jax_loss_fn(jmodel, dc), has_aux=True))(
        variables["params"], variables["batch_stats"],
        {k: jnp.asarray(v) for k, v in batch.items()}, 0.1)
    model.train()
    out = model({k: _t(v) for k, v in batch.items()}, inference="loss", bn_momentum=0.1)
    end = {k: _t(v) for k, v in batch.items()}
    end.update(out)
    loss, end = get_loss(end, scannet_config.ScannetDatasetConfig(), use_lang_classifier=True)
    loss.backward()
    return types.SimpleNamespace(model=model, jloss=float(jloss), jend=_np_tree(jend),
                                 jgrads=_np_tree(jgrads), loss=loss, end=end)


def test_classifier_train_losses_match_jax(classifier_train_pair):
    p = classifier_train_pair
    np.testing.assert_allclose(float(p.loss.detach()), p.jloss, rtol=LOSS_RTOL)
    for key in ("answer_loss", "lang_loss", "ref_loss"):
        np.testing.assert_allclose(float(p.end[key].detach()), float(p.jend[key]),
                                   rtol=LOSS_RTOL, err_msg=key)
    assert "decoder_loss" not in p.end


def test_classifier_train_gradients_match_jax(classifier_train_pair):
    """Every parameter's gradient within 1e-4 relative L2 (zero on both
    sides counts as agreeing: the decoders, which classifier mode does not
    run, and the attention key biases); the classifiers route to the
    "other" optimizer group, as JAX's ``label_params`` routes them."""
    p = classifier_train_pair
    ours = grad_tree(p.model)
    failures, checked = [], 0
    for path, want in _leaves(p.jgrads):
        got = _lookup(ours, path)
        checked += 1
        if np.linalg.norm(want) < 1e-10 and np.linalg.norm(got) < 1e-10:
            continue
        rel = rel_l2(got, want)
        if rel > GRAD_RTOL:
            failures.append(f"{'/'.join(path)}: {rel:.2e}")
    assert checked == len(list(p.model.parameters()))
    assert not failures, failures[:20]
    assert np.linalg.norm(_lookup(ours, ("blip_model", "answer_cls_2d3d", "fc2", "kernel"))) > 0
    labels = label_params(p.model)
    assert {labels[n] for n in labels if ".answer_cls" in n} == {"other"}


def test_rank_dumps_match_jax():
    """The rank forward with ``output_attentions``: the four dumps of the
    twin encoder's last layer, unpadded, within 1e-5 of JAX's (each row a
    distribution; the cross ones over the image or the proposals, then the
    question); the answer scores bitwise those of the same forward without
    dumps."""
    jcfg = jax_train_config()
    model = perturbed_model(port_config(jcfg))
    variables = export_jax_variables(model)
    batch = _f32(train_batch())
    jout = _jax_apply(jcfg, variables, batch, train=False, inference="rank", k_test=8,
                      output_attentions=True)
    tbatch = {k: _t(v) for k, v in batch.items()}
    with torch.no_grad():
        out = model(tbatch, inference="rank", k_test=8, output_attentions=True)
        plain = model(tbatch, inference="rank", k_test=8)
    assert set(out) == set(jout) == set(plain) | set(ATTENTION_KEYS)
    lq = batch["question_ids"].shape[1]
    tokens = {"2d": (32 // 16) ** 2 + 1, "3d": jcfg.num_proposal}
    for key in ATTENTION_KEYS:
        stream, kind = key.split("_")[:2]
        width = lq if kind == "self" else tokens[stream] + lq
        assert out[key].shape == (2, 4, lq, width), key
        _close(out[key], jout[key], key)
        torch.testing.assert_close(out[key].sum(-1), torch.ones(2, 4, lq), rtol=0, atol=1e-5)
    for key in SCORE_KEYS + ("lang_scores", "cluster_ref"):
        assert torch.equal(out[key], plain[key]), key
