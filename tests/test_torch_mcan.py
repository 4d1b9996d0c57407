"""The port's MCAN (3D-only) model against the JAX package: its modules
(``models/mcan.py``: SA, AttFlat, MCAN_E, MCAN_ED; ``models/lang.py``:
LangModule, CLIPLangModule, BertLangEncoder), the whole ``BridgeQA`` with
``use_blip=False`` in eval mode, one training step's gradients, and the
weights carried both ways.

Modules and the eval forward run in f32 on both sides, same weights
(``load_jax_variables`` / ``export_jax_variables``) and numpy inputs: within
1e-5 (matrix products and LayerNorm statistics summed in another order;
the detector's point ops are bitwise, ``tests/test_torch_detector.py``).
The training step runs in f64 as ``tests/test_torch_train.py`` runs the
BLIP path's, dropout off: gradients within 1e-4 relative L2 per tensor.
"""

import dataclasses
import functools
import types

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridgeqa_tpu.data.scannet_config import ScannetDatasetConfig
from bridgeqa_tpu.models import bridgeqa as jbridgeqa
from bridgeqa_tpu.models import lang as jlang
from bridgeqa_tpu.models import mcan as jmcan
from bridgeqa_tpu.ops import grouping as jgrouping
from bridgeqa_tpu.train import optim as joptim
from bridgeqa_tpu_torch.convert import export_jax_variables, load_jax_variables
from bridgeqa_tpu_torch.data import scannet_config
from bridgeqa_tpu_torch.losses import get_loss
from bridgeqa_tpu_torch.models import bridgeqa, lang, mcan, med
from bridgeqa_tpu_torch.models.layers import dropout_rng, set_compute_dtype
from bridgeqa_tpu_torch.train.optim import label_params
from tests.test_torch_bridgeqa import TINY_MED, _port_cfg
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
LANG_LEN = 6


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _close(got, want, what, atol=ATOL):
    got = got.detach().double().numpy()
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, np.asarray(want, np.float64), atol=atol, rtol=0, err_msg=what)


def _masks(rng, b, n):
    """(B, 1, 1, N) True where masked; row 0 masks nothing."""
    mask = rng.rand(b, 1, 1, n) < 0.3
    mask[0] = False
    return mask


@pytest.mark.parametrize("which", ["SA", "MCAN_E", "MCAN_ED"])
def test_mcan_blocks_match_jax(which):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, 32).astype(np.float32)
    y = rng.randn(2, 9, 32).astype(np.float32)
    xm, ym = _masks(rng, 2, 7), _masks(rng, 2, 9)
    if which == "SA":
        jm, m, args = jmcan.SA(32, 4), mcan.SA(32, 4), (x, xm)
    elif which == "MCAN_E":
        jm, m, args = jmcan.MCAN_E(32, 4, 2), mcan.MCAN_E(32, 4, 2), (x, xm)
    else:
        jm, m, args = jmcan.MCAN_ED(32, 4, 2), mcan.MCAN_ED(32, 4, 2), (x, y, xm, ym)
    jargs = tuple(map(jnp.asarray, args))
    variables = jm.init(jax.random.PRNGKey(0), *jargs, deterministic=True)
    want = jm.apply(variables, *jargs, deterministic=True)
    load_jax_variables(m, variables).eval()
    with torch.no_grad():
        got = m(*map(_t, args))
    for g, w in zip(*((got, want) if which == "MCAN_ED" else ((got,), (want,)))):
        _close(g, w, which)


@pytest.mark.parametrize("att_pdrop", [0.0, 0.4])
def test_attflat_matches_jax(att_pdrop, monkeypatch):
    """Eval pooling with the padding mask; in train mode with ``att_pdrop``
    the top-k attention drop over the same column draws on both sides: the
    port draws them from the generator, and JAX's ``jax.random.uniform`` is
    handed the same numbers. The glimpses' MLP has no dropout here."""
    rng = np.random.RandomState(2)
    n, topk = 12, 5
    x = rng.randn(3, n, 32).astype(np.float32)
    xm = _masks(rng, 3, n)
    jm = jmcan.AttFlat(32, 16, 2, 24, pdrop=0.0)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(xm),
                        deterministic=True)
    m = load_jax_variables(mcan.AttFlat(32, 16, 2, 24, pdrop=0.0), variables)
    draws = torch.rand((n,), generator=torch.Generator().manual_seed(4))
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape: jnp.asarray(draws.numpy()))
    train = att_pdrop > 0
    want = jm.apply(variables, jnp.asarray(x), jnp.asarray(xm), deterministic=not train,
                    att_pdrop=att_pdrop, att_drop_topk=topk, rngs={"dropout": jax.random.PRNGKey(2)})
    m.train(train)
    with torch.no_grad(), dropout_rng(torch.Generator().manual_seed(4)):
        got = m(_t(x), _t(xm), att_pdrop=att_pdrop, att_drop_topk=topk)
        plain = m(_t(x), _t(xm))
    _close(got, want, "attflat")
    if train:  # the drop changed the pooling
        assert float((got - plain).abs().max()) > 1e-3


@pytest.mark.parametrize("bidir", [False, True])
def test_lang_module_matches_jax(bidir):
    """Every length from 1 to L, forward and bidirectional (the backward
    direction runs each row reversed within its length)."""
    rng = np.random.RandomState(3)
    feat = rng.randn(LANG_LEN, LANG_LEN, 10).astype(np.float32)
    lens = np.arange(1, LANG_LEN + 1, dtype=np.int32)[::-1].copy()
    jm = jlang.LangModule(18, use_lang_classifier=True, use_bidir=bidir, hidden_size=16)
    variables = jm.init(jax.random.PRNGKey(3), jnp.asarray(feat), jnp.asarray(lens), train=False)
    want = jm.apply(variables, jnp.asarray(feat), jnp.asarray(lens), train=False)
    m = load_jax_variables(lang.LangModule(10, 18, use_lang_classifier=True, use_bidir=bidir,
                                           hidden_size=16), variables).eval()
    with torch.no_grad():
        got = m(_t(feat), _t(lens))
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["lang_mask"].numpy(), np.asarray(want["lang_mask"]))
    for key in ("lang_out", "lang_emb", "lang_scores"):
        _close(got[key], want[key], key)


def test_clip_lang_module_matches_jax():
    rng = np.random.RandomState(4)
    feat = rng.randn(4, LANG_LEN, 12).astype(np.float32)
    lens = np.array([1, 3, 6, 0], np.int32)
    jm = jlang.CLIPLangModule(out_size=16)
    variables = jm.init(jax.random.PRNGKey(4), jnp.asarray(feat), jnp.asarray(lens), train=False)
    want = jm.apply(variables, jnp.asarray(feat), jnp.asarray(lens), train=False)
    m = load_jax_variables(lang.CLIPLangModule(12, 16), variables).eval()
    with torch.no_grad():
        got = m(_t(feat), _t(lens))
    np.testing.assert_array_equal(got["lang_mask"].numpy(), np.asarray(want["lang_mask"]))
    for key in ("lang_out", "lang_emb"):
        _close(got[key], want[key], key)


BERT_CFG = dataclasses.replace(TINY_MED, add_cross_attention=False, hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0)


@pytest.mark.parametrize("mode", ["train", "freeze", "finetune_last_layer"])
def test_bert_lang_encoder_matches_jax(mode):
    """The states within 1e-5, and the gradient of a weighted sum of them:
    zero for the same parameters as JAX's (every one when frozen, all but
    the last layer's with ``finetune_last_layer``), the others within 1e-4
    relative L2."""
    rng = np.random.RandomState(5)
    ids = rng.randint(1, 100, (2, 9))
    mask = np.ones((2, 9), np.int32)
    mask[1, 5:] = 0
    weight = rng.randn(2, 9, 64).astype(np.float32)
    flags = dict(freeze=mode == "freeze", finetune_last_layer=mode == "finetune_last_layer")
    jm = jlang.BertLangEncoder(BERT_CFG, **flags)
    variables = jm.init(jax.random.PRNGKey(5), jnp.asarray(ids), jnp.asarray(mask), train=False)

    def loss(params):
        h = jm.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask), train=True)
        return jnp.sum(h * weight), h

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    m = load_jax_variables(lang.BertLangEncoder(_port_cfg(med.MedConfig, BERT_CFG), **flags),
                           variables).train()
    got = m(_t(ids), _t(mask))
    _close(got, want, "states")
    if got.requires_grad:
        (got * _t(weight)).sum().backward()
    ours = grad_tree(m)
    leaves = list(_leaves(_np_tree(jgrads)))
    largest = max(np.linalg.norm(g) for _, g in leaves)
    zero_ours, zero_jax = [], []
    for path, jg in leaves:
        g = _lookup(ours, path)
        if not np.any(jg):
            zero_jax.append(path)
        if not np.any(g):
            zero_ours.append(path)
        # a key bias's gradient is 0 up to rounding (a softmax ignores a
        # shift of a query's scores) on both sides
        elif max(np.linalg.norm(jg), np.linalg.norm(g)) > 1e-6 * largest:
            assert rel_l2(g, jg) < 1e-4, path
    assert zero_ours == zero_jax
    n_params = len(list(m.parameters()))
    assert len(zero_jax) == {"train": 0, "freeze": n_params}.get(mode, len(zero_jax))
    if mode == "finetune_last_layer":
        assert all(p[1] != "encoder" or p[2] != "layer_1" for p in zero_jax)
        assert 0 < len(zero_jax) < n_params


def mcan_config(**kw):
    """The tiny JAX config of ``tests/test_torch_train.py`` on the MCAN path,
    every dropout rate the config holds at 0."""
    return jax_train_config(use_blip=False, answer_pdrop=0.0, lang_pdrop=0.0, **kw)


def mcan_batch(seed: int = 7) -> dict:
    """``train_batch`` with the MCAN path's inputs: 300-d word vectors of
    varying lengths and answer classes."""
    batch = train_batch(seed)
    rng = np.random.RandomState(seed + 100)
    b = batch["point_clouds"].shape[0]
    batch.update(lang_feat=rng.randn(b, LANG_LEN, 300), lang_len=np.array([3, LANG_LEN], np.int32),
                 answer_cat=rng.randint(0, 30, (b,)).astype(np.int32))
    return batch


def _f32(batch):
    return {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in batch.items()}


@pytest.mark.parametrize("bert", [False, True])
def test_mcan_model_eval_matches_jax(bert):
    """``BridgeQA(use_blip=False)`` in eval mode (and ``lang_bert``: the
    question ids through the BERT encoder into the LSTM), bidirectional:
    every head within 1e-5 of JAX's, the indices exact. JAX on its chip's
    stripe ball query."""
    jcfg = mcan_config(lang_use_bidir=True, lang_bert=bert)
    model = perturbed_model(port_config(jcfg))
    variables = export_jax_variables(model)
    batch = _f32(mcan_batch())
    jmodel = jbridgeqa.BridgeQA(jcfg, mean_size_arr=ScannetDatasetConfig().mean_size_arr)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgrouping, "FORCE_MODE", "stripes")
        jout = jax.jit(functools.partial(jmodel.apply, train=False))(
            variables, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        out = model({k: _t(v) for k, v in batch.items()}, inference="rank")
    assert set(out) == set(jout)
    for key in ("answer_scores", "lang_scores", "cluster_ref", "fuse_feat"):
        _close(out[key], jout[key], key)
    for key in ("bbox_mask", "aggregated_vote_inds"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(jout[key]), err_msg=key)


def test_mcan_model_under_bf16_keeps_the_lstm_in_f32():
    """The JAX package builds the language modules without a dtype, so they
    compute in f32 in a bf16 model; ``set_compute_dtype`` leaves them so,
    and the rest of the model computes in bf16."""
    model = set_compute_dtype(perturbed_model(port_config(mcan_config(lang_bert=True))),
                              torch.bfloat16)
    assert model.lang_net.OptimizedLSTMCell_0.hi.weight_cast is None
    assert model.lang_bert_enc.bert.encoder.layer_0.intermediate_dense.weight_cast is None
    assert model.lang_feat_linear.weight_cast.dtype == torch.bfloat16
    with torch.no_grad():
        out = model({k: _t(v) for k, v in _f32(mcan_batch()).items()})
    assert torch.isfinite(out["answer_scores"].float()).all()


@pytest.fixture(scope="module")
def mcan_train_pair(jax_x64):
    """One training forward, get_loss and backward of the MCAN model on both
    sides in f64, every dropout off (AttFlat's glimpse MLP, 0.1 in both
    packages' code, set to 0 on both sides), BN momentum 0.1."""
    jcfg = mcan_config(lang_use_bidir=True)
    dc = ScannetDatasetConfig()
    model = perturbed_model(port_config(jcfg)).double()
    for flat in (model.attflat_lang, model.attflat_visual):
        flat.mlp.pdrop = 0.0
    variables = export_jax_variables(model)
    batch = mcan_batch()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbridgeqa, "AttFlat",
                   lambda *a, **k: jmcan.AttFlat(*a[:4], 0.0, **k))
        # flax's LSTM carry starts in the cell's parameter dtype (f32 by
        # default) and its scan refuses the f64 carry the x64 step computes:
        # the cells are built with f64 parameters, as the port's are here
        mp.setattr(jlang.nn, "OptimizedLSTMCell",
                   functools.partial(flax_nn.OptimizedLSTMCell, param_dtype=jnp.float64))
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


def test_mcan_train_losses_match_jax(mcan_train_pair):
    p = mcan_train_pair
    np.testing.assert_allclose(float(p.loss.detach()), p.jloss, rtol=LOSS_RTOL)
    for key in ("answer_loss", "lang_loss", "ref_loss", "vote_loss"):
        np.testing.assert_allclose(float(p.end[key].detach()), float(p.jend[key]),
                                   rtol=LOSS_RTOL, err_msg=key)
    assert float(p.end["answer_loss"].detach()) > 0


def test_mcan_train_gradients_match_jax(mcan_train_pair):
    """Every parameter's gradient within 1e-4 relative L2 (zero on both
    sides counts as agreeing: the attention key biases, as in
    ``tests/test_torch_train.py``)."""
    p = mcan_train_pair
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
    lstm = _lookup(ours, ("lang_net", "OptimizedLSTMCell_1", "hi", "kernel"))
    assert np.linalg.norm(lstm) > 0  # the backward direction trained


def test_mcan_tree_round_trips_and_routes_like_jax():
    """``export_jax_variables`` then ``load_jax_variables`` gives the same
    parameters and statistics (the LSTMs of both directions and the BERT
    encoder among them); every parameter falls in the optimizer group JAX's
    ``label_params`` gives its path ("other" for the whole MCAN model)."""
    model = perturbed_model(port_config(mcan_config(lang_use_bidir=True, lang_bert=True)))
    variables = export_jax_variables(model)
    again = load_jax_variables(bridgeqa.BridgeQA(model.cfg, device="cpu"), variables)
    for (name, a), (_, b) in zip(model.state_dict().items(), again.state_dict().items()):
        assert torch.equal(a, b), name
    jlabels = joptim.label_params(variables["params"])
    ours = label_params(model)
    for path, want in _leaves(jlabels):
        key = ".".join(path[:-1] + (
            {"kernel": "weight", "scale": "weight", "embedding": "weight"}.get(path[-1], path[-1]),))
        assert ours[key] == str(want), key
    assert set(ours.values()) == {"other"}
