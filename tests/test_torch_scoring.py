"""The port's fused answer-scoring path against the JAX package's, on the CPU.

``bridgeqa_tpu_torch.ops.scoring_layer`` and ``ops.vocab_loss`` run their
plain PyTorch versions here (the CUDA kernels are held to these on the card,
``tests/test_torch_cuda.py`` and ``chip_smoke.py``); the JAX side runs its
Pallas kernels in interpret mode, as ``tests/test_scoring_fused.py`` does.
Same weights (``convert.load_jax_variables``), same numpy inputs, f32.

Tolerances: atol 1e-4 against JAX (f32 on both sides, sums in another
order); the port's fused loss against its own module path at the JAX test's
2e-5; which answers are scored must be exact.
"""

import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridgeqa_tpu.data.scannet_config import ScannetDatasetConfig
from bridgeqa_tpu.models import blip_vqa3d as jblip
from bridgeqa_tpu.models import bridgeqa as jbridgeqa
from bridgeqa_tpu.models import med as jmed
from bridgeqa_tpu.ops import grouping as jgrouping
from bridgeqa_tpu.ops import scoring_layer as jscoring
from bridgeqa_tpu.ops import vit_block as jvit_block
from bridgeqa_tpu.ops import vocab_loss as jvocab
from bridgeqa_tpu_torch.convert import load_jax_variables
from bridgeqa_tpu_torch.data.scannet_config import MEAN_SIZE_ARR
from bridgeqa_tpu_torch.models import blip_vqa3d, bridgeqa, med
from bridgeqa_tpu_torch.models.layers import init_weights
from bridgeqa_tpu_torch.ops import scoring_layer, vit_block, vocab_loss
from tests.test_torch_bridgeqa import _port_cfg, _qa_batch
from tests.test_torch_ops import csrc_constants

ATOL = 1e-4
REPO = Path(__file__).resolve().parent.parent
# the JAX fused test's config: hidden 128, 2 heads
CFG = jmed.MedConfig(vocab_size=97, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                     intermediate_size=256, encoder_width=128, fused_scoring="force")


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, what, atol=ATOL):
    got = got.detach().float().numpy()
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol, rtol=0, err_msg=what)


def _answers(rng, q=2, g=8, la=4, lq=5, h=128, vocab=90):
    """Right-padded answers (labels -100 at padding) over q questions with a
    padded question mask."""
    ids = rng.randint(1, vocab, (q * g, la))
    lens = rng.randint(2, la + 1, q * g)
    mask = (np.arange(la)[None, :] < lens[:, None]).astype(np.int32)
    ids = np.where(mask > 0, ids, 0)
    labels = np.where(ids == 0, -100, ids)
    qs = rng.randn(q, lq, h).astype(np.float32)
    qmask = np.ones((q, lq), np.int32)
    qmask[0, 3:] = 0
    return ids, mask, labels, qs, qmask


# ------------------------------------------------------------ the repair

def test_mean_size_copy_matches_jax():
    np.testing.assert_array_equal(MEAN_SIZE_ARR, ScannetDatasetConfig().mean_size_arr)
    assert MEAN_SIZE_ARR.dtype == np.float32


def test_port_imports_nothing_of_jax():
    code = ("import sys, bridgeqa_tpu_torch.models.bridgeqa; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'bridgeqa_tpu' or m.startswith('bridgeqa_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 0, done.stdout + done.stderr


# ------------------------------------------------------------ the ops

def test_scoring_layer_plain_matches_pallas():
    """One layer through the op: la 4, g 8, 2 questions, question 1 padded."""
    rng = np.random.RandomState(0)
    h, heads, la, g, q, lq, inter = 128, 2, 4, 8, 2, 5, 256

    def r(*shape, scale=0.2):
        return (rng.randn(*shape) * scale).astype(np.float32)

    x = r(q * g * la, h, scale=1.0)
    # flax layout (in, out); the port takes (out, in)
    kernels = [r(h, 3 * h), r(h, h), r(h, h), r(h, h), r(h, inter), r(inter, h)]
    biases = [r(3 * h), r(h), r(h), r(h), r(inter), r(h)]
    norms = [(1.0 + r(h), r(h)) for _ in range(3)]
    ck, cv = r(q, lq, h, scale=1.0), r(q, lq, h, scale=1.0)
    qmask = np.ones((q, lq), np.int32)
    qmask[1, 2:] = 0
    cbias = np.where(qmask > 0, 0.0, scoring_layer.NEG).astype(np.float32)
    (wqkv, wo, wcq, wco, wi, wo2), (bqkv, bo, bcq, bco, bi, bo2) = kernels, biases
    (l1s, l1b), (l2s, l2b), (l3s, l3b) = norms
    want = jscoring.scoring_layer(
        jnp.asarray(x), wqkv, bqkv[None], wo, bo[None], l1s[None], l1b[None], wcq, bcq[None],
        wco, bco[None], l2s[None], l2b[None], wi, bi[None], wo2, bo2[None], l3s[None],
        l3b[None], ck, cv, cbias, la=la, group=jscoring._pick_group(g, la, jnp.float32),
        heads=heads, eps=1e-12, interpret=True)
    got = scoring_layer.scoring_layer_plain(
        _t(x), _t(wqkv.T), _t(bqkv), _t(wo.T), _t(bo), _t(l1s), _t(l1b), _t(wcq.T), _t(bcq),
        _t(wco.T), _t(bco), _t(l2s), _t(l2b), _t(wi.T), _t(bi), _t(wo2.T), _t(bo2), _t(l3s),
        _t(l3b), _t(ck), _t(cv), _t(cbias), la=la, heads=heads, eps=1e-12)
    _close(got, want, "scoring_layer")


@pytest.mark.parametrize("layernorm_idx", [0, 1])
def test_decoder_body_matches_pallas(layernorm_idx):
    """The whole stack (weight fusion, cross K/V per question, the FFN
    LayerNorm that ``layernorm_idx`` picks), 2 layers."""
    rng = np.random.RandomState(1 + layernorm_idx)
    jcfg = dataclasses.replace(CFG, parallel_layernorms=1)
    ids, mask, labels, qs, qmask = _answers(rng)
    jmodel = jmed.BertLMHeadModel(jcfg)
    variables = jmodel.init(jax.random.PRNGKey(3), *map(jnp.asarray, (ids, mask, qs, qmask)),
                            labels=jnp.asarray(labels), deterministic=True)
    # LayerNorm parameters away from (1, 0) and biases away from 0, so a
    # wrong pick or a dropped bias shows
    variables = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.1 * jnp.asarray(rng.randn(*v.shape), v.dtype)
        if "LayerNorm" in jax.tree_util.keystr(p) or jax.tree_util.keystr(p).endswith("['bias']")
        else v, variables)
    emb = rng.randn(*ids.shape, 128).astype(np.float32)
    want = jscoring.scoring_decoder_body(variables["params"]["bert"]["encoder"], jnp.asarray(emb),
                                         jnp.asarray(qs), jnp.asarray(qmask), config=jcfg,
                                         dtype=jnp.float32, interpret=True,
                                         layernorm_idx=layernorm_idx)
    model = load_jax_variables(med.BertLMHeadModel(_port_cfg(med.MedConfig, jcfg)), variables).eval()
    with torch.no_grad():
        got = scoring_layer.scoring_decoder_body(model.bert.encoder, _t(emb), _t(qs), _t(qmask),
                                                 config=model.config, layernorm_idx=layernorm_idx,
                                                 layer=scoring_layer.scoring_layer_plain)
    _close(got, want, f"decoder body, layernorm_idx {layernorm_idx}")


def test_vocab_reductions_plain_matches_pallas():
    """V = 203 (no tile multiple) and 37 rows (no block multiple)."""
    rng = np.random.RandomState(4)
    rows, hdim, v = 37, 64, 203
    h = (rng.randn(rows, hdim) * 2.0).astype(np.float32)
    table = (rng.randn(v, hdim) * 0.5).astype(np.float32)
    bias = (rng.randn(v) * 0.1).astype(np.float32)
    labels = rng.randint(0, v, rows).astype(np.int32)
    want = jvocab.lm_vocab_reductions(*map(jnp.asarray, (h, table, bias, labels)), interpret=True)
    got = vocab_loss.lm_vocab_reductions_plain(_t(h), _t(table), _t(bias), _t(labels))
    for name, a, b in zip(("lse", "sum_logits", "target_logit"), got, want):
        _close(a, b, name)


def test_streaming_loss_matches_pallas():
    rng = np.random.RandomState(5)
    b, lm1, hdim, v = 6, 5, 64, 203
    h = rng.randn(b, lm1, hdim).astype(np.float32)
    table = (rng.randn(v, hdim) * 0.3).astype(np.float32)
    bias = (rng.randn(v) * 0.1).astype(np.float32)
    labels = rng.randint(0, v, (b, lm1))
    labels[0, 2:] = -100
    labels[3, :1] = -100
    want = jvocab.label_smoothed_loss_streaming(*map(jnp.asarray, (h, labels, table, bias)),
                                                interpret=True)
    got = vocab_loss.label_smoothed_loss_streaming(_t(h), _t(labels), _t(table), _t(bias))
    _close(got, want, "per-sequence loss")


# ------------------------------------------------------------ the decoder

def _decoders(jcfg, rng):
    ids, mask, labels, qs, qmask = _answers(rng)
    jmodel = jmed.BertLMHeadModel(jcfg)
    jargs = tuple(map(jnp.asarray, (ids, mask, qs, qmask)))
    variables = jmodel.init(jax.random.PRNGKey(6), *jargs, labels=jnp.asarray(labels),
                            deterministic=True)
    model = load_jax_variables(med.BertLMHeadModel(_port_cfg(med.MedConfig, jcfg)), variables).eval()
    return jmodel, variables, model, jargs, (ids, mask, labels, qs, qmask)


def test_fused_loss_matches_jax_fused():
    """Both sides forced onto the fused path, right-padded answers."""
    jmodel, variables, model, jargs, arrays = _decoders(CFG, np.random.RandomState(7))
    ids, mask, labels, qs, qmask = arrays
    _, want = jmodel.apply(variables, *jargs, labels=jnp.asarray(labels), deterministic=True)
    with torch.no_grad():
        logits, got = model(*map(_t, (ids, mask, qs, qmask)), labels=_t(labels))
    assert logits is None
    _close(got, want, "fused loss")


@pytest.mark.parametrize("chunk", [None, 4])
def test_fused_loss_matches_module_path(chunk):
    """The port's fused path against its own module path (which keeps the
    answer padding mask), unchunked and chunked."""
    _, variables, model, _, arrays = _decoders(CFG, np.random.RandomState(8))
    ids, mask, labels, qs, qmask = map(_t, arrays)
    off_cfg = dataclasses.replace(model.config, fused_scoring="off")
    off = load_jax_variables(med.BertLMHeadModel(off_cfg), variables).eval()
    with torch.no_grad():
        _, fused = model(ids, mask, qs, qmask, labels=labels, loss_chunk_size=chunk)
        _, plain = off(ids, mask, qs, qmask, labels=labels, loss_chunk_size=chunk)
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), rtol=2e-5, atol=2e-5)


class TestGate:
    """Which path a call takes on the CPU."""

    def _call(self, mode, g=8, with_labels=True):
        cfg = dataclasses.replace(_port_cfg(med.MedConfig, CFG), fused_scoring=mode)
        model = init_weights(med.BertLMHeadModel(cfg), torch.Generator().manual_seed(0)).eval()
        ids, mask, labels, qs, qmask = map(_t, _answers(np.random.RandomState(9), q=2, g=g))
        with torch.no_grad():
            return model._fused_scoring_loss(ids, qs, qmask, labels if with_labels else None)

    @pytest.mark.parametrize("mode,fused", [("auto", False), ("force", True), ("off", False)])
    def test_modes(self, mode, fused):
        out = self._call(mode)
        assert (out is not None) == fused
        if fused:
            assert out.shape == (16,) and torch.isfinite(out).all()

    def test_module_path_without_grouping_or_labels(self):
        assert self._call("force", g=1) is None
        assert self._call("force", with_labels=False) is None

    def test_unknown_mode_raises(self):
        with pytest.raises(ValueError):
            self._call("always")

    def test_kernel_conditions(self):
        cfg = _port_cfg(med.MedConfig, CFG)
        gate = scoring_layer.fused_scoring_capable
        assert gate(cfg, 16, 2, 12, 80)
        # the TPU's hidden % 128 is gone
        assert gate(dataclasses.replace(cfg, hidden_size=96), 16, 2, 12, 80)
        assert not gate(cfg, 16, 16, 12, 80)  # g = 1
        assert not gate(cfg, 15, 2, 12, 80)  # ragged groups
        # rows of 16 bytes: hidden % 8
        assert not gate(dataclasses.replace(cfg, hidden_size=126), 16, 2, 12, 80)
        assert not gate(dataclasses.replace(cfg, num_attention_heads=128), 16, 2, 12, 80)
        assert not gate(cfg, 16, 2, scoring_layer.MAX_ANSWER_LEN + 1, 80)
        assert not gate(cfg, 16, 2, 12, 4096)  # keys past one block's shared memory
        # the main path: hidden 768, 12 heads, 256 answers of 12 tokens per question
        main = dataclasses.replace(cfg, hidden_size=768, num_attention_heads=12,
                                   intermediate_size=3072)
        assert gate(main, 8 * 256, 8, 12, 80)


# ----------------------------------------------- the tensor-core attentions

def test_attention_pipeline_constants():
    """The tensor-core pipeline's tile holds the longest answer the wrapper
    lets through, in 16-row slices of its consumer warps, one 128-byte
    swizzled row a head; the wrapper reads as many launch fields as the
    kernel writes; the shared memory of each instantiation is held to a
    block's 227 KB by the source's own static_asserts."""
    consts = csrc_constants("scoring_attention.cu")
    assert consts["kTileRows"] == scoring_layer.MAX_ANSWER_LEN
    assert consts["kConsumers"] * 16 == consts["kTileRows"]
    assert consts["kRow"] == 2 * consts["kHd"] == 128
    # the launch record the C entry writes and the wrapper reads
    assert consts["kLaunchFields"] == len(scoring_layer.ATTENTION_LAUNCH_FIELDS)
    text = (REPO / "bridgeqa_tpu_torch" / "csrc" / "scoring_attention.cu").read_text()
    assert "static_assert(SMEM <= 232448" in text


# ------------------------------------------------------------ the rank slice

@pytest.fixture(scope="module")
def fused_slice_outputs():
    """The whole rank slice at hidden 128 with ``fused_scoring="force"`` and
    ``vit_block.FUSED_MODE = "force"`` on both sides: the decoders score
    through the fused scoring path and the ViT runs the fused block."""
    med_cfg = dataclasses.replace(CFG, vocab_size=120, max_position_embeddings=64)
    blip = jblip.BlipVQA3DConfig(med=med_cfg, image_size=32, num_answers=30, scene_size=32,
                                 bos_token_id=110, vit="custom", vit_custom_embed_dim=128,
                                 vit_custom_depth=1, vit_custom_heads=2, vit_drop_path_rate=0.0)
    jcfg = jbridgeqa.BridgeQAConfig(num_answers=30, num_proposal=32, hidden_size=32, blip=blip,
                                    mcan_num_layers=1, mcan_flat_out_size=64,
                                    mcan_flat_mlp_size=32, input_feature_dim=1)
    mean_size = ScannetDatasetConfig().mean_size_arr
    batch = _qa_batch(np.random.RandomState(10))
    batch["answer_list_ids"][:5, 3:] = 0  # right-padded answers
    batch["answer_list_mask"][:5, 3:] = 0
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = jbridgeqa.BridgeQA(jcfg, mean_size_arr=mean_size)
    kw = dict(train=False, inference="rank", k_test=8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgrouping, "FORCE_MODE", "stripes")  # read while tracing
        mp.setattr(jvit_block, "FUSED_MODE", "force")
        variables = jax.jit(functools.partial(jmodel.init, **kw))(jax.random.PRNGKey(0), jbatch)
        jout = jax.jit(functools.partial(jmodel.apply, **kw))(variables, jbatch)
    tcfg = _port_cfg(bridgeqa.BridgeQAConfig, jcfg,
                     blip=_port_cfg(blip_vqa3d.BlipVQA3DConfig, blip,
                                    med=_port_cfg(med.MedConfig, med_cfg)))
    model = load_jax_variables(bridgeqa.BridgeQA(tcfg, mean_size, device="cpu"), variables)
    calls = {"scoring": 0, "vit": 0}
    body, blocks = scoring_layer.scoring_decoder_body, vit_block.fused_vit_blocks

    def counted(key, fn):
        def run(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return run

    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(med, "scoring_decoder_body", counted("scoring", body))
        mp.setattr(vit_block, "fused_vit_blocks", counted("vit", blocks))
        mp.setattr(vit_block, "FUSED_MODE", "force")
        out = model({k: _t(v) for k, v in batch.items()}, inference="rank", k_test=8)
    return out, {k: np.asarray(v) for k, v in jout.items()}, calls


def test_fused_slice_scores_the_same_answers(fused_slice_outputs):
    out, jout, calls = fused_slice_outputs
    assert calls["scoring"] == 2  # one fused scoring pass per decoder
    for key in ("answer_scores_2d", "answer_scores_scene"):
        scored = jout[key] != -1e4
        assert scored.sum(axis=1).tolist() == [8, 8], key
        np.testing.assert_array_equal(out[key].numpy() != -1e4, scored, err_msg=key)
        np.testing.assert_allclose(out[key].numpy()[scored], jout[key][scored], atol=ATOL, rtol=0,
                                   err_msg=key)
    np.testing.assert_allclose(out["answer_scores"].numpy(), jout["answer_scores"], rtol=1e-3,
                               atol=0)
    for key in ("lang_scores", "cluster_ref"):
        _close(out[key], jout[key], key)


def test_fused_slice_takes_the_fused_vit(fused_slice_outputs):
    """The image encoder ran the fused block once (both of its blocks and
    the final LayerNorm), and the heads that read its output agree."""
    out, jout, calls = fused_slice_outputs
    assert calls["vit"] == 1
    assert out["answer_scores"].shape == (2, 30)
