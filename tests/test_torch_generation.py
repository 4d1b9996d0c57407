"""The port's generate path against the JAX package: the beam search itself
(the exact cases of ``tests/test_generation.py`` through both searches), the
cacheable halves of attention, the KV-cache decode steps, and generate
through BLIP and the whole BridgeQA slice. Same weights
(``convert.load_jax_variables``), same numpy inputs, f32 on the CPU.

Floats agree to atol 1e-4 (both sides compute in f32 but sum in another
order); token ids and indices must be equal. Random weights give
near-uniform logits, whose beam choices sit on ~1e-5 ties that such
rounding can flip, so the generate tests sharpen the LM head bias on both
sides the same way (``_SHARPEN``, as ``tests/test_golden_orchestration.py``
does); the seeds are pinned to draws whose beam choices are decisively
untied (the smallest gap between a kept and a dropped candidate is checked
in ``test_blip_generate_matches_jax``).
"""

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridgeqa_tpu.data.scannet_config import ScannetDatasetConfig
from bridgeqa_tpu.models import blip_vqa3d as jblip
from bridgeqa_tpu.models import bridgeqa as jbridgeqa
from bridgeqa_tpu.models import generation as jgen
from bridgeqa_tpu.models import med as jmed
from bridgeqa_tpu.ops import grouping as jgrouping
from bridgeqa_tpu_torch.convert import load_jax_variables
from bridgeqa_tpu_torch.models import blip_vqa3d, bridgeqa, generation, med
from tests.test_torch_bridgeqa import TINY_BLIP, TINY_MED, _port_cfg, _qa_batch

ATOL = 1e-4
BOS, EOS, PAD = 5, 4, 0
V = 6
# the sharpened LM head bias: RandomState(1).randn(V) * 4 added on both sides
_SHARPEN = 4.0
_CROSS_GAIN = 10.0


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, what):
    got = got.detach().float().numpy()
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=ATOL, rtol=0, err_msg=what)


# ---- the search itself: toy decoders, both searches, JAX and the port ----

def _static_logits(row):
    row = np.asarray(row, np.float32)

    def jax_fn(flat_ids, flat_mask):
        return jnp.broadcast_to(jnp.asarray(row), flat_ids.shape + (V,))

    def torch_fn(flat_ids, flat_mask):
        return torch.from_numpy(row).expand(*flat_ids.shape, V)

    return jax_fn, torch_fn


def _prefix_logits():
    """Token 1 after bos is slightly likelier than token 2, but token 1
    after 2 has logit 10: the beam search must keep the "2" beam."""

    def jax_fn(flat_ids, flat_mask):
        vocab = jnp.arange(V)[None, None, :]
        bonus = jnp.where((flat_ids == 2)[..., None] & (vocab == 1), 10.0, 0.0)
        start = jnp.where((flat_ids == BOS)[..., None] & (vocab == 1), 0.5, 0.0)
        return bonus + start

    def torch_fn(flat_ids, flat_mask):
        vocab = torch.arange(V)[None, None, :]
        bonus = torch.where((flat_ids == 2)[..., None] & (vocab == 1), 10.0, 0.0)
        start = torch.where((flat_ids == BOS)[..., None] & (vocab == 1), 0.5, 0.0)
        return bonus + start

    return jax_fn, torch_fn


def _as_step(full_fn):
    """A full-prefix toy decoder as a cached one: the cache holds a step
    counter per row (a tensor, so the cache has a device) and the last
    token is all these decoders read."""

    def step(tok, cache):
        logits = full_fn(tok, None)[:, 0]
        return logits, dict(cache, steps=cache["steps"] + 1)

    return step


_ROW_STATIC = [0.0, 3.0, 2.0, 1.0, -5.0, -5.0]
_ROW_EOS = [0.0, 1.0, 0.5, 0.0, 5.0, -5.0]
# (name, decoder, batch, beams, max_length, min_length)
TOY_CASES = [
    ("greedy path when logits are static", lambda: _static_logits(_ROW_STATIC), 2, 3, 4, 1),
    ("eos freezes the beam", lambda: _static_logits(_ROW_EOS), 1, 2, 5, 1),
    ("min_length blocks eos", lambda: _static_logits(_ROW_EOS), 1, 2, 4, 2),
    ("prefix-dependent beats greedy", _prefix_logits, 1, 3, 3, 1),
]


def _toy_search(case, cached: bool):
    _, make, b, k, max_len, min_len = case
    jax_fn, torch_fn = make()
    kw = dict(bos_token_id=BOS, eos_token_id=EOS, pad_token_id=PAD, max_length=max_len,
              min_length=min_len)
    if cached:
        want = jgen.beam_search_cached(_as_step(jax_fn),
                                       {"steps": jnp.zeros((b * k, 1), jnp.int32)}, b, k, **kw)
        got = generation.beam_search_cached(_as_step(torch_fn),
                                            {"steps": torch.zeros((b * k, 1), dtype=torch.int32)},
                                            b, k, **kw)
    else:
        want = jgen.beam_search(jax_fn, b, k, **kw)
        got = generation.beam_search(torch_fn, b, k, device="cpu", **kw)
    ids, scores = (x.numpy() for x in got)
    np.testing.assert_array_equal(ids, np.asarray(want[0]))
    np.testing.assert_allclose(scores, np.asarray(want[1]), atol=1e-5, rtol=0)
    return ids, scores


@pytest.mark.parametrize("cached", [False, True], ids=["prefix rerun", "cached"])
@pytest.mark.parametrize("case", TOY_CASES, ids=[c[0] for c in TOY_CASES])
def test_toy_beam_search_matches_jax(case, cached):
    """The four exact cases of ``tests/test_generation.py``: the port's
    search equals JAX's and reaches the exact answer."""
    ids, scores = _toy_search(case, cached)
    name = case[0]
    if name.startswith("greedy"):
        np.testing.assert_array_equal(ids[:, 0], [[BOS, 1, 1, 1]] * 2)
        assert (np.diff(scores, axis=1) <= 1e-5).all()  # best first
        row = np.asarray(_ROW_STATIC)
        np.testing.assert_allclose(scores[:, 0], 3 * (row[1] - np.log(np.exp(row).sum())),
                                   rtol=1e-5)
    elif name.startswith("eos"):
        np.testing.assert_array_equal(ids[0, 0], [BOS, EOS, PAD, PAD, PAD])
        row = np.asarray(_ROW_EOS)
        np.testing.assert_allclose(scores[0, 0], row[4] - np.log(np.exp(row).sum()), rtol=1e-5)
    elif name.startswith("min_length"):
        assert ids[0, 0, 1] != EOS and ids[0, 0, 2] == EOS
    else:
        np.testing.assert_array_equal(ids[0, 0], [BOS, 2, 1])


def test_cached_search_moves_the_whole_cache_with_its_beams():
    """Each row of the cache carries a tag that decides its logits (the
    toy's cross states); rows of one question carry different tags. A
    search that left any leaf of the cache in place when its beams moved
    would decode a moved beam under its new row's tag and differ from JAX.
    The tag lives in a nested list, as the decoder's per-layer K/V do."""
    b, k, max_len = 2, 4, 6
    rng = np.random.RandomState(5)
    table = rng.randn(3, V, V).astype(np.float32) * 2.0  # (tag, last token, next token)
    tags = rng.randint(0, 3, (b * k,))

    def jax_step(tok, cache):
        tag = cache["layers"][0]["tag"]
        return jnp.asarray(table)[tag, tok[:, 0]], cache

    def torch_step(tok, cache):
        tag = cache["layers"][0]["tag"]
        return torch.from_numpy(table)[tag, tok[:, 0].long()], cache

    kw = dict(bos_token_id=BOS, eos_token_id=EOS, pad_token_id=PAD, max_length=max_len)
    want = jgen.beam_search_cached(jax_step, {"pos": jnp.zeros((), jnp.int32),
                                              "layers": [{"tag": jnp.asarray(tags)}]}, b, k, **kw)
    got = generation.beam_search_cached(torch_step, {"pos": 0,
                                                     "layers": [{"tag": _t(tags)}]}, b, k, **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-5, rtol=0)
    # the check has teeth: a search that leaves the cache in place differs
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(generation, "reorder_cache", lambda cache, rows: cache)
        unmoved = generation.beam_search_cached(torch_step, {"pos": 0,
                                                             "layers": [{"tag": _t(tags)}]},
                                                b, k, **kw)
    assert not torch.equal(unmoved[0], got[0])
    rows = torch.tensor([3, 0, 1, 1])
    cache = {"pos": 7, "layers": [{"a": torch.arange(4.0)[:, None]}], "b": torch.arange(4)}
    moved = generation.reorder_cache(cache, rows)
    assert moved["pos"] == 7
    assert moved["layers"][0]["a"][:, 0].tolist() == [3.0, 0.0, 1.0, 1.0]
    assert moved["b"].tolist() == [3, 0, 1, 1]


def test_interleave_streams_matches_jax():
    rng = np.random.RandomState(0)
    h2d = rng.randn(2, 3, 4).astype(np.float32)
    h3d = h2d + 100
    got = generation.interleave_streams(_t(h2d), _t(h3d), num_beams=2)
    want = np.asarray(jgen.interleave_streams(jnp.asarray(h2d), jnp.asarray(h3d), 2))
    np.testing.assert_array_equal(got.numpy(), want)
    out = got.numpy().reshape(2, 4, 3, 4)  # per sample: [2d, 2d, 3d, 3d]
    np.testing.assert_array_equal(out[:, 0], out[:, 1])
    np.testing.assert_array_equal(out[:, 2] - out[:, 0], np.full_like(out[:, 0], 100))


# ---- the decoder's cached halves and decode steps ----

DEC_MED = jmed.MedConfig(vocab_size=40, hidden_size=32, num_hidden_layers=2,
                         num_attention_heads=4, intermediate_size=64,
                         max_position_embeddings=32, encoder_width=32, fused_scoring="off")
B, K, LQ = 2, 4, 5


@pytest.fixture(scope="module")
def decoder():
    """The tiny decoder of ``tests/test_generation.py::TestKVCacheParity``,
    JAX and the port with the same weights; question rows repeated K times
    per sample (one stream), the second question ragged."""
    rng = np.random.RandomState(1)
    q_states = np.repeat(rng.rand(B, LQ, 32).astype(np.float32), K, axis=0)
    q_mask = np.ones((B, LQ), np.int32)
    q_mask[1, 3:] = 0
    q_mask = np.repeat(q_mask, K, axis=0)
    ids = rng.randint(1, 40, (B * K, 3))
    jmodel = jmed.BertLMHeadModel(DEC_MED)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.ones(ids.shape, jnp.int32),
                            jnp.asarray(q_states), jnp.asarray(q_mask), deterministic=True)
    model = load_jax_variables(med.BertLMHeadModel(_port_cfg(med.MedConfig, DEC_MED)), variables).eval()
    return jmodel, variables, model, q_states, q_mask


def _layer_vars(variables, i=0):
    return {"params": variables["params"]["bert"]["encoder"][f"layer_{i}"]}


def test_project_kv_and_attend_cached_match_jax(decoder):
    _, variables, model, q_states, q_mask = decoder
    rng = np.random.RandomState(2)
    hidden = rng.randn(B * K, 3, 32).astype(np.float32)
    bias = np.asarray(jmed.extend_attention_mask(jnp.asarray(q_mask)))
    jattn = jmed.BertSelfAttention(DEC_MED, is_cross_attention=True)
    jv = {"params": _layer_vars(variables)["params"]["crossattention"]["self"]}
    wk, wv = jattn.apply(jv, jnp.asarray(q_states), method="project_kv")
    want = jattn.apply(jv, jnp.asarray(hidden), wk, wv, jnp.asarray(bias), deterministic=True,
                       method="attend_cached")
    attn = model.bert.encoder.layer[0].crossattention.self
    with torch.no_grad():
        k, v = attn.project_kv(_t(q_states))
        got = attn.attend_cached(_t(hidden), k, v, _t(bias))
        # forward takes the same two halves
        whole = attn(_t(hidden), _t(bias), _t(q_states))
    _close(k, wk, "k")
    _close(v, wv, "v")
    _close(got, want, "context")
    assert torch.equal(whole, got)


def test_layer_decode_step_matches_jax(decoder):
    """One layer step at position 2 of a cache whose first two positions
    hold earlier keys and values."""
    _, variables, model, q_states, q_mask = decoder
    rng = np.random.RandomState(3)
    n, nh, hd, max_len, pos = B * K, 4, 8, 6, 2
    hidden = rng.randn(n, 1, 32).astype(np.float32)
    self_k = np.zeros((n, nh, max_len, hd), np.float32)
    self_v = np.zeros_like(self_k)
    self_k[:, :, :pos] = rng.randn(n, nh, pos, hd)
    self_v[:, :, :pos] = rng.randn(n, nh, pos, hd)
    self_bias = np.where(np.arange(max_len) <= pos, 0.0, jmed.NEG_INF).astype(np.float32)
    self_bias = self_bias[None, None, None, :]
    cross_bias = np.asarray(jmed.extend_attention_mask(jnp.asarray(q_mask)))
    jlayer = jmed.BertLayer(DEC_MED)
    lv = _layer_vars(variables)
    ck, cv = jlayer.apply(lv, jnp.asarray(q_states), method="decode_kv_init")
    jcache = {"self_k": jnp.asarray(self_k), "self_v": jnp.asarray(self_v), "cross_k": ck,
              "cross_v": cv}
    want, wcache = jlayer.apply(lv, jnp.asarray(hidden), jcache, pos, jnp.asarray(self_bias),
                                jnp.asarray(cross_bias), method="decode_step")
    layer = model.bert.encoder.layer[0]
    with torch.no_grad():
        tck, tcv = layer.decode_kv_init(_t(q_states))
        cache = {"self_k": _t(self_k), "self_v": _t(self_v), "cross_k": tck, "cross_v": tcv}
        got, cache = layer.decode_step(_t(hidden), cache, pos, _t(self_bias), _t(cross_bias))
    _close(got, want, "layer output")
    for key in ("self_k", "self_v", "cross_k", "cross_v"):
        _close(cache[key], wcache[key], key)


def test_lm_decode_steps_match_jax(decoder):
    """Three decode steps from ``init_cache``: logits and the whole cache."""
    jmodel, variables, model, q_states, q_mask = decoder
    rng = np.random.RandomState(4)
    tokens = rng.randint(1, 40, (3, B * K, 1))
    tokens[0] = 30  # bos
    max_len = 5
    jcache = jmodel.apply(variables, jnp.asarray(q_states), jnp.asarray(q_mask), max_len,
                          method="init_cache")
    with torch.no_grad():
        cache = model.init_cache(_t(q_states), _t(q_mask), max_len)
        for step, tok in enumerate(tokens):
            wlogits, jcache = jmodel.apply(variables, jnp.asarray(tok), jcache,
                                           method="decode_step")
            logits, cache = model.decode_step(_t(tok), cache)
            _close(logits, wlogits, f"logits at step {step}")
    assert cache["pos"] == int(jcache["pos"]) == 3
    _close(cache["cross_bias"], jcache["cross_bias"], "cross_bias")
    for i, (lc, wlc) in enumerate(zip(cache["layers"], jcache["layers"])):
        for key in ("self_k", "self_v", "cross_k", "cross_v"):
            assert lc[key].shape == wlc[key].shape
            _close(lc[key], wlc[key], f"layer {i} {key}")


def test_init_cache_refuses_remat():
    model = med.BertLMHeadModel(_port_cfg(med.MedConfig, dataclasses.replace(DEC_MED, remat=True)))
    with pytest.raises(ValueError, match="remat"):
        model.init_cache(torch.zeros(2, 3, 32), torch.ones(2, 3, dtype=torch.int32), 4)


def test_cached_equals_uncached_single_stream(decoder):
    """With every beam row of a sample on one stream, the cached search and
    the prefix re-run agree (``tests/test_generation.py:162-184``), and both
    equal JAX's."""
    jmodel, variables, model, q_states, q_mask = decoder
    kw = dict(bos_token_id=30, eos_token_id=4, pad_token_id=0, max_length=8, min_length=2)

    def jax_fn(flat_ids, flat_mask):
        logits, _ = jmodel.apply(variables, flat_ids, flat_mask, jnp.asarray(q_states),
                                 jnp.asarray(q_mask), deterministic=True)
        return logits

    want_ids, want_scores = jgen.beam_search(jax_fn, B, K, **kw)
    with torch.no_grad():
        def torch_fn(flat_ids, flat_mask):
            return model(flat_ids, flat_mask, _t(q_states), _t(q_mask))[0]

        ids_u, sc_u = generation.beam_search(torch_fn, B, K, device="cpu", **kw)
        cache = model.init_cache(_t(q_states), _t(q_mask), kw["max_length"])
        ids_c, sc_c = generation.beam_search_cached(model.decode_step, cache, B, K, **kw)
    assert torch.equal(ids_u, ids_c)
    np.testing.assert_allclose(sc_u.numpy(), sc_c.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(ids_c.numpy(), np.asarray(want_ids))
    _close(sc_c, want_scores, "scores")


# ---- generate through BLIP and the whole slice, at the tiny configs ----

SLICE_CFG = jbridgeqa.BridgeQAConfig(num_answers=30, num_proposal=32, hidden_size=32,
                                     blip=TINY_BLIP, mcan_num_layers=1, mcan_flat_out_size=64,
                                     mcan_flat_mlp_size=32, input_feature_dim=1)
NUM_BEAMS, MAX_LEN = 2, 6


def _sharpen(variables):
    """The variables with the 2D decoder's LM head bias sharpened
    (``RandomState(1).randn(V) * 4``), the decoder generate runs, and its
    cross-attention's value and output kernels x``_CROSS_GAIN``: at the
    init's std of 0.02 the question states move a beam's score by less
    than the 1e-4 the two sides may differ by, and a beam that read the
    other stream's states would go unseen."""
    params = jax.tree_util.tree_map(lambda x: x, variables["params"])
    dec = params["blip_model"]["text_decoder"]
    dec["cls"]["bias"] = (dec["cls"]["bias"]
                          + np.random.RandomState(1).randn(dec["cls"]["bias"].shape[0]) * _SHARPEN)
    for layer in dec["bert"]["encoder"].values():
        cross = layer["crossattention"]
        cross["self"]["value"]["kernel"] = cross["self"]["value"]["kernel"] * _CROSS_GAIN
        cross["output"]["dense"]["kernel"] = cross["output"]["dense"]["kernel"] * _CROSS_GAIN
    return {**variables, "params": params}


@pytest.fixture(scope="module")
def slice_pair():
    """The tiny BridgeQA of ``tests/test_torch_bridgeqa.py`` (JAX on its
    chip's stripe ball query), initialised through the rank path (which
    builds both decoders), its LM head bias sharpened; JAX's generate
    forward and the port with the same weights."""
    batch = _qa_batch(np.random.RandomState(7))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = jbridgeqa.BridgeQA(SLICE_CFG, mean_size_arr=ScannetDatasetConfig().mean_size_arr)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgrouping, "FORCE_MODE", "stripes")  # read while tracing
        variables = jax.jit(functools.partial(jmodel.init, train=False, inference="rank",
                                              k_test=8))(jax.random.PRNGKey(0), jbatch)
        variables = _sharpen(variables)
        jout = jax.jit(functools.partial(jmodel.apply, train=False, inference="generate",
                                         num_beams=NUM_BEAMS, max_length=MAX_LEN))(variables, jbatch)
    tcfg = _port_cfg(bridgeqa.BridgeQAConfig, SLICE_CFG,
                     blip=_port_cfg(blip_vqa3d.BlipVQA3DConfig, TINY_BLIP,
                                    med=_port_cfg(med.MedConfig, TINY_MED)))
    model = load_jax_variables(
        bridgeqa.BridgeQA(tcfg, ScannetDatasetConfig().mean_size_arr, device="cpu"), variables)
    return variables, model, batch, {k: np.asarray(v) for k, v in jout.items()}


def test_bridgeqa_generate_matches_jax(slice_pair):
    _, model, batch, jout = slice_pair
    with torch.no_grad():
        out = model({k: _t(v) for k, v in batch.items()}, inference="generate",
                    num_beams=NUM_BEAMS, max_length=MAX_LEN)
    assert out["generated_ids"].shape == (2, MAX_LEN)
    np.testing.assert_array_equal(out["generated_ids"].numpy(), jout["generated_ids"])
    assert (out["generated_ids"][:, 0] == TINY_BLIP.bos_token_id).all()
    for key in ("lang_scores", "cluster_ref", "center", "aggregated_vote_xyz", "objectness_scores"):
        _close(out[key], jout[key], key)
    for key in ("bbox_mask", "aggregated_vote_inds", "sa1_inds"):
        np.testing.assert_array_equal(out[key].numpy(), jout[key], err_msg=key)
    assert "answer_scores" not in out


def _blip_inputs(seed=11):
    rng = np.random.RandomState(seed)
    b, lq, n_obj = 2, 10, 8
    mask = np.ones((b, lq), np.int32)
    mask[1, 7:] = 0  # a ragged question
    return dict(image=rng.rand(b, 32, 32, 3).astype(np.float32),
                question_ids=rng.randint(1, 100, (b, lq)), question_mask=mask,
                scene_object_embeds=rng.randn(b, n_obj, 32).astype(np.float32),
                scene_object_mask=(rng.rand(b, n_obj) > 0.3).astype(np.int32))


def test_blip_generate_matches_jax(slice_pair):
    """``BLIPVQA3D.generate`` on its own (scene embeddings drawn, not
    detected), 2D and 3D states that differ. Its best ids, then every beam
    of the cached search, ids and scores: the best beam seldom leaves row 0,
    but the others hop rows, and one reordered without its cross K/V would
    read the 3D states. The first step's candidates are checked to be
    decisively apart, so the ids are a fair exact check."""
    variables, model, _, _ = slice_pair
    jmodel = jblip.BLIPVQA3D(dataclasses.replace(TINY_BLIP, scene_size=32, num_answers=30))
    bv = {"params": variables["params"]["blip_model"]}
    inputs = _blip_inputs()
    names = ("image", "question_ids", "question_mask", "scene_object_embeds", "scene_object_mask")
    args = tuple(jnp.asarray(inputs[k]) for k in names)
    want_ids, want_fused, _ = jax.jit(functools.partial(
        jmodel.apply, num_beams=NUM_BEAMS, max_length=MAX_LEN, method="generate"))(bv, *args)
    blip = model.blip_model
    with torch.no_grad():
        ids, fused, _ = blip.generate(*(_t(inputs[k]) for k in names), num_beams=NUM_BEAMS,
                                      max_length=MAX_LEN)
        h2d, h3d = blip.encode_question(blip.encode_image(_t(inputs["image"])),
                                        *(_t(inputs[k]) for k in names[1:]))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    _close(fused, want_fused, "fused")
    assert float((h2d - h3d).abs().max()) > 0.1  # the streams differ

    k = 2 * NUM_BEAMS
    kw = dict(bos_token_id=TINY_BLIP.bos_token_id, eos_token_id=TINY_BLIP.sep_token_id,
              pad_token_id=0, max_length=MAX_LEN)
    mask_rows = np.repeat(inputs["question_mask"], k, axis=0)
    states = generation.interleave_streams(h2d, h3d, NUM_BEAMS)
    jcache = jmodel.apply(bv, jnp.asarray(states.numpy()), jnp.asarray(mask_rows), MAX_LEN,
                          method=lambda m, *a: m.text_decoder.init_cache(*a))
    jstep = jax.jit(lambda tok, c: jmodel.apply(
        bv, tok, c, method=lambda m, t, cc: m.text_decoder.decode_step(t, cc)))
    want_beams, want_scores = jgen.beam_search_cached(jstep, jcache, 2, k, **kw)
    with torch.no_grad():
        cache = blip.text_decoder.init_cache(states, _t(mask_rows), MAX_LEN)
        beams, scores = generation.beam_search_cached(blip.text_decoder.decode_step, cache, 2, k,
                                                      **kw)
        cache = blip.text_decoder.init_cache(states, _t(mask_rows), MAX_LEN)
        bos = torch.full((2 * k, 1), TINY_BLIP.bos_token_id, dtype=torch.int32)
        logits, _ = blip.text_decoder.decode_step(bos, cache)
    np.testing.assert_array_equal(beams.numpy(), np.asarray(want_beams))
    _close(scores, want_scores, "beam scores")
    assert torch.equal(beams[:, 0], ids)
    # the gap between the K-th and the (K+1)-th candidate at the first step,
    # over the sharpened head: well above the 1e-4 the two sides may differ by
    logp = torch.log_softmax(logits.float(), -1).reshape(2, k, -1)[:, 0]
    top = torch.sort(logp, dim=-1, descending=True).values[:, :k + 1]
    assert float((top[:, :-1] - top[:, 1:]).min()) > 1e-3


def test_uncached_generate_warns_and_skips_the_fused_gate(slice_pair, monkeypatch):
    """``use_kv_cache=False`` warns, and its full-prefix decoder calls
    (no labels) never reach the fused scoring path, even where
    ``fused_scoring="force"`` would take it for an answer-scoring call."""
    variables, _, _, _ = slice_pair
    blip_cfg = _port_cfg(blip_vqa3d.BlipVQA3DConfig, TINY_BLIP,
                         med=_port_cfg(med.MedConfig, TINY_MED, fused_scoring="force"),
                         use_kv_cache=False, scene_size=32)
    blip = load_jax_variables(blip_vqa3d.BLIPVQA3D(blip_cfg),
                              {"params": variables["params"]["blip_model"]}).eval()

    def refuse(*args, **kwargs):
        raise AssertionError("generate reached the fused scoring path")

    monkeypatch.setattr(med, "scoring_decoder_body", refuse)
    inputs = _blip_inputs()
    with warnings.catch_warnings(record=True) as caught, torch.no_grad():
        warnings.simplefilter("always")
        ids, _, _ = blip.generate(*(_t(inputs[k]) for k in (
            "image", "question_ids", "question_mask", "scene_object_embeds",
            "scene_object_mask")), num_beams=NUM_BEAMS, max_length=MAX_LEN)
    assert any("use_kv_cache=False" in str(w.message) for w in caught)
    assert ids.shape == (2, MAX_LEN) and (ids[:, 0] == TINY_BLIP.bos_token_id).all()


def test_other_inference_modes_name_what_is_missing(slice_pair):
    """'loss' runs now (``tests/test_torch_train.py``); the classifier mode
    and the MCAN path are still missing and say so, and an unknown mode is
    refused."""
    _, model, batch, _ = slice_pair
    for change in (dict(use_text_decoder=False), dict(use_blip=False)):
        with pytest.raises(NotImplementedError, match="classifier mode"):
            bridgeqa.BridgeQA(dataclasses.replace(model.cfg, **change), device="cpu")
    with pytest.raises(ValueError, match="'rank', 'generate' or 'loss'"):
        model({k: _t(v) for k, v in batch.items()}, inference="classify")
