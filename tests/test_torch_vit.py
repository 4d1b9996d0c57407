"""The port's fused ViT block and row gather against the JAX package's, on
the CPU.

``bridgeqa_tpu_torch.ops.vit_block`` and ``ops.gather`` run their plain
PyTorch versions here (the CUDA kernels are held to these on the card,
``tests/test_torch_cuda.py`` and ``chip_smoke.py``); the JAX side runs its
Pallas kernels in interpret mode, as ``tests/test_vit_fused.py`` does. Same
weights (``convert.load_jax_variables``), same numpy inputs, f32.

Tolerances: atol 1e-4 against JAX (f32 on both sides, sums in another
order; the JAX kernel pads the tokens to a multiple of 16 and its output is
sliced); the port's fused ViT against its own module loop at the JAX test's
2e-5; the gather exact, and within 1e-5 relative of the one-hot kernel,
whose f32 product keeps about 17 bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from bridgeqa_tpu.models import med as jmed
from bridgeqa_tpu.models import vit as jvit
from bridgeqa_tpu.ops import gather as jgather
from bridgeqa_tpu.ops import vit_block as jvb
from bridgeqa_tpu_torch.convert import load_jax_variables
from bridgeqa_tpu_torch.models import med, vit
from bridgeqa_tpu_torch.models.layers import Dense, init_weights, set_compute_dtype
from bridgeqa_tpu_torch.ops import gather, scoring_layer
from bridgeqa_tpu_torch.ops import vit_block as vb
from tests.test_torch_bridgeqa import _port_cfg
from tests.test_torch_scoring import CFG as SCORING_CFG
from tests.test_torch_scoring import _answers

ATOL = 1e-4
# tests/test_vit_fused.py's model: 48 px (10 tokens), embed 128, depth 2, 2 heads
IMG, EMBED, DEPTH, HEADS = 48, 128, 2, 2


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, what, atol=ATOL):
    got = got.detach().float().numpy()
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol, rtol=0, err_msg=what)


def _perturbed(variables, rng, scale=0.1):
    """Biases away from 0 and LayerNorm parameters away from (1, 0), so a
    dropped bias or affine shows."""
    def bump(path, v):
        key = jax.tree_util.keystr(path)
        if key.endswith("['bias']") or "norm" in key:
            return v + scale * jnp.asarray(rng.randn(*v.shape), v.dtype)
        return v
    return jax.tree_util.tree_map_with_path(bump, variables)


@pytest.fixture(scope="module")
def vit_models():
    """The JAX ViT of ``tests/test_vit_fused.py`` and the port's with the
    same (perturbed) weights, and an image batch."""
    rng = np.random.RandomState(0)
    img = rng.rand(2, IMG, IMG, 3).astype(np.float32)
    jmodel = jvit.VisionTransformer(img_size=IMG, patch_size=16, embed_dim=EMBED, depth=DEPTH,
                                    num_heads=HEADS)
    variables = _perturbed(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(img)), rng)
    model = load_jax_variables(vit.VisionTransformer(IMG, 16, EMBED, DEPTH, HEADS), variables)
    return jmodel, variables, model, img


# ------------------------------------------------------------ the block

@pytest.mark.parametrize("n", [10, 5])
def test_vit_block_plain_matches_pallas(n):
    """One block: JAX gets the tokens padded to 16 and ``valid=n``."""
    rng = np.random.RandomState(n)
    h, mlp = EMBED, 4 * EMBED

    def r(*shape, scale=0.1):
        return (rng.randn(*shape) * scale).astype(np.float32)

    x = r(2, n, h, scale=1.0)
    # flax layout (in, out); the port takes (out, in)
    wqkv, wo, wi, wo2 = r(h, 3 * h), r(h, h), r(h, mlp), r(mlp, h)
    bqkv, bo, bi, bo2 = r(3 * h), r(h), r(mlp), r(h)
    (l1s, l1b), (l2s, l2b) = [(1.0 + r(h), r(h)) for _ in range(2)]
    xp = np.pad(x, ((0, 0), (0, (-n) % 16), (0, 0)))
    want = jvb.vit_block(jnp.asarray(xp), wqkv, bqkv[None], wo, bo[None], l1s[None], l1b[None],
                         wi, bi[None], wo2, bo2[None], l2s[None], l2b[None], heads=HEADS,
                         eps=1e-6, valid=n, interpret=True)[:, :n]
    got = vb.vit_block_plain(_t(x), _t(wqkv.T), _t(bqkv), _t(wo.T), _t(bo), _t(l1s), _t(l1b),
                             _t(wi.T), _t(bi), _t(wo2.T), _t(bo2), _t(l2s), _t(l2b), heads=HEADS,
                             eps=1e-6)
    _close(got, want, f"vit_block, {n} tokens")


def test_vit_block_plain_bf16_matches_pallas():
    """The bf16 block, where the port's deferred softmax normalisation (e
    rounded before P V) and the TPU kernel's (p = e / sum(e) rounded) round
    at different points: within 2^-6 of the largest output, the bf16
    tolerance of the kernels' checks."""
    rng = np.random.RandomState(21)
    n, h, mlp = 10, EMBED, 4 * EMBED

    def r(*shape, scale=0.1):
        return (rng.randn(*shape) * scale).astype(np.float32)

    x = r(2, n, h, scale=1.0)
    wqkv, wo, wi, wo2 = r(h, 3 * h), r(h, h), r(h, mlp), r(mlp, h)
    bqkv, bo, bi, bo2 = r(3 * h), r(h), r(mlp), r(h)
    (l1s, l1b), (l2s, l2b) = [(1.0 + r(h), r(h)) for _ in range(2)]
    xp = np.pad(x, ((0, 0), (0, (-n) % 16), (0, 0)))

    def jb(a):
        return jnp.asarray(a).astype(jnp.bfloat16)

    want = jvb.vit_block(jb(xp), jb(wqkv), bqkv[None], jb(wo), bo[None], l1s[None], l1b[None],
                         jb(wi), bi[None], jb(wo2), bo2[None], l2s[None], l2b[None], heads=HEADS,
                         eps=1e-6, valid=n, interpret=True)[:, :n]
    want = np.asarray(want.astype(jnp.float32))

    def tb(a):
        return _t(a).bfloat16()

    got = vb.vit_block_plain(tb(x), tb(wqkv.T), _t(bqkv), tb(wo.T), _t(bo), _t(l1s), _t(l1b),
                             tb(wi.T), _t(bi), tb(wo2.T), _t(bo2), _t(l2s), _t(l2b),
                             heads=HEADS, eps=1e-6)
    assert got.dtype == torch.bfloat16
    _close(got, want, "bf16 vit_block", atol=2.0**-6 * float(np.abs(want).max()))


def test_fused_vit_blocks_match_pallas(vit_models):
    """Both blocks, the port reading its ``blocks_{i}`` modules."""
    _, variables, model, _ = vit_models
    x = np.random.RandomState(1).randn(2, 10, EMBED).astype(np.float32)
    want = jvb.fused_vit_blocks(variables["params"], jnp.asarray(x), depth=DEPTH, heads=HEADS,
                                interpret=True)
    with torch.no_grad():
        got = vb.fused_vit_blocks(model, _t(x))
    _close(got, want, "fused_vit_blocks")


def _count_fused(monkeypatch):
    calls = []
    fused = vb.fused_vit_blocks
    monkeypatch.setattr(vb, "fused_vit_blocks", lambda *a, **k: calls.append(1) or fused(*a, **k))
    return calls


def test_fused_vit_matches_jax_fused(vit_models, monkeypatch):
    """The whole ViT with the fused path forced on both sides (the final
    LayerNorm included)."""
    jmodel, variables, model, img = vit_models
    monkeypatch.setattr(jvb, "FUSED_MODE", "force")
    want = jmodel.apply(variables, jnp.asarray(img))
    monkeypatch.setattr(vb, "FUSED_MODE", "force")
    calls = _count_fused(monkeypatch)
    with torch.no_grad():
        got = model(_t(img))
    assert calls == [1]
    _close(got, want, "fused ViT")


def test_fused_vit_matches_module_loop(vit_models, monkeypatch):
    _, _, model, img = vit_models
    with torch.no_grad():
        plain = model(_t(img))
        monkeypatch.setattr(vb, "FUSED_MODE", "force")
        fused = model(_t(img))
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), rtol=2e-5, atol=2e-5)


class TestGate:
    """Which path the port's ViT takes on the CPU."""

    @pytest.mark.parametrize("mode,fused", [("auto", False), ("force", True), ("off", False)])
    def test_modes(self, vit_models, monkeypatch, mode, fused):
        model, img = vit_models[2], vit_models[3]
        monkeypatch.setattr(vb, "FUSED_MODE", mode)
        calls = _count_fused(monkeypatch)
        with torch.no_grad():
            out = model(_t(img))
        assert len(calls) == int(fused)
        assert out.shape == (2, 10, EMBED)

    def test_unknown_mode_raises(self, vit_models, monkeypatch):
        monkeypatch.setattr(vb, "FUSED_MODE", "always")
        with pytest.raises(ValueError), torch.no_grad():
            vit_models[2](_t(vit_models[3]))

    def test_incapable_config_runs_the_module_loop(self, monkeypatch):
        """Head width 16: no attention kernel takes it."""
        model = init_weights(vit.VisionTransformer(32, 16, 64, 1, 4), torch.Generator())
        monkeypatch.setattr(vb, "FUSED_MODE", "force")
        calls = _count_fused(monkeypatch)
        with torch.no_grad():
            model(torch.zeros(1, 32, 32, 3))
        assert calls == []

    def test_kernel_conditions(self):
        gate = vb.fused_vit_capable
        assert gate(768, 12) and gate(1024, 16) and gate(EMBED, HEADS)
        # the TPU's embed_dim % 128 is gone
        assert gate(192, 3) and not jvb.fused_vit_capable(192, 3)
        assert not gate(64, 4)  # head width 16
        assert not gate(768, 7)  # ragged heads
        assert not gate(768, 12, mlp_dim=3070)  # MLP rows of 16 bytes


# ------------------------------------------------------------ the bias repair

def _capture(calls):
    def block(x, *args, **kw):
        calls.append(args)
        return x
    return block


def test_fused_vit_reads_f32_biases(vit_models):
    """After ``set_compute_dtype``, the fused ViT hands its kernels the f32
    parameters bit for bit (flax keeps them in f32)."""
    _, variables, model, _ = vit_models
    model = set_compute_dtype(load_jax_variables(
        vit.VisionTransformer(IMG, 16, EMBED, DEPTH, HEADS), variables), torch.bfloat16)
    calls = []
    with torch.no_grad():
        vb.fused_vit_blocks(model, torch.zeros(1, 10, EMBED, dtype=torch.bfloat16),
                            block=_capture(calls))
    assert len(calls) == DEPTH
    for i, args in enumerate(calls):
        p = variables["params"][f"blocks_{i}"]
        want = [p["attn"]["qkv"]["bias"], p["attn"]["proj"]["bias"], p["norm1"]["scale"],
                p["norm1"]["bias"], p["mlp"]["fc1"]["bias"], p["mlp"]["fc2"]["bias"],
                p["norm2"]["scale"], p["norm2"]["bias"]]
        got = [args[i] for i in (1, 3, 4, 5, 7, 9, 10, 11)]
        for a, b in zip(got, want):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b, np.float32))
        assert all(args[i].dtype == torch.bfloat16 for i in (0, 2, 6, 8))


def test_fused_decoder_reads_f32_biases():
    rng = np.random.RandomState(3)
    ids, mask, labels, qs, qmask = _answers(rng)
    jmodel = jmed.BertLMHeadModel(SCORING_CFG)
    variables = _perturbed(jmodel.init(jax.random.PRNGKey(4), *map(jnp.asarray, (ids, mask, qs,
                                                                                   qmask)),
                                       labels=jnp.asarray(labels), deterministic=True), rng)
    model = set_compute_dtype(load_jax_variables(
        med.BertLMHeadModel(_port_cfg(med.MedConfig, SCORING_CFG)), variables), torch.bfloat16)
    calls = []

    def layer(x, *args, **kw):
        calls.append(args)
        return x

    emb = torch.zeros(*ids.shape, 128, dtype=torch.bfloat16)
    with torch.no_grad():
        scoring_layer.scoring_decoder_body(model.bert.encoder, emb, _t(qs), _t(qmask),
                                           config=model.config, layer=layer)
    assert len(calls) == SCORING_CFG.num_hidden_layers
    enc = variables["params"]["bert"]["encoder"]
    for i, args in enumerate(calls):
        lp = enc[f"layer_{i}"]
        a, ca = lp["attention"]["self"], lp["crossattention"]["self"]
        want = [np.concatenate([a[k]["bias"] for k in ("query", "key", "value")]),
                lp["attention"]["output"]["dense"]["bias"], ca["query"]["bias"],
                lp["crossattention"]["output"]["dense"]["bias"],
                lp["intermediate_dense"]["bias"], lp["output_dense"]["bias"]]
        for a_, b_ in zip([args[i] for i in (1, 3, 7, 9, 13, 15)], want):
            assert a_.dtype == torch.float32
            np.testing.assert_array_equal(a_.detach().numpy(), np.asarray(b_, np.float32))


def test_module_path_adds_the_rounded_bias():
    """The module path's products are unchanged by the repair: the bias is
    rounded to the compute dtype once and added as before."""
    gen = torch.Generator().manual_seed(0)
    dense = Dense(64, 24)
    model = vit.VisionTransformer(32, 16, 64, 1, 4)
    init_weights(model, gen)
    with torch.no_grad():
        for m in (dense, model.patch_embed_proj):
            m.bias.normal_(generator=gen)
        bias32 = dense.bias.detach().clone()
        set_compute_dtype(dense, torch.bfloat16)
        set_compute_dtype(model, torch.bfloat16)
        x = torch.randn(5, 64, generator=gen)
        assert dense.bias.dtype == torch.float32 and torch.equal(dense.bias, bias32)
        want = F.linear(x.bfloat16(), dense.weight, bias32.bfloat16())
        assert torch.equal(dense(x), want)
        pe = model.patch_embed_proj
        img = torch.rand(1, 32, 32, 3, generator=gen)
        patches = img.bfloat16().reshape(1, 2, 16, 2, 16, 3).permute(0, 1, 3, 5, 2, 4)
        want = F.linear(patches.reshape(1, 4, -1), pe.weight.reshape(64, -1), pe.bias.bfloat16())
        assert torch.equal(pe(img), want)


# ------------------------------------------------------------ the gather

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_rows_matches_take_along_axis(dtype):
    rng = np.random.RandomState(5)
    table = rng.randn(3, 50, 7).astype(np.float32)
    idx = rng.randint(0, 50, (3, 37))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jnp.take_along_axis(jnp.asarray(table).astype(jdt), jnp.asarray(idx)[..., None], axis=1)
    got = gather.gather_rows(_t(table).to(dtype), _t(idx))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    # one table
    np.testing.assert_array_equal(gather.gather_rows(_t(table[1]), _t(idx[1])).numpy(),
                                  table[1][idx[1]])


@pytest.mark.parametrize("dtype,n,c,r", [(torch.float32, 300, 131, 777),
                                         (torch.bfloat16, 500, 4, 1000)])
def test_gather_rows_matches_pallas(dtype, n, c, r):
    """Both JAX row-gather kernels, in the TPU interpret mode: the row copy
    exactly, the one-hot product within its ~17 bits in f32."""
    rng = np.random.RandomState(n)
    table = rng.rand(n, c).astype(np.float32)
    idx = rng.randint(0, n, r).astype(np.int32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jt = jnp.asarray(table).astype(jdt)
    with pltpu.force_tpu_interpret_mode():
        row = np.asarray(jgather._gather_rows_one(jt, jnp.asarray(idx)).astype(jnp.float32))
        onehot = np.asarray(jgather._gather_rows_onehot(jt, jnp.asarray(idx)).astype(jnp.float32))
    got = gather.gather_rows(_t(table).to(dtype), _t(idx)).float().numpy()
    np.testing.assert_array_equal(got, row)
    np.testing.assert_allclose(got, onehot, rtol=1e-5, atol=0)


def test_gather_rows_refuses_bad_shapes():
    with pytest.raises(ValueError):
        gather.gather_rows(torch.zeros(2, 5, 3), torch.zeros(3, 4, dtype=torch.int64))
    with pytest.raises(ValueError):
        gather.gather_rows(torch.zeros(5, 3), torch.zeros(2, 4, dtype=torch.int64))
