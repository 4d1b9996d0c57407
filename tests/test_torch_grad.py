"""Gradients through the port on the CPU: which paths run where a gradient
is wanted, and what the compute-dtype layout gives autograd.

- The fused paths have no backward: the ViT gate and the scoring gate
  refuse them under grad (JAX's ``not deterministic``) and with ``remat``,
  and a kernel wrapper refuses an input that wants a gradient.
- ``set_compute_dtype`` keeps every parameter in f32 and makes
  compute-dtype copies once: a bf16 ``Dense`` and ``PatchEmbed`` under grad
  give the f32 weight and bias the gradients ``jax.grad`` gives the flax
  module with ``dtype=bfloat16, param_dtype=float32``, and without grad the
  tiny rank forward is bit for bit what bf16 parameters gave.
- FPS: the picked coordinates take the cotangent scatter of JAX's
  ``_fps_pallas_bwd``.

Tolerances: the gradients of the bf16 products within one bf16 step of the
largest gradient (2^-7 of it: both sides accumulate in f32 and round the
result to bf16 once, in another summation order); the FPS scatter within
1e-6 (repeated picks sum their cotangents in another order).
"""

import copy
import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridgeqa_tpu.ops import sampling as jsampling
from bridgeqa_tpu_torch.models import blip_vqa3d, bridgeqa, med
from bridgeqa_tpu_torch.models.layers import (
    Dense,
    Embed,
    PatchEmbed,
    init_weights,
    set_compute_dtype,
)
from bridgeqa_tpu_torch.ops import cuda_lib, sampling
from bridgeqa_tpu_torch.ops import vit_block as vb
from tests.test_torch_bridgeqa import _qa_batch
from tests.test_torch_scoring import CFG, _answers

CARD = torch.device("cuda")


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------ C1: the gates

@pytest.mark.parametrize("mode", ["auto", "force"])
def test_vit_gate_refuses_grad(monkeypatch, mode):
    monkeypatch.setattr(vb, "FUSED_MODE", mode)
    with torch.enable_grad():
        assert not vb.use_fused(768, 12, 3072, CARD)
    with torch.no_grad():
        assert vb.use_fused(768, 12, 3072, CARD)
    with torch.inference_mode():
        assert vb.use_fused(768, 12, 3072, CARD)


def _scoring_call(grad: bool, **cfg):
    config = dataclasses.replace(med.MedConfig(**{f.name: getattr(CFG, f.name)
                                                  for f in dataclasses.fields(CFG)}),
                                 fused_scoring="force", **cfg)
    model = init_weights(med.BertLMHeadModel(config), torch.Generator().manual_seed(0))
    ids, _, labels, qs, qmask = map(_t, _answers(np.random.RandomState(9), q=2, g=8))
    with torch.set_grad_enabled(grad):
        return model._fused_scoring_loss(ids, qs, qmask, labels)


@pytest.mark.parametrize("grad,cfg,fused", [(False, {}, True), (True, {}, False),
                                            (False, {"remat": True}, False)])
def test_scoring_gate_refuses_grad_and_remat(grad, cfg, fused):
    """"force" takes the fused path on the CPU only without grad and
    without remat."""
    out = _scoring_call(grad, **cfg)
    assert (out is not None) == fused


def test_refuse_grad():
    t = torch.zeros(3, requires_grad=True)
    with torch.enable_grad(), pytest.raises(RuntimeError, match="no backward"):
        cuda_lib.refuse_grad("k", torch.zeros(2), t)
    with torch.no_grad():
        cuda_lib.refuse_grad("k", t)
    cuda_lib.refuse_grad("k", torch.zeros(2), None)


# ------------------------------------------------------------ C2: the layout

def _tiny_config(fused: str):
    m = med.MedConfig(vocab_size=120, hidden_size=128, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=256, max_position_embeddings=64,
                      encoder_width=128, fused_scoring=fused)
    b = blip_vqa3d.BlipVQA3DConfig(med=m, image_size=32, num_answers=30, scene_size=32,
                                   bos_token_id=110, vit="custom", vit_custom_embed_dim=128,
                                   vit_custom_depth=1, vit_custom_heads=2)
    return bridgeqa.BridgeQAConfig(num_answers=30, num_proposal=32, hidden_size=32, blip=b,
                                   mcan_num_layers=1, mcan_flat_out_size=64,
                                   mcan_flat_mlp_size=32, input_feature_dim=1)


def _tiny_model(fused: str = "auto"):
    gen = torch.Generator().manual_seed(4)
    model = init_weights(bridgeqa.BridgeQA(_tiny_config(fused), device="cpu"), gen).eval()
    with torch.no_grad():  # biases away from 0, so a dropped or stale one shows
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.add_(torch.randn(p.shape, generator=gen) * 0.1)
    return model


CAST = (Dense, Embed, PatchEmbed)


def test_compute_dtype_keeps_f32_parameters():
    model = _tiny_model()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    set_compute_dtype(model, torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    # the state dict holds the same names and values as before
    assert model.state_dict().keys() == state.keys()
    assert all(torch.equal(model.state_dict()[k], v) for k, v in state.items())
    casts = [m for m in model.modules() if isinstance(m, CAST)]
    assert casts
    for m in casts:
        assert m.weight_cast.dtype == torch.bfloat16
        assert torch.equal(m.weight_cast, m.weight.detach().bfloat16())
        bias = getattr(m, "bias", None)
        if bias is not None:
            assert torch.equal(m.bias_cast, bias.detach().bfloat16())
    set_compute_dtype(model, torch.float32)  # back: no copies
    assert all(m.weight_cast is None and m.bias_cast is None for m in casts)


def _old_layout(model):
    """The layout ``set_compute_dtype`` made before f32 master parameters:
    bf16 matrix weights as parameters, f32 biases with a bf16 copy."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, CAST):
                m.weight.data = m.weight.data.bfloat16()
                bias = getattr(m, "bias", None)
                if bias is not None:
                    m.bias_cast = bias.detach().bfloat16()
    return model


@pytest.mark.parametrize("fused", ["auto", "force"])
def test_rank_forward_bitwise_as_bf16_parameters(monkeypatch, fused):
    """The tiny rank forward without grad, on the module paths ("auto" on
    the CPU) and on both fused paths ("force")."""
    monkeypatch.setattr(vb, "FUSED_MODE", fused)
    model = _tiny_model(fused)
    old = _old_layout(copy.deepcopy(model))
    set_compute_dtype(model, torch.bfloat16)
    batch = {k: _t(v) for k, v in _qa_batch(np.random.RandomState(7)).items()}
    with torch.no_grad():
        got = model(batch, inference="rank", k_test=8)
        want = old(batch, inference="rank", k_test=8)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _flax_grads(module, x, cot):
    variables = module.init(jax.random.PRNGKey(0), x)
    params = jax.tree_util.tree_map(
        lambda v: jnp.asarray(np.random.RandomState(v.size).randn(*v.shape) * 0.1, jnp.float32),
        variables["params"])

    def loss(p):
        return jnp.sum(module.apply({"params": p}, x).astype(jnp.float32) * cot)

    return params, jax.grad(loss)(params)


def _close_bf16_grad(got, want, what):
    want = np.asarray(want, np.float32)
    tol = 2.0**-7 * float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0, err_msg=what)


def test_bf16_dense_gradients_match_flax():
    rng = np.random.RandomState(1)
    x = rng.randn(6, 40).astype(np.float32)
    cot = rng.randn(6, 24).astype(np.float32)
    params, grads = _flax_grads(nn.Dense(24, dtype=jnp.bfloat16, param_dtype=jnp.float32),
                                jnp.asarray(x), jnp.asarray(cot))
    dense = Dense(40, 24)
    with torch.no_grad():
        dense.weight.copy_(_t(np.asarray(params["kernel"]).T))
        dense.bias.copy_(_t(np.asarray(params["bias"])))
    set_compute_dtype(dense, torch.bfloat16)
    with torch.enable_grad():
        y = dense(_t(x))
        assert y.dtype == torch.bfloat16
        (y.float() * _t(cot)).sum().backward()
    assert dense.weight.grad.dtype == torch.float32 and dense.bias.grad.dtype == torch.float32
    _close_bf16_grad(dense.weight.grad.T, grads["kernel"], "kernel")
    _close_bf16_grad(dense.bias.grad, grads["bias"], "bias")


def test_bf16_patch_embed_gradients_match_flax():
    rng = np.random.RandomState(2)
    p, c, e = 8, 3, 16
    img = rng.rand(2, 16, 24, c).astype(np.float32)
    cot = rng.randn(2, 2, 3, e).astype(np.float32)
    conv = nn.Conv(e, (p, p), strides=(p, p), padding="VALID", dtype=jnp.bfloat16,
                   param_dtype=jnp.float32)
    params, grads = _flax_grads(conv, jnp.asarray(img), jnp.asarray(cot))
    pe = PatchEmbed(c, e, p)
    with torch.no_grad():  # flax (kh, kw, in, out) -> (out, in, kh, kw)
        pe.weight.copy_(_t(np.asarray(params["kernel"]).transpose(3, 2, 0, 1)))
        pe.bias.copy_(_t(np.asarray(params["bias"])))
    set_compute_dtype(pe, torch.bfloat16)
    with torch.enable_grad():
        y = pe(_t(img))
        (y.float() * _t(cot).reshape(2, 6, e)).sum().backward()
    _close_bf16_grad(pe.weight.grad.permute(2, 3, 1, 0), grads["kernel"], "kernel")
    _close_bf16_grad(pe.bias.grad, grads["bias"], "bias")


# ------------------------------------------------------------ FPS

def test_fps_coordinates_take_the_jax_gradient():
    """Cloud 0 with padding and duplicates, cloud 1 all padding (index 0
    picked every time: its cotangents add up on row 0)."""
    rng = np.random.RandomState(3)
    n, npoint = 300, 40
    xyz = ((rng.rand(2, n, 3) - 0.5) * 2.0).astype(np.float32)
    xyz[0, 250:] = 0.0
    xyz[0, 10:40] = xyz[0, 100:130]
    xyz[1] = 0.0
    g = rng.randn(2, npoint, 3).astype(np.float32)
    t = _t(xyz).requires_grad_()
    with torch.enable_grad():
        idx, coords = sampling.furthest_point_sample_with_xyz(t, npoint)
        (coords * _t(g)).sum().backward()
    jidx, _ = jsampling._fps_pallas_impl(jnp.asarray(xyz), npoint, interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    (want,) = jsampling._fps_pallas_bwd(npoint, (jidx, xyz.shape), (None, jnp.asarray(g)))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), atol=1e-6, rtol=0)
