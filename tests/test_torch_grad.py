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
- Training's parts: ``BatchNorm`` in train mode against flax's with
  ``mutable=["batch_stats"]``; the stripe ball query's backward (the plain
  version against JAX's custom VJP called directly, and autograd of the
  plain forward against ``jax.vjp`` of ``_ball_query_stripes_xla``, all-empty
  balls included: the two JAX paths differ there, each side is held to its
  own); ``dropout`` and ``drop_path``; remat with dropout.

Tolerances: the gradients of the bf16 products within one bf16 step of the
largest gradient (2^-7 of it: both sides accumulate in f32 and round the
result to bf16 once, in another summation order); the FPS scatter and the
ball query's cotangents within 1e-6 (repeated picks sum their cotangents in
another order); BatchNorm within 1e-6 (f32 statistics, reduced in another
order).
"""

import copy
import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridgeqa_tpu.models import layers as jlayers
from bridgeqa_tpu.ops import grouping as jgrouping
from bridgeqa_tpu.ops import sampling as jsampling
from bridgeqa_tpu_torch.models import blip_vqa3d, bridgeqa, med, vit
from bridgeqa_tpu_torch.models.layers import (
    BatchNorm,
    Dense,
    Embed,
    PatchEmbed,
    drop_path,
    dropout,
    dropout_rng,
    init_weights,
    set_compute_dtype,
)
from bridgeqa_tpu_torch.ops import cuda_lib, grouping, sampling
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


def _scoring_call(grad: bool, train: bool = False, **cfg):
    config = dataclasses.replace(med.MedConfig(**{f.name: getattr(CFG, f.name)
                                                  for f in dataclasses.fields(CFG)}),
                                 fused_scoring="force", **cfg)
    model = init_weights(med.BertLMHeadModel(config), torch.Generator().manual_seed(0))
    model.train(train)
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


def test_scoring_gate_refuses_train_mode():
    """Train mode is JAX's ``not deterministic`` too: no fused path even
    without grad."""
    assert _scoring_call(False, train=True) is None


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


# ------------------------------------------------------------ training parts

def test_batchnorm_train_mode_matches_flax():
    """Output and both running statistics after one train-mode call, 1e-6;
    the eval-mode call then reads the updated statistics."""
    rng = np.random.RandomState(3)
    x = (rng.randn(2, 5, 7, 12) * 2 + 0.5).astype(np.float32)
    jbn = jlayers.BatchNorm(12)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    variables = {"params": {"scale": jnp.asarray(rng.rand(12) + 0.5, jnp.float32),
                            "bias": jnp.asarray(rng.randn(12), jnp.float32)},
                 "batch_stats": {"mean": jnp.asarray(rng.randn(12), jnp.float32),
                                 "var": jnp.asarray(rng.rand(12) + 0.5, jnp.float32)}}
    want, mutated = jbn.apply(variables, jnp.asarray(x), train=True, momentum=0.3,
                              mutable=["batch_stats"])
    bn = BatchNorm(12)
    with torch.no_grad():
        bn.weight.copy_(_t(variables["params"]["scale"]))
        bn.bias.copy_(_t(variables["params"]["bias"]))
        bn.running_mean.copy_(_t(variables["batch_stats"]["mean"]))
        bn.running_var.copy_(_t(variables["batch_stats"]["var"]))
    bn.train()
    got = bn(_t(x), 0.3)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(mutated["batch_stats"][key]), rtol=1e-6, atol=1e-6,
                                   err_msg=name)
    bn.eval()
    want_eval = jbn.apply({"params": variables["params"], **mutated}, jnp.asarray(x), train=False)
    np.testing.assert_allclose(bn(_t(x)).detach().numpy(), np.asarray(want_eval), rtol=1e-6,
                               atol=1e-6)


def _stripe_case(n, m, nsample, nf, seed):
    """A cloud with duplicate points and centres, the first four centres far
    from every point (all-empty balls)."""
    rng = np.random.RandomState(seed)
    xyz = ((rng.rand(2, n, 3) - 0.5) * 2.0).astype(np.float32)
    xyz[:, n // 2:n // 2 + 20] = xyz[:, :20]  # duplicates
    ctr = xyz[:, rng.permutation(n)[:m]].copy()
    ctr[:, :4] += 50.0
    feats = rng.rand(2, n, nf).astype(np.float32) if nf else None
    return xyz, ctr, feats


def _within(got, want, name):
    """Within 1e-6 of the largest value: a centre's cotangent sums up to 64
    f32 slots, and a point's those of every slot that picked it, in
    another order on each side."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max(),
                               err_msg=name)


# (n, m, nsample, nf): one pick a stripe, two picks a stripe, with features
STRIPE_CASES = [(4096, 64, 32, 0), (700, 48, 16, 0), (1000, 40, 16, 3), (512, 32, 64, 1)]


@pytest.mark.parametrize("n,m,nsample,nf", STRIPE_CASES)
def test_ball_query_backward_plain_matches_the_jax_vjp(n, m, nsample, nf):
    """The plain backward against ``_ball_query_stripes_bwd`` and
    ``_ball_query_stripes_feats_bwd`` called directly with the same indices
    and cotangents: the all-empty balls' slots (index 0) send their
    cotangents to point 0 and the centre, as the kernel's VJP does."""
    xyz, ctr, feats = _stripe_case(n, m, nsample, nf, seed=n + nf)
    radius = 0.2
    idx, _, _ = grouping.ball_query_stripes_plain(radius, nsample, _t(xyz), _t(ctr),
                                                  None if feats is None else _t(feats))
    assert bool((idx[:, :4] == 0).all())
    rng = np.random.RandomState(1)
    g_rel = rng.randn(2, m, nsample, 3).astype(np.float32)
    g_grouped = rng.randn(2, m, nsample, nf).astype(np.float32) if nf else None
    got = grouping.ball_query_stripes_backward(idx, _t(g_rel),
                                               None if g_grouped is None else _t(g_grouped), n)
    planes = tuple(jnp.asarray(g_rel[..., c]) for c in range(3))
    jidx = jnp.asarray(idx.numpy())
    if nf:
        fplanes = tuple(jnp.asarray(g_grouped[..., c]) for c in range(nf))
        want = jgrouping._ball_query_stripes_feats_bwd(
            radius, nsample, (jidx, xyz.shape, feats.shape), (None, planes, fplanes))
    else:
        want = jgrouping._ball_query_stripes_bwd(radius, nsample, (jidx, xyz.shape),
                                                 (None, planes)) + (None,)
    for g, w, name in zip(got, want, ("g_xyz", "g_center", "g_feats")):
        if w is None:
            assert g is None
            continue
        _within(g, w, name)
    assert float(got[0][:, 0].abs().sum()) > 0  # the empty balls' slots reach point 0


@pytest.mark.parametrize("n,m,nsample,nf", STRIPE_CASES)
def test_ball_query_plain_autograd_matches_jax(n, m, nsample, nf):
    """Autograd through the plain forward (the CPU path) against ``jax.vjp``
    of ``_ball_query_stripes_xla`` (JAX's CPU path): an all-empty ball's
    rel is a constant 0 on both, so its slots take no gradient there."""
    xyz, ctr, feats = _stripe_case(n, m, nsample, nf, seed=n + nf)
    radius = 0.2
    rng = np.random.RandomState(2)
    g_rel = rng.randn(2, m, nsample, 3).astype(np.float32)
    g_grouped = rng.randn(2, m, nsample, nf).astype(np.float32) if nf else None
    inputs = [_t(xyz).requires_grad_(), _t(ctr).requires_grad_()]
    if nf:
        inputs.append(_t(feats).requires_grad_())
    idx, rel, grouped = grouping.ball_query_stripes(radius, nsample, *inputs)
    outs, cots = [rel], [_t(g_rel)]
    if nf:
        outs.append(grouped)
        cots.append(_t(g_grouped))
    got = torch.autograd.grad(outs, inputs, cots)

    def fn(*args):
        out = jgrouping._ball_query_stripes_xla(radius, nsample, *args)
        return out[1:]

    primal, vjp = jax.vjp(fn, *map(jnp.asarray, [xyz, ctr] + ([feats] if nf else [])))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(
        jgrouping._ball_query_stripes_xla(radius, nsample, jnp.asarray(xyz), jnp.asarray(ctr))[0]))
    cot = (tuple(jnp.asarray(g_rel[..., c]) for c in range(3)),)
    if nf:
        cot += (tuple(jnp.asarray(g_grouped[..., c]) for c in range(nf)),)
    want = vjp(cot)
    for g, w, name in zip(got, want, ("xyz", "new_xyz", "feats")):
        _within(g, w, name)
    assert float(got[1][:, :4].abs().max()) == 0.0  # empty balls: no gradient on the CPU path


def test_dropout_and_drop_path():
    """Off in eval mode; in train mode the same generator seed gives the
    same mask, the kept share is 1 - p within 3 sigma, kept values are x /
    (1 - p); drop_path drops whole samples; without a generator, train mode
    raises."""
    x = torch.randn(64, 50, 8) + 3.0
    for fn in (dropout, drop_path):
        assert fn(x, 0.3, False) is x
        assert fn(x, 0.0, True) is x
        with pytest.raises(RuntimeError, match="generator"):
            fn(x, 0.3, True)
    p = 0.3
    with dropout_rng(torch.Generator().manual_seed(5)):
        a = dropout(x, p, True)
    with dropout_rng(torch.Generator().manual_seed(5)):
        b = dropout(x, p, True)
        c = dropout(x, p, True)
    assert torch.equal(a, b) and not torch.equal(b, c)
    kept = a != 0
    n = kept.numel()
    assert abs(kept.float().mean().item() - (1 - p)) <= 3 * (p * (1 - p) / n) ** 0.5
    torch.testing.assert_close(a[kept], x[kept] / (1 - p), rtol=0, atol=0)
    with dropout_rng(torch.Generator().manual_seed(6)):
        d = drop_path(x, 0.5, True)
    per_sample = (d != 0).reshape(64, -1)
    assert bool((per_sample.all(1) | ~per_sample.any(1)).all())
    assert 0 < int(per_sample.all(1).sum()) < 64
    torch.testing.assert_close(d[per_sample.all(1)], x[per_sample.all(1)] / 0.5, rtol=0, atol=0)


def _tiny_blip(remat_mode):
    from tests.test_blip import TINY_CFG

    jcfg = dataclasses.replace(
        TINY_CFG, vit_drop_path_rate=0.2, adapter_pdrop=0.2,
        med=dataclasses.replace(TINY_CFG.med, hidden_dropout_prob=0.2,
                                attention_probs_dropout_prob=0.2, fused_scoring="off"),
        remat=remat_mode is not None, remat_mode=remat_mode or "block")
    cfg = dataclasses.replace(
        _port(blip_vqa3d.BlipVQA3DConfig, jcfg, med=_port(med.MedConfig, jcfg.med)))
    with torch.device("cpu"):
        model = blip_vqa3d.BLIPVQA3D(cfg)
    return init_weights(model, torch.Generator().manual_seed(0)).train()


def _port(cls, jcfg, **nested):
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw.update(nested)
    return cls(**kw)


@pytest.mark.parametrize("remat_mode", ["block", "attn"])
def test_remat_gives_the_same_loss_and_gradients_with_dropout(monkeypatch, remat_mode):
    """JAX's ``tests/test_remat.py`` on the port, with dropout 0.2 and drop
    path 0.2: remat recomputes in the backward (counted), redraws the same
    masks from the explicit generator, and the loss and every gradient equal
    those of the model without remat."""
    rng = np.random.RandomState(0)
    b, lq, la, n_obj = 2, 8, 5, 4
    args = (_t(rng.rand(b, 32, 32, 3).astype(np.float32)), _t(rng.randint(1, 100, (b, lq))),
            torch.ones(b, lq, dtype=torch.int32), _t(rng.randint(1, 100, (b, la))),
            torch.ones(b, la, dtype=torch.int32), _t(rng.rand(b, n_obj, 16).astype(np.float32)),
            torch.ones(b, n_obj, dtype=torch.int32))
    calls = {"n": 0}
    counted = {"block": (vit.Block, "forward"), "attn": (med, "attend")}[remat_mode]
    original = getattr(*counted)

    def counting(*a, **kw):
        calls["n"] += 1
        return original(*a, **kw)

    monkeypatch.setattr(*counted, counting)
    results = []
    for mode in (None, remat_mode):
        model = _tiny_blip(mode)
        with dropout_rng(torch.Generator().manual_seed(11)):
            loss, _, _ = model(*args)
        calls["n"] = 0
        loss.backward()
        results.append((loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()
                                        if p.grad is not None}, calls["n"]))
    (l0, g0, back0), (l1, g1, back1) = results
    assert back0 == 0 and back1 > 0, (back0, back1)  # only remat recomputes
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=0)
    assert g0.keys() == g1.keys()
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], rtol=1e-5, atol=1e-6, msg=name)
