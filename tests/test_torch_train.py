"""The port's training forward, losses and gradients against the JAX
package's ``train_body``, at the tiny config of ``tests/test_torch_bridgeqa.py``
(its backbone cut to 512/256/128/64 points over 1024-point scenes, so that a
file stays within its time on the CPU), every dropout rate 0, BatchNorm in
train mode, float64 on both sides (``jax.enable_x64``, ``model.double()``).

Float64 makes a semantic difference (a missing term, a wrong mask, another
loss composition) stand out by orders of magnitude over rounding, as
``tests/test_golden_training.py`` does against the reference. Both packages
run their point ops in f32 (FPS, the ball query and the distances of the
losses cast to f32), so the sums over those f32 values, taken in another
order, leave about 1e-7 in the losses and about 1e-5 in the deepest
gradients: losses and outputs are held to 1e-5 relative, gradients to 1e-4
relative L2 per tensor.

One more f32 island is JAX's own and is removed here: under x64 the JAX
stripe path's ``PlaneDense`` (SA layer 0) computes in its planes' dtype,
f32 because the ball query emits f32, where flax's ``Dense`` and the port
promote to the f64 parameters. The test casts the planes to f64
(``_plane_dense_f64``), so both sides are f64 there too. In the package's
configurations (f32 parameters, f32 or bf16 compute) the two rules agree.
The weights are the port's initialisers' with every bias and norm
parameter and BatchNorm statistic moved off its initial value, so that no
tensor is 0 throughout.
"""

import copy
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridgeqa_tpu.data.scannet_config import ScannetDatasetConfig
from bridgeqa_tpu.losses import get_loss as jget_loss
from bridgeqa_tpu.models import bridgeqa as jbridgeqa
from bridgeqa_tpu.models import layers as jlayers
from bridgeqa_tpu.ops import grouping as jgrouping
from bridgeqa_tpu_torch.convert import export_jax_variables, load_jax_variables
from bridgeqa_tpu_torch.data import scannet_config
from bridgeqa_tpu_torch.losses import get_loss
from bridgeqa_tpu_torch.models import blip_vqa3d, bridgeqa, med
from bridgeqa_tpu_torch.models.layers import init_weights
from tests.test_torch_bridgeqa import TINY_BLIP, TINY_MED, _port_cfg, _qa_batch

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
NUM_POINTS = 1024
MAX_OBJ = 6
LOSS_KEYS = ("loss", "vote_loss", "objectness_loss", "center_loss", "heading_cls_loss",
             "heading_reg_loss", "size_cls_loss", "size_reg_loss", "sem_cls_loss", "box_loss",
             "ref_loss", "lang_loss", "answer_loss", "pos_ratio", "neg_ratio")
# what get_loss adds beside the losses
LABEL_KEYS = ("objectness_label", "objectness_mask", "object_assignment", "cluster_labels")
OUTPUT_KEYS = ("decoder_loss", "lang_scores", "cluster_ref", "center", "vote_xyz",
               "aggregated_vote_features", "objectness_scores", "bbox_corner")


def jax_train_config(**kw):
    med_cfg = dataclasses.replace(TINY_MED, hidden_dropout_prob=0.0,
                                  attention_probs_dropout_prob=0.0)
    blip_cfg = dataclasses.replace(TINY_BLIP, med=med_cfg, adapter_pdrop=0.0)
    return jbridgeqa.BridgeQAConfig(
        num_answers=30, num_proposal=32, hidden_size=32, blip=blip_cfg, mcan_num_layers=1,
        mcan_flat_out_size=64, mcan_flat_mlp_size=32, input_feature_dim=1,
        backbone_sa_npoints=(512, 256, 128, 64), head_pdrop=0.0, mcan_pdrop=0.0, **kw)


def port_config(jcfg):
    return _port_cfg(bridgeqa.BridgeQAConfig, jcfg,
                     blip=_port_cfg(blip_vqa3d.BlipVQA3DConfig, jcfg.blip,
                                    med=_port_cfg(med.MedConfig, jcfg.blip.med)))


def perturbed_model(cfg, seed: int = 0) -> bridgeqa.BridgeQA:
    """The port's initialisers, then every bias, norm scale and shift and
    BatchNorm statistic moved off its initial value (as
    ``tests/test_golden_training.py`` sets the statistics)."""
    model = bridgeqa.BridgeQA(cfg, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    init_weights(model, gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("bias", "b_2")):
                p.add_(torch.randn(p.shape, generator=gen) * 0.05)
            elif name.endswith(("LayerNorm.weight", "norm.weight", "norm1.weight",
                                "norm2.weight", "a_2")) or ".bn" in name:
                p.add_(torch.randn(p.shape, generator=gen) * 0.1)
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.normal_(0.0, 0.3, generator=gen)
            elif name.endswith("running_var"):
                b.uniform_(0.5, 2.0, generator=gen)
    return model


def train_batch(seed: int = 7, b: int = 2) -> dict:
    """The tiny rank batch with answers and the detection, grounding and
    language labels ``get_loss`` reads (float64)."""
    rng = np.random.RandomState(seed)
    batch = _qa_batch(rng, b=b, num_points=NUM_POINTS)
    answer_ids = rng.randint(1, 100, (b, 5))
    answer_ids[:, 0] = 110
    answer_ids[1, 3:] = 0  # padding: ignored labels
    batch.update(
        answer_ids=answer_ids,
        answer_mask=(answer_ids != 0).astype(np.int32),
        answer_cat_scores=rng.rand(b, 30),
        vote_label=(rng.rand(b, NUM_POINTS, 9) - 0.5) * 0.6,
        vote_label_mask=(rng.rand(b, NUM_POINTS) > 0.5).astype(np.int32),
        center_label=np.concatenate([(rng.rand(b, MAX_OBJ, 3) - 0.5) * 4.0,
                                     np.zeros((b, MAX_OBJ, 1))], axis=-1),
        box_label_mask=(rng.rand(b, MAX_OBJ) > 0.3).astype(np.float64),
        heading_class_label=np.zeros((b, MAX_OBJ), np.int32),
        heading_residual_label=np.zeros((b, MAX_OBJ)),
        size_class_label=rng.randint(0, 18, (b, MAX_OBJ)).astype(np.int32),
        size_residual_label=rng.randn(b, MAX_OBJ, 3) * 0.1,
        sem_cls_label=rng.randint(0, 18, (b, MAX_OBJ)).astype(np.int32),
        ref_center_label=(rng.rand(b, 3) - 0.5) * 4.0,
        ref_heading_class_label=np.zeros((b,), np.int32),
        ref_heading_residual_label=np.zeros((b,)),
        ref_size_class_label=rng.randint(0, 18, (b,)).astype(np.int32),
        ref_size_residual_label=rng.randn(b, 3) * 0.1,
        ref_obj_mask=np.ones((b,)),
        object_cat=rng.randint(0, 18, (b,)).astype(np.int32),
    )
    return {k: v.astype(np.float64) if v.dtype.kind == "f" else v for k, v in batch.items()}


_plane_dense_call = jlayers.PlaneDense.__call__


def _plane_dense_f64(self, planes, x=None):
    """``PlaneDense`` with its planes promoted like flax's ``Dense`` does
    its input (see the module docstring)."""
    planes = tuple(p.astype(jnp.promote_types(p.dtype, jnp.float64)) for p in planes)
    return _plane_dense_call(self, planes, x)


@pytest.fixture(scope="module")
def jax_x64():
    """x64 JAX with the stripe ball query (what the JAX package runs on its
    chip) and ``PlaneDense`` in f64, for everything traced inside."""
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgrouping, "FORCE_MODE", "stripes")
        mp.setattr(jlayers.PlaneDense, "__call__", _plane_dense_f64)
        yield


def jax_loss_fn(jmodel, dc):
    """``train_body``'s loss function (``bridgeqa_tpu/train/step.py``),
    returning the end points and the updated statistics beside the loss."""

    def loss_fn(params, batch_stats, batch, bn_momentum):
        out, mutated = jmodel.apply({"params": params, "batch_stats": batch_stats}, batch,
                                    train=True, bn_momentum=bn_momentum,
                                    mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(2)})
        end_points = dict(batch)
        end_points.update(out)
        loss, end_points = jget_loss(end_points, dc, detection=True, use_reference=True,
                                     use_lang_classifier=True, use_answer=True)
        return loss, (end_points, mutated["batch_stats"])

    return loss_fn


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _lookup(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def rel_l2(got, want) -> float:
    return float(np.linalg.norm(np.asarray(got, np.float64) - np.asarray(want, np.float64))
                 / (np.linalg.norm(np.asarray(want, np.float64)) + 1e-300))


def grad_tree(model) -> dict:
    """The gradients of ``model``'s parameters in the flax layout (zeros
    where a parameter got none)."""
    shadow = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(model.parameters(), shadow.parameters()):
            q.copy_(p.grad if p.grad is not None else torch.zeros_like(p))
    return export_jax_variables(shadow)["params"]


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


@pytest.fixture(scope="module")
def train_pair(jax_x64):
    """One training forward, get_loss and backward on both sides, same f64
    weights and batch, BN momentum 0.1."""
    jcfg = jax_train_config()
    dc = ScannetDatasetConfig()
    model = perturbed_model(port_config(jcfg)).double()
    variables = export_jax_variables(model)
    batch = train_batch()
    jmodel = jbridgeqa.BridgeQA(jcfg, mean_size_arr=dc.mean_size_arr)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, (jend, jstats)), jgrads = jax.jit(
        jax.value_and_grad(jax_loss_fn(jmodel, dc), has_aux=True))(
        variables["params"], variables["batch_stats"], jbatch, 0.1)

    model.train()
    out = model({k: _t(v) for k, v in batch.items()}, inference="loss", bn_momentum=0.1)
    end = {k: _t(v) for k, v in batch.items()}
    end.update(out)
    loss, end = get_loss(end, scannet_config.ScannetDatasetConfig(), use_lang_classifier=True)
    loss.backward()
    return types.SimpleNamespace(
        jcfg=jcfg, dc=dc, model=model, variables=variables, batch=batch, jmodel=jmodel,
        jloss=float(jloss), jend=_np_tree(jend), jstats=_np_tree(jstats),
        jgrads=_np_tree(jgrads), loss=loss, end=end)


def test_training_losses_and_outputs_match_jax(train_pair):
    """Every loss and metric get_loss writes, its labels and assignments,
    and the training forward's outputs, within 1e-5."""
    p = train_pair
    np.testing.assert_allclose(float(p.loss.detach()), p.jloss, rtol=LOSS_RTOL)
    for key in LOSS_KEYS:
        np.testing.assert_allclose(float(p.end[key].detach()), float(p.jend[key]), rtol=LOSS_RTOL,
                                   atol=1e-12, err_msg=key)
    for key in LABEL_KEYS:
        np.testing.assert_array_equal(p.end[key].detach().numpy(), p.jend[key], err_msg=key)
    for key in OUTPUT_KEYS:
        want = p.jend[key]
        got = p.end[key].detach().numpy()
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL,
                                   atol=LOSS_RTOL * float(np.abs(want).max()), err_msg=key)
    for key in ("sa1_inds", "sa2_inds", "seed_inds", "aggregated_vote_inds"):
        np.testing.assert_array_equal(p.end[key].numpy(), p.jend[key], err_msg=key)


def test_gradients_match_jax(train_pair):
    """dLoss/dtheta of every parameter against ``jax.grad`` of train_body's
    loss: 1e-4 relative L2 per tensor. A tensor whose gradient is zero up to
    rounding on both sides (the attention key biases: softmax ignores a
    constant shift per query) counts as agreeing, as in
    ``tests/test_golden_training.py``."""
    p = train_pair
    ours = grad_tree(p.model)
    checked, failures, worst = 0, [], []
    for path, want in _leaves(p.jgrads):
        got = _lookup(ours, path)
        assert got.shape == want.shape, path
        checked += 1
        if np.linalg.norm(want) < 1e-10 and np.linalg.norm(got) < 1e-10:
            continue
        rel = rel_l2(got, want)
        worst.append((rel, "/".join(path)))
        if rel > GRAD_RTOL:
            failures.append(f"{'/'.join(path)}: rel L2 {rel:.2e}")
    worst.sort(reverse=True)
    print("worst gradients:", worst[:5])
    assert checked == len(list(p.model.parameters()))
    assert not failures, failures[:20]


def test_batch_statistics_after_the_forward_match_jax(train_pair):
    """Each running mean and variance after the train-mode forward (momentum
    0.1, the unbiased batch variance) within 1e-6 relative L2."""
    ours = export_jax_variables(train_pair.model)["batch_stats"]
    paths = list(_leaves(train_pair.jstats))
    assert len(paths) == 2 * sum(1 for n, _ in train_pair.model.named_buffers()
                                 if n.endswith("running_mean"))
    for path, want in paths:
        assert rel_l2(_lookup(ours, path), want) < 1e-6, path


def test_loss_inference_matches_jax(train_pair, jax_x64):
    """``inference="loss"`` in eval mode (running statistics, no dropout):
    the decoders' loss, the ground-truth answer scores and both heads within
    1e-5 of JAX's ``apply(train=False, inference="loss")``."""
    p = train_pair
    model = perturbed_model(port_config(p.jcfg)).double()
    variables = export_jax_variables(model)
    jout = jax.jit(functools.partial(p.jmodel.apply, train=False, inference="loss"))(
        variables, {k: jnp.asarray(v) for k, v in p.batch.items()})
    model.eval()
    with torch.no_grad():
        out = model({k: _t(v) for k, v in p.batch.items()}, inference="loss")
    for key in ("decoder_loss", "answer_scores", "lang_scores", "cluster_ref", "center"):
        want = np.asarray(jout[key])
        np.testing.assert_allclose(out[key].numpy(), want, rtol=LOSS_RTOL,
                                   atol=LOSS_RTOL * float(np.abs(want).max()), err_msg=key)


def test_det_stage_matches_jax(train_pair, jax_x64):
    """``stage="DET"`` builds the detector alone and returns after it; in
    train mode its outputs and updated statistics within 1e-5 of JAX's."""
    p = train_pair
    jcfg = dataclasses.replace(p.jcfg, stage="DET")
    model = bridgeqa.BridgeQA(port_config(jcfg), device="cpu").double()
    variables = {c: {"detector": p.variables[c]["detector"]} for c in ("params", "batch_stats")}
    load_jax_variables(model, variables)
    assert not hasattr(model, "blip_model")
    jmodel = jbridgeqa.BridgeQA(jcfg, mean_size_arr=p.dc.mean_size_arr)
    pc = p.batch["point_clouds"]
    jout, mutated = jax.jit(functools.partial(jmodel.apply, train=True, bn_momentum=0.3,
                                              mutable=["batch_stats"]))(
        variables, {"point_clouds": jnp.asarray(pc)})
    model.train()
    out = model({"point_clouds": _t(pc)}, bn_momentum=0.3)
    assert set(out) == set(jout)
    for key, want in jout.items():
        want = np.asarray(want)
        got = out[key].detach().numpy()
        if want.dtype.kind in "iu" or key == "bbox_mask":
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            np.testing.assert_allclose(got, want, rtol=LOSS_RTOL,
                                       atol=LOSS_RTOL * float(np.abs(want).max()), err_msg=key)
    stats = export_jax_variables(model)["batch_stats"]
    for path, want in _leaves(_np_tree(mutated["batch_stats"])):
        assert rel_l2(_lookup(stats, path), want) < 1e-6, path
