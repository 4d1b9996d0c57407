"""The port's geometry (``nn_distance``, ``huber_loss``, the box IoUs) and
every detection loss against the JAX package's, on the same numpy inputs
made from a seed, in f32 on the CPU: 1e-5 (relative, and absolute on values
near 0), indices and labels exact. Both sides compute in f32 and reduce in
another order."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridgeqa_tpu.geometry import boxes as jboxes
from bridgeqa_tpu.geometry.nn_distance import huber_loss as jhuber_loss
from bridgeqa_tpu.geometry.nn_distance import nn_distance as jnn_distance
from bridgeqa_tpu.losses import detection as jdet
from bridgeqa_tpu_torch.geometry import boxes, nn_distance
from bridgeqa_tpu_torch.losses import detection

TOL = 1e-5
B, S, K, M, NS = 2, 24, 16, 5, 18


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _close(got, want, what=""):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=what)


def _rotated_corners(rng, n, spread=1.0, angle=True):
    """Boxes of random size and heading about random centres, as corners."""
    size = rng.rand(n, 3).astype(np.float32) + 0.2
    heading = ((rng.rand(n) - 0.5) * 2 * np.pi).astype(np.float32) if angle else \
        np.zeros(n, np.float32)
    centre = ((rng.rand(n, 3) - 0.5) * spread).astype(np.float32)
    return np.array(jboxes.get_3d_box_batch(jnp.asarray(size), jnp.asarray(heading),
                                              jnp.asarray(centre)))


@pytest.mark.parametrize("mode", ["l2", "l1", "l1smooth"])
def test_nn_distance_matches_jax(mode):
    rng = np.random.RandomState(0)
    a = rng.randn(B, 40, 3).astype(np.float32)
    b = rng.randn(B, 30, 3).astype(np.float32)
    kw = {"l1": dict(l1=True), "l1smooth": dict(l1smooth=True, delta=0.5), "l2": {}}[mode]
    want = jnn_distance(jnp.asarray(a), jnp.asarray(b), **kw)
    got = nn_distance.nn_distance(_t(a), _t(b), **kw)
    for g, w, name in zip(got, want, ("dist1", "idx1", "dist2", "idx2")):
        _close(g, w, name)
    x = rng.randn(50).astype(np.float32) * 3
    _close(nn_distance.huber_loss(_t(x), 1.5), jhuber_loss(jnp.asarray(x), 1.5), "huber")


def test_axis_aligned_box_functions_match_jax():
    rng = np.random.RandomState(1)
    c1 = _rotated_corners(rng, 64, angle=False)
    c2 = _rotated_corners(rng, 64, angle=False)
    c2[:8] = c1[:8]  # identical boxes: IoU 1
    for g, w in zip(boxes.box3d_min_max(_t(c1)), jboxes.box3d_min_max(jnp.asarray(c1))):
        _close(g, w, "min_max")
    want = jboxes.box3d_iou_batch(jnp.asarray(c1), jnp.asarray(c2))
    _close(boxes.box3d_iou_batch(_t(c1), _t(c2)), want, "iou_batch")
    assert (np.asarray(want) > 0).sum() > 16 and np.allclose(np.asarray(want)[:8], 1.0)
    _close(boxes.box3d_iou_auto(_t(c1), _t(c2), num_heading_bin=1),
           jboxes.box3d_iou_auto(jnp.asarray(c1), jnp.asarray(c2), num_heading_bin=1), "auto 1")
    mn1, mx1 = c1.min(1), c1.max(1)
    mn2, mx2 = c2.min(1), c2.max(1)
    _close(boxes.aabb_iou(*map(_t, (mn1, mx1, mn2, mx2))),
           jboxes.aabb_iou(*map(jnp.asarray, (mn1, mx1, mn2, mx2))), "aabb")


def test_oriented_box_functions_match_jax():
    """Rotated boxes: overlapping, identical, disjoint and one inside the
    other, broadcast over a (proposals, reference box) grid. (Identical and
    nested boxes need not read their true IoU: vertices on a clip edge fail
    the reference clipping's strict inside test. The port keeps the JAX
    values, edge cases included.)"""
    rng = np.random.RandomState(2)
    c1 = _rotated_corners(rng, 48, spread=0.3)
    c2 = _rotated_corners(rng, 48, spread=0.3)
    c2[:4] = c1[:4]  # identical
    c2[4:8] = c1[4:8] + np.float32(10.0)  # disjoint
    c2[8:12] = (c1[8:12] - c1[8:12].mean(1, keepdims=True)) * np.float32(0.5) \
        + c1[8:12].mean(1, keepdims=True)  # nested
    want = np.asarray(jboxes.box3d_iou_oriented(jnp.asarray(c1), jnp.asarray(c2)))
    _close(boxes.box3d_iou_oriented(_t(c1), _t(c2)), want, "oriented")
    assert np.all(want[4:8] == 0)
    assert ((want > 0) & (want < 1)).sum() > 10
    grid1, grid2 = c1[:12].reshape(3, 4, 8, 3), c2[:1][:, None]
    _close(boxes.box3d_iou_oriented(_t(grid1), _t(grid2)),
           jboxes.box3d_iou_oriented(jnp.asarray(grid1), jnp.asarray(grid2)), "broadcast")
    _close(boxes.box3d_iou_auto(_t(c1), _t(c2), num_heading_bin=12),
           jboxes.box3d_iou_auto(jnp.asarray(c1), jnp.asarray(c2), num_heading_bin=12), "auto 12")
    # the clipped footprints alone, quads counter-clockwise in (x, y)
    r1, r2 = c1[:, [3, 2, 1, 0], :2], c2[:, [3, 2, 1, 0], :2]
    want_area = jax.jit(jax.vmap(jboxes._clip_polygon_area))(jnp.asarray(r1), jnp.asarray(r2))
    _close(boxes._clip_polygon_area(_t(r1), _t(r2)), want_area, "clip area")


def _end_points(seed: int = 3, nh: int = 1):
    """Random detector outputs and labels of the shapes get_loss reads."""
    rng = np.random.RandomState(seed)
    f = np.float32
    seed_xyz = (rng.rand(B, S, 3) * 2 - 1).astype(f)
    centers = (rng.rand(B, M, 3) * 2 - 1).astype(f)
    agg = np.concatenate([centers + rng.randn(B, M, 3).astype(f) * 0.05,
                          (rng.rand(B, K - M, 3) * 2 - 1).astype(f)], axis=1)
    ep = dict(
        seed_xyz=seed_xyz,
        seed_inds=rng.randint(0, 100, (B, S)).astype(np.int32),
        vote_xyz=seed_xyz + rng.randn(B, S, 3).astype(f) * 0.1,
        vote_label=(rng.randn(B, 100, 9) * 0.2).astype(f),
        vote_label_mask=(rng.rand(B, 100) > 0.4).astype(np.int32),
        aggregated_vote_xyz=agg,
        center=agg + rng.randn(B, K, 3).astype(f) * 0.05,
        center_label=np.concatenate([centers, np.zeros((B, M, 1), f)], -1),
        box_label_mask=(rng.rand(B, M) > 0.2).astype(f),
        objectness_scores=rng.randn(B, K, 2).astype(f),
        heading_scores=rng.randn(B, K, nh).astype(f),
        heading_residuals_normalized=rng.randn(B, K, nh).astype(f),
        heading_class_label=rng.randint(0, nh, (B, M)).astype(np.int32),
        heading_residual_label=(rng.randn(B, M) * 0.1).astype(f),
        size_scores=rng.randn(B, K, NS).astype(f),
        size_residuals_normalized=rng.randn(B, K, NS, 3).astype(f) * 0.1,
        size_class_label=rng.randint(0, NS, (B, M)).astype(np.int32),
        size_residual_label=(rng.randn(B, M, 3) * 0.1).astype(f),
        sem_cls_scores=rng.randn(B, K, 18).astype(f),
        sem_cls_label=rng.randint(0, 18, (B, M)).astype(np.int32),
        bbox_corner=_rotated_corners(rng, B * K).reshape(B, K, 8, 3),
        cluster_ref=rng.randn(B, K).astype(f),
        ref_center_label=centers[:, 0],
        ref_heading_class_label=np.zeros((B,), np.int32),
        ref_heading_residual_label=(rng.randn(B) * 0.1).astype(f),
        ref_size_class_label=rng.randint(0, NS, (B,)).astype(np.int32),
        ref_size_residual_label=(rng.randn(B, 3) * 0.1).astype(f),
        ref_obj_mask=np.array([1, 0], np.int32),
        lang_scores=rng.randn(B, 18).astype(f),
        object_cat=rng.randint(0, 18, (B,)).astype(np.int32),
        answer_scores=rng.randn(B, 30).astype(f),
        answer_scores_scene=rng.randn(B, 30).astype(f),
        answer_cat=rng.randint(0, 30, (B,)).astype(np.int32),
    )
    cfg = types.SimpleNamespace(num_heading_bin=nh, num_size_cluster=NS,
                                mean_size_arr=(rng.rand(NS, 3) + 0.3).astype(f))
    return ep, cfg


def _both(ep):
    return {k: _t(v) for k, v in ep.items()}, {k: jnp.asarray(v) for k, v in ep.items()}


def test_vote_and_objectness_losses_match_jax():
    ep, _ = _end_points()
    t, j = _both(ep)
    _close(detection.compute_vote_loss(t), jdet.compute_vote_loss(j), "vote")
    got = detection.compute_objectness_loss(t)
    want = jdet.compute_objectness_loss(j)
    for g, w, name in zip(got, want, ("loss", "label", "mask", "assignment")):
        _close(g, w, name)
    assert 0 < int(np.asarray(want[1]).sum()) < B * K  # both classes present


@pytest.mark.parametrize("nh", [1, 4])
def test_box_and_sem_cls_losses_match_jax(nh):
    ep, cfg = _end_points(nh=nh)
    t, j = _both(ep)
    _, label, _, assignment = jdet.compute_objectness_loss(j)
    j.update(objectness_label=label, object_assignment=assignment)
    t.update(objectness_label=_t(np.asarray(label)), object_assignment=_t(np.asarray(assignment)))
    for g, w, name in zip(detection.compute_box_and_sem_cls_loss(t, cfg),
                          jdet.compute_box_and_sem_cls_loss(j, cfg),
                          ("center", "heading cls", "heading reg", "size cls", "size reg", "sem")):
        _close(g, w, name)


@pytest.mark.parametrize("nh", [1, 4])
def test_reference_language_and_answer_losses_match_jax(nh):
    ep, cfg = _end_points(nh=nh)
    t, j = _both(ep)
    for g, w, name in zip(detection.compute_reference_loss(t, cfg),
                          jdet.compute_reference_loss(j, cfg), ("loss", "ref", "labels")):
        _close(g, w, name)
    for mask in (None, ep["ref_obj_mask"]):
        _close(detection.softmax_ranking_loss(t["cluster_ref"], t["lang_scores"][:, :K].softmax(-1),
                                              None if mask is None else _t(mask)),
               jdet.softmax_ranking_loss(j["cluster_ref"],
                                         jnp.asarray(t["lang_scores"][:, :K].softmax(-1).numpy()),
                                         None if mask is None else jnp.asarray(mask)), "ranking")
    _close(detection.compute_lang_classification_loss(t),
           jdet.compute_lang_classification_loss(j), "lang")
    # the classifier's cross entropy with the scene head, then the decoders' loss
    _close(detection.compute_answer_classification_loss(t),
           jdet.compute_answer_classification_loss(j), "answer (classifier)")
    t["decoder_loss"], j["decoder_loss"] = _t(np.float32(3.25)), jnp.float32(3.25)
    _close(detection.compute_answer_classification_loss(t),
           jdet.compute_answer_classification_loss(j), "answer (decoder)")


@pytest.mark.parametrize("flags", [dict(), dict(detection=False, use_reference=False),
                                   dict(use_lang_classifier=True, use_answer=False,
                                        loss_weights={"vote_loss": 0.5, "ref_loss": 2.0})])
def test_get_loss_matches_jax(flags):
    """Every key get_loss writes, under each combination of its switches."""
    ep, cfg = _end_points()
    t, j = _both(ep)
    loss, tout = detection.get_loss(t, cfg, **flags)
    jloss, jout = jdet.get_loss(j, cfg, **flags)
    _close(loss, jloss, "loss")
    assert set(tout) == set(jout)
    for key in sorted(set(jout) - set(ep)):
        _close(tout[key], jout[key], key)
