"""The port's evaluation against the JAX package's, on the CPU: the same end
points, made with numpy from a seed, through both.

Integers and booleans (picks, classes, indices, accuracies of 0/1 counts)
must be equal; floats within 1e-6 (both sides compute in f32, and ``sin``,
``cos`` and sums round alike to within a few ulp). ``use_cat_rand`` draws
from a ``torch.Generator`` where JAX draws from a key, so its test holds
the property (a proposal of the asked category, or proposal 0 when there is
none), not the draw. ``eval/scoring.py`` is a copy, held to its original.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridgeqa_tpu.data.scannet_config import ScannetDatasetConfig as JDatasetConfig
from bridgeqa_tpu.eval import detection_eval as jdet
from bridgeqa_tpu.eval import qa_eval as jqa
from bridgeqa_tpu.eval import scoring as jscoring
from bridgeqa_tpu.geometry import nms as jnms
from bridgeqa_tpu_torch.data.scannet_config import ScannetDatasetConfig
from bridgeqa_tpu_torch.eval import detection_eval, qa_eval, scoring
from bridgeqa_tpu_torch.geometry import nms
from tests.test_torch_feed import assert_same_code

FLOAT_TOL = 1e-6
DC = ScannetDatasetConfig()
JDC = JDatasetConfig()


def test_scoring_is_a_copy():
    assert_same_code(scoring, jscoring)
    preds = {"q1": {"answer_top10": ["brown", "red"], "open_ended_answer": "a brown chair"},
             "q2": {"answer_top10": ["two"], "open_ended_answer": "three"}}
    gold = [{"question_id": "q1", "question": "what color is the chair", "answers": ["brown"]},
            {"question_id": "q2", "question": "how many doors are there", "answers": ["two"]}]
    assert scoring.score_predictions(preds, gold) == jscoring.score_predictions(preds, gold)


def _boxes(rng, b, k, dims):
    lo = rng.rand(b, k, dims).astype(np.float32) * 2.0
    hi = lo + 0.2 + rng.rand(b, k, dims).astype(np.float32)
    scores = rng.rand(b, k).astype(np.float32)
    valid = rng.rand(b, k) > 0.15
    return lo, hi, scores, valid


@pytest.mark.parametrize("kind", ["3d", "3d_samecls", "2d"])
def test_nms_picks_the_jax_boxes(kind):
    rng = np.random.RandomState({"3d": 0, "3d_samecls": 1, "2d": 2}[kind])
    dims = 2 if kind == "2d" else 3
    lo, hi, scores, valid = _boxes(rng, 6, 48, dims)
    valid[0] = False  # a row with nothing to pick
    cls = rng.randint(0, 3, (6, 48)).astype(np.int32)
    t = torch.from_numpy
    for threshold in (0.1, 0.25, 0.5):
        if kind == "3d_samecls":
            got = nms.nms_3d_samecls(t(lo), t(hi), t(scores), t(cls), threshold, valid=t(valid))
            want = jax.vmap(lambda a, b_, s, c, v: jnms.nms_3d_samecls(a, b_, s, c, threshold,
                                                                        valid=v))(
                lo, hi, scores, cls, valid)
        else:
            fn, jfn = {"3d": (nms.nms_3d, jnms.nms_3d), "2d": (nms.nms_2d, jnms.nms_2d)}[kind]
            got = fn(t(lo), t(hi), t(scores), threshold, valid=t(valid))
            want = jax.vmap(lambda a, b_, s, v: jfn(a, b_, s, threshold, valid=v))(
                lo, hi, scores, valid)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"{threshold}")
        assert not got[0].any()
        assert got.sum() > 6  # several boxes kept in a row
    # without a mask every box is a candidate
    if kind == "3d":
        got = nms.nms_3d(t(lo), t(hi), t(scores), 0.25)
        want = jax.vmap(lambda a, b_, s: jnms.nms_3d(a, b_, s, 0.25))(lo, hi, scores)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _detection_end_points(seed, b=3, k=32, n=600, max_obj=8):
    """Detector outputs and labels of overlapping boxes near the origin; the
    first proposals of a row repeat its first GT boxes, class and size, so
    that AP has true positives to count."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    ep = {
        "center": (rng.rand(b, k, 3) * 1.5).astype(f32),
        "heading_scores": rng.randn(b, k, 1).astype(f32),
        "heading_residuals": (rng.randn(b, k, 1) * 0.1).astype(f32),
        "size_scores": rng.randn(b, k, 18).astype(f32),
        "size_residuals": (rng.randn(b, k, 18, 3) * 0.1).astype(f32),
        "sem_cls_scores": rng.randn(b, k, 18).astype(f32),
        "objectness_scores": (rng.randn(b, k, 2) * 2).astype(f32),
        "point_clouds": (rng.rand(b, n, 4) * 1.5).astype(f32),
        "center_label": (rng.rand(b, max_obj, 3) * 1.5).astype(f32),
        "heading_class_label": np.zeros((b, max_obj), np.int32),
        "heading_residual_label": (rng.randn(b, max_obj) * 0.1).astype(f32),
        "size_class_label": rng.randint(0, 18, (b, max_obj)).astype(np.int32),
        "size_residual_label": (rng.randn(b, max_obj, 3) * 0.1).astype(f32),
        "box_label_mask": (np.arange(max_obj)[None] < rng.randint(3, max_obj, (b, 1))).astype(f32),
        "sem_cls_label": rng.randint(0, 18, (b, max_obj)).astype(np.int32),
    }
    for i in range(b):
        for j in range(3):
            scls = ep["size_class_label"][i, j]
            ep["center"][i, j] = ep["center_label"][i, j]
            ep["heading_residuals"][i, j, 0] = ep["heading_residual_label"][i, j]
            ep["size_scores"][i, j, scls] = 10.0
            ep["size_residuals"][i, j, scls] = ep["size_residual_label"][i, j]
            ep["sem_cls_scores"][i, j, ep["sem_cls_label"][i, j]] = 10.0
            ep["objectness_scores"][i, j] = (-3.0, 3.0)
    return ep


def _assert_map_cls_equal(got, want, with_score):
    assert len(got) == len(want)
    for g_row, w_row in zip(got, want):
        assert len(g_row) == len(w_row)
        for g, w in zip(g_row, w_row):
            assert g[0] == w[0]
            np.testing.assert_allclose(g[1], np.asarray(w[1]), atol=FLOAT_TOL, rtol=0)
            if with_score:
                assert g[2] == pytest.approx(w[2], abs=FLOAT_TOL)


@pytest.mark.parametrize("config", [
    {},
    {"per_class_proposal": False, "cls_nms": False},
    {"use_3d_nms": False, "remove_empty_box": True, "conf_thresh": 0.3},
], ids=["per_class", "one_class_3d_nms", "2d_nms_nonempty"])
def test_parse_predictions_groundtruths_and_ap_match(config):
    end_points = _detection_end_points(seed=len(config))
    jend = {k: jnp.asarray(v) for k, v in end_points.items()}
    tend = {k: torch.from_numpy(v) for k, v in end_points.items()}
    jcfg = {"dataset_config": JDC, **config}
    tcfg = {"dataset_config": DC, **config}
    want_pred = jdet.parse_predictions(jend, jcfg)
    got_pred = detection_eval.parse_predictions(tend, tcfg)
    np.testing.assert_array_equal(tend["pred_mask"], np.asarray(jend["pred_mask"]))
    assert tend["pred_mask"].sum() > 0
    _assert_map_cls_equal(got_pred, want_pred, with_score=True)
    want_gt = jdet.parse_groundtruths(jend, jcfg)
    got_gt = detection_eval.parse_groundtruths(tend, tcfg)
    _assert_map_cls_equal(got_gt, want_gt, with_score=False)

    for iou in (0.25, 0.5):
        calc = detection_eval.APCalculator(iou, DC.class2type)
        jcalc = jdet.APCalculator(iou, JDC.class2type)
        calc.step(got_pred, got_gt)
        jcalc.step(want_pred, want_gt)
        got, want = calc.compute_metrics(), jcalc.compute_metrics()
        assert list(got) == list(want)
        for key, w in want.items():
            assert got[key] == pytest.approx(float(w), abs=FLOAT_TOL), key
    assert want["mAP"] > 0 or want["AR"] > 0


def _qa_end_points(seed, b=4, k=16, max_obj=6, a=12):
    rng = np.random.RandomState(seed)
    f32 = np.float32
    answer_cats = (rng.rand(b, a - 2) > 0.7).astype(f32)  # narrower than the scores
    answer_cats[0] = 0.0
    return {
        "objectness_scores": rng.randn(b, k, 2).astype(f32),
        "objectness_label": rng.randint(0, 2, (b, k)).astype(np.int32),
        "objectness_mask": (rng.rand(b, k) > 0.2).astype(f32),
        "object_assignment": rng.randint(0, max_obj, (b, k)).astype(np.int32),
        "cluster_ref": rng.randn(b, k).astype(f32),
        "cluster_labels": np.eye(k, dtype=f32)[rng.randint(0, k, b)],
        "ref_box_label": np.eye(max_obj, dtype=np.int32)[rng.randint(0, max_obj, b)],
        "center": (rng.rand(b, k, 3) * 2).astype(f32),
        "heading_scores": rng.randn(b, k, 1).astype(f32),
        "heading_residuals": (rng.randn(b, k, 1) * 0.1).astype(f32),
        "size_scores": rng.randn(b, k, 18).astype(f32),
        "size_residuals": (rng.randn(b, k, 18, 3) * 0.1).astype(f32),
        "center_label": (rng.rand(b, max_obj, 3) * 2).astype(f32),
        "heading_class_label": np.zeros((b, max_obj), np.int32),
        "heading_residual_label": (rng.randn(b, max_obj) * 0.1).astype(f32),
        "size_class_label": rng.randint(0, 18, (b, max_obj)).astype(np.int32),
        "size_residual_label": (rng.randn(b, max_obj, 3) * 0.1).astype(f32),
        "sem_cls_label": rng.randint(0, 3, (b, max_obj)).astype(np.int32),
        "sem_cls_scores": rng.randn(b, k, 18).astype(f32),
        "object_cat": rng.randint(0, 18, (b,)).astype(np.int32),
        "lang_scores": rng.randn(b, 18).astype(f32),
        "answer_scores": rng.randn(b, a).astype(f32),
        "answer_scores_scene": rng.randn(b, a).astype(f32),
        "answer_scores_2d": rng.randn(b, a).astype(f32),
        "answer_cats": answer_cats,
        "num_bbox": rng.randint(2, max_obj, (b,)).astype(np.int32),
    }


EXACT_KEYS = ("ref_acc", "ref_acc_mean", "ref_iou_rate_0.25", "ref_iou_rate_0.5", "lang_acc",
              "answer_acc_at1", "answer_acc_at10", "answer_acc_at1_scene", "answer_acc_at10_scene",
              "answer_acc_at1_2d", "answer_acc_at10_2d", "answer_acc_at1_2d3d",
              "answer_acc_at1_3d_over_2d", "answer_acc_at1_2d_over_3d", "pred_answers_at10",
              "pred_mask", "label_mask", "cluster_ref")
FLOAT_KEYS = ("ref_iou", "pred_bboxes", "gt_bboxes", "obj_acc", "sem_acc")


@pytest.mark.parametrize("mode", [{}, {"use_best": True}, {"use_oracle": True},
                                  {"use_best": True, "use_oracle": True}],
                         ids=["default", "use_best", "use_oracle", "use_best_oracle"])
def test_get_eval_matches_jax(mode):
    end_points = _qa_end_points(seed=len(mode) + 3)
    if mode.get("use_best"):
        # ground on proposals assigned to the referenced object, so IoUs vary
        gt_ref = end_points["ref_box_label"].argmax(1)
        for i, row in enumerate(end_points["object_assignment"]):
            row[i % 3] = gt_ref[i]
            end_points["cluster_labels"][i] = np.eye(len(row))[i % 3]
    want = jqa.get_eval({k: jnp.asarray(v) for k, v in end_points.items()}, JDC,
                        use_lang_classifier=True, **mode)
    got = qa_eval.get_eval({k: torch.from_numpy(v) for k, v in end_points.items()}, DC,
                           use_lang_classifier=True, **mode)
    for key in EXACT_KEYS:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)
    for key in FLOAT_KEYS:
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want[key]), atol=FLOAT_TOL,
                                   rtol=0, err_msg=key)
    assert 0 < float(want["answer_acc_at10"]) < 1
    if mode.get("use_oracle") and mode.get("use_best"):
        np.testing.assert_allclose(got["ref_iou"].numpy(), 1.0, rtol=1e-5)


def test_use_cat_rand_grounds_a_proposal_of_the_asked_category():
    """Every draw picks a proposal whose assigned object has the question's
    category, uniformly enough that more than one is drawn over seeds; a
    row with no such proposal grounds proposal 0 with an all-zero
    cluster_ref; the generator is required."""
    end_points = _qa_end_points(seed=11)
    b, k = end_points["cluster_ref"].shape
    end_points["object_cat"] = np.array([1, 2, 1, 17], np.int32)  # row 3: no object of class 17
    num_bbox = end_points["num_bbox"]
    sem = end_points["sem_cls_label"] - (np.arange(6)[None] >= num_bbox[:, None])
    candidate = sem[np.arange(b)[:, None], end_points["object_assignment"]] == \
        end_points["object_cat"][:, None]
    assert candidate[:3].any(axis=1).all() and not candidate[3].any()
    chosen = set()
    for seed in range(8):
        out = qa_eval.get_eval({k_: torch.from_numpy(v) for k_, v in end_points.items()}, DC,
                               use_cat_rand=True, generator=torch.Generator().manual_seed(seed))
        ref = out["cluster_ref"].numpy()
        for i in range(3):
            j = int(ref[i].argmax())
            assert ref[i].sum() == 1 and candidate[i, j], (seed, i, j)
            chosen.add((i, j))
        assert not ref[3].any()
    assert len(chosen) > 3
    with pytest.raises(ValueError, match="generator"):
        qa_eval.get_eval({k_: torch.from_numpy(v) for k_, v in end_points.items()}, DC,
                         use_cat_rand=True)
