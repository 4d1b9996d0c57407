"""Detection post-processing + mAP evaluation (counterpart of
``bridgeqa_tpu/eval/detection_eval.py``).

Equivalents of ``lib/ap_helper.py`` (``parse_predictions`` 40-178,
``parse_groundtruths`` 180-224, ``APCalculator`` 225-279) and
``utils/eval_det.py`` (57-236). The box decode + NMS run on the device, on
the model's tensors, batched (``parse_predictions_device``); only the final
AP bookkeeping (variable-length per-scan detection lists) stays on the host,
in numpy, as in the JAX package.

Semantics notes:
- corner decode uses ``class2angle`` *without* the param2obb negation, like
  ``ap_helper.py:80-84`` (identical for ScanNet's heading 0);
- AP matching uses the axis-aligned IoU (the reference's *active*
  ``box3d_iou`` body) by default; configs with ``num_heading_bin > 1`` must
  construct ``APCalculator(..., rotated=True)`` / pass ``rotated=True`` to
  ``eval_det`` to get the general convex-clip IoU
  (``geometry.boxes.box3d_iou_oriented``);
- ``remove_empty_box`` checks points-in-box with axis-aligned extents; the
  reference used a Delaunay in-hull test (``extract_pc_in_box3d``), which is
  equivalent for ScanNet's axis-aligned boxes;
- AP is VOC-style with greedy confidence-ordered matching, each GT matched
  at most once; ``ovmax > thresh`` strict, mirroring ``eval_det.py:117-125``.
"""

import numpy as np
import torch

from bridgeqa_tpu_torch.geometry.boxes import (
    box3d_iou_oriented,
    box3d_min_max,
    get_3d_box_batch,
    heading_class_residual_to_angle,
)
from bridgeqa_tpu_torch.geometry.nms import nms_2d, nms_3d, nms_3d_samecls


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@torch.no_grad()
def parse_predictions_device(
    center, heading_scores, heading_residuals, size_scores, size_residuals,
    sem_cls_scores, objectness_scores, point_clouds, mean_size_arr,
    *, num_heading_bin: int = 1, remove_empty_box: bool = False, use_3d_nms: bool = True,
    cls_nms: bool = True, nms_iou: float = 0.25, use_old_type_nms: bool = False,
    conf_thresh: float = 0.05, per_class_proposal: bool = True,
):
    """On-device half of ``parse_predictions``, on the detector's tensors
    (floats taken in f32); ``mean_size_arr`` (NS, 3) on their device.

    Returns dict of tensors: corners (B,K,8,3), pred_mask (B,K) bool,
    obj_prob (B,K), sem_cls_probs (B,K,C), pred_sem_cls (B,K), keep (B,K).
    """
    center, heading_residuals, size_residuals = (
        center.float(), heading_residuals.float(), size_residuals.float())
    hcls = heading_scores.argmax(dim=-1)
    hres = heading_residuals.gather(-1, hcls[..., None])[..., 0]
    scls = size_scores.argmax(dim=-1)
    sres = size_residuals.gather(-2, scls[..., None, None].expand(*scls.shape, 1, 3))[..., 0, :]
    sem_cls_probs = torch.softmax(sem_cls_scores.float(), dim=-1)
    pred_sem_cls = sem_cls_scores.argmax(dim=-1)

    # ap_helper decode: angle WITHOUT the param2obb -1 (ap_helper.py:80-84)
    angle = heading_class_residual_to_angle(hcls, hres, num_heading_bin)
    box_size = mean_size_arr[scls] + sres
    corners = get_3d_box_batch(box_size, angle, center)  # (B, K, 8, 3)

    mn, mx = box3d_min_max(corners)  # (B, K, 3) each
    obj_prob = torch.softmax(objectness_scores.float(), dim=-1)[..., 1]

    nonempty = torch.ones_like(obj_prob, dtype=torch.bool)
    if remove_empty_box:
        pts = point_clouds[..., :3].float()  # (B, N, 3)
        inside = ((pts[:, None, :, :] >= mn[:, :, None, :])
                  & (pts[:, None, :, :] <= mx[:, :, None, :])).all(-1)  # (B, K, N)
        nonempty = inside.sum(-1) >= 5

    if use_3d_nms and cls_nms:
        pick = nms_3d_samecls(mn, mx, obj_prob, pred_sem_cls, nms_iou, valid=nonempty)
    elif use_3d_nms:
        pick = nms_3d(mn, mx, obj_prob, nms_iou, valid=nonempty)
    else:
        # 2D NMS over (x, z) extents (ap_helper.py:108-123)
        lo2 = torch.stack([mn[..., 0], mn[..., 2]], -1)
        hi2 = torch.stack([mx[..., 0], mx[..., 2]], -1)
        pick = nms_2d(lo2, hi2, obj_prob, nms_iou, valid=nonempty)

    return {
        "corners": corners,
        "pred_mask": pick,
        "obj_prob": obj_prob,
        "sem_cls_probs": sem_cls_probs,
        "pred_sem_cls": pred_sem_cls,
        "keep": pick & (obj_prob > conf_thresh),
    }


def parse_predictions(end_points, config_dict):
    """Full ``parse_predictions`` surface: device compute + host list build.

    Returns batch_pred_map_cls: per sample, list of (cls, corners(8,3), score).
    """
    dc = config_dict["dataset_config"]
    center = end_points["center"]
    dev = parse_predictions_device(
        center, end_points["heading_scores"], end_points["heading_residuals"],
        end_points["size_scores"], end_points["size_residuals"], end_points["sem_cls_scores"],
        end_points["objectness_scores"], end_points["point_clouds"],
        torch.as_tensor(dc.mean_size_arr, dtype=torch.float32, device=center.device),
        num_heading_bin=dc.num_heading_bin,
        remove_empty_box=config_dict.get("remove_empty_box", False),
        use_3d_nms=config_dict.get("use_3d_nms", True),
        cls_nms=config_dict.get("cls_nms", True),
        nms_iou=config_dict.get("nms_iou", 0.25),
        use_old_type_nms=config_dict.get("use_old_type_nms", False),
        conf_thresh=config_dict.get("conf_thresh", 0.05),
        per_class_proposal=config_dict.get("per_class_proposal", True),
    )
    dev = {k: _host(v) for k, v in dev.items()}
    end_points["pred_mask"] = dev["pred_mask"].astype(np.float32)

    bsize, num_prop = dev["obj_prob"].shape
    batch_pred_map_cls = []
    for i in range(bsize):
        keep = np.where(dev["keep"][i])[0]
        if config_dict.get("per_class_proposal", True):
            cur = []
            for cls_i in range(dc.num_class):
                cur += [(cls_i, dev["corners"][i, j], float(dev["sem_cls_probs"][i, j, cls_i] * dev["obj_prob"][i, j]))
                        for j in keep]
            batch_pred_map_cls.append(cur)
        else:
            batch_pred_map_cls.append(
                [(int(dev["pred_sem_cls"][i, j]), dev["corners"][i, j], float(dev["obj_prob"][i, j])) for j in keep]
            )
    end_points["batch_pred_map_cls"] = batch_pred_map_cls
    return batch_pred_map_cls


def parse_groundtruths(end_points, config_dict):
    """``parse_groundtruths`` (``ap_helper.py:180-224``), vectorized decode
    on the host."""
    dc = config_dict["dataset_config"]
    center = _host(end_points["center_label"])[..., :3]
    hcls = _host(end_points["heading_class_label"])
    hres = _host(end_points["heading_residual_label"])
    scls = _host(end_points["size_class_label"]).astype(int)
    sres = _host(end_points["size_residual_label"])
    mask = _host(end_points["box_label_mask"])
    sem = _host(end_points["sem_cls_label"])

    angle = heading_class_residual_to_angle(torch.from_numpy(hcls), torch.from_numpy(hres),
                                            dc.num_heading_bin)
    size = dc.mean_size_arr[scls] + sres
    corners = get_3d_box_batch(torch.from_numpy(size), angle, torch.from_numpy(center)).numpy()

    batch_gt_map_cls = []
    for i in range(center.shape[0]):
        batch_gt_map_cls.append(
            [(int(sem[i, j]), corners[i, j]) for j in range(center.shape[1]) if mask[i, j] == 1]
        )
    end_points["batch_gt_map_cls"] = batch_gt_map_cls
    return batch_gt_map_cls


def voc_ap(rec, prec, use_07_metric=False):
    """VOC AP (``utils/eval_det.py:9-42``)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.sum(rec >= t) > 0 else 0.0
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _aabb_iou_np(c1, c2):
    mn1, mx1 = c1.min(0), c1.max(0)
    mn2, mx2 = c2.min(0), c2.max(0)
    lo = np.maximum(mn1, mn2)
    hi = np.minimum(mx1, mx2)
    inter = np.prod(np.maximum(hi - lo, 0))
    v1 = np.prod(mx1 - mn1)
    v2 = np.prod(mx2 - mn2)
    return inter / (v1 + v2 - inter + 1e-8)


def _oriented_iou_np(c1, c2):
    """Host-side rotated-box IoU for AP matching (same convex-clip
    semantics as ``geometry.boxes.box3d_iou_oriented``): needed whenever
    the dataset config has ``num_heading_bin > 1`` — the axis-aligned
    matcher silently under/over-counts rotated overlaps."""
    return float(box3d_iou_oriented(torch.as_tensor(c1, dtype=torch.float32),
                                    torch.as_tensor(c2, dtype=torch.float32)))


def eval_det_cls(pred, gt, ovthresh=0.25, use_07_metric=False, rotated=False):
    """Per-class PR/AP (``eval_det.py:57-140``)."""
    class_recs = {}
    npos = 0
    for img_id in gt:
        bbox = np.array(gt[img_id])
        class_recs[img_id] = {"bbox": bbox, "det": [False] * len(bbox)}
        npos += len(bbox)
    for img_id in pred:
        if img_id not in gt:
            class_recs[img_id] = {"bbox": np.array([]), "det": []}

    image_ids, confidence, boxes = [], [], []
    for img_id in pred:
        for box, score in pred[img_id]:
            image_ids.append(img_id)
            confidence.append(score)
            boxes.append(box)
    confidence = np.array(confidence)
    order = np.argsort(-confidence)
    image_ids = [image_ids[i] for i in order]
    boxes = [boxes[i] for i in order]

    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d in range(nd):
        rec_d = class_recs[image_ids[d]]
        bbgt = rec_d["bbox"]
        ovmax, jmax = -np.inf, -1
        for j in range(len(bbgt)):
            iou_fn = _oriented_iou_np if rotated else _aabb_iou_np
            iou = iou_fn(np.asarray(boxes[d], float), np.asarray(bbgt[j], float))
            if iou > ovmax:
                ovmax, jmax = iou, j
        if ovmax > ovthresh:
            if not rec_d["det"][jmax]:
                tp[d] = 1.0
                rec_d["det"][jmax] = True
            else:
                fp[d] = 1.0
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(npos + 1e-8)
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)


def eval_det(pred_all, gt_all, ovthresh=0.25, use_07_metric=False, rotated=False):
    """Multi-class detection eval (``eval_det.py:143-236``, single-process).

    pred_all: {img_id: [(cls, corners, score)]}; gt_all: {img_id: [(cls, corners)]}.
    """
    pred = {}
    gt = {}
    for img_id in pred_all:
        for cls, bbox, score in pred_all[img_id]:
            pred.setdefault(cls, {}).setdefault(img_id, []).append((bbox, score))
            # reference quirk (eval_det.py:165-170): predicted classes enter
            # the gt map with empty lists, so per-class-proposal mode reports
            # every class (AP 0 when no GT instance exists) — keep it for
            # metric parity.
            gt.setdefault(cls, {}).setdefault(img_id, [])
    for img_id in gt_all:
        for cls, bbox in gt_all[img_id]:
            gt.setdefault(cls, {}).setdefault(img_id, []).append(bbox)

    rec, prec, ap = {}, {}, {}
    for cls in gt:
        if cls in pred:
            rec[cls], prec[cls], ap[cls] = eval_det_cls(pred[cls], gt[cls], ovthresh,
                                                        use_07_metric, rotated)
        else:  # eval_det.py:232-235 (gt class never predicted)
            rec[cls], prec[cls], ap[cls] = 0, 0, 0
    return rec, prec, ap


class APCalculator:
    """``APCalculator`` (``ap_helper.py:225-279``): accumulate batches, then
    per-class AP + recall + mAP/AR."""

    def __init__(self, ap_iou_thresh=0.25, class2type_map=None, rotated=False):
        self.ap_iou_thresh = ap_iou_thresh
        self.class2type_map = class2type_map
        self.rotated = rotated  # num_heading_bin > 1 configs
        self.reset()

    def step(self, batch_pred_map_cls, batch_gt_map_cls):
        assert len(batch_pred_map_cls) == len(batch_gt_map_cls)
        for i in range(len(batch_pred_map_cls)):
            self.gt_map_cls[self.scan_cnt] = batch_gt_map_cls[i]
            self.pred_map_cls[self.scan_cnt] = batch_pred_map_cls[i]
            self.scan_cnt += 1

    def compute_metrics(self):
        rec, prec, ap = eval_det(self.pred_map_cls, self.gt_map_cls,
                                 ovthresh=self.ap_iou_thresh, rotated=self.rotated)
        ret = {}
        for key in sorted(ap.keys()):
            name = self.class2type_map[key] if self.class2type_map else str(key)
            ret[f"{name} Average Precision"] = ap[key]
        ret["mAP"] = np.mean(list(ap.values())) if ap else 0.0
        rec_list = []
        for key in sorted(ap.keys()):
            name = self.class2type_map[key] if self.class2type_map else str(key)
            try:
                ret[f"{name} Recall"] = rec[key][-1]
                rec_list.append(rec[key][-1])
            except (IndexError, TypeError):
                ret[f"{name} Recall"] = 0
                rec_list.append(0)
        ret["AR"] = np.mean(rec_list) if rec_list else 0.0
        return ret

    def reset(self):
        self.gt_map_cls = {}
        self.pred_map_cls = {}
        self.scan_cnt = 0
