"""QA + grounding evaluation metrics on the device (counterpart of
``bridgeqa_tpu/eval/qa_eval.py``).

Port of ``lib/eval_helper.py:53-320`` (``get_eval``): grounding accuracy
and IoU of the referenced box, language-classifier accuracy, answer
accuracy@{1,10} for every head (main/scene/2d/2d3d), the 3D-vs-2D
disagreement rates, objectness and semantic accuracies. Everything is
batched tensor work on the model's outputs; nothing is read back.
"""

import torch
import torch.nn.functional as F

from bridgeqa_tpu_torch.geometry.boxes import box3d_iou_auto, get_3d_box_batch, params_to_obb
from bridgeqa_tpu_torch.models.generation import top_k_stable


def _answer_acc(scores, answer_cats, topk: int = 10):
    """acc@1 / acc@10 given (B, A) scores and (B, A) multi-hot labels."""
    at1 = answer_cats.gather(1, scores.argmax(dim=1)[:, None])[:, 0]
    k = min(topk, scores.shape[1])
    top_ids = top_k_stable(scores, k)
    at10 = answer_cats.gather(1, top_ids).amax(dim=1)
    return at1.mean(), at10.mean(), at1, top_ids


def _categorical(candidate: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One index per row, uniform over the row's True entries (index 0 for
    a row with none): the Gumbel-max draw ``jax.random.categorical`` makes,
    from ``generator``."""
    u = torch.rand(candidate.shape, generator=generator, device=candidate.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=torch.finfo(u.dtype).tiny)))
    return torch.where(candidate, gumbel, float("-inf")).argmax(dim=1)


def get_eval(end_points, config, *, use_lang_classifier: bool = False,
             use_oracle: bool = False, use_cat_rand: bool = False,
             use_best: bool = False, generator: torch.Generator | None = None):
    """Compute eval metrics into end_points.

    Requires the loss pass to have run first (objectness_label /
    object_assignment / cluster_labels present, as in the reference flow
    ``solver.py:396-400``).

    Ablation modes (``lib/eval_helper.py:53,97-125``, affecting the
    localization metrics only, like the reference):

    - ``use_best``: ground with the GT cluster label (upper bound);
    - ``use_cat_rand``: ground a uniformly random proposal whose assigned
      semantic class matches the question's object category (``generator``
      — a ``torch.Generator`` on the outputs' device — required; JAX draws
      from a ``jax.random`` key, so the draws differ); no candidate ->
      proposal 0, matching the reference's all-zero-row argmax fallback;
    - ``use_oracle``: score the GT box parameters gathered through
      ``object_assignment`` instead of the predicted box heads.
    """
    scores_obj = end_points["objectness_scores"]
    device = scores_obj.device
    mean_size_arr = torch.as_tensor(config.mean_size_arr, dtype=torch.float32).to(
        device, non_blocking=True)
    nh = config.num_heading_bin
    batch = scores_obj.shape[0]
    rows = torch.arange(batch, device=device)

    objectness_pred = scores_obj.argmax(dim=2)
    objectness_label = end_points["objectness_label"].long()

    pred_masks = (objectness_pred == 1).float()
    label_masks = (objectness_label == 1).float()

    # grounding accuracy (eval_helper.py:82-95) — always from the raw
    # cluster_ref, before any ablation mode (the reference computes ref_acc
    # before the mode branches)
    cluster_pred_idx = (end_points["cluster_ref"].float() * pred_masks).argmax(dim=1)
    cluster_preds = F.one_hot(cluster_pred_idx, pred_masks.shape[1])
    cluster_labels = end_points["cluster_labels"].float() * label_masks
    corrects = ((cluster_preds == 1) & (cluster_labels == 1)).sum(dim=1).float()
    end_points["ref_acc"] = corrects
    end_points["ref_acc_mean"] = corrects.mean()

    if use_best:
        # eval_helper.py:97-100: ground with the GT label
        pred_ref = end_points["cluster_labels"].argmax(dim=1)
        end_points["cluster_ref"] = end_points["cluster_labels"].float()
    elif use_cat_rand:
        # eval_helper.py:101-120: random proposal of the right category
        if generator is None:
            raise ValueError("use_cat_rand needs a torch.Generator (generator=)")
        num_bbox = end_points["num_bbox"].long()  # (B,)
        sem_full = end_points["sem_cls_label"].long()
        max_obj = sem_full.shape[1]
        # the reference decrements padded rows (sem_cls_label[num_bbox:] -= 1)
        # so padding can't alias the queried category
        sem_cls = sem_full - (torch.arange(max_obj, device=device)[None, :]
                              >= num_bbox[:, None]).long()
        assigned = sem_cls.gather(1, end_points["object_assignment"].long())
        candidate = assigned == end_points["object_cat"].long()[:, None]  # (B, K)
        has_cand = candidate.any(dim=1)
        pred_ref = torch.where(has_cand, _categorical(candidate, generator), 0)
        end_points["cluster_ref"] = (F.one_hot(pred_ref, candidate.shape[1]).float()
                                     * has_cand[:, None].float())
    else:
        pred_ref = (end_points["cluster_ref"].float() * pred_masks).argmax(dim=1)  # (B,)
    gt_ref = end_points["ref_box_label"].argmax(dim=1)

    if use_oracle:
        # eval_helper.py:126-138: GT box params through object_assignment
        assign = end_points["object_assignment"].long()

        def take_gt(x):  # x (B, MAX_OBJ, ...) -> the GT of the grounded proposal
            return x[rows, assign[rows, pred_ref]]

        pred_center = take_gt(end_points["center_label"]).float()
        pred_hcls = take_gt(end_points["heading_class_label"]).long()
        pred_hres = take_gt(end_points["heading_residual_label"]).float()
        pred_scls = take_gt(end_points["size_class_label"]).long()
        pred_sres = take_gt(end_points["size_residual_label"]).float()
    else:
        hcls = end_points["heading_scores"].argmax(dim=-1)
        scls = end_points["size_scores"].argmax(dim=-1)
        hres = end_points["heading_residuals"].float().gather(2, hcls[..., None])[..., 0]
        sres = end_points["size_residuals"].float().gather(
            2, scls[..., None, None].expand(*scls.shape, 1, 3))[:, :, 0, :]
        pred_center = end_points["center"].float()[rows, pred_ref]
        pred_hcls, pred_hres = hcls[rows, pred_ref], hres[rows, pred_ref]
        pred_scls, pred_sres = scls[rows, pred_ref], sres[rows, pred_ref]

    gt_center = end_points["center_label"].float()[rows, gt_ref]
    gt_hcls = end_points["heading_class_label"].long()[rows, gt_ref]
    gt_hres = end_points["heading_residual_label"].float()[rows, gt_ref]
    gt_scls = end_points["size_class_label"].long()[rows, gt_ref]
    gt_sres = end_points["size_residual_label"].float()[rows, gt_ref]

    pred_obb = params_to_obb(pred_center, pred_hcls, pred_hres, pred_scls, pred_sres, mean_size_arr, nh)
    gt_obb = params_to_obb(gt_center, gt_hcls, gt_hres, gt_scls, gt_sres, mean_size_arr, nh)
    pred_bbox = get_3d_box_batch(pred_obb[..., 3:6], pred_obb[..., 6], pred_obb[..., 0:3])
    gt_bbox = get_3d_box_batch(gt_obb[..., 3:6], gt_obb[..., 6], gt_obb[..., 0:3])
    ious = box3d_iou_auto(pred_bbox, gt_bbox, num_heading_bin=nh)  # (B,)

    end_points["ref_iou"] = ious
    end_points["ref_iou_rate_0.25"] = (ious >= 0.25).float().mean()
    end_points["ref_iou_rate_0.5"] = (ious >= 0.5).float().mean()
    end_points["pred_bboxes"] = pred_bbox
    end_points["gt_bboxes"] = gt_bbox

    zero = torch.zeros((), device=device)
    # language accuracy
    if use_lang_classifier and "lang_scores" in end_points:
        end_points["lang_acc"] = (end_points["lang_scores"].argmax(dim=1)
                                  == end_points["object_cat"].long()).float().mean()
    else:
        end_points["lang_acc"] = zero

    # answer accuracies for each scoring head
    answer_cats = end_points.get("answer_cats")
    at1_by_head = {}
    for head, suffix in (("answer_scores", ""), ("answer_scores_scene", "_scene"),
                         ("answer_scores_2d", "_2d"), ("answer_scores_2d3d", "_2d3d")):
        if head in end_points and answer_cats is not None:
            scores = end_points[head].float()
            cats = answer_cats.float()
            if cats.shape[1] < scores.shape[1]:
                cats = F.pad(cats, (0, scores.shape[1] - cats.shape[1]))
            a1, a10, at1_vec, top_ids = _answer_acc(scores, cats)
            end_points[f"answer_acc_at1{suffix}"] = a1
            end_points[f"answer_acc_at10{suffix}"] = a10
            at1_by_head[suffix] = at1_vec
            if suffix == "":
                # per-sample dump consumed by the eval script's
                # pred.<split>.pkl records (reference eval.py:362-383)
                end_points["pred_answers_at10"] = top_ids
        else:
            end_points[f"answer_acc_at1{suffix}"] = zero
            end_points[f"answer_acc_at10{suffix}"] = zero

    # 3D-over-2D disagreement rates (eval_helper.py:268-280)
    if "_2d" in at1_by_head and "_scene" in at1_by_head:
        correct_3d = at1_by_head["_scene"].bool()
        correct_2d = at1_by_head["_2d"].bool()
        end_points["answer_acc_at1_3d_over_2d"] = (correct_3d & ~correct_2d).float().mean()
        end_points["answer_acc_at1_2d_over_3d"] = (~correct_3d & correct_2d).float().mean()

    # objectness + semantic accuracy (eval_helper.py:311-320)
    objectness_mask = end_points["objectness_mask"].float()
    end_points["obj_acc"] = (((objectness_pred == objectness_label).float() * objectness_mask).sum()
                             / (objectness_mask.sum() + 1e-6))

    sem_cls_label = end_points["sem_cls_label"].long().gather(
        1, end_points["object_assignment"].long())
    sem_match = (sem_cls_label == end_points["sem_cls_scores"].argmax(dim=-1)).float()
    end_points["sem_acc"] = (sem_match * pred_masks).sum() / (pred_masks.sum() + 1e-6)
    end_points["pred_mask"] = pred_masks
    end_points["label_mask"] = label_masks

    return end_points
