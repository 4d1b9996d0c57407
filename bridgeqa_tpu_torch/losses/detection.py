"""VoteNet detection losses and BridgeQA's loss sum (counterpart of
``bridgeqa_tpu/losses/detection.py``), on the device: the NEAR/FAR
thresholds 0.3/0.6, objectness class weights [0.2, 0.8], the box loss
``center + 0.1 * heading_cls + heading_reg + 0.1 * size_cls + size_reg``, the
grounding target from the proposals' IoU with the reference box, and the
final x10.

Every normaliser covers the global batch, as JAX's: under data parallelism
each ratio's numerator and count are summed over the data-parallel ranks
(``parallel.global_batch.global_ratio``), and so is each per-sample mean."""

import math

import torch
import torch.nn.functional as F

from bridgeqa_tpu_torch.geometry.boxes import box3d_iou_auto, get_3d_box_batch, params_to_obb
from bridgeqa_tpu_torch.geometry.nn_distance import huber_loss, nn_distance
from bridgeqa_tpu_torch.parallel.global_batch import batch_mean, global_ratio

FAR_THRESHOLD = 0.6
NEAR_THRESHOLD = 0.3
GT_VOTE_FACTOR = 3
OBJECTNESS_CLS_WEIGHTS = (0.2, 0.8)


def _take(values, index):
    """``take_along_axis`` on axis 1: values (B, N, ...), index (B, K) ->
    (B, K, ...)."""
    index = index.long().reshape(index.shape + (1,) * (values.dim() - 2))
    return values.gather(1, index.expand(index.shape[:2] + values.shape[2:]))


def _nll(logits, labels):
    """-log_softmax(logits)[label] over the last axis."""
    return -F.log_softmax(logits, dim=-1).gather(-1, labels.long()[..., None])[..., 0]


def _weighted_ce(logits, labels, sample_weights):
    """Cross entropy weighted per sample: sum(nll * w) / (sum(w) + 1e-6)."""
    return global_ratio((_nll(logits, labels) * sample_weights).sum(), sample_weights.sum(), 1e-6)


def compute_vote_loss(end_points):
    """The min-of-min L1 Chamfer vote loss over the seeds with a vote label."""
    batch_size, num_seed, _ = end_points["seed_xyz"].shape
    seed_inds = end_points["seed_inds"]
    seed_gt_votes_mask = _take(end_points["vote_label_mask"], seed_inds)
    seed_gt_votes = (_take(end_points["vote_label"], seed_inds)
                     + end_points["seed_xyz"].repeat(1, 1, GT_VOTE_FACTOR))
    vote_xyz_r = end_points["vote_xyz"].reshape(batch_size * num_seed, -1, 3)
    gt_votes_r = seed_gt_votes.reshape(batch_size * num_seed, GT_VOTE_FACTOR, 3)
    _, _, dist2, _ = nn_distance(vote_xyz_r, gt_votes_r, l1=True)
    votes_dist = dist2.amin(dim=1).reshape(batch_size, num_seed)
    mask = seed_gt_votes_mask.float()
    return global_ratio((votes_dist * mask).sum(), mask.sum(), 1e-6)


def compute_objectness_loss(end_points):
    """Objectness cross entropy with the NEAR/FAR don't-care zone. Returns
    (loss, objectness_label, objectness_mask, object_assignment)."""
    gt_center = end_points["center_label"][:, :, 0:3]
    dist1, ind1, _, _ = nn_distance(end_points["aggregated_vote_xyz"], gt_center)
    euclidean_dist1 = torch.sqrt(dist1 + 1e-6)
    objectness_label = (euclidean_dist1 < NEAR_THRESHOLD).to(torch.int32)
    objectness_mask = ((euclidean_dist1 < NEAR_THRESHOLD)
                       | (euclidean_dist1 > FAR_THRESHOLD)).float()
    # constants copied without waiting for the card (no host sync in a step)
    cls_w = torch.tensor(OBJECTNESS_CLS_WEIGHTS, dtype=torch.float32).to(dist1.device,
                                                                        non_blocking=True)
    nll = _nll(end_points["objectness_scores"], objectness_label) * cls_w[objectness_label.long()]
    loss = global_ratio((nll * objectness_mask).sum(), objectness_mask.sum(), 1e-6)
    return loss, objectness_label, objectness_mask, ind1


def compute_box_and_sem_cls_loss(end_points, config):
    """Centre Chamfer, heading and size class cross entropy and masked Huber
    residuals, semantic class cross entropy. Returns (center_loss,
    heading_class_loss, heading_residual_normalized_loss, size_class_loss,
    size_residual_normalized_loss, sem_cls_loss)."""
    num_heading_bin = config.num_heading_bin
    num_size_cluster = config.num_size_cluster
    object_assignment = end_points["object_assignment"]
    device = object_assignment.device
    mean_size_arr = torch.tensor(config.mean_size_arr, dtype=torch.float32).to(device,
                                                                              non_blocking=True)
    objectness_label = end_points["objectness_label"].float()
    obj_count = objectness_label.sum()

    gt_center = end_points["center_label"][:, :, 0:3]
    dist1, _, dist2, _ = nn_distance(end_points["center"], gt_center)
    box_label_mask = end_points["box_label_mask"]
    center_loss = (global_ratio((dist1 * objectness_label).sum(), obj_count, 1e-6)
                   + global_ratio((dist2 * box_label_mask).sum(), box_label_mask.sum(), 1e-6))

    heading_class_label = _take(end_points["heading_class_label"], object_assignment)
    heading_class_loss = _weighted_ce(end_points["heading_scores"], heading_class_label,
                                      objectness_label)
    heading_residual_label = _take(end_points["heading_residual_label"], object_assignment)
    heading_residual_normalized_label = heading_residual_label / (math.pi / num_heading_bin)
    heading_one_hot = F.one_hot(heading_class_label.long(), num_heading_bin).float()
    pred_heading_res = (end_points["heading_residuals_normalized"] * heading_one_hot).sum(-1)
    heading_reg = huber_loss(pred_heading_res - heading_residual_normalized_label, delta=1.0)
    heading_residual_normalized_loss = global_ratio((heading_reg * objectness_label).sum(),
                                                    obj_count, 1e-6)

    size_class_label = _take(end_points["size_class_label"], object_assignment)
    size_class_loss = _weighted_ce(end_points["size_scores"], size_class_label, objectness_label)
    size_residual_label = _take(end_points["size_residual_label"], object_assignment)
    size_one_hot = F.one_hot(size_class_label.long(), num_size_cluster).float()[..., None]
    pred_size_res = (end_points["size_residuals_normalized"] * size_one_hot).sum(2)
    mean_size_label = (size_one_hot * mean_size_arr[None, None]).sum(2)
    size_reg = huber_loss(pred_size_res - size_residual_label / mean_size_label, delta=1.0)
    size_residual_normalized_loss = global_ratio((size_reg.mean(-1) * objectness_label).sum(),
                                                 obj_count, 1e-6)

    sem_cls_label = _take(end_points["sem_cls_label"], object_assignment)
    sem_cls_loss = _weighted_ce(end_points["sem_cls_scores"], sem_cls_label, objectness_label)
    return (center_loss, heading_class_loss, heading_residual_normalized_loss, size_class_loss,
            size_residual_normalized_loss, sem_cls_loss)


def softmax_ranking_loss(inputs, targets, mask=None):
    """-sum(log softmax(inputs) * targets) per row, averaged (weighted by
    ``mask`` when given)."""
    probs = torch.softmax(inputs + 1e-8, dim=1)
    loss = -(torch.log(probs + 1e-8) * targets).sum(dim=1)
    if mask is None:
        return batch_mean(loss)
    mask = mask + 1e-8
    return global_ratio((loss * mask).sum(), mask.sum())


def compute_reference_loss(end_points, config):
    """The grounding loss: the proposal whose box has the largest IoU with
    the reference box is the one-hot target of a softmax ranking loss over
    ``cluster_ref``. Returns (loss, cluster_ref, labels)."""
    device = end_points["cluster_ref"].device
    mean_size_arr = torch.tensor(config.mean_size_arr, dtype=torch.float32).to(device,
                                                                              non_blocking=True)
    nh = config.num_heading_bin
    gt_obb = params_to_obb(end_points["ref_center_label"], end_points["ref_heading_class_label"],
                           end_points["ref_heading_residual_label"],
                           end_points["ref_size_class_label"].long(),
                           end_points["ref_size_residual_label"], mean_size_arr, nh)
    gt_bbox = get_3d_box_batch(gt_obb[..., 3:6], gt_obb[..., 6], gt_obb[..., 0:3])
    ious = box3d_iou_auto(end_points["bbox_corner"], gt_bbox[:, None], num_heading_bin=nh)
    labels = F.one_hot(ious.argmax(dim=1), ious.shape[1]).float()
    loss = softmax_ranking_loss(end_points["cluster_ref"], labels,
                                mask=end_points.get("ref_obj_mask"))
    return loss, end_points["cluster_ref"], labels


def compute_lang_classification_loss(end_points):
    """Cross entropy of the language head, weighted by ``ref_obj_mask``."""
    nll = _nll(end_points["lang_scores"], end_points["object_cat"])
    mask = end_points["ref_obj_mask"] + 1e-8
    return global_ratio((nll * mask).sum(), mask.sum())


def compute_answer_classification_loss(end_points):
    """The decoders' LM loss (``decoder_loss``) where there is one, else the
    answer classifier's cross entropy; plus the scene and 2D/3D heads' where
    present."""
    if "decoder_loss" in end_points:
        loss = end_points["decoder_loss"]
    else:
        loss = batch_mean(_nll(end_points["answer_scores"], end_points["answer_cat"]))
    for extra in ("answer_scores_scene", "answer_scores_2d3d"):
        if extra in end_points:
            loss = loss + batch_mean(_nll(end_points[extra], end_points["answer_cat"]))
    return loss


SUB_LOSSES = ("vote_loss", "objectness_loss", "center_loss", "heading_cls_loss",
              "heading_reg_loss", "size_cls_loss", "size_reg_loss", "sem_cls_loss", "box_loss")


def get_loss(end_points, config, detection=True, use_reference=True, use_lang_classifier=False,
             use_answer=True, loss_weights=None):
    """The training loss: the weighted sum of every sub-loss, times 10.
    Writes each sub-loss, the objectness labels and assignment, the
    grounding labels and pos/neg ratios into ``end_points``, as the JAX
    function does. Returns (loss, end_points)."""
    loss_weights = loss_weights or {}
    device = end_points["seed_xyz"].device
    zero = torch.zeros((), dtype=torch.float32, device=device)

    vote_loss = compute_vote_loss(end_points)
    objectness_loss, objectness_label, objectness_mask, object_assignment = \
        compute_objectness_loss(end_points)
    end_points["objectness_label"] = objectness_label
    end_points["objectness_mask"] = objectness_mask
    end_points["object_assignment"] = object_assignment
    total = objectness_label.shape[0] * objectness_label.shape[1]
    end_points["pos_ratio"] = global_ratio(objectness_label.float().sum(), total)
    end_points["neg_ratio"] = global_ratio(objectness_mask.sum(), total) - end_points["pos_ratio"]

    (center_loss, heading_cls_loss, heading_reg_loss, size_cls_loss, size_reg_loss,
     sem_cls_loss) = compute_box_and_sem_cls_loss(end_points, config)
    box_loss = (center_loss + 0.1 * heading_cls_loss + heading_reg_loss + 0.1 * size_cls_loss
                + size_reg_loss)
    values = (vote_loss, objectness_loss, center_loss, heading_cls_loss, heading_reg_loss,
              size_cls_loss, size_reg_loss, sem_cls_loss, box_loss)
    end_points.update({k: v if detection else zero for k, v in zip(SUB_LOSSES, values)})

    if use_reference:
        ref_loss, _, cluster_labels = compute_reference_loss(end_points, config)
        end_points["cluster_labels"] = cluster_labels
        end_points["ref_loss"] = ref_loss
    else:
        end_points["cluster_labels"] = torch.zeros_like(objectness_label, dtype=torch.float32)
        end_points["cluster_ref"] = torch.zeros_like(objectness_label, dtype=torch.float32)
        end_points["ref_loss"] = zero

    end_points["answer_loss"] = compute_answer_classification_loss(end_points) if use_answer else zero
    end_points["lang_loss"] = (compute_lang_classification_loss(end_points)
                               if use_lang_classifier else zero)
    end_points["align_loss"] = zero
    end_points["mae_loss"] = zero

    loss = sum(loss_weights.get(k, 1.0) * end_points[k]
               for k in ("vote_loss", "objectness_loss", "box_loss", "sem_cls_loss", "ref_loss",
                         "lang_loss", "answer_loss", "mae_loss", "align_loss"))
    loss = loss * 10  # the reference's amplification
    end_points["loss"] = loss
    return loss, end_points
