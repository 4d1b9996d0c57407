"""Greedy NMS (2D / 3D / 3D-same-class) over a batch of fixed box counts
(counterpart of ``bridgeqa_tpu/geometry/nms.py``).

Replaces the host-side python loops of ``utils/nms.py:40-151``. Each
iteration picks the highest-scoring surviving box of every row, marks it
picked, and suppresses its overlaps above threshold. Output is a boolean
pick mask over the static number of boxes.

JAX loops ``while any(alive)`` inside ``lax.while_loop``; in PyTorch that
test would wait for the card every iteration. Here the loop runs a fixed K
iterations (K boxes: every iteration retires at least the box it picks, so
K always suffice) over the whole batch at once, and a row with no box left
alive is guarded, not tested: it picks nothing more. The loop never reads a
value back. The overlaps are computed once, as a (B, K, K) matrix, with the
operations JAX computes a row of them with.

Greedy-order equivalence with the reference: the reference sorts ascending
and pops from the back, suppressing strictly-greater overlaps; ``argmax``
here visits boxes in the same descending-score order (ties resolve to the
lower index, as ``jnp.argmax`` does).
"""

import torch


def _greedy_nms(overlaps, scores, valid, threshold):
    """Greedy NMS of each row.

    Args:
      overlaps: (B, K, K) overlap of box i (dim 1) against every box.
      scores: (B, K) float scores.
      valid: (B, K) bool mask of boxes to consider at all.
      threshold: suppress j if overlap(i, j) > threshold.

    Returns:
      (B, K) bool pick mask.
    """
    b, k = scores.shape
    rows = torch.arange(b, device=scores.device)
    cols = torch.arange(k, device=scores.device)
    suppress = overlaps > threshold
    alive = valid.clone()
    picked = torch.zeros_like(alive)
    for _ in range(k):
        i = torch.where(alive, scores, float("-inf")).argmax(dim=1)
        hit = cols[None, :] == i[:, None]  # each row's pick (tensor ops only: no host copy)
        picked |= hit & alive.any(dim=1, keepdim=True)
        alive &= ~suppress[rows, i] & ~hit
    return picked


def _iou_matrix(boxes_min, boxes_max):
    """(B, K, K) IoU of every box pair of a row from min/max extents, as
    JAX's ``overlap(i)`` computes each row."""
    vol = torch.prod(boxes_max - boxes_min, dim=-1)
    lo = torch.maximum(boxes_min[:, :, None], boxes_min[:, None, :])
    hi = torch.minimum(boxes_max[:, :, None], boxes_max[:, None, :])
    inter = torch.prod(torch.clamp(hi - lo, min=0.0), dim=-1)
    return inter / (vol[:, :, None] + vol[:, None, :] - inter)


def _valid(scores, valid):
    return torch.ones_like(scores, dtype=torch.bool) if valid is None else valid


def nms_3d(boxes_min, boxes_max, scores, threshold, valid=None):
    """3D NMS, semantics of ``nms_3d_faster`` (``utils/nms.py:75-110``).

    Args:
      boxes_min / boxes_max: (B, K, 3) axis-aligned extents.
      scores: (B, K).
      threshold: IoU threshold.
      valid: optional (B, K) bool; invalid boxes are never picked.

    Returns:
      (B, K) bool pick mask.
    """
    return _greedy_nms(_iou_matrix(boxes_min, boxes_max), scores, _valid(scores, valid),
                       threshold)


def nms_3d_samecls(boxes_min, boxes_max, scores, cls, threshold, valid=None):
    """3D NMS suppressing only same-class overlaps
    (``nms_3d_faster_samecls``, ``utils/nms.py:112-151``); cls (B, K)."""
    same = (cls[:, :, None] == cls[:, None, :]).to(scores.dtype)
    return _greedy_nms(_iou_matrix(boxes_min, boxes_max) * same, scores,
                       _valid(scores, valid), threshold)


def nms_2d(boxes_min, boxes_max, scores, threshold, valid=None):
    """2D NMS (``nms_2d_faster``, ``utils/nms.py:39-73``) on (B, K, 2) extents."""
    return _greedy_nms(_iou_matrix(boxes_min, boxes_max), scores, _valid(scores, valid),
                       threshold)
