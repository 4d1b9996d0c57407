"""ScanNet dataset configuration.

Reimplements the semantics of ``data/scannet/model_util_scannet.py``'s
``ScannetDatasetConfig`` (the file is absent from the reference snapshot; the
semantics are pinned down by its call sites, see SURVEY.md §1 note): 18
classes, a single heading bin (axis-aligned boxes), 18 size clusters with the
standard VoteNet ScanNet mean sizes, and the param→oriented-bounding-box
decoding used by ``models/proposal_module.py:87-108`` and
``lib/loss_helper.py:196-246``.

Everything here has both a numpy path (host-side dataset prep) and jnp-ready
constants; the batched decode used inside the jitted model lives in
``bridgeqa_tpu_torch.geometry.boxes``.

A copy of ``bridgeqa_tpu/data/scannet_config.py``, kept in the port because the port imports
nothing of the JAX package; ``tests/test_torch_feed.py`` holds the two equal.
"""

import numpy as np

# Standard VoteNet/ScanRefer ScanNet v2 mean box sizes (scannet_means.npz),
# rows indexed by size class (== semantic class for ScanNet).
MEAN_SIZE_ARR = np.array(
    [
        [0.76966727, 0.8116021, 0.92573744],
        [1.876858, 1.8425595, 1.1931566],
        [0.61328, 0.6148609, 0.7182701],
        [1.3955007, 1.5121545, 0.83443564],
        [0.97949594, 1.0675149, 0.6329687],
        [0.531663, 0.5955577, 1.7500148],
        [0.9624706, 0.72462326, 1.1481868],
        [0.83221924, 1.0490936, 1.6875663],
        [0.21132214, 0.4206159, 0.5372846],
        [1.4440073, 1.8970833, 0.26985747],
        [1.0294262, 1.4040797, 0.87554324],
        [1.3766412, 0.65521795, 1.6813129],
        [0.6650819, 0.71111923, 1.298853],
        [0.41999173, 0.37906948, 1.7513971],
        [0.59359556, 0.5912492, 0.73919016],
        [0.50867593, 0.50656086, 0.30136237],
        [1.1511526, 1.0546296, 0.49706793],
        [0.47535285, 0.49249494, 0.5802117],
    ],
    dtype=np.float32,
)


class ScannetDatasetConfig:
    """ScanNet detection config (18 NYU40-derived classes, axis-aligned)."""

    def __init__(self):
        self.type2class = {
            "cabinet": 0,
            "bed": 1,
            "chair": 2,
            "sofa": 3,
            "table": 4,
            "door": 5,
            "window": 6,
            "bookshelf": 7,
            "picture": 8,
            "counter": 9,
            "desk": 10,
            "curtain": 11,
            "refrigerator": 12,
            "shower curtain": 13,
            "toilet": 14,
            "sink": 15,
            "bathtub": 16,
            "others": 17,
        }
        self.class2type = {v: k for k, v in self.type2class.items()}
        self.nyu40ids = np.array([3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39])
        self.nyu40id2class = {nyu40id: i for i, nyu40id in enumerate(list(self.nyu40ids))}
        self.num_class = 18
        self.num_heading_bin = 1
        self.num_size_cluster = 18
        self.mean_size_arr = MEAN_SIZE_ARR.copy()

    # ---- angle/size codecs (ScanNet: heading always bin 0) ----

    def angle2class(self, angle):
        """Heading angle -> (class, residual). With one bin: class 0, residual=angle."""
        num_class = self.num_heading_bin
        angle = angle % (2 * np.pi)
        assert angle >= 0 and angle <= 2 * np.pi
        angle_per_class = 2 * np.pi / float(num_class)
        shifted_angle = (angle + angle_per_class / 2) % (2 * np.pi)
        class_id = int(shifted_angle / angle_per_class)
        residual_angle = shifted_angle - (class_id * angle_per_class + angle_per_class / 2)
        return class_id, residual_angle

    def class2angle(self, pred_cls, residual, to_label_format=True):
        num_class = self.num_heading_bin
        angle_per_class = 2 * np.pi / float(num_class)
        angle_center = pred_cls * angle_per_class
        angle = angle_center + residual
        if to_label_format and np.any(angle > np.pi):
            angle = np.where(angle > np.pi, angle - 2 * np.pi, angle)
        return angle

    def class2size(self, pred_cls, residual):
        return self.mean_size_arr[pred_cls] + residual

    def size2class(self, size, type_name):
        return self.type2class[type_name]

    def param2obb(self, center, heading_class, heading_residual, size_class, size_residual):
        heading_angle = self.class2angle(heading_class, heading_residual)
        box_size = self.class2size(int(size_class), size_residual)
        obb = np.zeros((7,))
        obb[0:3] = center
        obb[3:6] = box_size
        obb[6] = heading_angle * -1
        return obb

    def param2obb_batch(self, center, heading_class, heading_residual, size_class, size_residual):
        """Vectorized param2obb over the leading axis. center (K,3), the rest (K,)/(K,3)."""
        heading_angle = self.class2angle(heading_class.astype(np.float64), heading_residual)
        box_size = self.mean_size_arr[size_class] + size_residual
        obb = np.zeros((center.shape[0], 7))
        obb[:, 0:3] = center
        obb[:, 3:6] = box_size
        obb[:, 6] = heading_angle * -1
        return obb


def rotate_aligned_boxes_along_axis(input_boxes, rot_mat, axis):
    """Rotate axis-aligned boxes and recompute their axis-aligned extents.

    Mirrors the ScanRefer/ScanQA helper consumed by the dataset augmentation
    (``lib/dataset.py:447-491``): the centers rotate exactly; the lengths of
    the two in-plane axes become the extents of the rotated rectangle.
    """
    centers, lengths = input_boxes[:, 0:3], input_boxes[:, 3:6]
    new_centers = np.dot(centers, np.transpose(rot_mat))

    if axis == "x":
        d1, d2 = lengths[:, 1] / 2.0, lengths[:, 2] / 2.0
    elif axis == "y":
        d1, d2 = lengths[:, 0] / 2.0, lengths[:, 2] / 2.0
    else:
        d1, d2 = lengths[:, 0] / 2.0, lengths[:, 1] / 2.0

    new_1 = np.zeros((d1.shape[0], 4))
    new_2 = np.zeros((d1.shape[0], 4))

    if axis == "x":
        cols = (1, 2)
    elif axis == "y":
        cols = (0, 2)
    else:
        cols = (0, 1)

    for i, crnr in enumerate([(-1, -1), (1, -1), (1, 1), (-1, 1)]):
        crnrs = np.zeros((d1.shape[0], 3))
        crnrs[:, cols[0]] = crnr[0] * d1
        crnrs[:, cols[1]] = crnr[1] * d2
        crnrs = np.dot(crnrs, np.transpose(rot_mat))
        new_1[:, i] = crnrs[:, cols[0]]
        new_2[:, i] = crnrs[:, cols[1]]

    new_d1 = 2.0 * np.max(new_1, 1)
    new_d2 = 2.0 * np.max(new_2, 1)

    if axis == "x":
        new_lengths = np.stack((lengths[:, 0], new_d1, new_d2), axis=1)
    elif axis == "y":
        new_lengths = np.stack((new_d1, lengths[:, 1], new_d2), axis=1)
    else:
        new_lengths = np.stack((new_d1, new_d2, lengths[:, 2]), axis=1)

    return np.concatenate([new_centers, new_lengths], axis=1)
