"""Back-project per-frame ENet features onto scene points, max-pooled
across views (counterpart of ``scripts/project_multiview_features.py``, the
reference's ``scripts/project_multiview_features.py``).

For every scene, each point is projected into its frames (the intrinsics
rescaled to the 41x32 feature grid, depth 0.1-4.0 m, accuracy 0.05 m), the
depth-consistent features are gathered and max-pooled across views, and
``<out>/<scene>.npy`` holds the per-point 128-d features: the
``use_multiview`` channels of the data pipeline. The views of a scene are
one batched computation on ``--device`` (the card by default; without one
it raises). Real depth frames are read with PIL.

Demo: ``python -m bridgeqa_tpu_torch.scripts.project_multiview_features --synthetic
--device cpu --out /tmp/proj``
"""

import argparse
import os

import numpy as np
import torch

from bridgeqa_tpu_torch.scripts import common
from bridgeqa_tpu_torch.tools.projection import (
    FEATURE_DIMS,
    ProjectionHelper,
    adjust_intrinsic,
    project_scene_multiview,
)

# ScanNet frames_square default intrinsics at 640x480 (reference driver)
DEFAULT_INTRINSIC = np.array([
    [577.870605, 0.0, 319.5, 0.0],
    [0.0, 577.870605, 239.5, 0.0],
    [0.0, 0.0, 1.0, 0.0],
    [0.0, 0.0, 0.0, 1.0],
], dtype=np.float64)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--features_root", type=str, default=None,
                   help="per-frame feature npys (compute_multiview_features output)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--mode", type=str, default="maxpool", choices=["maxpool", "mean"])
    p.add_argument("--max_views", type=int, default=8)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def synthetic_scene():
    rng = np.random.RandomState(0)
    n, v = 500, 3
    w, h = FEATURE_DIMS
    intr = np.eye(4)
    intr[0, 0] = intr[1, 1] = 10.0
    intr[0, 2], intr[1, 2] = w / 2, h / 2
    points = rng.rand(n, 3).astype(np.float32) * 2 - 1
    points[:, 2] += 2.0  # in front of the identity camera
    poses = np.tile(np.eye(4, dtype=np.float32), (v, 1, 1))
    depths = np.full((v, h, w), 2.0, np.float32)
    feats = rng.rand(v, h, w, 128).astype(np.float32)
    return {"synth0000_00": (points, poses, depths, feats, intr)}


def load_real_scenes(args):
    from PIL import Image

    from bridgeqa_tpu_torch.data.pipeline import load_scene_npy

    frames_root = os.path.join(args.data_root, "frames_square")
    scannet_dir = os.path.join(args.data_root, "scannet_data")
    for scene_id in sorted(os.listdir(args.features_root)):
        scene = load_scene_npy(scannet_dir, scene_id)
        points = scene["mesh_vertices"][:, :3].astype(np.float32)
        frame_dir = os.path.join(args.features_root, scene_id)
        names = sorted(os.listdir(frame_dir))[: args.max_views]
        feats, poses, depths = [], [], []
        for name in names:
            stem = os.path.splitext(name)[0]
            feats.append(np.load(os.path.join(frame_dir, name)))
            poses.append(np.loadtxt(os.path.join(frames_root, scene_id, "pose", f"{stem}.txt")))
            dimg = Image.open(os.path.join(frames_root, scene_id, "depth", f"{stem}.png"))
            d = np.asarray(dimg, np.float32) / 1000.0
            # resize depth to the feature grid
            d = np.asarray(Image.fromarray(d).resize(FEATURE_DIMS, Image.NEAREST))
            depths.append(d)
        intr = adjust_intrinsic(DEFAULT_INTRINSIC, (640, 480), FEATURE_DIMS)
        yield scene_id, (points, np.stack(poses).astype(np.float32),
                         np.stack(depths), np.stack(feats), intr)


def main(argv=None):
    args = parse_args(argv)
    device = common.resolve_device(args.device)
    scenes = synthetic_scene().items() if (args.synthetic or not args.data_root) \
        else load_real_scenes(args)

    os.makedirs(args.out, exist_ok=True)
    n = 0
    for scene_id, (points, poses, depths, feats, intr) in scenes:
        helper = ProjectionHelper(intr, image_dims=(depths.shape[2], depths.shape[1]))
        arrays = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
                  for a in (points, poses, depths, feats)]
        agg = project_scene_multiview(helper, *arrays, mode=args.mode).cpu().numpy()
        np.save(os.path.join(args.out, f"{scene_id}.npy"), agg)
        n += 1
    print(f"projected multiview features for {n} scenes -> {args.out}")
    return n


if __name__ == "__main__":
    main()
