"""Back-project per-frame semantic labels (or RGB colours) onto scene
points (counterpart of ``scripts/project_multiview_labels.py``, the
reference's ``project_multiview_labels.py`` and ``project_multiview_color.py``).

The same depth-consistent projection as the feature driver, applied to
per-frame label maps (a majority vote across views) or RGB frames (the mean
across views), all views of a scene in one batched computation on
``--device`` (the card by default; without one it raises). Votes follow
JAX: a label outside ``[0, num_classes)`` casts no vote (``jax.nn.one_hot``
gives it an all-zero row, where ``F.one_hot`` would raise), a tie goes to
the lowest class (``argmax``'s first index) and a point no view sees gets
-1.

Demo: ``python -m bridgeqa_tpu_torch.scripts.project_multiview_labels --synthetic
--what labels --device cpu --out /tmp/lbl``
"""

import argparse
import os

import numpy as np
import torch

from bridgeqa_tpu_torch.scripts import common
from bridgeqa_tpu_torch.tools.projection import (
    ProjectionHelper,
    _at_pixels,
    aggregate_multiview,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--what", type=str, default="labels", choices=["labels", "color"])
    p.add_argument("--num_classes", type=int, default=41)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def project_labels(helper: ProjectionHelper, points, poses, depths, label_maps,
                   num_classes: int):
    """Majority vote across views: each view gives the hit pixel's label a
    vote; argmax of the votes wins; -1 where no view sees the point.
    points (N, 3), poses (V, 4, 4), depths (V, H, W), label_maps (V, H, W)
    integer -> (N,) int32."""
    uv, valid = helper.project(points, poses, depths)
    lab = _at_pixels(label_maps, uv)  # (V, N)
    classes = torch.arange(num_classes, device=lab.device)
    votes = (lab[..., None] == classes).float() * valid[..., None].float()  # (V, N, C)
    total = votes.sum(dim=0)
    seen = total.sum(dim=-1) > 0
    return torch.where(seen, total.argmax(dim=-1), -1).to(torch.int32)


def project_color(helper: ProjectionHelper, points, poses, depths, colors):
    """Mean RGB across the views that see each point: colors (V, H, W, 3)
    -> (N, 3)."""
    feats, valid = helper.project_features(points, poses, depths, colors)
    return aggregate_multiview(feats, valid, mode="mean")


def synthetic_scene(what: str, num_classes: int):
    rng = np.random.RandomState(0)
    n, v, w, h = 400, 3, 41, 32
    intr = np.eye(4)
    intr[0, 0] = intr[1, 1] = 10.0
    intr[0, 2], intr[1, 2] = w / 2, h / 2
    points = rng.rand(n, 3).astype(np.float32) * 1.5 - 0.75
    points[:, 2] += 2.0
    poses = np.tile(np.eye(4, dtype=np.float32), (v, 1, 1))
    depths = np.full((v, h, w), 2.0, np.float32)
    if what == "labels":
        maps = rng.randint(0, num_classes, (v, h, w)).astype(np.int32)
    else:
        maps = rng.rand(v, h, w, 3).astype(np.float32)
    return {"synth0000_00": (points, poses, depths, maps, intr)}


def main(argv=None):
    args = parse_args(argv)
    device = common.resolve_device(args.device)
    scenes = synthetic_scene(args.what, args.num_classes).items()
    # the real-data path is project_multiview_features.load_real_scenes with
    # label pngs / color jpgs in place of the feature npys
    os.makedirs(args.out, exist_ok=True)
    n = 0
    for scene_id, (points, poses, depths, maps, intr) in scenes:
        helper = ProjectionHelper(intr, image_dims=(depths.shape[2], depths.shape[1]))
        points, poses, depths, maps = (torch.from_numpy(np.ascontiguousarray(a)).to(device)
                                       for a in (points, poses, depths, maps))
        if args.what == "labels":
            out = project_labels(helper, points, poses, depths, maps, args.num_classes)
        else:
            out = project_color(helper, points, poses, depths, maps)
        np.save(os.path.join(args.out, f"{scene_id}.npy"), out.cpu().numpy())
        n += 1
    print(f"projected {args.what} for {n} scenes -> {args.out}")
    return n


if __name__ == "__main__":
    main()
