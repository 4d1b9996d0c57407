"""Extract the ENet features of every scene frame (counterpart of
``scripts/compute_multiview_features.py``, the reference's
``scripts/compute_multiview_features.py:89-123``).

328x256 frames go through the ENet encoder in batches of ``--batch``; each
frame's (32, 41, 128) map is saved as ``<out>/<scene>/<frame>.npy``. The
last batch is padded with copies of its last frame, and only its real
frames are written, as the JAX driver does.

The JAX driver's flags, plus ``--device`` (the card by default; without one
it raises). ``--enet_ckpt`` reads the reference's torch7 ENet checkpoint
(``scannetv2_enet.pth``) through the port's copy of the converter
(``utils/enet_checkpoint.py``) into ``convert.load_jax_variables``; the JAX
driver restores an orbax tree, which the port has no reader for. Without it
the weights are drawn from seed 0.

Demo: ``python -m bridgeqa_tpu_torch.scripts.compute_multiview_features --synthetic
--device cpu --out /tmp/mv``
"""

import argparse
import os

import numpy as np
import torch

from bridgeqa_tpu_torch.convert import load_jax_variables
from bridgeqa_tpu_torch.models.enet import ENetEncoder
from bridgeqa_tpu_torch.models.layers import init_weights
from bridgeqa_tpu_torch.scripts import common

IMAGE_DIMS = (328, 256)  # (W, H)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--enet_ckpt", type=str, default=None,
                   help="the reference's torch7 ENet .pth; random weights otherwise")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def iter_frames(args):
    if args.synthetic or not args.data_root:
        rng = np.random.RandomState(0)
        for s in range(2):
            for f in range(4):
                yield f"synth{s:04d}_00", f"{f * 20}", rng.rand(IMAGE_DIMS[1], IMAGE_DIMS[0], 3).astype(np.float32)
        return
    from PIL import Image

    frames_root = os.path.join(args.data_root, "frames_square")
    for scene_id in sorted(os.listdir(frames_root)):
        color_dir = os.path.join(frames_root, scene_id, "color")
        if not os.path.isdir(color_dir):
            continue
        for name in sorted(os.listdir(color_dir)):
            img = Image.open(os.path.join(color_dir, name)).convert("RGB")
            img = img.resize(IMAGE_DIMS, Image.BILINEAR)
            yield scene_id, os.path.splitext(name)[0], np.asarray(img, np.float32) / 255.0


def build_encoder(args, device):
    model = ENetEncoder(device)
    if args.enet_ckpt:
        from bridgeqa_tpu_torch.utils.enet_checkpoint import load_enet_torch7

        encoder_variables, _ = load_enet_torch7(args.enet_ckpt)
        load_jax_variables(model, encoder_variables)
    else:
        init_weights(model, torch.Generator(device=device).manual_seed(0))
    return model


def main(argv=None):
    args = parse_args(argv)
    device = common.resolve_device(args.device)
    model = build_encoder(args, device)

    @torch.no_grad()
    def extract(images):
        return model(torch.from_numpy(images).to(device)).cpu().numpy()

    buf, meta, count = [], [], 0
    for scene_id, frame_id, image in iter_frames(args):
        buf.append(image)
        meta.append((scene_id, frame_id))
        if len(buf) == args.batch:
            count += _flush(extract, buf, meta, args.out)
            buf, meta = [], []
    if buf:
        # pad to the batch's shape
        pad = args.batch - len(buf)
        feats_needed = len(buf)
        buf += [buf[-1]] * pad
        count += _flush(extract, buf, meta, args.out, keep=feats_needed)
    print(f"extracted features for {count} frames -> {args.out}")
    return count


def _flush(extract, buf, meta, out_root, keep=None):
    feats = extract(np.stack(buf))
    keep = keep if keep is not None else len(meta)
    for i in range(keep):
        scene_id, frame_id = meta[i]
        d = os.path.join(out_root, scene_id)
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, f"{frame_id}.npy"), feats[i])
    return keep


if __name__ == "__main__":
    main()
