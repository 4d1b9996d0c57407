"""Real-data parity dry-dock: reference checkpoint -> converter -> forward
-> predictions, with an optional diff against the torch reference
(counterpart of ``scripts/verify_parity.py``).

Given a reference checkpoint (``model.pth`` from the reference's
``scripts/train.py``) and a scene, this script:

1. converts the torch state dict onto the port's modules
   (``convert.load_reference_checkpoint``: the port's copy of
   ``convert_scanqa``, then ``merge_pretrained`` over the model's own tree)
   and reports any shape-mismatched or unmapped keys;
2. runs the detector (and the BLIP rank path when the checkpoint carries
   ``blip_model.*`` weights) on the scene, with the exact scan-order ball
   query (``grouping.FORCE_MODE = "exact"``), as the JAX script pins it;
3. decodes boxes through ``predict.py``'s NMS configuration and writes the
   JSON report with boxes and answers;
4. with ``--expected`` (a JSON of reference outputs for the same inputs,
   from the reference's ``scripts/predict.py``), diffs boxes (max |corner
   delta| against ``--box_tol``) and answers (exact match) and reports
   PASS/FAIL.

The JAX script's flags, plus ``--device`` (the card by default; without one
it raises). Parameters the checkpoint lacks keep the values drawn from seed
0, as the JAX script keeps its ``init``'s.

Usage (detector only, synthetic scene, the plumbing self-test):
  python -m bridgeqa_tpu_torch.scripts.verify_parity --checkpoint ckpt.pth --synthetic \
      --out report.json
Real data:
  python -m bridgeqa_tpu_torch.scripts.verify_parity --checkpoint model.pth \
      --scene_npy scene0000_00.npy --question "what color is the chair" --image view.jpg \
      --answer_vocab vocab.json
"""

import argparse
import json

import numpy as np
import torch

from bridgeqa_tpu_torch.scripts import common


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", required=True, help="reference torch model.pth")
    p.add_argument("--scene_npy", default=None, help="scene _aligned_vert.npy")
    p.add_argument("--synthetic", action="store_true", help="random 20k-point scene")
    p.add_argument("--num_points", type=int, default=20000)
    p.add_argument("--question", default=None)
    p.add_argument("--image", default=None, help="best-view image for the question")
    p.add_argument("--answer_vocab", default=None, help="answer_vocab.json of the run")
    p.add_argument("--vocab_txt", default=None, help="bert-base-uncased vocab.txt")
    p.add_argument("--k_test", type=int, default=256)
    p.add_argument("--num_proposal", type=int, default=256)
    p.add_argument("--expected", default=None,
                   help="JSON of reference outputs to diff against")
    p.add_argument("--box_tol", type=float, default=1e-3)
    p.add_argument("--tiny_backbone", action="store_true",
                   help="scaled-down SA npoints (fast plumbing checks on CPU)")
    p.add_argument("--out", default="parity_report.json")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def load_points(args):
    if args.synthetic or args.scene_npy is None:
        rng = np.random.RandomState(0)
        return ((rng.rand(args.num_points, 3) - 0.5) * 6.0).astype(np.float32)
    verts = np.load(args.scene_npy)
    pts = verts[:, :3].astype(np.float32)
    # 40k/20k random sample like the dataset (dataset.py:415)
    idx = np.random.RandomState(0).choice(len(pts), args.num_points,
                                          replace=len(pts) < args.num_points)
    return pts[idx]


def main(argv=None):
    args = parse_args(argv)
    device = common.resolve_device(args.device)

    from bridgeqa_tpu_torch.convert import load_reference_checkpoint
    from bridgeqa_tpu_torch.data.scannet_config import ScannetDatasetConfig
    from bridgeqa_tpu_torch.eval.detection_eval import parse_predictions
    from bridgeqa_tpu_torch.models.bridgeqa import BridgeQA, BridgeQAConfig
    from bridgeqa_tpu_torch.models.layers import init_weights
    from bridgeqa_tpu_torch.ops import grouping
    from bridgeqa_tpu_torch.utils.blip_checkpoint import load_torch_checkpoint

    sd = {k.removeprefix("module."): v for k, v in load_torch_checkpoint(args.checkpoint).items()}
    has_blip = any(k.startswith("blip_model.") for k in sd)
    dc = ScannetDatasetConfig()

    num_answers = 1
    answer_vocab = None
    if args.answer_vocab:
        with open(args.answer_vocab) as f:
            answer_vocab = json.load(f)
            if isinstance(answer_vocab, dict):
                answer_vocab = answer_vocab.get("answers", list(answer_vocab))
        num_answers = len(answer_vocab)

    stage = "VQA" if has_blip else "DET"
    backbone_kw = {}
    if args.tiny_backbone:
        backbone_kw = dict(backbone_sa_npoints=(128, 64, 32, 16),
                           backbone_sa_nsamples=(8, 8, 8, 8))
    cfg = BridgeQAConfig(num_answers=max(num_answers, 1), num_proposal=args.num_proposal,
                         stage=stage, **backbone_kw)
    model = BridgeQA(cfg, mean_size_arr=dc.mean_size_arr, device=device)
    init_weights(model, torch.Generator(device=device).manual_seed(0))

    points = load_points(args)[None]  # (1, N, 3)
    batch = {"point_clouds": torch.from_numpy(points).to(device)}
    report = {"checkpoint": args.checkpoint, "stage": stage}

    if stage == "VQA":
        from bridgeqa_tpu_torch.data.tokenization import (
            WordPieceTokenizer,
            make_answer_list,
            make_question_batch,
        )

        if args.vocab_txt:
            tok = WordPieceTokenizer.from_vocab_file(args.vocab_txt)
        else:
            tok = common.synthetic_tokenizer()
        q_ids, q_mask = make_question_batch(tok, [args.question or "what is this"], 80)
        if args.image:
            from PIL import Image

            from bridgeqa_tpu_torch.data.views import preprocess_vqa

            images = preprocess_vqa(np.asarray(Image.open(args.image).convert("RGB")))[None]
        else:
            images = np.zeros((1, 480, 480, 3), np.float32)
        ids, mask = make_answer_list(tok, answer_vocab or ["yes", "no"], 12)
        batch.update({k: torch.from_numpy(np.asarray(v)).to(device) for k, v in (
            ("question_ids", q_ids), ("question_mask", q_mask), ("images", images),
            ("answer_list_ids", ids), ("answer_list_mask", mask))})

    loaded, skipped = load_reference_checkpoint(model, sd)
    report["params_loaded"] = len(loaded)
    report["params_skipped"] = [s for s in skipped if "no such param" not in s]

    # Bitwise box comparison is this tool's contract: the exact scan-order
    # ball query (the stripe query is distribution-equivalent, not bitwise
    # against the reference's in-order fill); the mode is set back after
    force_mode, grouping.FORCE_MODE = grouping.FORCE_MODE, "exact"
    try:
        with torch.no_grad():
            if stage == "DET":
                out = model(batch)
            else:
                out = model(batch, inference="rank", k_test=min(args.k_test, num_answers))
    finally:
        grouping.FORCE_MODE = force_mode
    with torch.no_grad():
        ep = {k: v for k, v in out.items() if torch.is_tensor(v)}
        ep["point_clouds"] = batch["point_clouds"]
        cfg_dict = dict(dataset_config=dc, remove_empty_box=False, use_3d_nms=True,
                        cls_nms=True, nms_iou=0.25, use_old_type_nms=False, conf_thresh=0.05,
                        per_class_proposal=True)
        preds = parse_predictions(ep, cfg_dict)
    report["num_boxes_kept"] = len(preds[0]) // dc.num_class
    report["bbox_corners"] = out["bbox_corner"][0].float().cpu().numpy().tolist()
    report["objectness"] = out["objectness_scores"][0].float().cpu().numpy().tolist()
    if "answer_scores" in out and answer_vocab:
        scores = out["answer_scores"][0].float().cpu().numpy()
        top10 = np.argsort(-scores)[:10]
        report["answer_top10"] = [answer_vocab[i] for i in top10]

    if args.expected:
        with open(args.expected) as f:
            exp = json.load(f)
        diffs = {}
        if "bbox_corners" in exp:
            ours = np.asarray(report["bbox_corners"])
            theirs = np.asarray(exp["bbox_corners"])
            diffs["bbox_max_abs_delta"] = float(np.abs(ours - theirs).max())
            diffs["bbox_ok"] = bool(diffs["bbox_max_abs_delta"] < args.box_tol)
        if "answer_top10" in exp and "answer_top10" in report:
            diffs["answer_top1_match"] = report["answer_top10"][0] == exp["answer_top10"][0]
            diffs["answer_top10_overlap"] = len(
                set(report["answer_top10"]) & set(exp["answer_top10"]))
        report["diff"] = diffs
        report["pass"] = all(v for k, v in diffs.items() if k.endswith(("_ok", "_match")))

    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    kept = report["num_boxes_kept"]
    print(f"wrote {args.out}: {report['params_loaded']} params loaded, "
          f"{len(report['params_skipped'])} skipped, {kept} boxes kept"
          + (f", pass={report.get('pass')}" if args.expected else ""))
    return report


if __name__ == "__main__":
    main()
