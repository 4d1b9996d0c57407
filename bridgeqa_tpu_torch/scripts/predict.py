"""Produce ``pred.<split>.json`` from a trained run of the PyTorch port.

Counterpart of ``scripts/predict.py`` (the reference's
``scripts/predict.py:222-421``): replays the run configuration from
``info.json`` (``overwrite_config``, 382-389), restores the best ``model``
checkpoint, and for every batch runs rank inference + objectness-masked
grounding. Output records mirror the reference schema
(``predict.py:353-358``): scene_id, question_id, answer_top10, bbox
(8 corners of the grounded proposal); with ``--open_ended`` also the
beam-searched answer, decoded to text by the run's tokenizer.

Box decoding, NMS masking and answer top-10 run on the device, in eval mode
without grad (the fused kernels' gates); the host only formats JSON. With
``--output_attention`` each record also carries the last twin-encoder
layer's attention probabilities under the reference's keys
(``2d_self_attention``, ``3d_self_attention``, ``2d_cross_attention``,
``3d_cross_attention``; ``predict.py:359-365``), as nested lists.
"""

import argparse
import json
import os

import numpy as np
import torch

from bridgeqa_tpu_torch.data.answers import Answer
from bridgeqa_tpu_torch.data.device_feed import device_batches
from bridgeqa_tpu_torch.data.tokenization import make_answer_list
from bridgeqa_tpu_torch.eval.detection_eval import parse_predictions_device
from bridgeqa_tpu_torch.scripts import common
from bridgeqa_tpu_torch.train import checkpoints

# the twin encoder's last-layer attention dumps (``--output_attention``)
ATTENTION_KEYS = ("2d_self_attention", "3d_self_attention", "2d_cross_attention",
                  "3d_cross_attention")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run_dir", type=str, required=True)
    p.add_argument("--split", type=str, default="val",
                   choices=["val", "test_w_obj", "test_wo_obj", "train"])
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--k_test", type=int, default=256)
    p.add_argument("--nms_iou", type=float, default=0.25)
    p.add_argument("--open_ended", action="store_true",
                   help="also beam-search a free-form answer per question "
                        "(reference predict.py's open-ended generation path)")
    p.add_argument("--num_beams", type=int, default=5)
    p.add_argument("--gen_max_length", type=int, default=20)
    p.add_argument("--output_attention", action="store_true",
                   help="dump the last twin-encoder layer's 2d/3d self/cross "
                        "attention probs per sample")
    p.add_argument("--device", type=str, default="cuda",
                   help="a CUDA card (default; fails without one) or 'cpu'")
    return p.parse_args(argv)


def overwrite_config(args, info: dict):
    """Reconstruct the train-time namespace (``utils/misc.py:38``); the
    device is this call's, not the training run's, and remat is off."""
    merged = argparse.Namespace(**info)
    merged.run_dir = args.run_dir
    merged.split = args.split
    merged.k_test = args.k_test
    merged.nms_iou = args.nms_iou
    merged.device = args.device
    # remat saves training memory and changes no forward without grad; the
    # fused scoring path and the KV-cache decode refuse it (as JAX's do)
    merged.remat = False
    if args.batch_size:
        merged.batch_size = args.batch_size
    merged.use_unanswerable = True  # predict.py uses the full split
    return merged


def load_run(cli, splits):
    """(args, dataset of the first split, tokenizer, answer_cands, model,
    dataset config, device): the run's configuration and best weights, the
    dataset indexing the run's answer vocabulary."""
    info = checkpoints.load_run_info(cli.run_dir)
    args = overwrite_config(cli, info)
    device = common.resolve_device(args.device)
    answer_cands, _ = checkpoints.load_answer_vocab(cli.run_dir)
    datasets, tokenizer, _, _ = common.build_datasets(args, splits=splits)
    dataset = datasets[splits[0]]
    # predictions must index the run's answer vocab, not a rebuilt one
    dataset.answer_cands = answer_cands
    dataset.answer_vocab = Answer(answer_cands)
    dataset.num_answers = len(answer_cands)
    model, _, dc = common.build_model(args, num_answers=len(answer_cands), device=device)
    checkpoints.load_params(cli.run_dir, "model", model)
    return args, dataset, tokenizer, answer_cands, model.eval(), dc, device


def main(argv=None):
    cli = parse_args(argv)
    split = "val" if cli.split in ("train", "val") else cli.split
    args, dataset, tokenizer, answer_cands, model, dc, device = load_run(cli, (split,))
    mean_size = torch.as_tensor(dc.mean_size_arr, dtype=torch.float32, device=device)

    ids, mask = make_answer_list(tokenizer, answer_cands, args.answer_len)
    answer_list = {"answer_list_ids": torch.from_numpy(ids).to(device),
                   "answer_list_mask": torch.from_numpy(mask).to(device)}

    @torch.no_grad()
    def infer(batch):
        out = model(batch, inference="rank", k_test=args.k_test,
                    output_attentions=cli.output_attention)
        # objectness-masked grounding + on-device NMS suppression
        dev = parse_predictions_device(
            out["center"], out["heading_scores"], out["heading_residuals"],
            out["size_scores"], out["size_residuals"], out["sem_cls_scores"],
            out["objectness_scores"], batch["point_clouds"], mean_size,
            num_heading_bin=dc.num_heading_bin, nms_iou=args.nms_iou,
        )
        pred_mask = dev["pred_mask"].float()
        masked_ref = out["cluster_ref"].float() - 1e6 * (1.0 - pred_mask)
        grounded = masked_ref.argmax(dim=1)
        rows = torch.arange(grounded.shape[0], device=grounded.device)
        corners = out["bbox_corner"][rows, grounded].float()
        top10 = torch.argsort(out["answer_scores"], dim=1, descending=True, stable=True)[:, :10]
        return top10, corners, {k: out[k] for k in ATTENTION_KEYS if out.get(k) is not None}

    @torch.no_grad()
    def generate(batch):
        out = model(batch, inference="generate", num_beams=cli.num_beams,
                    max_length=cli.gen_max_length)
        return out["generated_ids"]

    loader = common.make_loader(dataset, args, shuffle=False)
    preds = []
    try:
        for batch in device_batches(loader, device):
            batch.update(answer_list)
            top10, corners, attention = infer(batch)
            top10, corners = top10.cpu().numpy(), corners.cpu().numpy()
            attention = {k: v.float().cpu().numpy() for k, v in attention.items()}
            gen_texts = None
            if cli.open_ended:
                gen_ids = generate(batch).cpu().numpy()
                gen_texts = [tokenizer.decode(row) for row in gen_ids]
            for i in range(len(batch["question_id_str"])):
                rec = {
                    "scene_id": batch["scene_id_str"][i],
                    "question_id": batch["question_id_str"][i],
                    "question": batch["question"][i],
                    "answer_top10": [answer_cands[j] for j in top10[i]],
                    "bbox": np.asarray(corners[i], np.float32).tolist(),
                }
                if gen_texts is not None:
                    rec["open_ended_answer"] = gen_texts[i]
                for k, v in attention.items():  # the reference's predict.py:359-365
                    rec[k] = v[i].tolist()
                preds.append(rec)
    finally:
        loader.shutdown()

    out_path = os.path.join(cli.run_dir, f"pred.{cli.split}.json")
    with open(out_path, "w") as f:
        json.dump(preds, f, indent=2)
    print(f"wrote {len(preds)} predictions -> {out_path}")
    return preds


if __name__ == "__main__":
    main()
