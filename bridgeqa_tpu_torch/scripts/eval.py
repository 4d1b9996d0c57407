"""Evaluate a trained run of the PyTorch port: QA metrics (--qa) and/or
detector mAP (--detection).

Counterpart of ``scripts/eval.py`` (the reference's ``scripts/eval.py``,
``eval_qa`` 264-440, ``eval_det`` 442-507): restores the run, loops the val
split, and reports EM@1/EM@10, grounding IoU rates, objectness/semantic
accuracy, and AP@0.25/0.5 through the APCalculator. The forwards run in
eval mode without grad (the fused kernels' gates), the metric math on the
device; only AP's variable-length per-scan lists are host-side.

Alongside the aggregate ``score.<split>.json`` this writes the reference's
per-sample artifacts (``eval.py:301-303,383-420``): ``pred.<split>.pkl``
({scene_id: {question_id: {pred_bbox, gt_bbox, iou, pred_answers_at10}}}),
its flattened ``pred.<split>.pkl.json`` conversion, and
``score.<split>.pkl`` (per-batch metric lists per trial).
"""

import argparse
import json
import os
import pickle

import numpy as np
import torch

from bridgeqa_tpu_torch.data.device_feed import device_batches
from bridgeqa_tpu_torch.data.tokenization import make_answer_list
from bridgeqa_tpu_torch.eval.detection_eval import APCalculator, parse_groundtruths, parse_predictions
from bridgeqa_tpu_torch.eval.qa_eval import get_eval
from bridgeqa_tpu_torch.scripts import common
from bridgeqa_tpu_torch.scripts.predict import load_run
from bridgeqa_tpu_torch.train.step import StepConfig, eval_step
from bridgeqa_tpu_torch.utils.logging_utils import RunningMeans


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run_dir", type=str, required=True)
    p.add_argument("--split", type=str, default="val")
    p.add_argument("--qa", action="store_true")
    p.add_argument("--detection", action="store_true")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--k_test", type=int, default=256)
    p.add_argument("--nms_iou", type=float, default=0.25)
    p.add_argument("--repeat", type=int, default=1,
                   help="number of seeded eval trials; per-trial metric lists are "
                        "stacked into score.<split>.pkl (reference eval.py:297-312,517)")
    p.add_argument("--seed", type=int, default=42, help="base seed; trial t uses seed+t")
    p.add_argument("--force", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="a CUDA card (default; fails without one) or 'cpu'")
    return p.parse_args(argv)


SCALAR_KEYS = ("loss", "ref_acc_mean", "ref_iou_rate_0.25", "ref_iou_rate_0.5", "lang_acc",
               "obj_acc", "sem_acc", "answer_acc_at1", "answer_acc_at10",
               "answer_acc_at1_scene", "answer_acc_at1_2d", "answer_acc_at1_2d3d",
               "pos_ratio", "neg_ratio")
PER_SAMPLE_KEYS = ("ref_acc", "ref_iou", "pred_bboxes", "gt_bboxes", "pred_answers_at10",
                   "lang_acc", "answer_acc_at1", "answer_acc_at10")


def _host(end_points, keys) -> dict:
    return {k: end_points[k].detach().float().cpu().numpy() if end_points[k].is_floating_point()
            else end_points[k].detach().cpu().numpy() for k in keys if k in end_points}


def _accumulate_qa(cli, batch, end_points, agg, batch_lists, predictions, answer_cands):
    """Fold one eval batch into the running means, the per-batch metric
    lists, and the per-sample prediction records (reference eval.py:318-420)."""
    agg.update({k: float(v) for k, v in _host(end_points, SCALAR_KEYS).items()})
    per = _host(end_points, PER_SAMPLE_KEYS)
    batch_lists["ref_acc"] += np.asarray(per["ref_acc"]).tolist()
    batch_lists["ious"] += np.asarray(per["ref_iou"]).tolist()
    if "lang_acc" in per:
        batch_lists["lang_acc"].append(float(per["lang_acc"]))
    batch_lists["answer_acc_at1"].append(float(per["answer_acc_at1"]))
    batch_lists["answer_acc_at10"].append(float(per["answer_acc_at10"]))
    for i in range(len(batch["question_id_str"])):
        scene_id = batch["scene_id_str"][i]
        qid = batch["question_id_str"][i]
        rec = predictions.setdefault(scene_id, {}).setdefault(qid, {})
        rec["pred_bbox"] = np.asarray(per["pred_bboxes"][i])
        rec["gt_bbox"] = np.asarray(per["gt_bboxes"][i])
        rec["iou"] = float(per["ref_iou"][i])
        if "pred_answers_at10" in per:
            rec["pred_answers_at10"] = [
                answer_cands[j] if j < len(answer_cands) else "<pad>"
                for j in np.asarray(per["pred_answers_at10"][i])]


def main(argv=None):
    cli = parse_args(argv)
    if not (cli.qa or cli.detection):
        cli.qa = True
    args, dataset, tokenizer, answer_cands, model, dc, device = load_run(cli, (cli.split,))
    info = vars(args)

    detection_only = info.get("stage") == "DET" or info.get("no_blip")
    extra = {}
    if not detection_only:
        ids, mask = make_answer_list(tokenizer, answer_cands, args.answer_len)
        extra = {"answer_list_ids": torch.from_numpy(ids).to(device),
                 "answer_list_mask": torch.from_numpy(mask).to(device)}
    step_cfg = StepConfig(detection=True, use_reference=not info.get("no_reference", False),
                          use_lang_classifier=not info.get("no_lang_cls", False),
                          use_answer=False)

    @torch.no_grad()
    def evaluate(batch):
        end_points = eval_step(model, batch, k_test=args.k_test, step_cfg=step_cfg,
                               dataset_config=dc)
        return get_eval(end_points, dc, use_lang_classifier=not info.get("no_lang_cls", False))

    agg = RunningMeans()
    ap25 = APCalculator(0.25, dc.class2type)
    ap50 = APCalculator(0.5, dc.class2type)

    # per-sample records + per-trial stacks of per-batch metric lists
    # (reference eval.py:297-312,318-420: --repeat runs N seeded trials and
    # stacks each trial's metric lists into score.<split>.pkl)
    predictions = {}
    trial_lists = {"ref_acc": [], "lang_acc": [], "answer_acc_at1": [],
                   "answer_acc_at10": [], "ious": []}

    for trial in range(max(1, cli.repeat)):
        # reseed the dataset's point sampling / augmentation stream per trial
        dataset.seed = cli.seed + trial
        dataset.rng = np.random.RandomState(dataset.seed)
        loader = common.make_loader(dataset, args, shuffle=False, seed=dataset.seed)
        batch_lists = {k: [] for k in trial_lists}
        first_trial = trial == 0

        try:
            for batch in device_batches(loader, device):
                batch.update(extra)
                end_points = evaluate(batch)
                if cli.qa:
                    _accumulate_qa(cli, batch, end_points, agg if first_trial else RunningMeans(),
                                   batch_lists, predictions if first_trial else {}, answer_cands)
                if cli.detection and first_trial:
                    cfg_dict = {"dataset_config": dc, "nms_iou": cli.nms_iou}
                    pred = parse_predictions(end_points, cfg_dict)
                    gt = parse_groundtruths(end_points, cfg_dict)
                    ap25.step(pred, gt)
                    ap50.step(pred, gt)
        finally:
            loader.shutdown()
        for k in trial_lists:
            trial_lists[k].append(batch_lists[k])

    results = {}
    if cli.qa:
        results["qa"] = agg.means()
        # reference eval.py:301-303,383-420: per-sample pkl + json conversion
        pred_path = os.path.join(cli.run_dir, f"pred.{cli.split}.pkl")
        with open(pred_path, "wb") as f:
            pickle.dump(predictions, f)
        conved = []
        for scene_id, scene in predictions.items():
            for qid, inst in scene.items():
                inst = {k: v.tolist() if isinstance(v, np.ndarray) else v
                        for k, v in inst.items()}
                inst.update({"scene_id": scene_id, "question_id": qid})
                inst["answer_top10"] = inst.pop("pred_answers_at10", [])
                inst["bbox"] = inst.pop("pred_bbox")
                conved.append(inst)
        with open(pred_path + ".json", "w") as f:
            json.dump(conved, f)
        with open(os.path.join(cli.run_dir, f"score.{cli.split}.pkl"), "wb") as f:
            # one list per trial, stacked (reference eval.py:297-312,517)
            pickle.dump(trial_lists, f)
    if cli.detection:
        for name, calc in (("mAP@0.25", ap25), ("mAP@0.5", ap50)):
            m = calc.compute_metrics()
            results[name] = {k: float(v) for k, v in m.items()}

    out_path = os.path.join(cli.run_dir, f"score.{cli.split}.json")
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
