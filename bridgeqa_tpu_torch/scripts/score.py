"""Score a ``pred.<split>.json`` against gold answers.

Equivalent of the reference ``scripts/score.py`` (218 LoC): EM@1/EM@10 and
captioning metrics (BLEU-1..4, ROUGE-L, METEOR, CIDEr) with the
per-question-type breakdown (``qclass1``, score.py:128-148). Uses the
dependency-free scorers in ``bridgeqa_tpu_torch.eval.scoring`` instead of
pycocoevalcap (same formulas; no Java/nltk downloads).

A copy of ``scripts/score.py`` for the PyTorch port (run as
``python -m bridgeqa_tpu_torch.scripts.score``), importing the port's
modules; ``tests/test_torch_drivers.py`` holds the two equal.
"""

import argparse
import json
import os

from bridgeqa_tpu_torch.eval.scoring import score_predictions
from bridgeqa_tpu_torch.scripts import common


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run_dir", type=str, required=True)
    p.add_argument("--split", type=str, default="val")
    p.add_argument("--pred_file", type=str, default=None)
    p.add_argument("--gold_file", type=str, default=None,
                   help="ScanQA json with gold answers; defaults to the run's data")
    p.add_argument("--data_root", type=str, default=None)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    pred_path = args.pred_file or os.path.join(args.run_dir, f"pred.{args.split}.json")
    with open(pred_path) as f:
        preds = json.load(f)

    if args.gold_file:
        with open(args.gold_file) as f:
            gold_records = json.load(f)
    elif args.data_root:
        gold_records = common.load_scanqa_records(args.data_root, args.split)
    else:
        gold_records = common.synthetic_records(len(preds))

    preds_by_qid = {str(p["question_id"]): p for p in preds}
    results = score_predictions(preds_by_qid, gold_records)
    # self-describing completeness markers (vs the reference's pycocoevalcap
    # stack, scripts/score.py:128-148): parity comparisons must not silently
    # assume these are the Java-pipeline variants
    results["_metric_notes"] = {
        "SPICE": "not computed (Java pycocoevalcap pipeline; out of scope offline)",
        "METEOR": "Lavie-Agarwal aligner, exact + Porter-stem stages; "
                  "WordNet synonym stage inactive (no corpus data offline)",
        "Top1 (F-value)": "identity lemmatization (reference uses nltk "
                          "WordNetLemmatizer; no corpus data offline)",
        "tokenization": "PTB-approximate (lowercase, clitic split, "
                        "punctuation dropped) in place of the Java "
                        "PTBTokenizer",
    }
    out_path = os.path.join(args.run_dir, f"report.{args.split}.json")
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
