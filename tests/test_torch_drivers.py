"""The port's drivers on the CPU: the solver's schedule, checkpoints, the DET
graft, the tiny driver chain, and eval through the drivers against the JAX
package's ``scripts/eval.py`` with the same weights.

- The chain runs as a user runs it, through each script's ``main(argv)``
  with ``--synthetic --tiny --device cpu --num_workers 1``: ``train
  --first_stage_ckpt_path`` (VQA on a saved DET model) -> ``train
  --use_checkpoint`` -> ``predict`` (rank and ``--open_ended``) -> ``eval
  --qa --detection --repeat 2`` -> ``score``, and must write what JAX's
  ``tests/test_solver.py`` checks.
- Parity: weights saved as a JAX run's ``model`` (a flax tree), carried
  into a port run directory (the same ``info.json`` and
  ``answer_vocab.json``) by ``convert.load_jax_variables``, give the port's
  ``eval --qa`` the accuracies of JAX's ``scripts/eval.py``, and the answer scores within
  1e-4 relative. Both
  sides take the same stripe ball query (JAX's ``FORCE_MODE="stripes"``,
  the port's rule) and the same synthetic images (the port's
  ``SyntheticViewLookup``; the JAX drivers seed theirs from the salted
  ``hash``).
"""

import json
import os
import pickle
import shutil
import types

import numpy as np
import pytest
import torch

from bridgeqa_tpu.ops import grouping as jgrouping
from bridgeqa_tpu.train import checkpoints as jcheckpoints
from bridgeqa_tpu.train import solver as jsolver
from bridgeqa_tpu.utils import logging_utils as jlogging_utils
from bridgeqa_tpu.utils import profiling as jprofiling
from bridgeqa_tpu_torch.convert import export_jax_variables, load_jax_variables
from bridgeqa_tpu_torch.data import sources
from bridgeqa_tpu_torch.models.layers import set_compute_dtype
from bridgeqa_tpu_torch.scripts import common, train
from bridgeqa_tpu_torch.scripts import eval as eval_script
from bridgeqa_tpu_torch.scripts import predict as predict_script
from bridgeqa_tpu_torch.scripts import score as score_script
from bridgeqa_tpu_torch.train import checkpoints, solver
from bridgeqa_tpu_torch.train.optim import build_optimizer
from bridgeqa_tpu_torch.utils import logging_utils, profiling
from scripts import common as jcommon
from scripts import eval as jeval_script
from scripts import score as jscore_script
from tests.test_torch_feed import assert_same_code

# two val records: validation, predict and eval take one batch each
TINY = ["--synthetic", "--tiny", "--device", "cpu", "--num_workers", "1", "--batch_size", "2",
        "--num_points", "2048", "--val_step", "0", "--verbose", "1", "--k_test", "8",
        "--synthetic_val_records", "2"]
ARTIFACTS = ("info.json", "answer_vocab.json", "log.txt", "metrics.jsonl", "model", "model_last",
             "checkpoint", "cmdline.txt", "predictions.csv")


def test_copies_match_originals():
    assert_same_code(logging_utils, jlogging_utils)
    assert_same_code(profiling, jprofiling, names=("PhaseTimer", "PhaseTimer.__init__",
                                                   "PhaseTimer.phase", "PhaseTimer.means",
                                                   "PhaseTimer.reset"))
    assert_same_code(score_script, jscore_script, names=("parse_args", "main"))


def test_bn_momentum_schedule_is_jax():
    for cfg in ({}, {"bn_decay_step": 3, "bn_momentum_min": 0.01}):
        port = types.SimpleNamespace(cfg=solver.SolverConfig(**cfg))
        ref = types.SimpleNamespace(cfg=jsolver.SolverConfig(**cfg))
        got = [solver.Solver.bn_momentum(port, e) for e in range(101)]
        assert got == [jsolver.Solver.bn_momentum(ref, e) for e in range(101)]
    assert got[0] == 0.5 and got[3] == 0.25 and got[100] == 0.01


def _tiny_model(stage="VQA", seed=0):
    args = train.parse_args(TINY + ["--stage", stage] + (["--no_blip"] if stage == "DET" else []))
    model, _, _ = common.build_model(args, num_answers=4, device=torch.device("cpu"), seed=seed)
    return model


def _stepped_optimizer(model, seed, steps=2):
    """An optimizer whose moments and counts moved: random gradients, no
    forward (the state is what is checked)."""
    optimizer = build_optimizer(model)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=gen)
        optimizer.step()
    return optimizer


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    """Parameters, BN statistics, AdamW moments, each group's count and the
    epoch come back bit for bit into a model and optimizer built from
    another seed; the bf16 copies are made again from the loaded weights."""
    model = set_compute_dtype(_tiny_model(seed=1), torch.bfloat16)
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.normal_(generator=torch.Generator().manual_seed(len(name)))
    optimizer = _stepped_optimizer(model, seed=2)
    checkpoints.save_train_state(tmp_path, model, optimizer, epoch=7)
    assert not os.path.exists(os.path.join(tmp_path, "checkpoint.tmp"))

    other = set_compute_dtype(_tiny_model(seed=3), torch.bfloat16)
    other_opt = _stepped_optimizer(other, seed=4, steps=1)
    assert checkpoints.load_train_state(tmp_path, other, other_opt) == 7
    want, got = model.state_dict(), other.state_dict()
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    saved, loaded = optimizer.state_dict(), other_opt.state_dict()
    assert [g["count"] for g in loaded["param_groups"]] == [2, 2, 2]
    assert [(g["label"], g["count"], g["lr"]) for g in loaded["param_groups"]] == \
        [(g["label"], g["count"], g["lr"]) for g in saved["param_groups"]]
    for i, state in saved["state"].items():
        for k, v in state.items():
            assert torch.equal(loaded["state"][i][k], v), (i, k)
            assert loaded["state"][i][k].device.type == "cpu"
    for m in other.modules():
        if getattr(m, "weight_cast", None) is not None:
            assert torch.equal(m.weight_cast, m.weight.detach().to(torch.bfloat16))

    # the weights alone (model / model_last) too
    checkpoints.save_params(tmp_path, "model", model)
    with torch.no_grad():
        for v in other.state_dict().values():
            v.add_(1)
    checkpoints.load_params(tmp_path, "model", other)
    for k, v in other.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_det_graft_copies_parameters_and_keeps_buffers(tmp_path):
    det = _tiny_model("DET", seed=1)
    for buf in det.buffers():
        buf.add_(1.0)
    checkpoints.save_params(tmp_path, "model_last", det)
    model = _tiny_model(seed=2)
    for name, buf in model.named_buffers():
        if name.endswith("running_var"):
            buf.mul_(3.0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    checkpoints.graft_detector(tmp_path, "model_last", model)
    det_params = dict(det.named_parameters())
    param_names = {k for k, _ in model.named_parameters()}
    for k, v in model.state_dict().items():
        if k in param_names and k.startswith("detector."):
            assert torch.equal(v, det_params[k]), k
        else:  # buffers (the detector's BN statistics among them), other parameters
            assert torch.equal(v, before[k]), k
    assert any(k.startswith("detector.") and k.endswith("running_var") for k in before)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """train (the VQA stage on a DET stage's weights) -> train --use_checkpoint,
    one step each. The DET weights are a DET model's, saved as a DET run's
    ``model_last`` (``test_det_graft_copies_parameters_and_keeps_buffers``
    holds the graft; a DET training run is the train script's other stage,
    run on the card by ``chip_smoke.py`` phase 8)."""
    root = str(tmp_path_factory.mktemp("runs"))
    det = os.path.join(root, "det")
    os.makedirs(det)
    checkpoints.save_params(det, "model_last", _tiny_model("DET", seed=3))
    vqa = train.main(TINY + ["--epochs", "1", "--max_iters_per_epoch", "1", "--output_root", root,
                             "--tag", "vqa", "--first_stage_ckpt_path", det])
    run = os.path.join(root, "vqa")
    resumed = train.main(TINY + ["--epochs", "2", "--max_iters_per_epoch", "1", "--output_root",
                                 root, "--tag", "vqa", "--use_checkpoint", run])
    return root, run, vqa, resumed


def test_train_writes_the_artifacts(chain):
    root, run, vqa, resumed = chain
    for name in ARTIFACTS:
        assert os.path.exists(os.path.join(run, name)), name
    with open(os.path.join(run, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    phases = {r["phase"] for r in recs}
    assert {"train", "val", "timing"} <= phases
    for r in recs:
        for k, v in r.items():
            if isinstance(v, float):
                assert np.isfinite(v), (k, r)
    info = checkpoints.load_run_info(run)
    assert info["tiny"] is True and info["device"] == "cpu"
    assert vqa.cfg.epochs == 1 and resumed.global_iter == 1 and vqa.global_iter == 1
    assert torch.load(os.path.join(run, "checkpoint"), weights_only=True)["epoch"] == 2
    with open(os.path.join(run, "log.txt")) as f:
        log = f.read()
    assert "loaded stage-1 detector" in log and "resumed from" in log


def test_predict_and_score(chain):
    """predict (rank and --open_ended), then score its pred.val.json, as
    the pre-port score script scores it."""
    _, run, *_ = chain
    preds = predict_script.main(["--run_dir", run, "--k_test", "4", "--device", "cpu",
                                 "--open_ended", "--num_beams", "2", "--gen_max_length", "5"])
    assert len(preds) == 2
    with open(os.path.join(run, "pred.val.json")) as f:
        assert json.load(f) == preds
    vocab, _ = checkpoints.load_answer_vocab(run)
    for p in preds:
        assert set(p) >= {"scene_id", "question_id", "answer_top10", "bbox", "open_ended_answer"}
        assert sorted(p["answer_top10"]) == sorted(vocab)
        assert np.isfinite(np.asarray(p["bbox"])).all() and np.asarray(p["bbox"]).shape == (8, 3)
        assert isinstance(p["open_ended_answer"], str)
    report = score_script.main(["--run_dir", run, "--split", "val"])
    assert "EM@1" in report and "BLEU-1" in report and "CIDEr" in report
    assert report == jscore_script.main(["--run_dir", run, "--split", "val"])
    # --output_attention adds the twin encoder's last-layer dumps to each
    # record, as JAX's predict does, and changes no answer
    dumped = predict_script.main(["--run_dir", run, "--k_test", "4", "--device", "cpu",
                                  "--output_attention"])
    info = checkpoints.load_run_info(run)
    lq, heads = info["question_len"], 4  # the tiny config's 4 heads
    widths = {"2d_self_attention": lq, "3d_self_attention": lq,
              "2d_cross_attention": (64 // 16) ** 2 + 1 + lq, "3d_cross_attention": 32 + lq}
    for p, q in zip(dumped, preds):
        assert p["answer_top10"] == q["answer_top10"] and p["bbox"] == q["bbox"]
        for key, width in widths.items():
            att = np.asarray(p[key])
            assert att.shape == (heads, lq, width), key
            np.testing.assert_allclose(att.sum(-1), 1.0, atol=1e-5, err_msg=key)


def test_eval_qa_detection_repeat(chain):
    _, run, *_ = chain
    results = eval_script.main(["--run_dir", run, "--qa", "--detection", "--k_test", "4",
                                "--batch_size", "2", "--repeat", "2", "--device", "cpu"])
    with open(os.path.join(run, "score.val.json")) as f:
        assert json.load(f) == results
    assert {"qa", "mAP@0.25", "mAP@0.5"} <= set(results)
    for v in results["qa"].values():
        assert np.isfinite(v)
    with open(os.path.join(run, "pred.val.pkl"), "rb") as f:
        predictions = pickle.load(f)
    rec = next(iter(next(iter(predictions.values())).values()))
    assert set(rec) >= {"pred_bbox", "gt_bbox", "iou", "pred_answers_at10"}
    with open(os.path.join(run, "score.val.pkl"), "rb") as f:
        scores = pickle.load(f)
    n_samples = sum(len(s) for s in predictions.values())
    assert len(scores["ious"]) == 2 and all(len(t) == n_samples for t in scores["ious"])


def test_no_card_and_unported_options_refuse(tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            train.main(["--synthetic", "--tiny", "--output_root", str(tmp_path)])
    # tensor parallelism shards over ranks: one process cannot take it
    with pytest.raises(ValueError, match="--distributed"):
        train.main(TINY + ["--tp", "2", "--output_root", str(tmp_path)])
    # the MCAN model reads GloVe vectors of the question (lang_feat), which
    # no driver can give it (nor can the JAX drivers: ROADMAP C3)
    with pytest.raises(ValueError, match="lang_feat"):
        train.main(TINY + ["--no_blip", "--output_root", str(tmp_path)])


def test_eval_with_jax_weights_gives_the_jax_accuracies(chain, tmp_path, monkeypatch):
    """Weights saved as a JAX run's ``model`` (a flax tree, beside the
    chain's ``info.json`` and ``answer_vocab.json``), evaluated by
    ``scripts/eval.py`` and, carried into a port run directory by
    ``load_jax_variables``, by the port's eval: the same accuracies, the
    answer scores within 1e-4 relative, the losses within 1e-4 relative."""
    monkeypatch.setattr(jcommon, "synthetic_view_lookup",
                        lambda image_size, seed=0: sources.SyntheticViewLookup(image_size))
    monkeypatch.setattr(jgrouping, "FORCE_MODE", "stripes")  # read while tracing
    _, run, *_ = chain
    jrun, prun = str(tmp_path / "jax"), str(tmp_path / "port")
    info = checkpoints.load_run_info(run)
    info["synthetic_val_records"] = 8  # the JAX drivers' val split, which they do not size
    for d in (jrun, prun):
        os.makedirs(d)
        shutil.copy(os.path.join(run, "answer_vocab.json"), d)
        checkpoints.save_run_info(d, info)

    # JAX-format weights: the port's initialisers' with every parameter and
    # BN statistic moved off its initial value, as a flax tree
    # (``export_jax_variables``), saved as the JAX run's ``model``
    args = predict_script.overwrite_config(predict_script.parse_args(
        ["--run_dir", prun, "--device", "cpu"]), checkpoints.load_run_info(prun))
    answers, _ = checkpoints.load_answer_vocab(prun)
    model, _, _ = common.build_model(args, num_answers=len(answers), device=torch.device("cpu"),
                                     seed=5)
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for v in model.state_dict().values():
            v.add_(torch.from_numpy(0.02 * rng.rand(*v.shape).astype(np.float32)))
    variables = export_jax_variables(model)
    jcheckpoints.save_params(jrun, "model", variables["params"], variables["batch_stats"])

    # the port's run: the JAX run's model file, carried across
    model, _, _ = common.build_model(args, num_answers=len(answers), device=torch.device("cpu"))
    load_jax_variables(model, jcheckpoints.load_params(jrun, "model"))
    checkpoints.save_params(prun, "model", model)

    captured = {"jax": [], "port": []}
    for side, module in (("jax", jeval_script), ("port", eval_script)):
        original = module._accumulate_qa

        def record(cli, batch, end_points, *rest, _side=side, _original=original):
            captured[_side].append({k: torch.as_tensor(np.array(end_points[k])).float().numpy()
                                    for k in ("answer_scores", "answer_scores_2d",
                                              "answer_scores_scene")})
            return _original(cli, batch, end_points, *rest)

        monkeypatch.setattr(module, "_accumulate_qa", record)
    eval_args = ["--qa", "--k_test", "4", "--batch_size", "4"]
    want = jeval_script.main(["--run_dir", jrun] + eval_args)["qa"]
    got = eval_script.main(["--run_dir", prun, "--device", "cpu"] + eval_args)["qa"]

    assert len(captured["port"]) == len(captured["jax"]) == 2
    flipped = []
    for b, (g, w) in enumerate(zip(captured["port"], captured["jax"])):
        for key in ("answer_scores_2d", "answer_scores_scene", "answer_scores"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4, atol=0, err_msg=key)
        rows = np.nonzero(g["answer_scores"].argmax(1) != w["answer_scores"].argmax(1))[0]
        flipped += [(b, int(r)) for r in rows]
    # a near tie that flips a top-1 is held by its scores (above); the
    # answer accuracies may then differ by those rows' share of a batch
    print(f"top-1 flipped in (batch, row): {flipped}")
    assert set(got) == set(want)
    for key, w in want.items():
        if key in ("loss", "pos_ratio", "neg_ratio"):
            assert got[key] == pytest.approx(w, rel=1e-4), key
        elif flipped and key.startswith("answer_acc"):
            assert abs(got[key] - w) <= len(flipped) / 4 / 2 + 1e-9, key
        else:
            assert got[key] == w, key
