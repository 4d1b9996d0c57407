"""The port's parallelism (``bridgeqa_tpu_torch/parallel/``, ``train
--distributed``) on the CPU: two gloo ranks against one process on the
global batch and against the JAX package.

One pair of processes (``tests/_torch_parallel_worker.py``, each started as
a fresh interpreter, never a fork of this one; they import no JAX) runs
every distributed check in turn, while this process computes what each is
held to:

- the DDP train step on two ranks (each on its half of the global batch)
  against one process on the whole batch, the oracle of
  ``tests/test_multihost.py::_expected_single_process``: the loss and
  metrics of two steps, every gradient, the BatchNorm statistics and the
  weights after two AdamW steps within 1e-10, in f64 on the tiny config
  of ``tests/test_torch_train.py`` with dropout off; and against JAX's
  ``train_body`` loss and gradients on the same global batch at that
  file's tolerances (1e-5 for the loss, 1e-4 relative L2 per gradient);
- ``Solver._global_mean`` with divergent shards (0.8 over 3 samples, 0.2
  over 5) gives 0.425 on both ranks;
- the sharded eval step against JAX's ``make_sharded_eval_step`` on a
  2-device slice of the virtual CPU mesh, in f32 at
  ``tests/test_torch_bridgeqa.py``'s tolerance: per-sample scores, top-1
  answers, the averaged loss;
- ``tp=2`` against dp-only: the losses and the (gathered) weights and
  optimizer moments after two steps within 1e-10, and a dp checkpoint
  loaded into the sharded model reads back bitwise;
- ``train --distributed --tiny --synthetic --device cpu`` on two ranks:
  the run's files written once (by rank 0), the same best criterion on
  both ranks, a resume.

``tp_param_specs`` is held to JAX's ``tp_param_specs`` leaf for leaf without
processes.
"""

import csv
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridgeqa_tpu.data.scannet_config import ScannetDatasetConfig
from bridgeqa_tpu.models import bridgeqa as jbridgeqa
from bridgeqa_tpu.ops import grouping as jgrouping
from bridgeqa_tpu.parallel import make_mesh as jmake_mesh
from bridgeqa_tpu.parallel import tp_param_specs as jtp_param_specs
from bridgeqa_tpu.parallel.eval import make_sharded_eval_step as jmake_sharded_eval_step
from bridgeqa_tpu.train.step import StepConfig as JStepConfig
from bridgeqa_tpu.train.step import TrainState
from bridgeqa_tpu_torch.convert import _flax_leaf, export_jax_variables
from bridgeqa_tpu_torch.data import scannet_config
from bridgeqa_tpu_torch.parallel.tp import tp_param_specs
from bridgeqa_tpu_torch.train.optim import GROUPS, build_optimizer, param_label
from bridgeqa_tpu_torch.train.step import StepConfig, train_step
from tests.test_torch_bridgeqa import ATOL
from tests.test_torch_train import (  # noqa: F401  (jax_x64 is a fixture)
    GRAD_RTOL,
    LOSS_RTOL,
    _leaves,
    _lookup,
    _t,
    grad_tree,
    jax_loss_fn,
    jax_train_config,
    jax_x64,
    perturbed_model,
    port_config,
    rel_l2,
    train_batch,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
GLOBAL_BATCH = 4
PARITY = 1e-10
WORKER_TIMEOUT = 600
DC = scannet_config.ScannetDatasetConfig()
STEP_CFG = StepConfig(use_lang_classifier=True)


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _single_process(cfg, state, batch):
    """The oracle: the same two steps in this process on the global batch."""
    model = perturbed_model(cfg).double()
    model.load_state_dict(state)
    optimizer = build_optimizer(model)
    tbatch = {k: _t(v) for k, v in batch.items()}
    out = {"metrics": [], "grads": None}

    def mark(part):
        if part == "backward" and out["grads"] is None:
            out["grads"] = {n: (p.grad.detach().clone() if p.grad is not None else None)
                            for n, p in model.named_parameters()}

    for k in range(2):
        metrics = train_step(model, optimizer, tbatch, bn_momentum=0.1, step_cfg=STEP_CFG,
                             dataset_config=DC, mark=mark)
        out["metrics"].append({key: float(v) for key, v in metrics.items()})
        if k == 0:
            out["stats"] = {n: b.clone() for n, b in model.named_buffers()
                            if n.endswith(("running_mean", "running_var"))}
    out["state"] = model.state_dict()
    out["optimizer"] = optimizer.state_dict()["state"]
    return out


def _jax_gradients(jcfg, variables, batch):
    """train_body's loss and gradients, and the statistics after its
    forward, on the global batch (x64)."""
    dc = ScannetDatasetConfig()
    jmodel = jbridgeqa.BridgeQA(jcfg, mean_size_arr=dc.mean_size_arr)
    (loss, (_, stats)), grads = jax.jit(jax.value_and_grad(jax_loss_fn(jmodel, dc),
                                                           has_aux=True))(
        variables["params"], variables["batch_stats"],
        {k: jnp.asarray(v) for k, v in batch.items()}, 0.1)
    return float(loss), jax.tree.map(np.asarray, grads), jax.tree.map(np.asarray, stats)


def _jax_sharded_eval(jcfg, variables, batch):
    """JAX's sharded eval step over two CPU devices (f32)."""
    dc = ScannetDatasetConfig()
    jmodel = jbridgeqa.BridgeQA(jcfg, mean_size_arr=dc.mean_size_arr)
    mesh = jmake_mesh(jax.devices()[:WORLD])
    step = jmake_sharded_eval_step(jmodel, dc, JStepConfig(), mesh, k_test=8, check_vma=False)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"], opt_state=())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgrouping, "FORCE_MODE", "stripes")  # the port's ball query
        out = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def parallel_run(tmp_path_factory, jax_x64):
    workdir = str(tmp_path_factory.mktemp("parallel"))
    jcfg = jax_train_config()
    cfg = port_config(jcfg)
    model = perturbed_model(cfg).double()
    state = model.state_dict()
    batch = train_batch(b=GLOBAL_BATCH)
    eval_batch = {k: v.astype(np.float32) if v.dtype == np.float64 else v
                  for k, v in batch.items()}
    torch.save({"cfg": cfg, "state": state, "batch": batch, "eval_batch": eval_batch},
               os.path.join(workdir, "inputs.pt"))
    port = str(_free_port())
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, "-m", "tests._torch_parallel_worker", str(r),
                               str(WORLD), port, workdir], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    try:
        # what the ranks are held to, while they run
        single = _single_process(cfg, state, batch)
        variables = export_jax_variables(model)
        jax_loss, jax_grads, jax_stats = _jax_gradients(jcfg, variables, batch)
        f32 = perturbed_model(cfg)
        f32.load_state_dict(state)
        with jax.enable_x64(False):
            jax_eval = _jax_sharded_eval(jcfg, export_jax_variables(f32), eval_batch)
        logs = [p.communicate(timeout=WORKER_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-6000:]}"
    results = [torch.load(os.path.join(workdir, f"result{r}.pt"), weights_only=False)
               for r in range(WORLD)]
    return dict(workdir=workdir, model=model, single=single, results=results,
                jax_loss=jax_loss, jax_grads=jax_grads, jax_stats=jax_stats, jax_eval=jax_eval)


def _rel(got, want) -> float:
    return rel_l2(got.detach().numpy(), want.detach().numpy())


def _rounding_only(grads: dict) -> set:
    """Parameters whose gradient is 0 up to rounding (the attention key
    biases, the biases ahead of a BatchNorm, the grounding head's output
    bias: ``tests/test_torch_trajectory.py``'s ROUNDING_ONLY). AdamW divides
    by the gradient's size, so it steps them by rounding noise: after a step
    they agree only to what one AdamW step can move a weight."""
    return {n for n, g in grads.items() if g is None or g.norm() < 1e-10}


def _assert_tensors_close(got: dict, want: dict, rtol: float, what: str, skip=()):
    assert set(got) == set(want), what
    failures = []
    for k, w in want.items():
        if k in skip:
            continue
        g = got[k]
        if w is None or g is None:
            assert w is None and g is None, (what, k)
            continue
        assert g.shape == w.shape, (what, k)
        # a tensor that is 0 up to rounding on both sides (the attention key
        # biases' gradients) agrees, as in tests/test_torch_train.py
        if w.norm() < 1e-10 and g.norm() < 1e-10:
            continue
        if _rel(g, w) > rtol:
            failures.append((k, _rel(g, w)))
    assert not failures, (what, failures[:10])


def _assert_weights_and_moments(got, want, what):
    """The weights and AdamW moments after the steps within 1e-10; the
    rounding-only parameters within the two AdamW steps' reach (2 x 2 x the
    largest learning rate, 5e-4)."""
    # the optimizer's state is indexed in its groups' order
    names = [n for g in GROUPS for n in want["grads"] if param_label(n) == g]
    skip = _rounding_only(want["grads"])
    assert len(skip) < 40, sorted(skip)
    _assert_tensors_close(got["state"], want["state"], PARITY, f"{what} weights", skip)
    for n in skip:
        assert (got["state"][n] - want["state"][n]).abs().max() <= 4 * 5e-4, (what, n)
    for i, per_param in want["optimizer"].items():
        if names[i] in skip:
            continue
        for key in ("exp_avg", "exp_avg_sq"):
            _assert_tensors_close({i: got["optimizer"][i][key]}, {i: per_param[key]},
                                  PARITY, f"{what} {names[i]} {key}")


def test_ddp_step_equals_one_process_on_the_global_batch(parallel_run):
    single = parallel_run["single"]
    for r, res in enumerate(parallel_run["results"]):
        ddp = res["ddp"]
        for k, (got, want) in enumerate(zip(ddp["metrics"], single["metrics"])):
            for key, w in want.items():
                assert abs(got[key] - w) <= PARITY * max(abs(w), 1e-12), (r, k, key, got[key], w)
        _assert_tensors_close(ddp["grads"], single["grads"], PARITY, f"rank {r} gradients")
        _assert_tensors_close(ddp["stats"], single["stats"], PARITY, f"rank {r} statistics")
        _assert_weights_and_moments(ddp, single, f"rank {r}")


def test_ddp_step_matches_jax_train_body(parallel_run):
    """The two ranks' first step against JAX's train_body on the global
    batch: the loss, every gradient and the statistics, at the tolerances
    of ``tests/test_torch_train.py``."""
    run = parallel_run
    ddp = run["results"][0]["ddp"]
    np.testing.assert_allclose(ddp["metrics"][0]["loss"], run["jax_loss"], rtol=LOSS_RTOL)
    shadow = run["model"]
    for n, p in shadow.named_parameters():
        g = ddp["grads"][n]
        p.grad = torch.zeros_like(p) if g is None else g
    ours = grad_tree(shadow)
    failures = []
    for path, want in _leaves(run["jax_grads"]):
        got = _lookup(ours, path)
        if np.linalg.norm(want) < 1e-10 and np.linalg.norm(got) < 1e-10:
            continue
        if rel_l2(got, want) > GRAD_RTOL:
            failures.append(("/".join(path), rel_l2(got, want)))
    assert not failures, failures[:10]
    stats = {}
    for n, b in ddp["stats"].items():
        module, leaf = n.rsplit(".", 1)
        stats.setdefault(module, {})[leaf] = b.numpy()
    for path, want in _leaves(run["jax_stats"]):
        module = ".".join(path[:-1])
        got = stats[module]["running_" + path[-1]]
        assert rel_l2(got, want) < 1e-6, path


def test_global_mean_agrees_over_divergent_shards(parallel_run):
    # the ranks ran the port alone: nothing of JAX or the JAX package
    assert not any(res["jax_imported"] for res in parallel_run["results"])
    crits = [res["global_crit"] for res in parallel_run["results"]]
    assert crits[0] == crits[1]
    assert abs(crits[0] - (0.8 * 3 + 0.2 * 5) / 8.0) < 1e-12


def test_sharded_eval_matches_jax(parallel_run):
    want = parallel_run["jax_eval"]
    for res in parallel_run["results"]:
        got = {k: v.numpy() for k, v in res["eval"].items()}
        np.testing.assert_array_equal(got["point_clouds"], want["point_clouds"])
        scores, jscores = got["answer_scores"], want["answer_scores"]
        assert scores.shape == jscores.shape == (GLOBAL_BATCH, 30)
        np.testing.assert_allclose(scores, jscores, rtol=1e-3, atol=0)
        np.testing.assert_array_equal(scores.argmax(axis=1), jscores.argmax(axis=1))
        np.testing.assert_allclose(got["lang_scores"], want["lang_scores"], atol=ATOL, rtol=0)
        for key in ("loss", "vote_loss"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)


def test_tensor_parallel_equals_data_parallel(parallel_run):
    for r, res in enumerate(parallel_run["results"]):
        tp, ddp = res["tp"], res["ddp"]
        assert tp["model_rank"] == r
        for k, (got, want) in enumerate(zip(tp["metrics"], ddp["metrics"])):
            for key, w in want.items():
                assert abs(got[key] - w) <= PARITY * max(abs(w), 1e-12), (r, k, key, got[key], w)
        _assert_weights_and_moments(tp, ddp, f"rank {r} tp")
        for k, v in ddp["state"].items():
            assert torch.equal(tp["reloaded"][k], v), k
        # each rank held half of every sharded product
        widths = tp["shard_widths"]
        full = {k: tuple(v.shape) for k, v in ddp["state"].items()}
        q = "blip_model.text_encoder.encoder.layer_0.attention.self.query.weight"
        assert widths[q] == (full[q][0] // WORLD, full[q][1])
        o = "blip_model.text_encoder.encoder.layer_0.output_dense.weight"
        assert widths[o] == (full[o][0], full[o][1] // WORLD)
        qkv = "blip_model.visual_encoder.blocks_0.attn.qkv.weight"
        assert widths[qkv] == (full[qkv][0] // WORLD, full[qkv][1])


def test_distributed_driver_writes_once_and_resumes(parallel_run):
    run, workdir = parallel_run, parallel_run["workdir"]
    bests = [res["driver"]["best"] for res in run["results"]]
    assert bests[0] == bests[1]
    assert all(res["driver"]["data_size"] == WORLD for res in run["results"])
    for tag in ("run", "resumed"):
        run_dir = os.path.join(workdir, tag)
        assert set(os.listdir(run_dir)) == {
            "info.json", "answer_vocab.json", "log.txt", "metrics.jsonl", "model",
            "model_last", "checkpoint", "cmdline.txt", "predictions.csv", "rank1"}, tag
        assert os.listdir(os.path.join(run_dir, "rank1")) == ["log.txt", "metrics.jsonl"] or \
            set(os.listdir(os.path.join(run_dir, "rank1"))) == {"log.txt", "metrics.jsonl"}
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            lines = [json.loads(line) for line in f]
        train_lines = [ln for ln in lines if ln.get("phase") == "train"]
        assert len(train_lines) == 2, tag  # two steps, logged once each
        with open(os.path.join(run_dir, "predictions.csv")) as f:
            rows = list(csv.DictReader(f))
        assert len(rows) == 4, tag  # both ranks' val rows (2 a rank)
        assert len({r["question_id"] for r in rows}) == 4, tag
        with open(os.path.join(run_dir, "cmdline.txt")) as f:
            assert f.read().count("--distributed") == 1
        assert json.load(open(os.path.join(run_dir, "info.json")))["distributed"] is True
    with open(os.path.join(workdir, "resumed", "log.txt")) as f:
        log = f.read()
    assert "resumed from" in log and "at epoch 1" in log
    assert "epoch 2/2 start" in log and "epoch 1/2 start" not in log
    state = torch.load(os.path.join(workdir, "resumed", "checkpoint"), weights_only=True)
    assert state["epoch"] == 2


def test_tp_specs_classify_every_leaf_as_jax():
    """Column, row or replicated: the port's names against JAX's regexes on
    the flax tree of the same model."""
    model = perturbed_model(port_config(jax_train_config()))
    jspecs = jtp_param_specs(export_jax_variables(model)["params"])
    specs = tp_param_specs(model)
    kinds = {"PartitionSpec(None, 'model')": "column", "PartitionSpec('model',)": "column",
             "PartitionSpec('model', None)": "row", "PartitionSpec()": None}
    modules = dict(model.named_modules())
    counted = {"column": 0, "row": 0, None: 0}
    for name, p in model.named_parameters():
        module_name, leaf = name.rsplit(".", 1)
        _, flax_leaf, _ = _flax_leaf(modules[module_name], leaf, p.detach().numpy())
        node = jspecs
        for part in module_name.split(".") + [flax_leaf]:
            node = node[part]
        want = kinds[repr(node)]
        assert specs[name] == want, name
        counted[want] += 1
    # the rows: every attention's output dense, every FFN out, the ViT's
    # proj and fc2
    assert counted["column"] > 0 and counted["row"] > 0 and counted[None] > 0
    assert counted["row"] == sum(1 for n in specs if n.endswith(
        ("attention.output.dense.weight", "output_dense.weight", "attn.proj.weight",
         "mlp.fc2.weight")))


def test_concurrent_kernel_builds_build_once(tmp_path, monkeypatch):
    """Two ranks that reach ``cuda_lib`` at once (threads here; the lock is
    a file lock, so processes too): one compiles every source and links,
    the other waits and finds the library. ``nvcc`` is a stand-in that
    counts its calls and writes its output."""
    import threading

    from bridgeqa_tpu_torch.ops import cuda_lib

    calls = tmp_path / "calls"
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\necho x >> "%s"\nsleep 0.2\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\n' % calls)
    fake.chmod(0o755)
    monkeypatch.setattr(cuda_lib, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "kernels")
    paths = []
    threads = [threading.Thread(target=lambda: paths.append(cuda_lib._build())) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(paths) == 2 and paths[0] == paths[1] and paths[0].exists()
    sources = len(list(cuda_lib.CSRC.glob("*.cu")))
    assert len(calls.read_text().split()) == sources + 1  # each source once, one link
    # nothing of the build is left beside the library but its lock
    assert sorted(p.suffix for p in (tmp_path / "kernels").iterdir()) == [".lock", ".so"]
