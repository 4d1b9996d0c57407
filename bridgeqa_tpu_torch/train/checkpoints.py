"""Checkpoints: best / last / resumable train state (counterpart of
``bridgeqa_tpu/train/checkpoints.py``, whose Orbax trees become
``torch.save`` files of the same names).

Replaces the reference's three torch artifacts (``lib/solver.py:659-695``):
``model`` (best weights), ``model_last`` (per-epoch weights), and
``checkpoint`` ({model, optimizer, epoch} for ``--use_checkpoint`` resume,
``scripts/train.py:443-449``) — plus the run metadata files (``info.json``,
``answer_vocab.json``). A weights file holds the model's ``state_dict``
(parameters and BatchNorm running statistics, not the compute-dtype copies);
the resumable one adds the optimizer's ``state_dict`` (the AdamW moments and
each group's ``count``, which sets its schedule) and the epoch. Files hold
tensors and Python scalars only and load with ``weights_only=True``. After
every load the compute-dtype copies are made again
(``refresh_compute_copies``), so a forward without grad reads the loaded
weights.

Under ``torch.distributed`` every rank calls the savers and only rank 0
writes (the JAX package's Orbax saves are collective too): a model sharded
for tensor parallelism gathers its weights and moments inside
``state_dict()``, so the files hold the unsharded layout whatever the run's
parallelism. Every rank loads.
"""

import json
import os

import torch
from torch import nn

from bridgeqa_tpu_torch.models.layers import refresh_compute_copies
from bridgeqa_tpu_torch.parallel.mesh import is_main_process


def _path(run_dir, name):
    return os.path.join(os.path.abspath(run_dir), name)


def _save(obj, path):
    # written under another name first: an interrupted save leaves the last
    # complete file in place
    if not is_main_process():
        return
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_params(run_dir, name, model: nn.Module):
    """Save the model's weights and statistics — the ``model.pth`` /
    ``model_last.pth`` unit."""
    _save(model.state_dict(), _path(run_dir, name))


def load_state(run_dir, name, device="cpu") -> dict:
    """The ``state_dict`` saved as ``name``, its tensors on ``device``."""
    return torch.load(_path(run_dir, name), map_location=device, weights_only=True)


def load_params(run_dir, name, model: nn.Module) -> nn.Module:
    """Fill ``model`` from the weights saved as ``name`` (all or nothing)."""
    device = next(model.parameters()).device
    model.load_state_dict(load_state(run_dir, name, device))
    return refresh_compute_copies(model)


def graft_detector(run_dir, name, model: nn.Module) -> nn.Module:
    """The two-stage flow (``qa_module.py:386-407``): copy the detector's
    parameters of the run saved as ``name`` (a DET stage) into ``model``.
    Its buffers (the BatchNorm running statistics) stay the model's own, as
    JAX grafts ``params["detector"]`` and keeps ``batch_stats``."""
    device = next(model.parameters()).device
    state = load_state(run_dir, name, device)
    params = {k: v for k, v in model.named_parameters() if k.startswith("detector.")}
    missing = sorted(set(params) - set(state))
    if missing:
        raise KeyError(f"{run_dir}/{name} lacks detector parameters {missing[:5]}")
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(state[k])
    return refresh_compute_copies(model)


def save_train_state(run_dir, model: nn.Module, optimizer: torch.optim.Optimizer, epoch: int,
                     name="checkpoint"):
    """Full resumable state — the ``checkpoint.tar`` unit."""
    _save({"epoch": int(epoch), "model": model.state_dict(),
           "optimizer": optimizer.state_dict()}, _path(run_dir, name))


def load_train_state(run_dir, model: nn.Module, optimizer: torch.optim.Optimizer,
                     name="checkpoint") -> int:
    """Restore the model and the optimizer in place; returns the epoch. The
    optimizer's step counts stay on the host, where ``torch.optim.AdamW``
    keeps them (on the card its update would read each one back)."""
    device = next(model.parameters()).device
    payload = torch.load(_path(run_dir, name), map_location=device, weights_only=True)
    model.load_state_dict(payload["model"])
    opt_state = payload["optimizer"]
    for per_param in opt_state["state"].values():
        if "step" in per_param:
            per_param["step"] = per_param["step"].cpu()
    optimizer.load_state_dict(opt_state)
    refresh_compute_copies(model)
    return int(payload["epoch"])


def save_run_info(run_dir, info: dict, name="info.json"):
    """``info.json`` replayed by predict/eval (``utils/misc.py:38``)."""
    if not is_main_process():
        return
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, name), "w") as f:
        json.dump(info, f, indent=2, default=str)


def load_run_info(run_dir, name="info.json"):
    with open(os.path.join(run_dir, name)) as f:
        return json.load(f)


def save_answer_vocab(run_dir, answer_cands, answer_counter=None):
    if not is_main_process():
        return
    with open(os.path.join(run_dir, "answer_vocab.json"), "w") as f:
        json.dump({"answer_cands": list(answer_cands),
                   "answer_counter": answer_counter or {}}, f)


def load_answer_vocab(run_dir):
    with open(os.path.join(run_dir, "answer_vocab.json")) as f:
        d = json.load(f)
    return d["answer_cands"], d.get("answer_counter", {})
