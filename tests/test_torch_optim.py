"""The port's optimizer (``train/optim.py``) against the JAX package's optax
one, and the train step's refresh of the compute-dtype weight copies.

- ``label_params``: every parameter of the tiny model in the JAX package's
  group.
- The schedules: the same learning rate at counts 0, a milestone less one,
  the milestone and past the end, for every scheduler type (1e-6 of the
  base rate: optax evaluates the schedules in f32, so a rate near 0, the
  linear ramp's end, carries the rounding of terms the size of the base).
- Two AdamW steps with the value clip and per-group weight decay against
  optax on the same gradients (1e-6 relative).
- After a ``train_step``, a forward without grad (which reads the bf16
  copies of the weights) equals that of a fresh model given the stepped
  weights and cast, bit for bit.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from bridgeqa_tpu.train import optim as joptim
from bridgeqa_tpu_torch.convert import export_jax_variables
from bridgeqa_tpu_torch.models.layers import set_compute_dtype
from bridgeqa_tpu_torch.train import optim
from bridgeqa_tpu_torch.train.step import METRIC_KEYS, train_step
from tests.test_torch_train import _leaves, _t, jax_train_config, perturbed_model, port_config
from tests.test_torch_train import train_batch

CODES = {"blip": 0.0, "blip3d": 1.0, "other": 2.0}


def test_label_params_matches_jax():
    """Each parameter carries its port label as its value; the export puts
    it at its flax path, where the JAX labels are compared."""
    model = perturbed_model(port_config(jax_train_config()))
    labels = optim.label_params(model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.fill_(CODES[labels[name]])
    tree = export_jax_variables(model)["params"]
    want = joptim.label_params(tree)
    seen = set()
    for path, value in _leaves(tree):
        label = want
        for k in path:
            label = label[k]
        assert np.all(value == CODES[label]), (path, label)
        seen.add(label)
    assert seen == {"blip", "blip3d", "other"}
    assert len(list(_leaves(tree))) == len(labels)


@pytest.mark.parametrize("kind", ["step", "step_except_2d", "linear", "cosine", "none"])
def test_schedules_match_optax(kind):
    cfg = optim.OptimConfig(scheduler_type=kind, steps_per_epoch=3, total_epochs=7,
                            lr_decay_step=(2, 5), lr_decay_step_2d=(1, 4))
    spe = cfg.steps_per_epoch
    counts = sorted({0, 1, spe - 1, spe, 2 * spe - 1, 2 * spe, 4 * spe, 5 * spe - 1, 5 * spe,
                     7 * spe, 9 * spe + 2})
    for group, base in (("blip", cfg.lr_blip), ("blip3d", cfg.lr_blip3d), ("other", cfg.lr)):
        if kind in ("step", "step_except_2d"):
            epochs = cfg.lr_decay_step_2d if kind == "step_except_2d" and group == "blip" \
                else cfg.lr_decay_step
            sched = joptim.multistep_schedule(base, epochs, cfg.lr_decay_rate, spe)
        elif kind == "linear":
            sched = joptim.linear_schedule(base, cfg.total_epochs, spe)
        elif kind == "cosine":
            sched = joptim.cosine_schedule(base, cfg.total_epochs, spe)
        else:
            sched = lambda count, base=base: base  # noqa: E731
        for count in counts:
            want = float(sched(jnp.asarray(count)))
            got = optim.learning_rate(cfg, group, count)
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * base,
                                       err_msg=f"{group} at {count}")


class _Named(nn.Module):
    """Parameters at names that route to each group."""

    def __init__(self, rng):
        super().__init__()

        def holder(**shapes):
            m = nn.Module()
            for name, shape in shapes.items():
                setattr(m, name, nn.Parameter(torch.from_numpy(rng.randn(*shape))))
            return m

        self.blip_model = nn.Module()
        self.blip_model.text_encoder = holder(w=(4, 3), b=(3,))
        self.blip_model.text_decoder_scene = holder(w=(5, 2))
        self.blip_model.lowrank_2d = holder(w=(3, 3))
        self.detector = holder(w=(6,), v=(2, 2))


def test_adamw_steps_match_optax():
    """Two steps, gradients up to 3 (so the clip acts), another rate and
    weight decay in each group."""
    cfg = dict(lr=3e-3, lr_blip=1e-3, lr_blip3d=2e-3, wd=0.05, wd_blip=0.02)
    rng = np.random.RandomState(0)
    model = _Named(rng)
    params = {}
    for name, p in model.named_parameters():
        node = params
        *parents, leaf = name.split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(p.detach().numpy())
    tx, labels = joptim.build_optimizer(params, joptim.OptimConfig(**cfg))
    state = tx.init(params)
    optimizer = optim.build_optimizer(model, optim.OptimConfig(**cfg))
    assert {g["label"]: g["weight_decay"] for g in optimizer.param_groups} == {
        "blip": 0.02, "blip3d": 0.02, "other": 0.05}
    for _ in range(2):
        grads = {name: rng.randn(*p.shape) * 3 for name, p in model.named_parameters()}
        for name, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[name].copy())
        optimizer.step()
        jgrads = jax.tree_util.tree_map_with_path(
            lambda path, _: jnp.asarray(grads[".".join(k.key for k in path)]), params)
        updates, state = tx.update(jgrads, state, params)
        params = optax.apply_updates(params, updates)
    for name, p in model.named_parameters():
        want = params
        for k in name.split("."):
            want = want[k]
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-12,
                                   err_msg=name)
    assert [g["count"] for g in optimizer.param_groups] == [2, 2, 2]


def test_stepped_weights_reach_the_no_grad_forward():
    """The stale-copy repair: ``train_step`` makes the bf16 copies again
    after the optimizer step. Without it the no-grad forward would read the
    weights from before the step (checked too, so the test can fail)."""
    cfg = port_config(jax_train_config())
    model = set_compute_dtype(perturbed_model(cfg), torch.bfloat16)
    batch = {k: _t(v).float() if v.dtype.kind == "f" else _t(v)
             for k, v in train_batch().items()}
    stale = copy.deepcopy(model)
    marks = []
    metrics = train_step(model, optim.build_optimizer(model), batch, bn_momentum=0.1,
                         mark=marks.append)
    assert set(metrics) == set(METRIC_KEYS)
    assert marks == ["forward", "backward", "optimizer"]

    fresh = copy.deepcopy(model)
    fresh.load_state_dict(model.state_dict())
    set_compute_dtype(fresh, torch.bfloat16)
    with torch.no_grad():
        stale.load_state_dict(model.state_dict())  # the copies stay as they were
    outs = []
    for m in (model, fresh, stale):
        m.eval()
        with torch.no_grad():
            outs.append(m(batch, inference="rank", k_test=8))
    for key in ("answer_scores_2d", "lang_scores", "cluster_ref"):
        assert torch.equal(outs[0][key], outs[1][key]), key
    assert not torch.equal(outs[0]["lang_scores"], outs[2]["lang_scores"])


def test_optim_config_matches_jax():
    assert [f.name for f in dataclasses.fields(optim.OptimConfig)] == \
        [f.name for f in dataclasses.fields(joptim.OptimConfig)]
    assert optim.OptimConfig() == optim.OptimConfig(
        **dataclasses.asdict(joptim.OptimConfig()))
