"""Ten training steps of the port (``train.step.train_step`` with
``train.optim.build_optimizer``) against ten of the JAX package's
``train_body`` with its optax optimizer: the same tiny f64 model and batch as
``tests/test_torch_train.py`` (whose module docstring gives the setting and
the tolerances' reasons), ``OptimConfig()``'s weight decays, clip and
schedules with its learning rates x0.01, and the BN momentum schedule of
``tests/test_golden_training.py`` (``max(0.5 * 0.5 ** (k // 4), 0.01)``).

The loss at every step within 1e-5 relative; every parameter and BatchNorm
statistic after the ten steps within 1e-4 relative L2 per tensor; and the
change of each over the ten steps (after minus before) within 5e-3 relative
L2 of JAX's change, so that a wrong update shows against the size of the
update and not of the weights (at these rates an element moves by about
1e-5 of its size). The change is not held for the parameters whose gradient
is rounding by construction (``ROUNDING_ONLY``); the rest differ by at most
about 1.6e-3, in the detector's feature-propagation and vote layers, where
the f32 point ops' rounding reaches the elements with the smallest gradients
and AdamW's division by the gradient's size lets it show.

Why the learning rates are scaled: AdamW's first step moves each element by
about ``lr * sign(g)``, so an element whose gradient lies below the
rounding of the f32 point ops (about 1e-5 of a detector tensor's gradient,
``tests/test_torch_train.py``) steps by ``+-lr`` on the two sides. At the
default rates that moves the votes far enough to flip an f32 ball-query
membership or FPS pick of the vote aggregation within a few steps, a
discrete change each side makes at another step, after which the two runs
follow different graphs: a run of this test at the default rates, and at
the golden test's x0.1, parts beyond 1e-5 within the first steps. The scale
changes no code path: every rate, weight decay, clip and count is still
applied by both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from bridgeqa_tpu.data.scannet_config import ScannetDatasetConfig
from bridgeqa_tpu.models import bridgeqa as jbridgeqa
from bridgeqa_tpu.train.optim import OptimConfig as JOptimConfig
from bridgeqa_tpu.train.optim import build_optimizer as jbuild_optimizer
from bridgeqa_tpu.train.step import StepConfig as JStepConfig
from bridgeqa_tpu.train.step import TrainState, train_body
from bridgeqa_tpu_torch.convert import export_jax_variables
from bridgeqa_tpu_torch.train.optim import OptimConfig, build_optimizer
from bridgeqa_tpu_torch.train.step import METRIC_KEYS, train_step
from tests.test_torch_train import (  # noqa: F401  (jax_x64 is a fixture)
    _leaves,
    _lookup,
    _t,
    jax_train_config,
    jax_x64,
    perturbed_model,
    port_config,
    rel_l2,
    train_batch,
)

STEPS = 10
MOMENTA = [max(0.5 * 0.5 ** (k // 4), 0.01) for k in range(STEPS)]
LR_SCALE = 0.01
CHANGE_RTOL = 5e-3
# parameters whose gradient is 0 up to rounding by construction, so that
# AdamW, which divides by the gradient's size, steps them by rounding: the
# attention key biases (softmax ignores a shift per query), the biases ahead
# of a BatchNorm (it subtracts their mean) and the grounding head's output
# bias (the reference loss is a softmax over the proposals)
ROUNDING_ONLY = ("key/bias", "vgen/conv1/bias", "vgen/conv2/bias", "object_cls/fc2/bias")


def _rates(cfg):
    return dict(lr=cfg.lr * LR_SCALE, lr_blip=cfg.lr_blip * LR_SCALE,
                lr_blip3d=cfg.lr_blip3d * LR_SCALE)


def test_ten_steps_match_train_body(jax_x64):
    jcfg = jax_train_config()
    dc = ScannetDatasetConfig()
    model = perturbed_model(port_config(jcfg)).double()
    variables = export_jax_variables(model)
    batch = train_batch()

    jmodel = jbridgeqa.BridgeQA(jcfg, mean_size_arr=dc.mean_size_arr)
    tx, _ = jbuild_optimizer(variables["params"], JOptimConfig(**_rates(JOptimConfig())))
    state = TrainState.create(jax.tree.map(jnp.asarray, variables), tx)
    step = jax.jit(lambda s, b, m: train_body(jmodel, dc, tx, JStepConfig(), s, b,
                                              jax.random.PRNGKey(0), m))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = []
    for k in range(STEPS):
        state, metrics = step(state, jbatch, MOMENTA[k])
        want.append({key: float(metrics[key]) for key in METRIC_KEYS})

    optimizer = build_optimizer(model, OptimConfig(**_rates(OptimConfig())))
    tbatch = {k: _t(v) for k, v in batch.items()}
    got = [train_step(model, optimizer, tbatch, bn_momentum=m) for m in MOMENTA]

    losses = [(g["loss"].item(), w["loss"]) for g, w in zip(got, want)]
    print("losses (port, JAX):", losses)
    assert losses[-1][1] < losses[0][1], "the steps must train"
    for k, (g, w) in enumerate(losses):
        assert abs(g - w) <= 1e-5 * abs(w), (k, g, w)

    ours = export_jax_variables(model)
    worst, worst_change = [], []
    for collection, tree in (("params", state.params), ("batch_stats", state.batch_stats)):
        for path, w in _leaves(jax.tree.map(np.asarray, tree)):
            name = f"{collection}/{'/'.join(path)}"
            mine, start = _lookup(ours[collection], path), _lookup(variables[collection], path)
            worst.append((rel_l2(mine, w), name))
            worst_change.append((rel_l2(mine - start, w - start), name))
    worst.sort(reverse=True)
    worst_change.sort(reverse=True)
    worst_change = [w for w in worst_change if not w[1].endswith(ROUNDING_ONLY)]
    print("worst tensors after the steps:", worst[:8])
    print("worst changes over the steps:", worst_change[:8])
    assert len(worst) == len(list(model.parameters())) + 2 * sum(
        1 for n, _ in model.named_buffers() if n.endswith("running_mean"))
    assert worst[0][0] <= 1e-4, worst[:8]
    assert worst_change[0][0] <= CHANGE_RTOL, worst_change[:8]
    assert all(optimizer_count == STEPS for optimizer_count in
               (g["count"] for g in optimizer.param_groups))
    assert {g["label"] for g in optimizer.param_groups} == {"blip", "blip3d", "other"}
    assert torch.isfinite(torch.stack([g["loss"] for g in got])).all()
