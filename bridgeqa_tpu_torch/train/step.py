"""The train and eval steps (counterpart of ``bridgeqa_tpu/train/step.py``'s
``train_body`` and ``eval_body``): forward, losses and metrics, and for
training the backward and the optimizer step."""

import dataclasses
from collections.abc import Callable
from typing import Any

import torch
from torch import nn

from bridgeqa_tpu_torch.data.scannet_config import ScannetDatasetConfig
from bridgeqa_tpu_torch.losses import get_loss
from bridgeqa_tpu_torch.models.layers import refresh_compute_copies

# what both steps report
METRIC_KEYS = ("loss", "vote_loss", "objectness_loss", "box_loss", "sem_cls_loss", "ref_loss",
               "lang_loss", "answer_loss", "pos_ratio", "neg_ratio")


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """The JAX ``StepConfig``: which losses count, and their weights."""

    detection: bool = True
    use_reference: bool = True
    use_lang_classifier: bool = True
    use_answer: bool = True
    loss_weights: Any = None


def _losses(end_points, step_cfg: StepConfig, dataset_config, use_answer: bool):
    return get_loss(end_points, dataset_config or ScannetDatasetConfig(),
                    detection=step_cfg.detection, use_reference=step_cfg.use_reference,
                    use_lang_classifier=step_cfg.use_lang_classifier, use_answer=use_answer,
                    loss_weights=step_cfg.loss_weights)


def train_step(model: nn.Module, optimizer: torch.optim.Optimizer, batch: dict, *,
               bn_momentum: float = 0.1, generator: torch.Generator | None = None,
               step_cfg: StepConfig = StepConfig(), dataset_config=None,
               mark: Callable[[str], None] | None = None) -> dict:
    """One training step (JAX's ``train_body``): the model in train mode
    (BatchNorm on batch statistics, moving its running ones by
    ``bn_momentum``; dropout from ``generator``), ``get_loss``, the backward,
    ``optimizer.step()`` (``train.optim.build_optimizer``'s clips and
    schedules), and then the compute-dtype copies of the weights are made
    again, so that a forward without grad reads the stepped weights.
    ``mark``, if given, is called with "forward", "backward" and "optimizer"
    as each of those parts ends (a timer's hook). Returns the metrics
    (``METRIC_KEYS``), detached."""
    mark = mark or (lambda part: None)
    model.train()
    out = model(batch, inference="loss", bn_momentum=bn_momentum, generator=generator)
    end_points = dict(batch)
    end_points.update(out)
    loss, end_points = _losses(end_points, step_cfg, dataset_config, step_cfg.use_answer)
    mark("forward")
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    mark("backward")
    optimizer.step()
    refresh_compute_copies(model)
    mark("optimizer")
    return {k: end_points[k].detach() for k in METRIC_KEYS}


@torch.no_grad()
def eval_step(model: nn.Module, batch: dict, *, k_test: int = 256,
              step_cfg: StepConfig = StepConfig(), dataset_config=None) -> dict:
    """The eval forward (JAX's ``eval_body``): rank inference in eval mode,
    then ``get_loss`` without the answer loss (rank scores are
    log-likelihoods, not logits). Returns the end points: the batch, the
    model's outputs and every loss and metric (``METRIC_KEYS`` among them)."""
    model.eval()
    end_points = dict(batch)
    end_points.update(model(batch, inference="rank", k_test=k_test))
    _, end_points = _losses(end_points, step_cfg, dataset_config, use_answer=False)
    return end_points
