"""The optimizer (counterpart of ``bridgeqa_tpu/train/optim.py``): AdamW in
three parameter groups routed by name (blip, blip3d, other), each with its
own learning rate, weight decay, schedule and step count; gradients clipped
by value to 1.0 first. The JAX package builds it from optax; here it is
``torch.optim.AdamW``, which computes the same update (the decay
``lr * wd * param`` on the parameter before the step, the moments' bias
corrections from each parameter's step count)."""

import dataclasses
import math
from collections.abc import Sequence

import torch
from torch import nn

# the JAX package's routing substrings
_BLIP3D_PATTERNS = ("layer_twin", "text_encoder_scene", "text_decoder_scene")
_OTHER_PATTERNS = ("lowrank", "fusion", "gated", "lang_net", "answer_cls",
                   "linear_scene_object", "scene_weight", "classifier")
GROUPS = ("blip", "blip3d", "other")


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """The JAX ``OptimConfig``'s fields and defaults."""

    lr: float = 5e-4
    lr_blip: float = 1e-4
    lr_blip3d: float = 1e-4
    wd: float = 1e-5
    wd_blip: float = 0.0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    max_grad_value: float = 1.0
    lr_decay_step: Sequence[int] = (100, 200)  # epochs
    lr_decay_step_2d: Sequence[int] = (100, 200)
    lr_decay_rate: float = 0.2
    # "step" | "step_except_2d" | "linear" | "cosine" | anything else: constant
    scheduler_type: str = "step"
    steps_per_epoch: int = 1
    total_epochs: int = 0  # linear and cosine need it


def param_label(name: str) -> str:
    """The group of a parameter, by its name (the port's names carry the
    flax paths, so the JAX package's substrings route them alike)."""
    if "blip_model" in name:
        if any(p in name for p in _BLIP3D_PATTERNS):
            return "blip3d"
        if any(p in name for p in _OTHER_PATTERNS):
            return "other"
        return "blip"
    return "other"


def label_params(model: nn.Module) -> dict:
    """{parameter name: group} for every parameter of ``model``."""
    return {name: param_label(name) for name, _ in model.named_parameters()}


def learning_rate(cfg: OptimConfig, group: str, count: int) -> float:
    """The group's learning rate for its ``count``-th update (0 first), as
    optax's schedules give it: "step" multiplies by ``lr_decay_rate`` at
    each milestone epoch reached (``step_except_2d``: the blip group on
    ``lr_decay_step_2d``), "linear" ramps the factor from 1 to 0.001 over
    ``total_epochs`` and holds, "cosine" anneals to 0 over ``total_epochs``;
    all stepped per epoch of ``steps_per_epoch`` updates."""
    base = {"blip": cfg.lr_blip, "blip3d": cfg.lr_blip3d, "other": cfg.lr}[group]
    epoch = count // cfg.steps_per_epoch
    if cfg.scheduler_type in ("step", "step_except_2d"):
        milestones = (cfg.lr_decay_step_2d if cfg.scheduler_type == "step_except_2d"
                      and group == "blip" else cfg.lr_decay_step)
        return base * cfg.lr_decay_rate ** sum(count >= int(e) * cfg.steps_per_epoch
                                               for e in milestones)
    if cfg.scheduler_type in ("linear", "cosine") and cfg.total_epochs <= 0:
        raise ValueError(f"the {cfg.scheduler_type} schedule needs OptimConfig.total_epochs")
    if cfg.scheduler_type == "linear":
        return base * (1.0 + (0.001 - 1.0) * min(epoch, cfg.total_epochs) / cfg.total_epochs)
    if cfg.scheduler_type == "cosine":
        return base * 0.5 * (1.0 + math.cos(math.pi * epoch / cfg.total_epochs))
    return base


class GroupedAdamW(torch.optim.AdamW):
    """``torch.optim.AdamW`` over the three groups of ``label_params``
    (empty groups left out). ``step()`` clips every gradient to
    ``[-max_grad_value, max_grad_value]``, sets each group's learning rate
    from its own update count, takes the AdamW step and counts it. A
    parameter with no gradient takes a zero one, as JAX's gradient of an
    unused parameter is zero: its moments decay and its weight decays."""

    def __init__(self, model: nn.Module, cfg: OptimConfig = OptimConfig()):
        self.cfg = cfg
        by_group = {g: [] for g in GROUPS}
        for name, p in model.named_parameters():
            by_group[param_label(name)].append(p)
        wd = {"blip": cfg.wd_blip, "blip3d": cfg.wd_blip, "other": cfg.wd}
        groups = [dict(params=ps, label=g, count=0, lr=learning_rate(cfg, g, 0),
                       weight_decay=wd[g]) for g, ps in by_group.items() if ps]
        super().__init__(groups, betas=(cfg.adam_beta1, cfg.adam_beta2), eps=cfg.adam_epsilon)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("GroupedAdamW.step takes no closure")
        params = [p for g in self.param_groups for p in g["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        torch.nn.utils.clip_grad_value_(params, self.cfg.max_grad_value)
        for g in self.param_groups:
            g["lr"] = learning_rate(self.cfg, g["label"], g["count"])
        super().step()
        for g in self.param_groups:
            g["count"] += 1


def build_optimizer(model: nn.Module, cfg: OptimConfig = OptimConfig()) -> GroupedAdamW:
    """The training optimizer of ``model`` (JAX's ``build_optimizer``)."""
    return GroupedAdamW(model, cfg)
