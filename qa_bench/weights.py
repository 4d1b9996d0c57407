"""Weights made from the seed, on the device, in one draw.

Every parameter and persistent buffer of the reference model (whose names
and shapes are the port's) is a slice of one standard normal draw from a
``torch.Generator`` on the device, scaled and shifted by a rule on its name
and shape: norm scales near 1, biases and running means near 0, running
variances above 1, the detector's products at He scale (its MLPs end in
BatchNorm and ReLU), the ViT patch embedding at LeCun scale, the low-rank
bilinear kernel non-negative as BLIP initialises it, and every other product
and embedding at std 0.02, as BLIP and BERT initialise them. The same seed
gives the same weights to the program and to the reference.
"""

import math

import torch

WEIGHT_STREAM = 1


def stream_seed(seed: int, stream: int) -> int:
    """A generator seed for one stream of draws of a run's seed (any whole
    number): both sides of a comparison draw the same stream alike."""
    return (seed * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9) % (1 << 63)


def rule(name: str, shape) -> tuple[float, float, bool]:
    """(scale, shift, absolute) of a parameter: ``shift + scale * n``, with
    ``|n|`` where absolute, n standard normal."""
    last = name.rsplit(".", 1)[-1]
    if last == "running_var":
        return 0.2, 1.0, True
    if last == "running_mean":
        return 0.1, 0.0, False
    if len(shape) == 1:
        return (0.1, 1.0, False) if last in ("weight", "a_2") else (0.02, 0.0, False)
    if last == "bilinear_fusion_kernel":
        return 0.5 / math.sqrt(shape[-1]), 0.0, True
    fan_in = math.prod(shape[1:])
    if name.startswith("detector."):
        return math.sqrt(2.0 / fan_in), 0.0, False
    if len(shape) == 4:
        return math.sqrt(1.0 / fan_in), 0.0, False
    return 0.02, 0.0, False


@torch.no_grad()
def make_state(schema: dict, seed: int, device) -> dict:
    """``schema``: name -> shape (a model's ``state_dict`` gives it, on any
    device, the meta device too). Returns name -> f32 tensor on ``device``,
    every tensor a view of one draw."""
    sizes = [math.prod(shape) for shape in schema.values()]
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, WEIGHT_STREAM))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    state, start = {}, 0
    for (name, shape), size in zip(schema.items(), sizes):
        scale, shift, absolute = rule(name, shape)
        t = flat[start:start + size]
        if absolute:
            t.abs_()
        state[name] = t.mul_(scale).add_(shift).view(shape)
        start += size
    return state


def schema_of(model: torch.nn.Module) -> dict:
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}
