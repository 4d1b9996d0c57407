"""Plain PyTorch building blocks of the reference, inference only.

Frozen from ``bridgeqa_tpu_torch/models/layers.py`` (``Dense``, ``Embed``,
``LayerNorm``, ``BatchNorm`` in eval mode, ``SharedMLP``, ``PatchEmbed``,
``gelu``) with the compute-dtype copies, dropout, remat and the training
statistics removed. Parameter names and shapes are the port's, so one state
dict loads into both. The parameters stay in float32; ``computing`` sets
the type the products run in, float32 by default.
"""

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

# the working type of every product's operands and result, and a rounding
# of the operands below it (the control's), as ``computing`` sets them
_WORKING = {"dtype": torch.float32, "lower": None}
FP8_MAX = 448.0  # float8_e4m3fn's largest finite value


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through float8 e4m3 with one scale for the tensor (its
    largest magnitude onto e4m3's largest finite value), back in its type."""
    scale = t.detach().abs().amax().float().clamp_min(1e-30) / FP8_MAX
    return ((t.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(t.dtype)


@contextlib.contextmanager
def computing(dtype: torch.dtype, lower: str | None = None):
    """Inside the block every product takes its operands in ``dtype``
    (float32, or bfloat16 where the port computes in it: the weights are
    cast at each product, the statistics of the norms and the softmaxes stay
    in float32), with TF32 off. ``lower`` computes one precision below
    (the control): "tf32" lets float32 products run in TF32 on the card,
    "fp8" rounds each product's operands through float8 e4m3."""
    saved = dict(_WORKING), (torch.backends.cuda.matmul.allow_tf32,
                             torch.backends.cudnn.allow_tf32)
    _WORKING.update(dtype=dtype, lower=lower)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = lower == "tf32"
    try:
        yield
    finally:
        _WORKING.update(saved[0])
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[1]


@contextlib.contextmanager
def held(modules, dtype: torch.dtype):
    """Inside the block each of ``modules`` computes in ``dtype`` with
    nothing lowered, whatever ``computing`` sets around it: a control that
    lowers only the layers after them."""
    for m in modules:
        def forward(*args, _inner=m.forward, **kwargs):
            with computing(dtype):
                return _inner(*args, **kwargs)
        m.forward = forward
    try:
        yield
    finally:
        for m in modules:
            del m.forward


def working() -> torch.dtype:
    return _WORKING["dtype"]


def operand(t: torch.Tensor) -> torch.Tensor:
    """A product's operand in the working type, rounded below it for the
    control."""
    t = t.to(_WORKING["dtype"])
    return _fp8(t) if _WORKING["lower"] == "fp8" else t


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis in float32, back in the input's type."""
    return torch.softmax(x.float(), dim=-1).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


class Dense(nn.Module):
    """``y = x @ weight.T + bias``; weight (out, in)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(working())
        return F.linear(operand(x), operand(self.weight), bias)


class Embed(nn.Module):
    def __init__(self, num: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, features))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight.to(working()))


class LayerNorm(nn.Module):
    def __init__(self, features: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Statistics in float32, the output in the input's type."""
        return F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over the trailing axis, eps 1e-5."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("running_mean", torch.empty(features))
        self.register_buffer("running_var", torch.empty(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = ((x.float() - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
             * self.weight + self.bias)
        return y.to(x.dtype)


class SharedMLP(nn.Module):
    """[Dense (no bias) -> BatchNorm -> ReLU] over the trailing axis."""

    def __init__(self, in_features: int, widths):
        super().__init__()
        self.depth = len(widths)
        cin = in_features
        for i, width in enumerate(widths):
            self.add_module(f"layer{i}", Dense(cin, width, bias=False))
            self.add_module(f"bn{i}", BatchNorm(width))
            cin = width

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"layer{i}")(x)))
        return x


class PatchEmbed(nn.Module):
    """The ViT patch embedding as one product over flattened patches;
    weight in the conv layout (out, in, p, p)."""

    def __init__(self, in_chans: int, embed_dim: int, patch: int):
        super().__init__()
        self.patch = patch
        self.weight = nn.Parameter(torch.empty(embed_dim, in_chans, patch, patch))
        self.bias = nn.Parameter(torch.empty(embed_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C) -> (B, H/p * W/p, embed_dim), patches row-major."""
        b, h, w, c = x.shape
        p = self.patch
        x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 5, 2, 4)
        x = x.reshape(b, (h // p) * (w // p), c * p * p)
        weight = self.weight.reshape(self.weight.shape[0], -1)
        return F.linear(operand(x), operand(weight), self.bias.to(working()))


def add_indexed(parent: nn.Module, prefix: str, modules) -> list:
    modules = list(modules)
    for i, m in enumerate(modules):
        parent.add_module(f"{prefix}{i}", m)
    return modules
