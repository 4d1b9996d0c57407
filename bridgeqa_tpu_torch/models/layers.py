"""Shared building blocks of the port (counterpart of
``bridgeqa_tpu/models/layers.py`` plus the flax layers the JAX package uses).

Every layer keeps its parameters under the flax names' counterparts
(``convert.py`` maps flax ``kernel`` to ``weight`` and so on) and runs in
the dtype of its weights: ``set_compute_dtype`` casts the matrix weights
(``Dense``, ``Embed``, ``PatchEmbed``) to the compute dtype and leaves every
other parameter in f32. Biases stay f32 parameters, as flax keeps them: the
module path adds a compute-dtype copy made once by ``set_compute_dtype``
(flax casts at each call), and the fused paths read the f32 parameter.
``init_weights`` fills every parameter from a ``torch.Generator`` with the
JAX package's initialisers. Inference only: no dropout, no batch statistics
updates.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn


def _trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """flax ``truncated_normal``: a standard normal cut at +-2, scaled by
    ``std``, drawn by inverting the CDF of a uniform draw."""
    edge = math.erf(2.0 / math.sqrt(2.0))
    t.uniform_(-edge, edge, generator=generator).erfinv_().mul_(math.sqrt(2.0) * std)


class Dense(nn.Linear):
    """``flax.linen.Dense``: ``weight`` is the transposed flax ``kernel``;
    the input is cast to the weight's dtype. ``init`` names the flax
    ``kernel_init``: "normal" (std 0.02), "trunc_normal" (std 0.02),
    "kaiming" (fan-in normal, gain 2) or "lecun" (fan-in truncated normal)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 init: str = "normal"):
        super().__init__(in_features, out_features, bias=bias)
        self.init = init
        # the bias in the compute dtype (``set_compute_dtype``), None while it
        # is the weight's dtype
        self.register_buffer("bias_cast", None, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.weight.dtype), self.weight, _call_bias(self))

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        w = self.weight
        if self.init == "normal":
            w.normal_(0.0, 0.02, generator=generator)
        elif self.init == "trunc_normal":
            _trunc_normal_(w, 0.02, generator)
        elif self.init == "kaiming":
            w.normal_(0.0, math.sqrt(2.0 / self.in_features), generator=generator)
        elif self.init == "lecun":
            _trunc_normal_(w, math.sqrt(1.0 / self.in_features) / 0.87962566103423978, generator)
        else:
            raise ValueError(f"unknown init {self.init!r}")
        if self.bias is not None:
            self.bias.zero_()


class Embed(nn.Module):
    """``flax.linen.Embed``: ``weight`` is the flax ``embedding`` table."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)

    def attend(self, query: torch.Tensor) -> torch.Tensor:
        """Logits against the table (the tied LM head)."""
        return query.to(self.weight.dtype) @ self.weight.T

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        self.weight.normal_(0.0, 0.02, generator=generator)


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm``: f32 statistics, output in the input's
    dtype; ``weight``/``bias`` are the flax ``scale``/``bias``."""

    def __init__(self, features: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.weight.shape, self.weight.float(), self.bias.float(),
                         self.eps)
        return y.to(x.dtype)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()


class BatchNorm(nn.Module):
    """Eval path of the JAX ``BatchNorm`` over the trailing axis, eps 1e-5:
    ``(x - mean) * rsqrt(var + eps) * weight + bias`` with the running
    statistics, computed in f32, output in the input's dtype."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = (x.float() - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)


class SharedMLP(nn.Module):
    """[Dense -> BN -> ReLU] stack over the trailing axis (``SharedMLP``).

    ``in_features`` is the input width; with channel planes (the JAX
    ``PlaneDense`` layer 0) the input is their concatenation
    ``[planes..., x]``, which uses the same kernel rows."""

    def __init__(self, in_features: int, widths, bn: bool = True):
        super().__init__()
        self.bn = bn
        self.depth = len(widths)
        cin = in_features
        for i, width in enumerate(widths):
            self.add_module(f"layer{i}", Dense(cin, width, bias=not bn, init="kaiming"))
            if bn:
                self.add_module(f"bn{i}", BatchNorm(width))
            cin = width

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"layer{i}")(x)
            if self.bn:
                x = getattr(self, f"bn{i}")(x)
            x = F.relu(x)
        return x


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, flax ``nn.gelu(approximate=False)``."""
    return F.gelu(x, approximate="none")


def add_indexed(parent: nn.Module, prefix: str, modules) -> list:
    """Register ``modules`` as ``{prefix}{i}`` (the flax list naming) and
    return them as a plain list for iteration."""
    modules = list(modules)
    for i, m in enumerate(modules):
        parent.add_module(f"{prefix}{i}", m)
    return modules


def _call_bias(m: nn.Module):
    """The bias a module-path product adds: the compute-dtype copy where
    ``set_compute_dtype`` made one, else the parameter."""
    return m.bias if m.bias_cast is None else m.bias_cast


def set_compute_dtype(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the matrix weights to the compute dtype. Biases, norms, BN
    statistics and free parameters stay f32; each ``Dense`` and
    ``PatchEmbed`` keeps a copy of its bias in the compute dtype for the
    module path, made here once so that no call adds a cast. Run it after the
    weights are loaded or drawn: a later change of a bias does not reach the
    copy."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (Dense, Embed, PatchEmbed)):
                m.weight.data = m.weight.data.to(dtype)
            if isinstance(m, (Dense, PatchEmbed)) and m.bias is not None:
                m.bias_cast = None if dtype == m.bias.dtype else m.bias.detach().to(dtype)
    return model


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter and buffer from ``generator`` with the JAX
    package's initialisers. Raises if a module holding parameters has no
    initialiser."""
    for name, m in model.named_modules():
        has_own = any(True for _ in m.parameters(recurse=False))
        if hasattr(m, "init_weights_"):
            m.init_weights_(generator)
        elif has_own:
            raise TypeError(f"{name or type(m).__name__} holds parameters but has no initialiser")
    return model


class PatchEmbed(nn.Module):
    """The ViT patch embedding (flax ``nn.Conv``, kernel = stride = patch,
    VALID) written as one matrix product over the flattened patches, so no
    convolution algorithm (and no TF32 path) is involved. ``weight`` has the
    torch conv layout (out, in, kh, kw)."""

    def __init__(self, in_chans: int, embed_dim: int, patch: int):
        super().__init__()
        self.patch = patch
        self.weight = nn.Parameter(torch.empty(embed_dim, in_chans, patch, patch))
        self.bias = nn.Parameter(torch.zeros(embed_dim))
        self.register_buffer("bias_cast", None, persistent=False)  # as ``Dense``'s

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C) -> (B, H/p * W/p, embed_dim), patches row-major."""
        b, h, w, c = x.shape
        p = self.patch
        x = x.to(self.weight.dtype).reshape(b, h // p, p, w // p, p, c)
        x = x.permute(0, 1, 3, 5, 2, 4).reshape(b, (h // p) * (w // p), c * p * p)
        return F.linear(x, self.weight.reshape(self.weight.shape[0], -1), _call_bias(self))

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        fan_in = self.weight[0].numel()
        _trunc_normal_(self.weight, math.sqrt(1.0 / fan_in) / 0.87962566103423978, generator)
        self.bias.zero_()
