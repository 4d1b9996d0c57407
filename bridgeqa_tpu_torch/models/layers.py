"""Shared building blocks of the port (counterpart of
``bridgeqa_tpu/models/layers.py`` plus the flax layers the JAX package uses).

Every layer keeps its parameters under the flax names' counterparts
(``convert.py`` maps flax ``kernel`` to ``weight`` and so on), in f32, as
flax keeps them. ``set_compute_dtype`` gives each ``Dense``, ``Embed`` and
``PatchEmbed`` a compute dtype: it makes compute-dtype copies of the weight
and the bias once (``weight_cast``, ``bias_cast``, non-persistent buffers),
and these layers run in that dtype. Without grad the products read the
copies, so no call adds a cast; under grad they cast the f32 parameters
inside the graph (flax casts at each call), so the gradients reach them
(``param_as``). The fused paths run only without grad and read the copies
of the weights and the f32 biases.
``init_weights`` fills every parameter from a ``torch.Generator`` with the
JAX package's initialisers.

Training: ``model.train()`` stands for JAX's ``train=True``
(``deterministic=False``) and ``model.eval()`` for ``train=False``.
``BridgeQA`` leaves its constructor in eval mode; a module built on its own
starts in ``nn.Module``'s train mode, so its caller sets the mode. In train mode
``BatchNorm`` normalises with the batch statistics and updates its running
ones with the momentum its caller passes, and ``dropout``/``drop_path`` draw
their masks from the generator that ``dropout_rng`` makes current (JAX's
``rngs={"dropout": key}``); no mask ever comes from PyTorch's global
generator. ``remat`` is JAX's ``nn.remat``: ``torch.utils.checkpoint`` that
redraws the same masks when it recomputes.
"""

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from bridgeqa_tpu_torch.parallel.global_batch import batch_moments


def _trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """flax ``truncated_normal``: a standard normal cut at +-2, scaled by
    ``std``, drawn by inverting the CDF of a uniform draw."""
    edge = math.erf(2.0 / math.sqrt(2.0))
    t.uniform_(-edge, edge, generator=generator).erfinv_().mul_(math.sqrt(2.0) * std)


class Dense(nn.Linear):
    """``flax.linen.Dense``: ``weight`` is the transposed flax ``kernel``;
    the input is cast to its compute dtype. ``init`` names the flax
    ``kernel_init``: "normal" (std 0.02), "trunc_normal" (std 0.02),
    "kaiming" (fan-in normal, gain 2), "lecun" (fan-in truncated normal) or
    "orthogonal"."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 init: str = "normal"):
        super().__init__(in_features, out_features, bias=bias)
        self.init = init
        _register_casts(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(self)
        bias = None if self.bias is None else param_as(self, "bias", dt)
        return F.linear(x.to(dt), param_as(self, "weight", dt), bias)

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
        elif self.init == "orthogonal":
            nn.init.orthogonal_(w, generator=generator)
        else:
            raise ValueError(f"unknown init {self.init!r}")
        if self.bias is not None:
            self.bias.zero_()


class Embed(nn.Module):
    """``flax.linen.Embed``: ``weight`` is the flax ``embedding`` table."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))
        _register_casts(self)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, param_as(self, "weight", compute_dtype(self)))

    def attend(self, query: torch.Tensor) -> torch.Tensor:
        """Logits against the table (the tied LM head)."""
        table = param_as(self, "weight", compute_dtype(self))
        return query.to(table.dtype) @ table.T

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        self.weight.normal_(0.0, 0.02, generator=generator)


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in ``promote_types(x.dtype, f32)``: f32 for bf16 and f32 inputs,
    f64 kept (the JAX package's statistics and softmaxes)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm``: statistics in at least f32, output in the
    input's dtype; ``weight``/``bias`` are the flax ``scale``/``bias``."""

    def __init__(self, features: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = at_least_f32(x)
        y = F.layer_norm(xf, self.weight.shape, self.weight.to(xf.dtype), self.bias.to(xf.dtype),
                         self.eps)
        return y.to(x.dtype)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()


class BatchNorm(nn.Module):
    """The JAX ``BatchNorm`` over the trailing axis, eps 1e-5:
    ``(x - mean) * rsqrt(var + eps) * weight + bias``, computed in
    ``promote_types(x, f32)``, output in the input's dtype.

    In eval mode ``mean`` and ``var`` are the running statistics. In train
    mode they are the batch's, the variance taken in one pass as
    ``E[x^2] - mean^2`` (biased); the running statistics then move by
    torch's convention, ``running = (1 - m) * running + m * batch``, with
    the unbiased batch variance. The batch is the global one, as JAX's:
    under data parallelism the sums and the count are all-reduced over the
    data-parallel ranks (``parallel.global_batch.batch_moments``,
    differentiably, so the backward carries the cross-rank terms).
    ``momentum`` is a call argument, as in JAX, so a schedule needs no
    rebuild."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, momentum: float = 0.1) -> torch.Tensor:
        xf = at_least_f32(x)
        if self.training:
            mean, mean_sq, bessel = batch_moments(xf, tuple(range(x.dim() - 1)))
            var = mean_sq - mean * mean
            with torch.no_grad():
                unbiased = var * bessel
                self.running_mean.copy_((1.0 - momentum) * self.running_mean + momentum * mean)
                self.running_var.copy_((1.0 - momentum) * self.running_var + momentum * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y.to(x.dtype)

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

    def forward(self, x: torch.Tensor, bn_momentum: float = 0.1) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"layer{i}")(x)
            if self.bn:
                x = getattr(self, f"bn{i}")(x, bn_momentum)
            x = F.relu(x)
        return x


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, flax ``nn.gelu(approximate=False)``."""
    return F.gelu(x, approximate="none")


# the generator ``dropout_rng`` made current (per thread: autograd may run a
# recompute on a thread of its own, where ``remat`` sets it again)
_current_generator = contextvars.ContextVar("dropout_generator", default=None)


@contextlib.contextmanager
def dropout_rng(generator: torch.Generator | None):
    """Make ``generator`` the one the dropout masks inside the block are
    drawn from (JAX's ``rngs={"dropout": key}``). It lies on the device of
    the tensors it masks."""
    token = _current_generator.set(generator)
    try:
        yield
    finally:
        _current_generator.reset(token)


def _generator() -> torch.Generator:
    gen = _current_generator.get()
    if gen is None:
        raise RuntimeError("dropout in train mode needs a generator: pass one to "
                           "BridgeQA.forward(..., generator=) or draw under layers.dropout_rng")
    return gen


def uniform(shape, device) -> torch.Tensor:
    """Draws uniform on [0, 1) from the generator ``dropout_rng`` made
    current (JAX's ``make_rng("dropout")``)."""
    return torch.rand(shape, generator=_generator(), device=device)


def dropout(x: torch.Tensor, rate: float, training: bool) -> torch.Tensor:
    """flax ``nn.Dropout``: in train mode each element is kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``, else zeroed;
    otherwise ``x`` itself."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    return torch.where(uniform(x.shape, x.device) < keep, x / keep, 0.0)


def drop_path(x: torch.Tensor, rate: float, training: bool) -> torch.Tensor:
    """Stochastic depth (the JAX ViT's ``DropPath``): ``dropout`` with one
    draw per sample, over the leading axis."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    return torch.where(uniform(shape, x.device) < keep, x / keep, 0.0)


def remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward instead of
    kept (JAX's ``nn.remat``): ``torch.utils.checkpoint`` without the
    reentrant autograd. The checkpoint restores only PyTorch's global
    generators, and the masks here come from ``dropout_rng``'s: the
    recompute sets that generator back to where the forward found it, draws
    the same masks, and leaves it where it was. Without grad, a plain
    call."""
    if not torch.is_grad_enabled():
        return fn(*args)
    gen = _current_generator.get()
    start = None if gen is None else gen.get_state()
    calls = [0]

    def run(*a):
        calls[0] += 1
        if gen is None or calls[0] == 1:
            with dropout_rng(gen):
                return fn(*a)
        resume = gen.get_state()
        gen.set_state(start)
        try:
            with dropout_rng(gen):
                return fn(*a)
        finally:
            gen.set_state(resume)

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)


def add_indexed(parent: nn.Module, prefix: str, modules) -> list:
    """Register ``modules`` as ``{prefix}{i}`` (the flax list naming) and
    return them as a plain list for iteration."""
    modules = list(modules)
    for i, m in enumerate(modules):
        parent.add_module(f"{prefix}{i}", m)
    return modules


def _register_casts(m: nn.Module) -> None:
    # the weight and the bias in the compute dtype (``set_compute_dtype``),
    # None while it is the parameters' dtype
    m.register_buffer("weight_cast", None, persistent=False)
    m.register_buffer("bias_cast", None, persistent=False)


def compute_dtype(m: nn.Module) -> torch.dtype:
    """The dtype a ``Dense``, ``Embed`` or ``PatchEmbed`` computes in: the
    one ``set_compute_dtype`` gave it, else its parameters'."""
    return m.weight.dtype if m.weight_cast is None else m.weight_cast.dtype


def param_as(m: nn.Module, name: str, dtype: torch.dtype) -> torch.Tensor:
    """Parameter ``name`` ("weight" or "bias") of ``m`` in ``dtype``, as a
    product reads it. Without grad, the copy ``set_compute_dtype`` made
    where it has that dtype, so the call adds no cast; under grad, the
    parameter cast inside the graph, so its gradient reaches the f32
    parameter."""
    cast = getattr(m, f"{name}_cast")
    if cast is not None and cast.dtype == dtype and not torch.is_grad_enabled():
        return cast
    return getattr(m, name).to(dtype)


def _make_copies(model: nn.Module, dtype_of) -> nn.Module:
    # each Dense, Embed and PatchEmbed weight and bias gets a copy in
    # ``dtype_of(its current copy or None, the parameter)``; none where that
    # is None or the parameter's own dtype, and none inside a module that
    # sets ``keeps_param_dtype`` (flax builds it without a dtype, so it
    # computes in its parameters' dtype under any compute dtype)
    pinned = {id(m) for top in model.modules() if getattr(top, "keeps_param_dtype", False)
              for m in top.modules()}
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (Dense, Embed, PatchEmbed)) and id(m) not in pinned:
                for name in ("weight", "bias"):
                    p = getattr(m, name, None)
                    dtype = None if p is None else dtype_of(getattr(m, f"{name}_cast"), p)
                    cast = None if dtype is None or dtype == p.dtype else p.detach().to(dtype)
                    setattr(m, f"{name}_cast", cast)
    return model


def set_compute_dtype(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Give every ``Dense``, ``Embed`` and ``PatchEmbed`` of ``model`` the
    compute dtype ``dtype``, except inside a module that sets
    ``keeps_param_dtype`` (the language encoders of the MCAN path, which the
    JAX package builds without a dtype). Every parameter stays as it is, in f32 as flax
    keeps them; the weight and bias of those layers get compute-dtype copies,
    made here once (non-persistent buffers: the ``state_dict`` and
    ``convert.load_jax_variables`` see the f32 parameters). Without grad the
    products read the copies; under grad they cast the parameters in the
    graph. The copies are made now: after the weights are loaded, drawn or
    changed by an optimizer step they are stale until this runs again (or
    ``refresh_compute_copies``, which ``train_step`` calls)."""
    return _make_copies(model, lambda cast, p: dtype)


def refresh_compute_copies(model: nn.Module) -> nn.Module:
    """Make the compute-dtype copies that ``set_compute_dtype`` made again,
    each in its own dtype, from the parameters as they are now, so that a
    forward without grad reads them: after an optimizer step the copies are
    stale until this runs."""
    return _make_copies(model, lambda cast, p: None if cast is None else cast.dtype)


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
        _register_casts(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C) -> (B, H/p * W/p, embed_dim), patches row-major."""
        b, h, w, c = x.shape
        p = self.patch
        dt = compute_dtype(self)
        x = x.to(dt).reshape(b, h // p, p, w // p, p, c)
        x = x.permute(0, 1, 3, 5, 2, 4).reshape(b, (h // p) * (w // p), c * p * p)
        weight = param_as(self, "weight", dt)
        return F.linear(x, weight.reshape(weight.shape[0], -1), param_as(self, "bias", dt))

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        fan_in = self.weight[0].numel()
        _trunc_normal_(self.weight, math.sqrt(1.0 / fan_in) / 0.87962566103423978, generator)
        self.bias.zero_()


class Conv(nn.Module):
    """``flax.linen.Conv`` over channel-last (B, H, W, C) tensors: ``weight``
    has the torch conv layout (out, in, kh, kw), the transposed flax
    ``kernel`` (kh, kw, in, out). ``padding`` (ph, pw) pads both sides of H
    by ph and of W by pw (flax's explicit pairs, when they are symmetric).
    The convolution is ``F.conv2d`` on a channels-last view of the input;
    it computes in the parameters' dtype."""

    def __init__(self, in_chans: int, out_chans: int, kernel: tuple, stride: int = 1,
                 padding: tuple = (0, 0), dilation: int = 1, bias: bool = True):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, tuple(padding), dilation
        self.weight = nn.Parameter(torch.empty(out_chans, in_chans, *kernel))
        self.bias = nn.Parameter(torch.zeros(out_chans)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias, self.stride, self.padding,
                     self.dilation)
        return y.permute(0, 2, 3, 1)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        """flax's default ``lecun_normal`` kernel and zero bias."""
        fan_in = self.weight[0].numel()
        _trunc_normal_(self.weight, math.sqrt(1.0 / fan_in) / 0.87962566103423978, generator)
        if self.bias is not None:
            self.bias.zero_()
