"""Tensor parallelism: Megatron column and row sharding over the mesh's
``model`` axis (counterpart of ``bridgeqa_tpu/parallel/tp.py``).

JAX annotates the transformer kernels and lets GSPMD insert the
collectives. Here ``shard_model`` replaces each such ``Dense``'s weight (and
a column layer's bias) by this rank's shard and swaps in a layer that runs
Megatron's two operators:

- column-parallel (``query``/``key``/``value``, ``intermediate_dense``, the
  ViT's ``attn.qkv`` and ``mlp.fc1``): the output features are split; the
  input is whole, and its gradient is all-reduced over the model axis in the
  backward (Megatron's ``f``);
- row-parallel (the attention and FFN outputs, ``attn.proj``, ``mlp.fc2``):
  the input features are split; the partial products are all-reduced in the
  forward (``g``, whose backward is the identity), and the bias, whole, is
  added once after the sum.

An attention keeps whole heads: its ``num_heads`` becomes the shard's
count, and the ViT's fused ``qkv`` (queries, keys and values one after the
other along its outputs) is split per head inside each of the three, not
into three contiguous thirds. Every other parameter is replicated. The
compute-dtype copies of the weights are made from the shards.

It runs on the module path: the fused kernels read whole weights and are
refused on a sharded decoder or ViT (and take no grad in any case). The
optimizer needs no collective: it clips by value and AdamW acts on each
element (``train/optim.py``), so a shard steps exactly as its slice of the
whole tensor would. ``state_dict()`` gathers each shard to the unsharded
layout and ``load_state_dict`` takes its slice (the moments too,
``GroupedAdamW``), so a tp run and a dp run read each other's checkpoints.
The claim held is JAX's (``tp.py:9-10``): dp+tp losses are dp-only ones.
"""

import re

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from bridgeqa_tpu_torch.models.layers import Dense, compute_dtype, param_as, refresh_compute_copies
from bridgeqa_tpu_torch.models.med import BertLMHeadModel, BertSelfAttention
from bridgeqa_tpu_torch.models.vit import Attention, VisionTransformer
from bridgeqa_tpu_torch.parallel.mesh import current_mesh

# the JAX package's patterns over the port's names (flax "/" -> ".", kernel -> weight)
_COLUMN = [
    r".*\.(query|key|value)\.weight$",
    r".*\.intermediate_dense\.weight$",
    r".*\.attn\.qkv\.weight$",           # ViT fused qkv
    r".*\.mlp\.fc1\.weight$",            # ViT MLP
]
_ROW = [
    r".*\.attention\.output\.dense\.weight$",
    r".*\.crossattention\.output\.dense\.weight$",
    r".*\.output_dense\.weight$",
    r".*\.attn\.proj\.weight$",
    r".*\.mlp\.fc2\.weight$",
]
_COLUMN_BIAS = [c.replace(r"\.weight$", r"\.bias$") for c in _COLUMN]


def tp_param_specs(model: nn.Module) -> dict:
    """{parameter name: "column" | "row" | None}: how each parameter is
    split over the model axis (JAX's ``P(None, "model")``, ``P("model",
    None)`` and ``P("model")`` for a column bias, ``P()``). The port's
    weights are (out, in), so "column" splits dim 0 and "row" dim 1."""

    def spec(name, p):
        if p.dim() == 2:
            if any(re.match(rx, name) for rx in _COLUMN):
                return "column"
            if any(re.match(rx, name) for rx in _ROW):
                return "row"
        if p.dim() == 1 and any(re.match(rx, name) for rx in _COLUMN_BIAS):
            return "column"
        return None

    return {name: spec(name, p) for name, p in model.named_parameters()}


class _CopyToModel(torch.autograd.Function):
    """Megatron's ``f``: identity forward, all-reduce of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's ``g``: all-reduce forward, identity backward (every rank
    of the model axis holds the same cotangent)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _shard_index(kind: str, n: int, size: int, r: int, heads_of_three: bool) -> torch.Tensor:
    """Rows (column) or columns (row) of an ``n``-wide dimension that rank
    ``r`` of ``size`` holds: a contiguous block, or for a fused qkv the
    same block of each of its three parts (whole heads of q, k and v)."""
    if heads_of_three:
        third = n // 3
        return torch.cat([torch.arange(j * third + r * third // size,
                                       j * third + (r + 1) * third // size) for j in range(3)])
    return torch.arange(r * n // size, (r + 1) * n // size)


class _ShardedDense(Dense):
    """A ``Dense`` holding one shard of its weight (see the module note);
    ``state_dict`` and ``load_state_dict`` speak the unsharded layout."""

    def _setup(self, kind: str, group, qkv: bool):
        self.tp_kind, self.tp_group, self.tp_qkv = kind, group, qkv
        self.tp_size, self.tp_rank = dist.get_world_size(group), dist.get_rank(group)
        self.tp_dim = 0 if kind == "column" else 1
        self.tp_full = self.weight.shape[self.tp_dim]
        sharded = [("weight", self.tp_dim)]
        if kind == "column" and self.bias is not None:
            sharded.append(("bias", 0))
        self.tp_sharded = dict(sharded)
        with torch.no_grad():
            for name, dim in sharded:
                p = getattr(self, name)
                index = self._index(self.tp_rank).to(p.device)
                shard = nn.Parameter(p.index_select(dim, index).clone())
                shard.tp_gather = self._gather_fn(dim)
                shard.tp_slice = self._slice_fn(dim)
                setattr(self, name, shard)
        if kind == "column":
            self.out_features = self.weight.shape[0]
        else:
            self.in_features = self.weight.shape[1]

    def _index(self, r: int) -> torch.Tensor:
        return _shard_index(self.tp_kind, self.tp_full, self.tp_size, r, self.tp_qkv)

    def _gather_fn(self, dim):
        def gather(t: torch.Tensor) -> torch.Tensor:
            """The unsharded tensor of which ``t`` is this rank's shard."""
            t = t.detach().contiguous()
            parts = [torch.empty_like(t) for _ in range(self.tp_size)]
            dist.all_gather(parts, t, group=self.tp_group)
            shape = list(t.shape)
            shape[dim] = self.tp_full
            full = t.new_empty(shape)
            for r, part in enumerate(parts):
                full.index_copy_(dim, self._index(r).to(t.device), part)
            return full
        return gather

    def _slice_fn(self, dim):
        def take(t: torch.Tensor) -> torch.Tensor:
            """This rank's shard of the unsharded ``t``."""
            return t.index_select(dim, self._index(self.tp_rank).to(t.device))
        return take

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        super()._save_to_state_dict(destination, prefix, keep_vars)
        for name in self.tp_sharded:
            destination[prefix + name] = getattr(self, name).tp_gather(destination[prefix + name])

    def _load_from_state_dict(self, state_dict, prefix, local_metadata, strict, missing_keys,
                              unexpected_keys, error_msgs):
        for name in self.tp_sharded:
            key = prefix + name
            if key in state_dict and state_dict[key].shape[self.tp_sharded[name]] == self.tp_full:
                state_dict[key] = getattr(self, name).tp_slice(state_dict[key])
        super()._load_from_state_dict(state_dict, prefix, local_metadata, strict, missing_keys,
                                      unexpected_keys, error_msgs)


class ColumnParallelDense(_ShardedDense):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(_CopyToModel.apply(x, self.tp_group))


class RowParallelDense(_ShardedDense):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(self)
        y = _ReduceFromModel.apply(F.linear(x.to(dt), param_as(self, "weight", dt)), self.tp_group)
        return y if self.bias is None else y + param_as(self, "bias", dt)


def shard_model(model: nn.Module) -> nn.Module:
    """Shard ``model``'s transformer products over the current mesh's model
    axis in place, as ``tp_param_specs`` says, before its optimizer is
    built. Every rank holds the same whole weights when it is called (drawn
    from one seed, or loaded)."""
    mesh = current_mesh()
    if mesh is None or mesh.size(1) == 1:
        raise ValueError("shard_model needs a mesh with a model axis (make_mesh(model=tp))")
    group = mesh.get_group("model")
    size = dist.get_world_size(group)
    specs = tp_param_specs(model)
    for name, m in list(model.named_modules()):
        kind = specs.get(f"{name}.weight")
        if kind is None:
            continue
        if type(m) is not Dense:
            raise TypeError(f"{name}: only a plain Dense can be sharded, not {type(m).__name__}")
        width = m.out_features if kind == "column" else m.in_features
        qkv = name.endswith("attn.qkv")
        if width % (3 * size if qkv else size):
            raise ValueError(f"{name}: {width} features do not split over {size} ranks")
        m.__class__ = ColumnParallelDense if kind == "column" else RowParallelDense
        m._setup(kind, group, qkv)
    for name, m in model.named_modules():
        if isinstance(m, (BertSelfAttention, Attention)):
            if m.num_heads % size:
                raise ValueError(f"{name}: {m.num_heads} heads do not split over {size} ranks")
            m.num_heads //= size
        elif isinstance(m, (BertLMHeadModel, VisionTransformer)):
            m.tensor_parallel = True
    return refresh_compute_copies(model)
