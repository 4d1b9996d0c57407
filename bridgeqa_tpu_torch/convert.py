"""Carry the JAX package's weights into the port.

The port names its submodules after the flax paths (``detector.backbone_net.
sa1.mlp_module.layer0``, ``blip_model.text_decoder.bert.encoder.layer_3.
crossattention.self.query``), so the mapping is a walk over the flax tree:

- Dense ``kernel`` (in, out) -> ``weight`` (out, in);
- Conv ``kernel`` (kh, kw, in, out) -> ``weight`` (out, in, kh, kw);
- LayerNorm / BatchNorm ``scale`` -> ``weight``; ``bias`` -> ``bias``;
- BatchNorm statistics ``mean`` / ``var`` -> ``running_mean`` / ``running_var``;
- Embed ``embedding`` -> ``weight``;
- every other leaf (``cls_token``, ``pos_embed``, ``bilinear_fusion_*``,
  ``a_2``, ``b_2``, the LM head ``bias``) keeps its name and layout.

``export_jax_variables`` walks the other way, from the port's modules to a
flax tree of numpy arrays: a ``Dense`` weight back to its (in, out) kernel,
a ``Conv`` or ``PatchEmbed`` weight back to (kh, kw, in, out).

A reference checkpoint (the reference's ``model.pth``) reaches the port
through ``load_reference_checkpoint``: the port's copy of the JAX package's
converter (``utils/bridgeqa_checkpoint.convert_scanqa``) maps it onto the
flax tree, ``merge_pretrained`` keeps the model's own values where the
checkpoint has none, and ``load_jax_variables`` fills the modules. Nothing
here imports JAX.
"""

import numpy as np
import torch
from torch import nn

from bridgeqa_tpu_torch.models.layers import (BatchNorm, Conv, Dense, Embed, LayerNorm,
                                              PatchEmbed, refresh_compute_copies)
from bridgeqa_tpu_torch.utils.blip_checkpoint import load_torch_checkpoint, merge_pretrained
from bridgeqa_tpu_torch.utils.bridgeqa_checkpoint import convert_scanqa

_RENAME = {"kernel": "weight", "scale": "weight", "embedding": "weight",
           "mean": "running_mean", "var": "running_var"}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    else:
        yield prefix, tree


def _to_torch_layout(name: str, value: np.ndarray) -> np.ndarray:
    if name == "kernel" and value.ndim == 2:
        return value.T
    if name == "kernel" and value.ndim == 4:
        return value.transpose(3, 2, 0, 1)
    return value


@torch.no_grad()
def load_jax_variables(model: nn.Module, variables) -> nn.Module:
    """Fill ``model``'s parameters and buffers from a flax ``{"params",
    "batch_stats"}`` tree of arrays. Every value is copied (no view of the
    caller's buffers survives). Raises on a missing, unknown or mis-shaped
    entry, so a load is all or nothing."""
    state = model.state_dict(keep_vars=True)
    filled = set()
    for collection in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(collection, {})):
            leaf = path[-1]
            key = ".".join(path[:-1] + (_RENAME.get(leaf, leaf),))
            if key not in state:
                raise KeyError(f"{collection}/{'/'.join(path)} has no counterpart {key!r} in the port")
            arr = np.array(_to_torch_layout(leaf, np.asarray(value, dtype=np.float32)), copy=True)
            target = state[key]
            if tuple(arr.shape) != tuple(target.shape):
                raise ValueError(f"{key}: port shape {tuple(target.shape)}, JAX {arr.shape}")
            target.copy_(torch.from_numpy(arr))
            filled.add(key)
    missing = sorted(set(state) - filled)
    if missing:
        raise KeyError(f"port entries with no JAX value: {missing[:10]}"
                       f"{' ...' if len(missing) > 10 else ''}")
    return model


def _flax_leaf(module: nn.Module, name: str, value: np.ndarray):
    """(collection, flax leaf name, value in the flax layout) of the
    parameter or buffer ``name`` of ``module``."""
    if isinstance(module, (BatchNorm, LayerNorm)):
        if name in ("running_mean", "running_var"):
            return "batch_stats", name[len("running_"):], value
        return "params", "scale" if name == "weight" else name, value
    if isinstance(module, Dense) and name == "weight":
        return "params", "kernel", value.T
    if isinstance(module, (Conv, PatchEmbed)) and name == "weight":
        return "params", "kernel", value.transpose(2, 3, 1, 0)
    if isinstance(module, Embed) and name == "weight":
        return "params", "embedding", value
    return "params", name, value


@torch.no_grad()
def export_jax_variables(model: nn.Module) -> dict:
    """The flax ``{"params", "batch_stats"}`` tree of ``model``'s parameters
    and persistent buffers, as numpy copies in their own dtype: the inverse
    of ``load_jax_variables``."""
    out = {"params": {}, "batch_stats": {}}
    for mod_name, module in model.named_modules():
        entries = list(module._parameters.items()) + [
            (k, v) for k, v in module._buffers.items()
            if k not in module._non_persistent_buffers_set]
        for name, tensor in entries:
            if tensor is None:
                continue
            collection, leaf, value = _flax_leaf(module, name, tensor.detach().cpu().numpy())
            node = out[collection]
            for part in mod_name.split(".") if mod_name else ():
                node = node.setdefault(part, {})
            node[leaf] = np.array(value, copy=True)
    return out


def load_reference_checkpoint(model: nn.Module, state_dict_or_path):
    """Fill ``model`` (a ``BridgeQA``) from a reference ScanQA/BridgeQA
    checkpoint: a ``.pth`` path or a state dict of arrays, its keys with or
    without DDP's ``module.`` prefix. The converted tree is merged into the
    model's own (``merge_pretrained``: an entry the checkpoint lacks, or has
    in another shape, keeps the model's value), then loaded, and the
    compute-dtype copies are made again. Returns (loaded, skipped), the flax
    paths taken from the checkpoint and those it could not place."""
    if isinstance(state_dict_or_path, (str, bytes)) or hasattr(state_dict_or_path, "__fspath__"):
        sd = load_torch_checkpoint(state_dict_or_path)
    else:
        sd = state_dict_or_path
    sd = {k.removeprefix("module."): (v.detach().cpu().numpy() if torch.is_tensor(v)
                                      else np.asarray(v)) for k, v in sd.items()}
    blip = model.cfg.blip
    converted = convert_scanqa(sd, image_size=blip.image_size, vocab_size=blip.med.vocab_size,
                               share_decoder=blip.share_decoder)
    own = export_jax_variables(model)
    params, loaded, skipped = merge_pretrained(own["params"], converted["params"])
    stats, loaded_s, skipped_s = merge_pretrained(own["batch_stats"], converted["batch_stats"])
    load_jax_variables(model, {"params": params, "batch_stats": stats})
    refresh_compute_copies(model)
    return loaded + loaded_s, skipped + skipped_s
