"""torch BLIP checkpoint -> flax params converter.

Equivalent of the reference loading pipeline (``models/blip.py:371-399``
``load_checkpoint`` + ``models/med.py:514-518/985-988`` twin-weight init +
``utils/blip_utils.py:331-353`` ``get_blip_model_simple``): takes the
BLIP VQA torch state dict (e.g. ``model_base_vqa_capfilt_large.pth``) and
produces the ``BLIPVQA3D`` flax param tree:

- torch ``Linear.weight`` (out, in) -> flax ``Dense.kernel`` (in, out);
- ``patch_embed.proj.weight`` (D, 3, kh, kw) -> Conv kernel (kh, kw, 3, D);
- ``pos_embed`` bicubic-resized when image resolution differs
  (``vit.py:283-307`` ``interpolate_pos_embed``);
- BERT ``token_type_embeddings`` row 0 folded into the position embeddings
  (BLIP only ever uses token type 0, so the fold is exact);
- encoder layer i copied into ``layer_twin_i`` (the twin init);
- decoder weights copied into ``text_decoder_scene`` (the reference
  materializes the scene decoder from the same pretrained decoder);
- vocab rows padded with zeros if the checkpoint predates the [DEC]/[ENC]
  additions.

Pure numpy — runs on host, no torch dependency unless loading a ``.pth``.

A copy of ``bridgeqa_tpu/utils/blip_checkpoint.py``, kept in the port
because the port imports nothing of the JAX package;
``tests/test_torch_converters.py`` holds the two equal. One deliberate
difference: ``interpolate_pos_embed`` resizes with scipy's ``zoom`` alone
(scipy is installed wherever the port runs) and has no JAX fallback.
"""

import numpy as np


def interpolate_pos_embed(pos_embed, num_patches_new: int):
    """Bicubic grid resize of ViT position embeddings, CLS row preserved
    (reference ``models/vit.py:283-307``). pos_embed: (1, 1+N, D) numpy."""
    pos_embed = np.asarray(pos_embed)
    n_old = pos_embed.shape[1] - 1
    if n_old == num_patches_new:
        return pos_embed
    gs_old = int(round(n_old ** 0.5))
    gs_new = int(round(num_patches_new ** 0.5))
    cls_tok, grid = pos_embed[:, :1], pos_embed[:, 1:]
    grid = grid.reshape(gs_old, gs_old, -1)
    from scipy.ndimage import zoom

    z = gs_new / gs_old
    # grid_mode=True + edge replication matches torch F.interpolate's
    # align_corners=False bicubic boundary handling
    grid = zoom(grid, (z, z, 1.0), order=3, grid_mode=True, mode="nearest")
    grid = grid.reshape(1, gs_new * gs_new, -1)
    return np.concatenate([cls_tok, grid], axis=1).astype(pos_embed.dtype)


def _linear(sd, prefix):
    w = np.asarray(sd[f"{prefix}.weight"])
    out = {"kernel": w.T}
    if f"{prefix}.bias" in sd:
        out["bias"] = np.asarray(sd[f"{prefix}.bias"])
    return out


def _layernorm(sd, prefix):
    return {"scale": np.asarray(sd[f"{prefix}.weight"]),
            "bias": np.asarray(sd[f"{prefix}.bias"])}


def _attention(sd, prefix):
    return {
        "self": {
            "query": _linear(sd, f"{prefix}.self.query"),
            "key": _linear(sd, f"{prefix}.self.key"),
            "value": _linear(sd, f"{prefix}.self.value"),
        },
        "output": {
            "dense": _linear(sd, f"{prefix}.output.dense"),
            "LayerNorm": _layernorm(sd, f"{prefix}.output.LayerNorm"),
        },
    }


def _bert_layer(sd, prefix):
    layer = {
        "attention": _attention(sd, f"{prefix}.attention"),
        "intermediate_dense": _linear(sd, f"{prefix}.intermediate.dense"),
        "output_dense": _linear(sd, f"{prefix}.output.dense"),
        "output_LayerNorm": _layernorm(sd, f"{prefix}.output.LayerNorm"),
    }
    # BertOutputParallel extra LayerNorms (parallelshare checkpoints)
    i = 0
    while f"{prefix}.output.LayerNorms.{i}.weight" in sd:
        layer[f"output_LayerNorms_{i}"] = _layernorm(sd, f"{prefix}.output.LayerNorms.{i}")
        i += 1
    if f"{prefix}.crossattention.self.query.weight" in sd:
        layer["crossattention"] = _attention(sd, f"{prefix}.crossattention")
    return layer


def _pad_vocab(arr, vocab_size: int):
    if arr.shape[0] >= vocab_size:
        return arr[:vocab_size]
    pad = np.zeros((vocab_size - arr.shape[0],) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def _bert_embeddings(sd, prefix, vocab_size: int):
    word = _pad_vocab(np.asarray(sd[f"{prefix}.word_embeddings.weight"]), vocab_size)
    pos = np.asarray(sd[f"{prefix}.position_embeddings.weight"])
    # fold token_type row 0 into positions (BLIP uses token type 0 only)
    tt_key = f"{prefix}.token_type_embeddings.weight"
    if tt_key in sd:
        pos = pos + np.asarray(sd[tt_key])[0][None, :]
    return {
        "word_embeddings": {"embedding": word},
        "position_embeddings": {"embedding": pos},
        "LayerNorm": _layernorm(sd, f"{prefix}.LayerNorm"),
    }


def convert_vit(sd, prefix: str, num_patches: int):
    """torch timm-style ViT -> flax VisionTransformer params."""
    w = np.asarray(sd[f"{prefix}.patch_embed.proj.weight"])  # (D, 3, kh, kw)
    params = {
        "cls_token": np.asarray(sd[f"{prefix}.cls_token"]),
        "pos_embed": interpolate_pos_embed(sd[f"{prefix}.pos_embed"], num_patches),
        "patch_embed_proj": {
            "kernel": w.transpose(2, 3, 1, 0),
            "bias": np.asarray(sd[f"{prefix}.patch_embed.proj.bias"]),
        },
        "norm": _layernorm(sd, f"{prefix}.norm"),
    }
    i = 0
    while f"{prefix}.blocks.{i}.norm1.weight" in sd:
        params[f"blocks_{i}"] = {
            "norm1": _layernorm(sd, f"{prefix}.blocks.{i}.norm1"),
            "attn": {
                "qkv": _linear(sd, f"{prefix}.blocks.{i}.attn.qkv"),
                "proj": _linear(sd, f"{prefix}.blocks.{i}.attn.proj"),
            },
            "norm2": _layernorm(sd, f"{prefix}.blocks.{i}.norm2"),
            "mlp": {
                "fc1": _linear(sd, f"{prefix}.blocks.{i}.mlp.fc1"),
                "fc2": _linear(sd, f"{prefix}.blocks.{i}.mlp.fc2"),
            },
        }
        i += 1
    return params


def convert_bert_encoder(sd, prefix: str, *, twin: bool):
    """torch BertEncoder -> flax {layer_i[, layer_twin_i]} params. Twin
    layers initialize from the same pretrained layer (``med.py:514-518``)."""
    params = {}
    i = 0
    while f"{prefix}.layer.{i}.attention.self.query.weight" in sd:
        layer = _bert_layer(sd, f"{prefix}.layer.{i}")
        params[f"layer_{i}"] = layer
        if twin:
            twin_key = f"{prefix}.layer_twin.{i}.attention.self.query.weight"
            if twin_key in sd:  # fine-tuned BridgeQA checkpoint with real twins
                params[f"layer_twin_{i}"] = _bert_layer(sd, f"{prefix}.layer_twin.{i}")
            else:
                params[f"layer_twin_{i}"] = _bert_layer(sd, f"{prefix}.layer.{i}")
        i += 1
    return params


def convert_lm_head(sd, prefix: str, vocab_size: int):
    """torch BertLMHeadModel (bert + cls.predictions) -> flax params.
    The decoder projection is tied to the word embeddings on our side, so
    only transform + bias are taken."""
    return {
        "bert": {
            "embeddings": _bert_embeddings(sd, f"{prefix}.bert.embeddings", vocab_size),
            "encoder": convert_bert_encoder(sd, f"{prefix}.bert.encoder", twin=False),
        },
        "cls": {
            "transform_dense": _linear(sd, f"{prefix}.cls.predictions.transform.dense"),
            "transform_LayerNorm": _layernorm(sd, f"{prefix}.cls.predictions.transform.LayerNorm"),
            "bias": _pad_vocab(np.asarray(sd[f"{prefix}.cls.predictions.bias"]), vocab_size),
        },
    }


def convert_blip_vqa(sd, *, image_size: int = 480, patch_size: int = 16,
                     vocab_size: int = 30524, share_decoder: bool = False):
    """Full BLIP-VQA torch state dict -> BLIPVQA3D flax params (partial tree:
    only the pretrained submodules; adapters/fusion stay at init)."""
    sd = {k: v for k, v in sd.items()}
    num_patches = (image_size // patch_size) ** 2

    # the torch text_encoder may carry a "bert." inner prefix
    te_prefix = "text_encoder.bert" if "text_encoder.bert.embeddings.word_embeddings.weight" in sd \
        else "text_encoder"

    params = {
        "visual_encoder": convert_vit(sd, "visual_encoder", num_patches),
        "text_encoder": {
            "embeddings": _bert_embeddings(sd, f"{te_prefix}.embeddings", vocab_size),
            "encoder": convert_bert_encoder(sd, f"{te_prefix}.encoder", twin=True),
        },
        "text_decoder": convert_lm_head(sd, "text_decoder", vocab_size),
    }
    if not share_decoder:
        scene_prefix = "text_decoder_scene" \
            if "text_decoder_scene.bert.embeddings.word_embeddings.weight" in sd else "text_decoder"
        params["text_decoder_scene"] = convert_lm_head(sd, scene_prefix, vocab_size)

    # fine-tuned BridgeQA checkpoints also carry the adapter / fusion heads
    # (blip_vqa_3d.py:105-160: index-keyed nn.Sequential modules)
    if "linear_scene_object.0.weight" in sd:
        params["linear_scene_object"] = {
            "fc1": _linear(sd, "linear_scene_object.0"),
            "fc2": _linear(sd, "linear_scene_object.3"),
            "norm": _layernorm(sd, "linear_scene_object.5"),
        }
    if "lowrank_2d.weight" in sd:
        params["lowrank_2d"] = _linear(sd, "lowrank_2d")
        params["lowrank_3d"] = _linear(sd, "lowrank_3d")
        # torch nn.Bilinear weight is (out, in1, in2) == our einsum kernel layout
        params["bilinear_fusion_kernel"] = np.asarray(sd["bilinear_fusion.weight"])
        params["bilinear_fusion_bias"] = np.asarray(sd["bilinear_fusion.bias"])
    if "answer_cls.0.weight" in sd:
        params["answer_cls"] = {
            "fc1": _linear(sd, "answer_cls.0"),
            "norm": _layernorm(sd, "answer_cls.3"),
            "fc2": _linear(sd, "answer_cls.4"),
        }
    if "answer_cls_2d3d.0.weight" in sd:
        params["answer_cls_2d3d"] = {
            "fc1": _linear(sd, "answer_cls_2d3d.0"),
            "norm": _layernorm(sd, "answer_cls_2d3d.3"),
            "fc2": _linear(sd, "answer_cls_2d3d.4"),
        }
    return params


def load_torch_checkpoint(path):
    """Load a .pth; returns the raw state dict (handles {'model': ...})."""
    import torch

    ckpt = torch.load(path, map_location="cpu")
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in sd.items()}


def merge_pretrained(init_params, pretrained):
    """Recursively overwrite init params with converted pretrained arrays,
    validating shapes; returns (merged, loaded_paths, skipped_paths).
    Shape-mismatched keys are dropped like ``blip.py:390-395``."""
    loaded, skipped = [], []

    def merge(dst, src, path):
        out = dict(dst)
        for k, v in src.items():
            if k not in dst:
                skipped.append(f"{path}{k} (no such param)")
                continue
            if isinstance(v, dict):
                out[k] = merge(dst[k], v, f"{path}{k}/")
            else:
                want = np.asarray(dst[k]).shape
                have = np.asarray(v).shape
                if want != have:
                    skipped.append(f"{path}{k} (shape {have} != {want})")
                else:
                    out[k] = np.asarray(v, dtype=np.asarray(dst[k]).dtype)
                    loaded.append(f"{path}{k}")
        return out

    merged = merge(init_params, pretrained, "")
    return merged, loaded, skipped
