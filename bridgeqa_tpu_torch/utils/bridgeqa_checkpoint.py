"""Full reference-ScanQA torch checkpoint -> BridgeQA flax variables.

Maps the reference's trained ``model.pth`` (``models/qa_module.py:47-760``
state dict: VoteNet detector + BLIP_VQA3D + grounding/lang heads) onto this
framework's :class:`bridgeqa_tpu.models.bridgeqa.BridgeQA` tree, so a user
of the reference can load their trained checkpoints directly. Used by
``scripts/verify_parity.py`` for real-data parity dry-docks.

Name map (reference -> ours):
- ``backbone_net.saK.mlp_module.layerJ`` / ``fpK.mlp.layerJ``
  -> ``detector/backbone_net/{saK,fpK}/{mlp_module,mlp}/{layerJ,bnJ}``
  (1x1 Conv2d (Cout, Cin, 1, 1) -> Dense kernel (Cin, Cout))
- ``vgen.convK/bnK``              -> ``detector/vgen/...`` (Conv1d)
- ``proposal.vote_aggregation.*`` -> ``detector/proposal/vote_aggregation``
- ``proposal.proposal.{0,1,3,4,6}`` (index-keyed Conv1d/BN head)
  -> ``detector/proposal/{proposal_mlp/layer{0,1}+bn{0,1}, proposal_out}``
- ``blip_model.*``                -> ``blip_model/*`` (convert_blip_vqa)
- ``object_feat_linear.0`` / ``linear_blip_to_object`` / ``lang_cls.{0,3}``
  / ``object_cls.{0,3}`` / ``dec_list_qo.N.*`` -> same-named heads.

A copy of ``bridgeqa_tpu/utils/bridgeqa_checkpoint.py``, kept in the port
because the port imports nothing of the JAX package;
``tests/test_torch_converters.py`` holds the two equal. Its tree is what
``convert.load_jax_variables`` walks onto the port's modules
(``convert.load_reference_checkpoint``).
"""

import numpy as np

from bridgeqa_tpu_torch.utils.blip_checkpoint import convert_blip_vqa


def _dense_from_conv(sd, key):
    """torch Conv1d/Conv2d 1x1 weight (Cout, Cin, 1[, 1]) -> Dense params."""
    w = np.asarray(sd[f"{key}.weight"], np.float32)
    w = w.reshape(w.shape[0], w.shape[1])
    out = {"kernel": w.T}
    if f"{key}.bias" in sd:
        out["bias"] = np.asarray(sd[f"{key}.bias"], np.float32)
    return out


def _dense(sd, key):
    out = {"kernel": np.asarray(sd[f"{key}.weight"], np.float32).T}
    if f"{key}.bias" in sd:
        out["bias"] = np.asarray(sd[f"{key}.bias"], np.float32)
    return out


def _bn(sd, key):
    params = {"scale": np.asarray(sd[f"{key}.weight"], np.float32),
              "bias": np.asarray(sd[f"{key}.bias"], np.float32)}
    stats = {"mean": np.asarray(sd[f"{key}.running_mean"], np.float32),
             "var": np.asarray(sd[f"{key}.running_var"], np.float32)}
    return params, stats


def _shared_mlp(sd, prefix, mlp_key="mlp_module"):
    """Reference SharedMLP ``{prefix}.layerJ.{conv,bn.bn}`` -> ours
    ``{layerJ: dense, bnJ: bn}``."""
    params, stats = {}, {}
    j = 0
    while f"{prefix}.layer{j}.conv.weight" in sd:
        params[f"layer{j}"] = _dense_from_conv(sd, f"{prefix}.layer{j}.conv")
        bn_p, bn_s = _bn(sd, f"{prefix}.layer{j}.bn.bn")
        params[f"bn{j}"] = bn_p
        stats[f"bn{j}"] = bn_s
        j += 1
    return params, stats


def _mcan_layernorm(sd, key):
    """MCAN's custom LayerNorm keeps torch7-style names (a_2/b_2)."""
    return {"a_2": np.asarray(sd[f"{key}.a_2"], np.float32),
            "b_2": np.asarray(sd[f"{key}.b_2"], np.float32)}


def _mhatt(sd, prefix):
    return {name: _dense(sd, f"{prefix}.{name}")
            for name in ("linear_q", "linear_k", "linear_v", "linear_merge")}


def _ffn(sd, prefix):
    return {"mlp": {"fc": _dense(sd, f"{prefix}.mlp.fc.linear"),
                    "linear": _dense(sd, f"{prefix}.mlp.linear")}}


def _sga(sd, prefix):
    """Reference SGA (mcan_module.py:276-300) -> our SGA params."""
    return {
        "mhatt1": _mhatt(sd, f"{prefix}.mhatt1"),
        "mhatt2": _mhatt(sd, f"{prefix}.mhatt2"),
        "ffn": _ffn(sd, f"{prefix}.ffn"),
        "norm1": _mcan_layernorm(sd, f"{prefix}.norm1"),
        "norm2": _mcan_layernorm(sd, f"{prefix}.norm2"),
        "norm3": _mcan_layernorm(sd, f"{prefix}.norm3"),
    }


def convert_detector(sd, prefix=""):
    """Reference detector keys (optionally ``{prefix}``-qualified) -> our
    ``detector/`` params + batch_stats subtrees."""
    p = prefix
    params, stats = {"backbone_net": {}}, {"backbone_net": {}}
    for name in ("sa1", "sa2", "sa3", "sa4"):
        sub_p, sub_s = _shared_mlp(sd, f"{p}backbone_net.{name}.mlp_module")
        params["backbone_net"][name] = {"mlp_module": sub_p}
        stats["backbone_net"][name] = {"mlp_module": sub_s}
    for name in ("fp1", "fp2"):
        sub_p, sub_s = _shared_mlp(sd, f"{p}backbone_net.{name}.mlp")
        params["backbone_net"][name] = {"mlp": sub_p}
        stats["backbone_net"][name] = {"mlp": sub_s}

    vgen_p, vgen_s = {}, {}
    for i in (1, 2, 3):
        vgen_p[f"conv{i}"] = _dense_from_conv(sd, f"{p}vgen.conv{i}")
    for i in (1, 2):
        bn_p, bn_s = _bn(sd, f"{p}vgen.bn{i}")
        vgen_p[f"bn{i}"] = bn_p
        vgen_s[f"bn{i}"] = bn_s
    params["vgen"] = vgen_p
    stats["vgen"] = vgen_s

    agg_p, agg_s = _shared_mlp(sd, f"{p}proposal.vote_aggregation.mlp_module")
    head_p, head_s = {}, {}
    head_p["layer0"] = _dense_from_conv(sd, f"{p}proposal.proposal.0")
    head_p["layer1"] = _dense_from_conv(sd, f"{p}proposal.proposal.3")
    for j, idx in ((0, 1), (1, 4)):
        bn_p, bn_s = _bn(sd, f"{p}proposal.proposal.{idx}")
        head_p[f"bn{j}"] = bn_p
        head_s[f"bn{j}"] = bn_s
    params["proposal"] = {
        "vote_aggregation": {"mlp_module": agg_p},
        "proposal_mlp": head_p,
        "proposal_out": _dense_from_conv(sd, f"{p}proposal.proposal.6"),
    }
    stats["proposal"] = {
        "vote_aggregation": {"mlp_module": agg_s},
        "proposal_mlp": head_s,
    }
    return params, stats


# ScanQA's actual attribute names (qa_module.py:195-215) -> the detector-
# checkpoint names convert_detector speaks (VoteNet stage-1 convention)
_SCANQA_DETECTOR_ALIASES = {
    "detection_backbone.": "backbone_net.",
    "voting_net.": "vgen.",
    "proposal_net.": "proposal.",
}


def convert_scanqa(sd, *, image_size: int = 480, vocab_size: int = 30524,
                   share_decoder: bool = False):
    """Full reference ScanQA state dict -> {"params", "batch_stats"} for
    BridgeQA (paralleltwin path). Heads absent from the checkpoint are left
    out (merge_pretrained keeps their init). Accepts both the ScanQA module
    names (``detection_backbone/voting_net/proposal_net``, qa_module.py:195)
    and the bare VoteNet names (``backbone_net/vgen/proposal``)."""
    renamed = {}
    for k, v in sd.items():
        for ref_name, det_name in _SCANQA_DETECTOR_ALIASES.items():
            if k.startswith(ref_name):
                k = det_name + k[len(ref_name):]
                break
        renamed[k] = v
    sd = {k: np.asarray(v) for k, v in renamed.items()}
    det_params, det_stats = convert_detector(sd)
    params = {"detector": det_params}
    stats = {"detector": det_stats}

    blip_sd = {k[len("blip_model."):]: v for k, v in sd.items()
               if k.startswith("blip_model.")}
    if blip_sd:
        params["blip_model"] = convert_blip_vqa(
            blip_sd, image_size=image_size, vocab_size=vocab_size,
            share_decoder=share_decoder)

    if "object_feat_linear.0.weight" in sd:
        params["object_feat_linear"] = _dense(sd, "object_feat_linear.0")
    if "linear_blip_to_object.weight" in sd:
        params["linear_blip_to_object"] = _dense(sd, "linear_blip_to_object")
    for head in ("lang_cls", "object_cls"):
        if f"{head}.0.weight" in sd:
            params[head] = {"fc1": _dense(sd, f"{head}.0"),
                            "fc2": _dense(sd, f"{head}.3")}
    i = 0
    while f"dec_list_qo.{i}.mhatt1.linear_q.weight" in sd:
        params[f"dec_qo_{i}"] = _sga(sd, f"dec_list_qo.{i}")
        i += 1
    return {"params": params, "batch_stats": stats}
