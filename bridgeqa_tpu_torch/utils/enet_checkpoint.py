"""torch7-ported ENet checkpoint -> flax ENetEncoder/ENetClassifier params.

The reference loads ``scannetv2_enet.pth`` into an index-keyed
``nn.Sequential`` (``lib/enet.py:130-694``, consumed via
``create_enet_for_3d`` at ``scripts/compute_multiview_features.py:89-123``).
This maps that state dict onto :mod:`bridgeqa_tpu.models.enet`:

top[0].0        initial 3x3/2 conv (13 ch)      -> initial/conv
top[2]/top[3]   BN(16, eps 1e-3) + PReLU        -> initial/bn + initial/prelu
top[4]          down 16->64                     -> b1_0
top[5..8]       4x regular 64                   -> b1_1..b1_4
top[9]          down 64->128                    -> b2_0
top[10..17]     stage-2 series                  -> b2_1..b2_8
top[18..25]     stage-3 series                  -> b3_0..b3_7
top[26].0       1x1 classifier                  -> ENetClassifier

Within a bottleneck ``{i}.0.0``: 0 reduce / 1 bn1 / 2 prelu1 / core convs /
bn2 / prelu2 / expand / bn3; ``{i}.2`` is the post-residual PReLU.

A copy of ``bridgeqa_tpu/utils/enet_checkpoint.py``, kept in the port
because the port imports nothing of the JAX package;
``tests/test_torch_converters.py`` holds the two equal.
"""

import numpy as np

# flax module name per top-level torch index (encoder part)
_BLOCK_NAMES = (
    ["b1_0", "b1_1", "b1_2", "b1_3", "b1_4", "b2_0"]
    + [f"b2_{i}" for i in range(1, 9)]
    + [f"b3_{i}" for i in range(8)]
)
# stage-2/3 bottleneck kinds, in series order (ENet table; enet.py:139-694)
_SERIES = ["regular", "dilated", "asymmetric", "dilated",
           "regular", "dilated", "asymmetric", "dilated"]


def _kind(block_name: str) -> str:
    if block_name in ("b1_0", "b2_0"):
        return "down"
    if block_name.startswith("b1"):
        return "regular"
    stage, i = block_name.split("_")
    idx = int(i) - 1 if stage == "b2" else int(i)
    return _SERIES[idx]


def _conv(sd, key, transpose=True):
    w = np.asarray(sd[f"{key}.weight"], np.float32)
    out = {"kernel": w.transpose(2, 3, 1, 0) if transpose else w}
    if f"{key}.bias" in sd:
        out["bias"] = np.asarray(sd[f"{key}.bias"], np.float32)
    return out


def _bn(sd, key):
    params = {"scale": np.asarray(sd[f"{key}.weight"], np.float32),
              "bias": np.asarray(sd[f"{key}.bias"], np.float32)}
    stats = {"mean": np.asarray(sd[f"{key}.running_mean"], np.float32),
             "var": np.asarray(sd[f"{key}.running_var"], np.float32)}
    return params, stats


def _prelu(sd, key):
    return {"alpha": np.asarray(sd[f"{key}.weight"], np.float32)}


def _bottleneck(sd, top: int, kind: str):
    b = f"{top}.0.0"
    params, stats = {}, {}
    params["reduce"] = _conv(sd, f"{b}.0")
    params["bn1"], stats["bn1"] = _bn(sd, f"{b}.1")
    params["prelu1"] = _prelu(sd, f"{b}.2")
    if kind == "asymmetric":
        params["conv_a"] = _conv(sd, f"{b}.3")  # (1, 5), no bias
        params["conv_b"] = _conv(sd, f"{b}.4")  # (5, 1), bias
        params["bn2"], stats["bn2"] = _bn(sd, f"{b}.5")
        params["prelu2"] = _prelu(sd, f"{b}.6")
        params["expand"] = _conv(sd, f"{b}.7")
        params["bn3"], stats["bn3"] = _bn(sd, f"{b}.8")
    else:
        params["conv"] = _conv(sd, f"{b}.3")
        params["bn2"], stats["bn2"] = _bn(sd, f"{b}.4")
        params["prelu2"] = _prelu(sd, f"{b}.5")
        params["expand"] = _conv(sd, f"{b}.6")
        params["bn3"], stats["bn3"] = _bn(sd, f"{b}.7")
    params["prelu_out"] = _prelu(sd, f"{top}.2")
    return params, stats


def convert_enet(sd):
    """torch ``create_enet`` state dict -> (encoder variables, classifier
    variables): ``{"params": ..., "batch_stats": ...}`` trees for
    ``ENetEncoder`` / ``ENetClassifier``."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    init_bn_params, init_bn_stats = _bn(sd, "2")
    params = {"initial": {"conv": _conv(sd, "0.0"),
                          "bn": init_bn_params,
                          "prelu": _prelu(sd, "3")}}
    stats = {"initial": {"bn": init_bn_stats}}
    for offset, name in enumerate(_BLOCK_NAMES):
        top = 4 + offset
        p, s = _bottleneck(sd, top, _kind(name))
        params[name] = p
        stats[name] = s
    encoder = {"params": params, "batch_stats": stats}
    classifier = {"params": {"classifier": _conv(sd, "26.0")}}
    return encoder, classifier


def load_enet_torch7(path):
    """Load the reference's ``.pth`` and convert (torch needed on host)."""
    import torch

    sd = torch.load(path, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return convert_enet({k: v.numpy() for k, v in sd.items()})
