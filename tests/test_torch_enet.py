"""The port's ENet (``bridgeqa_tpu_torch/models/enet.py``) against the JAX
package's, on the CPU, and the ways weights reach it: the JAX tree
(``convert.load_jax_variables`` and back through ``export_jax_variables``)
and the reference's torch7 checkpoint (the port's copy of
``utils/enet_checkpoint.py``).

The JAX ``init`` leaves BatchNorm at mean 0, variance 1, scale 1 and bias 0,
every PReLU slope at 0.25 and every convolution bias at 0, which would hide
a swapped or dropped parameter: the tests draw them all at random first.
The encoder and the classifier run at 48x64 (H x W) in f32, within 1e-5 of
JAX (convolutions sum in another order, through 27 bottlenecks; the
features reach about 10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridgeqa_tpu.models import enet as jenet
from bridgeqa_tpu.utils import enet_checkpoint as jenet_checkpoint
from bridgeqa_tpu_torch.convert import export_jax_variables, load_jax_variables
from bridgeqa_tpu_torch.models import enet
from bridgeqa_tpu_torch.utils import enet_checkpoint

TOL = 1e-5
IMG_H, IMG_W = 48, 64
NUM_CLASSES = 41


def _randomised(variables, rng):
    """Every BatchNorm statistic and affine, PReLU slope and convolution
    bias drawn at random."""
    def draw(path, v):
        key = jax.tree_util.keystr(path)
        shape = np.shape(v)
        if key.endswith("['mean']") or key.endswith("['bias']"):
            return jnp.asarray(rng.randn(*shape) * 0.2, jnp.float32)
        if key.endswith("['var']"):
            return jnp.asarray(rng.uniform(0.5, 2.0, shape), jnp.float32)
        if key.endswith("['scale']"):
            return jnp.asarray(1.0 + rng.randn(*shape) * 0.2, jnp.float32)
        if key.endswith("['alpha']"):
            return jnp.asarray(rng.uniform(0.0, 0.5, shape), jnp.float32)
        return v
    return jax.tree_util.tree_map_with_path(draw, variables)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def enet_pair():
    rng = np.random.RandomState(0)
    images = rng.rand(2, IMG_H, IMG_W, 3).astype(np.float32)
    jencoder, jclassifier = jenet.create_enet_for_3d(NUM_CLASSES)
    enc_vars = _randomised(jencoder.init(jax.random.PRNGKey(0), jnp.asarray(images)), rng)
    feats = jencoder.apply(enc_vars, jnp.asarray(images))
    cls_vars = jclassifier.init(jax.random.PRNGKey(1), feats)
    encoder, classifier = enet.create_enet_for_3d(NUM_CLASSES, device="cpu")
    load_jax_variables(encoder, enc_vars)
    load_jax_variables(classifier, cls_vars)
    want = {"features": np.asarray(feats),
            "logits": np.asarray(jclassifier.apply(cls_vars, feats))}
    return images, enc_vars, cls_vars, encoder, classifier, want


def _close(got, want, what):
    got = got.detach().numpy()
    assert got.shape == want.shape and np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0, err_msg=what)


def test_encoder_and_classifier_match_jax(enet_pair):
    images, _, _, encoder, classifier, want = enet_pair
    with torch.no_grad():
        feats = encoder(torch.from_numpy(images))
        logits = classifier(feats)
    assert feats.shape == (2, IMG_H // 8, IMG_W // 8, 128)
    _close(feats, want["features"], "encoder")
    _close(logits, want["logits"], "classifier")


@pytest.mark.parametrize("shape", [(1, 44, 64, 3), (1, 48, 60, 3), (48, 64, 3)])
def test_encoder_refuses_sizes_that_are_not_multiples_of_8(enet_pair, shape):
    with pytest.raises(ValueError), torch.no_grad():
        enet_pair[3](torch.zeros(shape))


@pytest.mark.parametrize("part", ["encoder", "classifier"])
def test_export_round_trips(enet_pair, part):
    """``export_jax_variables`` gives back the JAX tree leaf for leaf, the
    convolution kernels in flax's (kh, kw, in, out), and loads into a fresh
    module unchanged."""
    _, enc_vars, cls_vars, encoder, classifier, _ = enet_pair
    model, variables = (encoder, enc_vars) if part == "encoder" else (classifier, cls_vars)
    exported = export_jax_variables(model)
    for collection in ("params", "batch_stats"):
        got = _leaves(exported[collection])
        want = _leaves(variables.get(collection, {}))
        assert list(sorted(got)) == list(sorted(want)), collection
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    fresh = (enet.ENetEncoder("cpu") if part == "encoder"
             else enet.ENetClassifier(NUM_CLASSES, device="cpu"))
    load_jax_variables(fresh, exported)
    for (name, a), (_, b) in zip(model.state_dict().items(), fresh.state_dict().items()):
        assert torch.equal(a, b), name


def _torch7_state_dict(enc_vars, cls_vars) -> dict:
    """The reference's index-keyed ``create_enet`` state dict holding the
    given flax trees (the inverse of ``convert_enet``)."""
    p, s = enc_vars["params"], enc_vars["batch_stats"]
    sd = {}

    def conv(key, node):
        sd[f"{key}.weight"] = np.asarray(node["kernel"]).transpose(3, 2, 0, 1)
        if "bias" in node:
            sd[f"{key}.bias"] = np.asarray(node["bias"])

    def bn(key, params, stats):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = np.asarray(params["scale"]), np.asarray(params["bias"])
        sd[f"{key}.running_mean"] = np.asarray(stats["mean"])
        sd[f"{key}.running_var"] = np.asarray(stats["var"])

    def prelu(key, node):
        sd[f"{key}.weight"] = np.asarray(node["alpha"])

    conv("0.0", p["initial"]["conv"])
    bn("2", p["initial"]["bn"], s["initial"]["bn"])
    prelu("3", p["initial"]["prelu"])
    for offset, name in enumerate(enet_checkpoint._BLOCK_NAMES):
        top, bp, bs = 4 + offset, p[name], s[name]
        b = f"{top}.0.0"
        cores = ["conv_a", "conv_b"] if "conv_a" in bp else ["conv"]
        conv(f"{b}.0", bp["reduce"])
        bn(f"{b}.1", bp["bn1"], bs["bn1"])
        prelu(f"{b}.2", bp["prelu1"])
        for j, core in enumerate(cores):
            conv(f"{b}.{3 + j}", bp[core])
        k = 3 + len(cores)
        bn(f"{b}.{k}", bp["bn2"], bs["bn2"])
        prelu(f"{b}.{k + 1}", bp["prelu2"])
        conv(f"{b}.{k + 2}", bp["expand"])
        bn(f"{b}.{k + 3}", bp["bn3"], bs["bn3"])
        prelu(f"{top}.2", bp["prelu_out"])
    conv("26.0", cls_vars["params"]["classifier"])
    return sd


def test_torch7_checkpoint_reaches_the_same_tree_through_both_converters(enet_pair, tmp_path):
    """A state dict at the reference's torch7 names: the port's copy of the
    converter and the JAX package's give the same trees, and the port loads
    its tree into the modules, whose outputs are JAX's."""
    images, enc_vars, cls_vars, _, _, want = enet_pair
    sd = _torch7_state_dict(enc_vars, cls_vars)
    got_enc, got_cls = enet_checkpoint.convert_enet(sd)
    want_enc, want_cls = jenet_checkpoint.convert_enet(sd)
    for got, ref in ((got_enc, want_enc), (got_cls, want_cls), (got_enc, enc_vars),
                     (got_cls, cls_vars)):
        for collection in ("params", "batch_stats"):
            g, w = _leaves(got.get(collection, {})), _leaves(ref.get(collection, {}))
            assert sorted(g) == sorted(w), collection
            for k, v in w.items():
                np.testing.assert_array_equal(g[k], v, err_msg=k)
    # the .pth route the multiview driver's --enet_ckpt takes
    path = tmp_path / "enet.pth"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)
    enc_tree, cls_tree = enet_checkpoint.load_enet_torch7(str(path))
    encoder, classifier = enet.create_enet_for_3d(NUM_CLASSES, device="cpu")
    load_jax_variables(encoder, enc_tree)
    load_jax_variables(classifier, cls_tree)
    with torch.no_grad():
        feats = encoder(torch.from_numpy(images))
        _close(feats, want["features"], "encoder from the torch7 checkpoint")
        _close(classifier(feats), want["logits"], "classifier from the torch7 checkpoint")
