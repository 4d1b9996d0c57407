"""The port's copies of the JAX package's checkpoint converters
(``bridgeqa_tpu_torch/utils/{blip,bridgeqa,enet}_checkpoint.py``) and the
path a reference checkpoint takes into the port with no JAX
(``convert.load_reference_checkpoint``).

- Each copy is held to its original by the AST comparison of
  ``tests/test_torch_feed.py``. The one deliberate difference,
  ``interpolate_pos_embed`` without its JAX fallback, is held by its output.
- A reference ScanQA state dict at the reference's names (the detector
  under the ScanQA module names, ``blip_model.*`` as
  ``tests/test_checkpoint_convert.py`` builds it, the heads and the SGA
  layers), its arrays drawn from a seed at the shapes of the tiny model of
  ``tests/test_torch_bridgeqa.py``, loads into the port through the copies.
  The port's rank forward then equals the JAX model's after JAX's own
  ``convert_scanqa`` and ``merge_pretrained``, at that file's tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridgeqa_tpu.data.scannet_config import ScannetDatasetConfig
from bridgeqa_tpu.models import bridgeqa as jbridgeqa
from bridgeqa_tpu.ops import grouping as jgrouping
from bridgeqa_tpu.utils import blip_checkpoint as jblip_checkpoint
from bridgeqa_tpu.utils import bridgeqa_checkpoint as jbridgeqa_checkpoint
from bridgeqa_tpu.utils import enet_checkpoint as jenet_checkpoint
from bridgeqa_tpu_torch.convert import export_jax_variables, load_reference_checkpoint
from bridgeqa_tpu_torch.models import blip_vqa3d, bridgeqa, med
from bridgeqa_tpu_torch.models.layers import init_weights
from bridgeqa_tpu_torch.utils import blip_checkpoint, bridgeqa_checkpoint, enet_checkpoint
from tests.test_torch_bridgeqa import ATOL, TINY_BLIP, TINY_MED, _port_cfg, _qa_batch
from tests.test_torch_feed import assert_same_code

JCFG = jbridgeqa.BridgeQAConfig(num_answers=30, num_proposal=32, hidden_size=32, blip=TINY_BLIP,
                                mcan_num_layers=1, mcan_flat_out_size=64, mcan_flat_mlp_size=32,
                                input_feature_dim=1)
# the checkpoint's ViT grid is 4x4 patches, the model's 2x2: the position
# embeddings go through interpolate_pos_embed
CKPT_PATCHES = 16


@pytest.mark.parametrize("port_module,jax_module,changed", [
    (blip_checkpoint, jblip_checkpoint, ("interpolate_pos_embed",)),
    (bridgeqa_checkpoint, jbridgeqa_checkpoint, ()),
    (enet_checkpoint, jenet_checkpoint, ()),
], ids=["blip", "bridgeqa", "enet"])
def test_copies_match_originals(port_module, jax_module, changed):
    assert_same_code(port_module, jax_module, changed)


@pytest.mark.parametrize("n_old,n_new", [(16, 16), (16, 64), (64, 36), (900, 4)])
def test_pos_embed_interpolation_matches_the_original(n_old, n_new):
    pe = np.random.RandomState(n_old + n_new).randn(1, 1 + n_old, 8).astype(np.float32)
    got = blip_checkpoint.interpolate_pos_embed(pe, n_new)
    np.testing.assert_array_equal(got, jblip_checkpoint.interpolate_pos_embed(pe, n_new))
    assert got.shape == (1, 1 + n_new, 8) and got.dtype == np.float32


class _RefStateDict:
    """A reference checkpoint's state dict (torch names and layouts), its
    arrays drawn from ``rng`` at the shapes of a flax tree of the model."""

    def __init__(self, rng):
        self.rng = rng
        self.sd = {}

    def _draw(self, shape, scale=0.05):
        return (self.rng.randn(*shape) * scale).astype(np.float32)

    def linear(self, key, node):
        self.sd[f"{key}.weight"] = self._draw(node["kernel"].shape[::-1])
        if "bias" in node:
            self.sd[f"{key}.bias"] = self._draw(node["bias"].shape)

    def conv1x1(self, key, node):
        cin, cout = node["kernel"].shape
        self.sd[f"{key}.weight"] = self._draw((cout, cin, 1))
        if "bias" in node:
            self.sd[f"{key}.bias"] = self._draw(node["bias"].shape)

    def norm(self, key, node, stats=None):
        n = node["scale"].shape
        self.sd[f"{key}.weight"] = 1.0 + self._draw(n, 0.1)
        self.sd[f"{key}.bias"] = self._draw(n, 0.1)
        if stats is not None:
            self.sd[f"{key}.running_mean"] = self._draw(n, 0.3)
            self.sd[f"{key}.running_var"] = self.rng.uniform(0.5, 2.0, n).astype(np.float32)

    def shared_mlp(self, prefix, node, stats):
        j = 0
        while f"layer{j}" in node:
            self.conv1x1(f"{prefix}.layer{j}.conv", node[f"layer{j}"])
            self.norm(f"{prefix}.layer{j}.bn.bn", node[f"bn{j}"], stats[f"bn{j}"])
            j += 1

    def detector(self, p, s):
        """Under the ScanQA module names (``qa_module.py:195``)."""
        for name in ("sa1", "sa2", "sa3", "sa4"):
            self.shared_mlp(f"detection_backbone.{name}.mlp_module",
                            p["backbone_net"][name]["mlp_module"],
                            s["backbone_net"][name]["mlp_module"])
        for name in ("fp1", "fp2"):
            self.shared_mlp(f"detection_backbone.{name}.mlp", p["backbone_net"][name]["mlp"],
                            s["backbone_net"][name]["mlp"])
        for i in (1, 2, 3):
            self.conv1x1(f"voting_net.conv{i}", p["vgen"][f"conv{i}"])
        for i in (1, 2):
            self.norm(f"voting_net.bn{i}", p["vgen"][f"bn{i}"], s["vgen"][f"bn{i}"])
        prop, prop_s = p["proposal"], s["proposal"]
        self.shared_mlp("proposal_net.vote_aggregation.mlp_module",
                        prop["vote_aggregation"]["mlp_module"],
                        prop_s["vote_aggregation"]["mlp_module"])
        head, head_s = prop["proposal_mlp"], prop_s["proposal_mlp"]
        self.conv1x1("proposal_net.proposal.0", head["layer0"])
        self.norm("proposal_net.proposal.1", head["bn0"], head_s["bn0"])
        self.conv1x1("proposal_net.proposal.3", head["layer1"])
        self.norm("proposal_net.proposal.4", head["bn1"], head_s["bn1"])
        self.conv1x1("proposal_net.proposal.6", prop["proposal_out"])

    def attention(self, prefix, node):
        for name in ("query", "key", "value"):
            self.linear(f"{prefix}.self.{name}", node["self"][name])
        self.linear(f"{prefix}.output.dense", node["output"]["dense"])
        self.norm(f"{prefix}.output.LayerNorm", node["output"]["LayerNorm"])

    def bert_layer(self, prefix, node):
        self.attention(f"{prefix}.attention", node["attention"])
        if "crossattention" in node:
            self.attention(f"{prefix}.crossattention", node["crossattention"])
        self.linear(f"{prefix}.intermediate.dense", node["intermediate_dense"])
        self.linear(f"{prefix}.output.dense", node["output_dense"])
        self.norm(f"{prefix}.output.LayerNorm", node["output_LayerNorm"])

    def embeddings(self, prefix, node):
        for name in ("word_embeddings", "position_embeddings"):
            self.sd[f"{prefix}.{name}.weight"] = self._draw(node[name]["embedding"].shape, 0.5)
        width = node["word_embeddings"]["embedding"].shape[1]
        self.sd[f"{prefix}.token_type_embeddings.weight"] = self._draw((2, width), 0.5)
        self.norm(f"{prefix}.LayerNorm", node["LayerNorm"])

    def encoder(self, prefix, node):
        i = 0
        while f"layer_{i}" in node:
            self.bert_layer(f"{prefix}.layer.{i}", node[f"layer_{i}"])
            if f"layer_twin_{i}" in node:
                self.bert_layer(f"{prefix}.layer_twin.{i}", node[f"layer_twin_{i}"])
            i += 1

    def lm_head(self, prefix, node):
        self.embeddings(f"{prefix}.bert.embeddings", node["bert"]["embeddings"])
        self.encoder(f"{prefix}.bert.encoder", node["bert"]["encoder"])
        self.linear(f"{prefix}.cls.predictions.transform.dense", node["cls"]["transform_dense"])
        self.norm(f"{prefix}.cls.predictions.transform.LayerNorm",
                  node["cls"]["transform_LayerNorm"])
        self.sd[f"{prefix}.cls.predictions.bias"] = self._draw(node["cls"]["bias"].shape)

    def blip(self, p):
        vit = p["visual_encoder"]
        width = vit["cls_token"].shape[-1]
        self.sd["blip_model.visual_encoder.cls_token"] = self._draw((1, 1, width), 0.5)
        self.sd["blip_model.visual_encoder.pos_embed"] = self._draw((1, 1 + CKPT_PATCHES, width),
                                                                    0.5)
        kernel = vit["patch_embed_proj"]["kernel"]  # (kh, kw, 3, D)
        self.sd["blip_model.visual_encoder.patch_embed.proj.weight"] = self._draw(
            kernel.transpose(3, 2, 0, 1).shape)
        self.sd["blip_model.visual_encoder.patch_embed.proj.bias"] = self._draw((width,))
        self.norm("blip_model.visual_encoder.norm", vit["norm"])
        i = 0
        while f"blocks_{i}" in vit:
            blk, key = vit[f"blocks_{i}"], f"blip_model.visual_encoder.blocks.{i}"
            self.norm(f"{key}.norm1", blk["norm1"])
            self.norm(f"{key}.norm2", blk["norm2"])
            self.linear(f"{key}.attn.qkv", blk["attn"]["qkv"])
            self.linear(f"{key}.attn.proj", blk["attn"]["proj"])
            self.linear(f"{key}.mlp.fc1", blk["mlp"]["fc1"])
            self.linear(f"{key}.mlp.fc2", blk["mlp"]["fc2"])
            i += 1
        self.embeddings("blip_model.text_encoder.embeddings", p["text_encoder"]["embeddings"])
        self.encoder("blip_model.text_encoder.encoder", p["text_encoder"]["encoder"])
        self.lm_head("blip_model.text_decoder", p["text_decoder"])
        self.lm_head("blip_model.text_decoder_scene", p["text_decoder_scene"])
        # the fusion heads, index-keyed as the reference's nn.Sequential
        head = p["linear_scene_object"]
        self.linear("blip_model.linear_scene_object.0", head["fc1"])
        self.linear("blip_model.linear_scene_object.3", head["fc2"])
        self.norm("blip_model.linear_scene_object.5", head["norm"])
        self.linear("blip_model.lowrank_2d", p["lowrank_2d"])
        self.linear("blip_model.lowrank_3d", p["lowrank_3d"])
        self.sd["blip_model.bilinear_fusion.weight"] = self._draw(
            p["bilinear_fusion_kernel"].shape)
        self.sd["blip_model.bilinear_fusion.bias"] = self._draw(p["bilinear_fusion_bias"].shape)

    def heads(self, p):
        self.linear("object_feat_linear.0", p["object_feat_linear"])
        self.linear("linear_blip_to_object", p["linear_blip_to_object"])
        for head in ("lang_cls", "object_cls"):
            self.linear(f"{head}.0", p[head]["fc1"])
            self.linear(f"{head}.3", p[head]["fc2"])
        i = 0
        while f"dec_qo_{i}" in p:
            sga, key = p[f"dec_qo_{i}"], f"dec_list_qo.{i}"
            for att in ("mhatt1", "mhatt2"):
                for name in ("linear_q", "linear_k", "linear_v", "linear_merge"):
                    self.linear(f"{key}.{att}.{name}", sga[att][name])
            self.linear(f"{key}.ffn.mlp.fc.linear", sga["ffn"]["mlp"]["fc"])
            self.linear(f"{key}.ffn.mlp.linear", sga["ffn"]["mlp"]["linear"])
            for norm in ("norm1", "norm2", "norm3"):
                width = sga[norm]["a_2"].shape
                self.sd[f"{key}.{norm}.a_2"] = 1.0 + self._draw(width, 0.1)
                self.sd[f"{key}.{norm}.b_2"] = self._draw(width, 0.1)
            i += 1


def reference_state_dict(variables, seed: int) -> dict:
    ref = _RefStateDict(np.random.RandomState(seed))
    p, s = variables["params"], variables["batch_stats"]
    ref.detector(p["detector"], s["detector"])
    ref.blip(p["blip_model"])
    ref.heads(p)
    return ref.sd


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.fixture(scope="module")
def converted_pair():
    tcfg = _port_cfg(bridgeqa.BridgeQAConfig, JCFG,
                     blip=_port_cfg(blip_vqa3d.BlipVQA3DConfig, TINY_BLIP,
                                    med=_port_cfg(med.MedConfig, TINY_MED)))
    model = bridgeqa.BridgeQA(tcfg, ScannetDatasetConfig().mean_size_arr, device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    base = export_jax_variables(model)
    sd = reference_state_dict(base, seed=3)
    # a torch checkpoint as DDP saved it: tensors under "module."
    loaded, skipped = load_reference_checkpoint(
        model, {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()})
    return model, base, sd, loaded, skipped


def test_reference_checkpoint_loads_through_the_copies(converted_pair):
    """Every array of the checkpoint finds its place; the tree the copy
    makes equals the original converter's, leaf for leaf."""
    model, base, sd, loaded, skipped = converted_pair
    assert not skipped, skipped[:5]
    want = jbridgeqa_checkpoint.convert_scanqa(sd, image_size=32, vocab_size=120)
    got = bridgeqa_checkpoint.convert_scanqa(sd, image_size=32, vocab_size=120)
    for collection in ("params", "batch_stats"):
        want_leaves = dict(_leaves(want[collection]))
        got_leaves = dict(_leaves(got[collection]))
        assert list(got_leaves) == list(want_leaves), collection
        for path, arr in want_leaves.items():
            np.testing.assert_array_equal(got_leaves[path], arr, err_msg="/".join(path))
    assert len(loaded) == sum(1 for c in ("params", "batch_stats") for _ in _leaves(want[c]))
    # every parameter and statistic of the model came from the checkpoint
    assert len(loaded) == sum(1 for c in ("params", "batch_stats") for _ in _leaves(base[c]))
    ours = export_jax_variables(model)["params"]["detector"]["vgen"]["conv1"]["kernel"]
    np.testing.assert_array_equal(ours, sd["voting_net.conv1.weight"][..., 0].T)


def test_port_forward_equals_jax_after_its_own_conversion(converted_pair):
    """The rank forward of the loaded port model against JAX's
    ``apply`` on JAX's ``convert_scanqa`` + ``merge_pretrained`` of the same
    state dict (over the same starting tree)."""
    model, base, sd, _, _ = converted_pair
    converted = jbridgeqa_checkpoint.convert_scanqa(sd, image_size=32, vocab_size=120)
    params, _, skipped = jblip_checkpoint.merge_pretrained(base["params"], converted["params"])
    stats, _, skipped_s = jblip_checkpoint.merge_pretrained(base["batch_stats"],
                                                            converted["batch_stats"])
    assert not skipped and not skipped_s
    batch = _qa_batch(np.random.RandomState(7))
    jmodel = jbridgeqa.BridgeQA(JCFG, mean_size_arr=ScannetDatasetConfig().mean_size_arr)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgrouping, "FORCE_MODE", "stripes")  # the port's ball query
        jout = jax.jit(functools.partial(jmodel.apply, train=False, inference="rank", k_test=8))(
            {"params": params, "batch_stats": stats}, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        out = model({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()},
                    inference="rank", k_test=8)
    for key in ("lang_scores", "cluster_ref", "center"):
        want = np.asarray(jout[key])
        assert np.isfinite(want).all(), key
        np.testing.assert_allclose(out[key].numpy(), want, atol=ATOL, rtol=0, err_msg=key)
    for key in ("answer_scores_2d", "answer_scores_scene"):
        want = np.asarray(jout[key])
        scored = want != -1e4
        assert scored.sum(axis=1).tolist() == [8, 8], key
        np.testing.assert_array_equal(out[key].numpy() != -1e4, scored, err_msg=key)
        np.testing.assert_allclose(out[key].numpy()[scored], want[scored], atol=ATOL, rtol=0,
                                   err_msg=key)
    np.testing.assert_allclose(out["answer_scores"].numpy(), np.asarray(jout["answer_scores"]),
                               rtol=1e-3, atol=0)
