"""BridgeQA: detector + twin-BLIP VQA + grounding heads (counterpart of
``bridgeqa_tpu/models/bridgeqa.py``, the BLIP decoder paths).

``BridgeQA.forward(batch, inference="rank", k_test=...)`` runs what the JAX
``BridgeQA.apply(batch, train=False, inference="rank")`` runs: the VoteNet
detector, proposal features into BLIP's twin encoder, both LM decoders
ranking the answer list, the language head on the fused CLS state and the
SGA grounding head producing ``cluster_ref``. ``inference="generate"``
decodes open-ended answers by beam search instead of ranking the list.
``inference="loss"``, and any call in train mode (``model.train()``, JAX's
``train=True``), runs the training forward instead: the decoders' LM loss
(``decoder_loss``) in place of the answer scores. ``stage="DET"`` builds and
runs the detector alone. The MCAN path and classifier mode are later parts
of the port."""

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bridgeqa_tpu_torch.data.scannet_config import MEAN_SIZE_ARR
from bridgeqa_tpu_torch.models.blip_vqa3d import BLIPVQA3D, BlipVQA3DConfig
from bridgeqa_tpu_torch.models.detector import VoteNetDetector
from bridgeqa_tpu_torch.models.layers import (
    Dense,
    add_indexed,
    dropout,
    dropout_rng,
    gelu,
)
from bridgeqa_tpu_torch.models.mcan import SGA


@dataclasses.dataclass(frozen=True)
class BridgeQAConfig:
    """The JAX ``BridgeQAConfig``'s fields and defaults. The MCAN and
    language encoder fields are kept so a JAX config carries over unchanged;
    the BLIP paths do not read them."""

    num_answers: int = 4500
    num_object_class: int = 18
    input_feature_dim: int = 0
    num_heading_bin: int = 1
    num_size_cluster: int = 18
    num_proposal: int = 256
    vote_factor: int = 1
    seed_feat_dim: int = 256
    proposal_size: int = 128
    pointnet_width: int = 1
    pointnet_depth: int = 2
    backbone_sa_npoints: tuple = (2048, 1024, 512, 256)
    backbone_sa_nsamples: tuple = (64, 32, 16, 16)
    answer_pdrop: float = 0.3
    mcan_num_layers: int = 2
    mcan_num_heads: int = 8
    mcan_pdrop: float = 0.1
    mcan_flat_mlp_size: int = 512
    mcan_flat_glimpses: int = 1
    mcan_flat_out_size: int = 1024
    lang_use_bidir: bool = False
    lang_emb_size: int = 300
    lang_pdrop: float = 0.1
    lang_bert: bool = False
    lang_bert_freeze: bool = False
    lang_bert_finetune_last: bool = False
    hidden_size: int = 128
    head_pdrop: float = 0.1
    use_object_mask: bool = True
    use_lang_cls: bool = True
    use_reference: bool = True
    use_answer: bool = True
    use_blip: bool = True
    use_text_decoder: bool = True
    stage: str = "VQA"
    att_pdrop: float = 0.0
    att_drop_topk: int = 100
    blip: BlipVQA3DConfig = dataclasses.field(default_factory=BlipVQA3DConfig)


class MlpHead(nn.Module):
    """Dense, GELU, dropout, Dense (the lang_cls / object_cls heads)."""

    def __init__(self, in_features: int, hidden: int, out: int, pdrop: float = 0.1):
        super().__init__()
        self.pdrop = pdrop
        self.fc1 = Dense(in_features, hidden)
        self.fc2 = Dense(hidden, out)

    def forward(self, x):
        return self.fc2(dropout(gelu(self.fc1(x)), self.pdrop, self.training))


class BridgeQA(nn.Module):
    def __init__(self, cfg: BridgeQAConfig, mean_size_arr: np.ndarray = MEAN_SIZE_ARR,
                 device: torch.device | str = "cuda"):
        """``mean_size_arr`` (num_size_cluster, 3): the size-cluster means,
        ScanNet's by default. The model is built on ``device``: the card
        unless the caller asks for the CPU (``device="cpu"``), in eval mode
        (JAX's ``train=False``) until ``.train()``."""
        super().__init__()
        with torch.device(device):
            self._build(cfg, mean_size_arr)
        self.eval()

    def _build(self, cfg: BridgeQAConfig, mean_size_arr: np.ndarray) -> None:
        c = self.cfg = cfg
        if c.stage not in ("DET", "VQA"):
            raise ValueError(f"stage must be 'DET' or 'VQA', got {c.stage!r}")
        if c.stage == "VQA" and not (c.use_blip and c.use_text_decoder):
            raise NotImplementedError("the port runs the BLIP decoder paths (use_blip, "
                                      "use_text_decoder) only so far: the MCAN path and the "
                                      "classifier mode are later parts of the port")
        self.detector = VoteNetDetector(
            c.num_object_class, c.num_heading_bin, c.num_size_cluster, mean_size_arr,
            c.input_feature_dim, c.num_proposal, c.vote_factor, c.seed_feat_dim, c.proposal_size,
            c.pointnet_width, c.pointnet_depth, c.backbone_sa_npoints, c.backbone_sa_nsamples)
        if c.stage == "DET":
            return
        self.object_feat_linear = Dense(c.proposal_size, c.hidden_size)
        blip_cfg = dataclasses.replace(c.blip, scene_size=c.hidden_size, num_answers=c.num_answers,
                                       use_text_decoder=c.use_text_decoder)
        self.blip_model = BLIPVQA3D(blip_cfg)
        h = blip_cfg.med.hidden_size
        self.lang_cls = MlpHead(h, c.hidden_size, c.num_object_class, c.head_pdrop)
        self.object_cls = MlpHead(c.hidden_size, c.hidden_size, 1, c.head_pdrop)
        self.linear_blip_to_object = Dense(h, c.hidden_size)
        self.dec_list_qo = add_indexed(self, "dec_qo_", (SGA(c.hidden_size, c.mcan_num_heads,
                                                             c.mcan_pdrop)
                                                         for _ in range(c.mcan_num_layers)))

    def forward(self, batch, inference: str = "rank", k_test: int = 256,
                num_beams: int | None = None, max_length: int | None = None,
                bn_momentum: float = 0.1, generator: torch.Generator | None = None):
        """batch: dict of tensors (point_clouds, images, question_ids,
        question_mask; answer_list_ids and answer_list_mask for "rank";
        answer_ids and answer_mask for "loss"). Returns the detector outputs
        (alone with ``stage="DET"``), lang_scores and cluster_ref, and
        - with ``inference="rank"`` answer_scores(_2d, _scene) over the
          answer list (the top ``k_test`` of each decoder scored);
        - with ``inference="generate"`` generated_ids (B, max_length): the
          best beam of ``2 * num_beams`` per question (``num_beams``,
          ``max_length``: the BLIP config's ``num_beams`` and
          ``generate_max_length`` when None);
        - with ``inference="loss"`` or in train mode, decoder_loss (the two
          decoders' LM losses summed over the batch and divided by it), and
          answer_scores = the batch's answer_cat_scores where it has them.
        In train mode BatchNorm moves its running statistics by
        ``bn_momentum``, and dropout draws from ``generator`` (on the
        model's device; None: the one ``layers.dropout_rng`` made current),
        which train mode needs unless every rate is 0."""
        if inference not in ("rank", "generate", "loss"):
            raise ValueError(f"inference must be 'rank', 'generate' or 'loss', got {inference!r}")
        if generator is None:
            return self._forward(batch, inference, k_test, num_beams, max_length, bn_momentum)
        with dropout_rng(generator):
            return self._forward(batch, inference, k_test, num_beams, max_length, bn_momentum)

    def _forward(self, batch, inference, k_test, num_beams, max_length, bn_momentum):
        c = self.cfg
        out = self.detector(batch["point_clouds"], bn_momentum)
        if c.stage == "DET":
            return out
        object_feat = gelu(self.object_feat_linear(out["aggregated_vote_features"]))
        bbox_mask = out["bbox_mask"].bool()  # True where the proposal is an object
        # MCAN convention (True = masked): mask the non-objects
        object_mask = (~bbox_mask)[:, None, None, :] if c.use_object_mask else None

        images = batch["images"]
        image = images[:, 0] if images.dim() == 5 else images
        if self.training or inference == "loss":
            out["decoder_loss"], fused_feat, fused_mask = self.blip_model(
                image, batch["question_ids"], batch["question_mask"], batch["answer_ids"],
                batch["answer_mask"], object_feat, bbox_mask.to(torch.int32))
            if "answer_cat_scores" in batch:
                out["answer_scores"] = batch["answer_cat_scores"]  # for the accuracy metrics
        elif inference == "generate":
            out["generated_ids"], fused_feat, fused_mask = self.blip_model.generate(
                image, batch["question_ids"], batch["question_mask"], object_feat,
                bbox_mask.to(torch.int32), num_beams=num_beams, max_length=max_length)
        else:
            fused_feat, scores, fused_mask = self.blip_model.rank(
                image, batch["question_ids"], batch["question_mask"], batch["answer_list_ids"],
                batch["answer_list_mask"], object_feat, bbox_mask.to(torch.int32), k_test=k_test)
            for key, val in scores.items():
                if val.shape[1] < c.num_answers:
                    val = F.pad(val, (0, c.num_answers - val.shape[1]), value=-1e4)
                out[key] = val

        if c.use_lang_cls:
            out["lang_scores"] = self.lang_cls(fused_feat[:, 0])
        if c.use_reference:
            fused_for_crossatt = self.linear_blip_to_object(fused_feat)
            fused_mask_b = fused_mask.bool()[:, None, None, :]
            # the reference's mask polarity: x_mask = ~object_mask (True AT
            # objects), y_mask = ~fused_mask (True at question padding)
            x_mask = None if object_mask is None else ~object_mask
            for dec in self.dec_list_qo:
                object_feat = dec(object_feat, fused_for_crossatt, x_mask, ~fused_mask_b)
            object_conf_feat = object_feat * bbox_mask.to(object_feat.dtype)[..., None]
            out["cluster_ref"] = self.object_cls(object_conf_feat)[..., 0]
        return out
