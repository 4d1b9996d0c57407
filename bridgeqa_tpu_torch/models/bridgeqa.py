"""BridgeQA: detector + twin-BLIP VQA + grounding heads (counterpart of the
rank inference path of ``bridgeqa_tpu/models/bridgeqa.py``).

``BridgeQA.forward(batch, inference="rank", k_test=...)`` runs what the JAX
``BridgeQA.apply(batch, train=False, inference="rank")`` runs: the VoteNet
detector, proposal features into BLIP's twin encoder, both LM decoders
ranking the answer list, the language head on the fused CLS state and the
SGA grounding head producing ``cluster_ref``. Training, generate, the MCAN
path and classifier mode are later parts of the port."""

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bridgeqa_tpu_torch.data.scannet_config import MEAN_SIZE_ARR
from bridgeqa_tpu_torch.models.blip_vqa3d import BLIPVQA3D, BlipVQA3DConfig
from bridgeqa_tpu_torch.models.detector import VoteNetDetector
from bridgeqa_tpu_torch.models.layers import Dense, add_indexed, gelu
from bridgeqa_tpu_torch.models.mcan import SGA


@dataclasses.dataclass(frozen=True)
class BridgeQAConfig:
    """The JAX ``BridgeQAConfig``'s fields and defaults. The MCAN, language
    encoder and training fields are kept so a JAX config carries over
    unchanged; the rank path does not read them."""

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
    """Dense, GELU, Dense (the lang_cls / object_cls heads)."""

    def __init__(self, in_features: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = Dense(in_features, hidden)
        self.fc2 = Dense(hidden, out)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class BridgeQA(nn.Module):
    def __init__(self, cfg: BridgeQAConfig, mean_size_arr: np.ndarray = MEAN_SIZE_ARR,
                 device: torch.device | str = "cuda"):
        """``mean_size_arr`` (num_size_cluster, 3): the size-cluster means,
        ScanNet's by default. The model is built on ``device``: the card
        unless the caller asks for the CPU (``device="cpu"``)."""
        super().__init__()
        with torch.device(device):
            self._build(cfg, mean_size_arr)

    def _build(self, cfg: BridgeQAConfig, mean_size_arr: np.ndarray) -> None:
        c = self.cfg = cfg
        if c.stage != "VQA" or not c.use_blip or not c.use_text_decoder:
            raise NotImplementedError("the port runs the BLIP rank path (stage='VQA', use_blip, "
                                      "use_text_decoder) only so far")
        self.detector = VoteNetDetector(
            c.num_object_class, c.num_heading_bin, c.num_size_cluster, mean_size_arr,
            c.input_feature_dim, c.num_proposal, c.vote_factor, c.seed_feat_dim, c.proposal_size,
            c.pointnet_width, c.pointnet_depth, c.backbone_sa_npoints, c.backbone_sa_nsamples)
        self.object_feat_linear = Dense(c.proposal_size, c.hidden_size)
        blip_cfg = dataclasses.replace(c.blip, scene_size=c.hidden_size, num_answers=c.num_answers,
                                       use_text_decoder=c.use_text_decoder)
        self.blip_model = BLIPVQA3D(blip_cfg)
        h = blip_cfg.med.hidden_size
        self.lang_cls = MlpHead(h, c.hidden_size, c.num_object_class)
        self.object_cls = MlpHead(c.hidden_size, c.hidden_size, 1)
        self.linear_blip_to_object = Dense(h, c.hidden_size)
        self.dec_list_qo = add_indexed(self, "dec_qo_", (SGA(c.hidden_size, c.mcan_num_heads)
                                                         for _ in range(c.mcan_num_layers)))

    def forward(self, batch, inference: str = "rank", k_test: int = 256):
        """batch: dict of tensors (point_clouds, images, question_ids,
        question_mask, answer_list_ids, answer_list_mask). Returns the
        detector outputs plus answer_scores(_2d, _scene), lang_scores and
        cluster_ref."""
        if inference != "rank":
            raise NotImplementedError(f"inference={inference!r}: the port runs 'rank' only so far")
        c = self.cfg
        out = self.detector(batch["point_clouds"])
        object_feat = gelu(self.object_feat_linear(out["aggregated_vote_features"]))
        bbox_mask = out["bbox_mask"].bool()  # True where the proposal is an object
        # MCAN convention (True = masked): mask the non-objects
        object_mask = (~bbox_mask)[:, None, None, :] if c.use_object_mask else None

        images = batch["images"]
        image = images[:, 0] if images.dim() == 5 else images
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
