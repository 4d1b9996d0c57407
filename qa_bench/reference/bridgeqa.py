"""BridgeQA's rank inference in plain PyTorch, eval mode: the reference the
rank cells hold the port to, in the precision ``nn.computing`` sets.

Frozen from the rank path of ``bridgeqa_tpu_torch/models/bridgeqa.py``,
``blip_vqa3d.py`` (``encode_question``, ``_rank_with_decoder``, ``rank``,
``fuse_2d3d``, ``MlpAdapter``), ``mcan.py`` (``SGA``, ``MHAtt``,
``McanLayerNorm``) and ``generation.py::top_k_stable``: the VoteNet
detector, the ViT, the twin encoder, both decoders ranking the answer list
(first-token probabilities pick the top ``k_test``, each is scored in full),
the likelihood ensemble, the language head and the SGA grounding head with
the original mask polarity. Module names are the port's, so the benchmark's
weights load into both.
"""

import math

import torch
from torch import nn

from qa_bench.reference.detector import Detector
from qa_bench.reference.med import BertModelTwin, LMHeadModel
from qa_bench.reference.nn import Dense, LayerNorm, add_indexed, gelu, operand, softmax
from qa_bench.reference.vit import vit


class Mlp(nn.Module):
    """fc1, GELU, fc2 (``MlpHead``)."""

    def __init__(self, i: int, h: int, o: int):
        super().__init__()
        self.fc1, self.fc2 = Dense(i, h), Dense(h, o)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class McanLayerNorm(nn.Module):
    def __init__(self, size: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.a_2 = nn.Parameter(torch.empty(size))
        self.b_2 = nn.Parameter(torch.empty(size))

    def forward(self, x):
        mean = x.mean(dim=-1, keepdim=True)
        std = (((x - mean) ** 2).sum(dim=-1, keepdim=True) / (x.shape[-1] - 1)).sqrt()
        return self.a_2 * (x - mean) / (std + self.eps) + self.b_2


class MHAtt(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.hidden, self.heads = hidden, heads
        self.linear_v, self.linear_k = Dense(hidden, hidden), Dense(hidden, hidden)
        self.linear_q, self.linear_merge = Dense(hidden, hidden), Dense(hidden, hidden)

    def forward(self, v, k, q, mask):
        """mask True where a key is masked."""
        b = q.shape[0]
        hd = self.hidden // self.heads

        def split(x, dense):
            return dense(x).reshape(b, -1, self.heads, hd).transpose(1, 2)

        vh, kh, qh = split(v, self.linear_v), split(k, self.linear_k), split(q, self.linear_q)
        scores = torch.einsum("bhqd,bhkd->bhqk", operand(qh), operand(kh)) / math.sqrt(hd)
        att = softmax(scores.masked_fill(mask, -1e9))
        out = torch.einsum("bhqk,bhkd->bhqd", operand(att), operand(vh))
        return self.linear_merge(out.transpose(1, 2).reshape(b, -1, self.hidden))


class SGA(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.mhatt1, self.norm1 = MHAtt(hidden, heads), McanLayerNorm(hidden)
        self.mhatt2, self.norm2 = MHAtt(hidden, heads), McanLayerNorm(hidden)
        self.ffn = nn.Module()
        self.ffn.mlp = nn.Module()
        self.ffn.mlp.fc, self.ffn.mlp.linear = Dense(hidden, 4 * hidden), Dense(4 * hidden, hidden)
        self.norm3 = McanLayerNorm(hidden)

    def forward(self, x, y, x_mask, y_mask):
        x = self.norm1(x + self.mhatt1(x, x, x, x_mask))
        x = self.norm2(x + self.mhatt2(y, y, x, y_mask))
        return self.norm3(x + self.ffn.mlp.linear(gelu(self.ffn.mlp.fc(x))))


class Blip(nn.Module):
    """BLIP_VQA3D's rank path ("paralleltwin": one decoder per stream)."""

    def __init__(self, c: dict, med: dict, scene_size: int):
        super().__init__()
        h = med["hidden_size"]
        self.cfg = c
        self.visual_encoder = vit(c)
        self.text_encoder = BertModelTwin(med, h)
        self.text_decoder = LMHeadModel(med, h)
        self.text_decoder_scene = LMHeadModel(med, h)
        self.lowrank_2d, self.lowrank_3d = Dense(h, h // 8), Dense(h, h // 8)
        self.bilinear_fusion_kernel = nn.Parameter(torch.empty(h, h // 8, h // 8))
        self.bilinear_fusion_bias = nn.Parameter(torch.empty(h))
        self.linear_scene_object = nn.Module()
        adapter = self.linear_scene_object
        adapter.fc1, adapter.fc2 = Dense(scene_size, h), Dense(h, h)
        adapter.norm = LayerNorm(h, 1e-5)

    def rank_decoder(self, decoder, states, q_mask, answer_ids, answer_mask, k: int):
        """(top-k answer ids (B, k), their log-probability sums (B, k))."""
        c = self.cfg
        b = states.shape[0]
        bos = torch.full((b, 1), c["bos_token_id"], dtype=answer_ids.dtype,
                         device=answer_ids.device)
        start = decoder.logits(decoder.states(bos, torch.ones_like(bos), states, q_mask))[:, 0]
        prob_first = torch.softmax(start.float(), dim=1)[:, answer_ids[:, 1]]
        topk = torch.sort(prob_first, dim=-1, descending=True, stable=True).indices[:, :k]
        la = answer_ids.shape[1]
        loss = decoder.sequence_loss(answer_ids[topk].reshape(b * k, la),
                                     answer_mask[topk].reshape(b * k, la), states, q_mask,
                                     c["pad_token_id"], c["rank_loss_chunk_size"])
        return topk, (-loss).reshape(b, k)

    def rank(self, image, q_ids, q_mask, answer_ids, answer_mask, object_feat, object_mask,
             k_test: int):
        image_embeds = self.visual_encoder(image)
        a = self.linear_scene_object
        scene = a.norm(gelu(a.fc2(gelu(a.fc1(object_feat)))))
        image_atts = torch.ones(image_embeds.shape[:2], dtype=q_mask.dtype, device=q_mask.device)
        h2d, h3d = self.text_encoder(q_ids, q_mask, image_embeds, image_atts, scene, object_mask)
        b, num_answers = h2d.shape[0], answer_ids.shape[0]
        k = min(k_test, num_answers)
        scores = {}
        for key, decoder, states in (("answer_scores_2d", self.text_decoder, h2d),
                                     ("answer_scores_scene", self.text_decoder_scene, h3d)):
            ids, sums = self.rank_decoder(decoder, states, q_mask, answer_ids, answer_mask, k)
            full = torch.full((b, num_answers), -1e4, dtype=torch.float32, device=sums.device)
            scores[key] = full.scatter(1, ids, sums.float())
        w = self.cfg["scene_ensemble_weight"]
        scores["answer_scores"] = (torch.exp(scores["answer_scores_2d"])
                                   + torch.exp(w * scores["answer_scores_scene"]))
        x, y = self.lowrank_2d(h2d), self.lowrank_3d(h3d)
        fused = (torch.einsum("...i,oij,...j->...o", operand(x),
                              operand(self.bilinear_fusion_kernel), operand(y))
                 + self.bilinear_fusion_bias.to(x.dtype) + (h2d + h3d) / 2.0)
        return fused, scores


class BridgeQA(nn.Module):
    """``c``: the configuration file's fields (``blip`` and ``med`` nested)."""

    def __init__(self, c: dict):
        super().__init__()
        med, blip = c["blip"]["med"], c["blip"]
        h = c["hidden_size"]
        self.detector = Detector(c)
        self.object_feat_linear = Dense(c["proposal_size"], h)
        self.blip_model = Blip(blip, med, h)
        self.lang_cls = Mlp(med["hidden_size"], h, c["num_object_class"])
        self.object_cls = Mlp(h, h, 1)
        self.linear_blip_to_object = Dense(med["hidden_size"], h)
        self.dec_list_qo = add_indexed(self, "dec_qo_", (SGA(h, c["mcan_num_heads"])
                                                         for _ in range(c["mcan_num_layers"])))

    def forward(self, batch, k_test: int):
        out = self.detector(batch["point_clouds"])
        object_feat = gelu(self.object_feat_linear(out["aggregated_vote_features"]))
        is_object = out["bbox_mask"].bool()
        fused, scores = self.blip_model.rank(
            batch["images"], batch["question_ids"], batch["question_mask"],
            batch["answer_list_ids"], batch["answer_list_mask"], object_feat,
            is_object.to(batch["question_mask"].dtype), k_test)
        out.update(scores)
        out["lang_scores"] = self.lang_cls(fused[:, 0])
        fused_obj = self.linear_blip_to_object(fused)
        # the original mask polarity: True at the objects for the proposals,
        # True at the question padding for the question
        x_mask = is_object[:, None, None, :]
        y_mask = ~batch["question_mask"].bool()[:, None, None, :]
        for dec in self.dec_list_qo:
            object_feat = dec(object_feat, fused_obj, x_mask, y_mask)
        conf = object_feat * is_object.to(object_feat.dtype)[..., None]
        out["cluster_ref"] = self.object_cls(conf)[..., 0]
        return out
