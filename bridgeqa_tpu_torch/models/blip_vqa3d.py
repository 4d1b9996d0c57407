"""BLIP_VQA3D, the 2D/3D twin-transformer VQA model (counterpart of the rank
and generate paths of ``bridgeqa_tpu/models/blip_vqa3d.py``): ViT image
encoder, twin med-BERT question encoder (the 2D stream attends to the image,
the 3D stream to the projected scene proposals), two causal LM decoders that
rank a fixed answer list, beam-search generation of open-ended answers, the
low-rank bilinear 2D/3D fusion, the training forward (both decoders'
label-smoothed LM losses), classifier mode (``use_text_decoder=False``:
answer classifiers on the CLS states, ``classify``) and the twin encoder's
attention dumps (``rank(..., output_attentions=True)``)."""

import dataclasses
import warnings

import torch
from torch import nn

from bridgeqa_tpu_torch.models.generation import (
    beam_search_cached,
    generate_answers,
    interleave_streams,
    top_k_stable,
)
from bridgeqa_tpu_torch.models.layers import Dense, LayerNorm, dropout, gelu
from bridgeqa_tpu_torch.models.med import IGNORE_INDEX, BertLMHeadModel, BertModelTwin, MedConfig
from bridgeqa_tpu_torch.models.vit import create_vit
from bridgeqa_tpu_torch.parallel.global_batch import global_ratio
from bridgeqa_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class BlipVQA3DConfig:
    """The JAX ``BlipVQA3DConfig``'s fields and defaults. The rank path
    reads the widths, ``scene_feature_position``, ``share_decoder``, the
    layer counts, the token ids, ``scene_ensemble_weight`` and
    ``rank_loss_chunk_size``; generate reads the widths, the layer counts,
    the token ids (bos, ``sep_token_id`` as eos, pad), ``num_beams``,
    ``use_kv_cache``, ``generate_max_length`` and ``generate_min_length``;
    training also ``vit_drop_path_rate``, ``adapter_pdrop``, ``remat`` and
    ``remat_mode``; classifier mode (``use_text_decoder=False``)
    ``answer_pdrop`` and ``use_scene_classifier_2d3d``.
    ``use_scene_classifier`` is kept so a JAX config carries over unchanged
    (the JAX package reads it nowhere either)."""

    med: MedConfig = dataclasses.field(default_factory=MedConfig)
    image_size: int = 480
    vit: str = "base"
    vit_drop_path_rate: float = 0.1
    vit_custom_embed_dim: int = 256
    vit_custom_depth: int = 2
    vit_custom_heads: int = 4
    scene_size: int = 128
    num_answers: int = 4500
    answer_pdrop: float = 0.1
    adapter_pdrop: float = 0.1
    use_text_decoder: bool = True
    use_scene_classifier: bool = False
    use_scene_classifier_2d3d: bool = False
    share_decoder: bool = False
    scene_feature_position: str = "paralleltwin"
    decoder_layers: int | None = None
    encoder_layers: int | None = None
    pad_token_id: int = 0
    bos_token_id: int = 30522
    sep_token_id: int = 102
    scene_ensemble_weight: float = 1.05
    rank_loss_chunk_size: int | None = 512
    num_beams: int = 5
    use_kv_cache: bool = True
    generate_max_length: int = 20
    generate_min_length: int = 1
    remat: bool = False
    remat_mode: str = "block"


class MlpAdapter(nn.Module):
    """Dense, GELU, dropout, Dense, GELU, LayerNorm (eps 1e-5, torch's
    default as in the reference's ``linear_scene_object``)."""

    def __init__(self, in_features: int, hidden_size: int, drop: float = 0.1):
        super().__init__()
        self.drop = drop
        self.fc1 = Dense(in_features, hidden_size)
        self.fc2 = Dense(hidden_size, hidden_size)
        self.norm = LayerNorm(hidden_size, 1e-5)

    def forward(self, x):
        x = dropout(gelu(self.fc1(x)), self.drop, self.training)
        return self.norm(gelu(self.fc2(x)))


class ClassifierHead(nn.Module):
    """The ``answer_cls`` head: Dense, GELU, dropout, LayerNorm (eps 1e-5),
    Dense to the answer vocabulary."""

    def __init__(self, hidden_size: int, num_answers: int, drop: float = 0.1):
        super().__init__()
        self.drop = drop
        self.fc1 = Dense(hidden_size, hidden_size)
        self.norm = LayerNorm(hidden_size, 1e-5)
        self.fc2 = Dense(hidden_size, num_answers)

    def forward(self, x):
        return self.fc2(self.norm(dropout(gelu(self.fc1(x)), self.drop, self.training)))


class BLIPVQA3D(nn.Module):
    def __init__(self, cfg: BlipVQA3DConfig):
        super().__init__()
        self.cfg = c = cfg
        med = c.med
        if c.encoder_layers is not None:
            med = dataclasses.replace(med, num_hidden_layers=c.encoder_layers)
        if c.remat:
            med = dataclasses.replace(med, remat=True, remat_mode=c.remat_mode)
        self.visual_encoder, vision_width = create_vit(
            c.vit, c.image_size, c.vit_custom_embed_dim, c.vit_custom_depth, c.vit_custom_heads,
            c.vit_drop_path_rate, c.remat, c.remat_mode)
        if vision_width != med.hidden_size:
            raise ValueError("twin exchange concatenates image embeds with BERT hidden states; "
                             f"vision width ({vision_width}) must equal med hidden size "
                             f"({med.hidden_size})")
        self.text_encoder = BertModelTwin(dataclasses.replace(med, encoder_width=vision_width))
        if c.scene_feature_position not in ("paralleltwin", "parallelshare"):
            raise ValueError(f"unsupported scene_feature_position: {c.scene_feature_position!r}")
        dec_med = med if c.decoder_layers is None else dataclasses.replace(
            med, num_hidden_layers=c.decoder_layers)
        dec_cfg = dataclasses.replace(dec_med, encoder_width=med.hidden_size)
        if c.scene_feature_position == "parallelshare":
            dec_cfg = dataclasses.replace(dec_cfg, parallel_layernorms=1)
        self.text_decoder = BertLMHeadModel(dec_cfg)
        if not c.share_decoder and c.scene_feature_position != "parallelshare":
            self.text_decoder_scene = BertLMHeadModel(dec_cfg)

        h = med.hidden_size
        lowrank = h // 8
        self.lowrank = lowrank
        self.lowrank_2d = Dense(h, lowrank)
        self.lowrank_3d = Dense(h, lowrank)
        # torch nn.Bilinear(lowrank, lowrank, h): out_o = x W_o y + b_o
        self.bilinear_fusion_kernel = nn.Parameter(torch.empty(h, lowrank, lowrank))
        self.bilinear_fusion_bias = nn.Parameter(torch.zeros(h))
        self.linear_scene_object = MlpAdapter(c.scene_size, h, c.adapter_pdrop)
        if not c.use_text_decoder:
            self.answer_cls = ClassifierHead(h, c.num_answers, c.answer_pdrop)
            if c.use_scene_classifier_2d3d:
                self.answer_cls_2d3d = ClassifierHead(h, c.num_answers, c.answer_pdrop)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        # flax uniform(scale): U[0, scale)
        self.bilinear_fusion_kernel.uniform_(0.0, 1.0 / self.lowrank**0.5, generator=generator)
        self.bilinear_fusion_bias.zero_()

    def _decoder_scene(self) -> BertLMHeadModel:
        c = self.cfg
        if c.share_decoder or c.scene_feature_position == "parallelshare":
            return self.text_decoder
        return self.text_decoder_scene

    def _scene_layernorm_idx(self) -> int:
        return 1 if self.cfg.scene_feature_position == "parallelshare" else 0

    def encode_image(self, image):
        """image (B, H, W, 3) -> (B, 1 + N, width)."""
        with span("vit"):
            return self.visual_encoder(image)

    def encode_question(self, image_embeds, question_ids, question_mask, scene_object_embeds,
                        scene_object_mask, output_attentions: bool = False):
        """Twin encoding of the question against the image and the scene;
        returns (hidden_2d, hidden_3d), each (B, Lq, H), and with
        ``output_attentions`` the last layer's probabilities
        (``BertEncoderTwin``) as a third element."""
        with span("twin"):
            image_atts = torch.ones(image_embeds.shape[:2], dtype=torch.int32,
                                    device=image_embeds.device)
            scene_embeds = self.linear_scene_object(scene_object_embeds)
            return self.text_encoder(question_ids, question_mask, image_embeds, image_atts,
                                     scene_embeds, scene_object_mask,
                                     output_attentions=output_attentions)

    def fuse_2d3d(self, h2d, h3d):
        """Low-rank bilinear fusion plus the stream mean."""
        x = self.lowrank_2d(h2d)
        y = self.lowrank_3d(h3d)
        bilinear = torch.einsum("...i,oij,...j->...o", x, self.bilinear_fusion_kernel.to(x.dtype), y)
        return bilinear + self.bilinear_fusion_bias.to(x.dtype) + (h2d + h3d) / 2.0

    def forward(self, image, question_ids, question_mask, answer_ids, answer_mask,
                scene_object_embeds, scene_object_mask):
        """The training forward (JAX's ``__call__``): the twin encoding, then
        both decoders' label-smoothed LM losses over the answers (padding
        ignored), summed and divided by the batch. In eval mode the same
        losses without dropout (the JAX package's ``inference="loss"``).
        Returns (loss, fused_hidden, question_mask)."""
        image_embeds = self.encode_image(image)
        h2d, h3d = self.encode_question(image_embeds, question_ids, question_mask,
                                        scene_object_embeds, scene_object_mask)
        targets = torch.where(answer_ids == self.cfg.pad_token_id, IGNORE_INDEX, answer_ids)
        _, loss_2d = self.text_decoder(answer_ids, answer_mask, h2d, question_mask, labels=targets)
        _, loss_3d = self._decoder_scene()(answer_ids, answer_mask, h3d, question_mask,
                                           labels=targets,
                                           layernorm_idx=self._scene_layernorm_idx())
        # the mean over the global batch's questions (JAX's global array)
        loss = global_ratio(loss_2d.sum() + loss_3d.sum(), image_embeds.shape[0])
        return loss, self.fuse_2d3d(h2d, h3d), question_mask

    def classify(self, image, question_ids, question_mask, scene_object_embeds,
                 scene_object_mask):
        """Classifier mode (JAX ``classify``): ``answer_cls`` scores the
        answer vocabulary from the 2D and the 3D CLS state, and with
        ``use_scene_classifier_2d3d`` ``answer_cls_2d3d`` from the fused one;
        answer_scores is the mean of the heads. In train and eval mode alike.
        Returns (scores dict, fused_hidden, question_mask)."""
        h2d, h3d = self.encode_question(self.encode_image(image), question_ids, question_mask,
                                        scene_object_embeds, scene_object_mask)
        score_2d = self.answer_cls(h2d[:, 0])
        score_3d = self.answer_cls(h3d[:, 0])
        fused = self.fuse_2d3d(h2d, h3d)
        scores = {"answer_scores_2d": score_2d, "answer_scores_scene": score_3d}
        if self.cfg.use_scene_classifier_2d3d:
            scores["answer_scores_2d3d"] = self.answer_cls_2d3d(fused[:, 0])
            scores["answer_scores"] = (score_2d + score_3d + scores["answer_scores_2d3d"]) / 3.0
        else:
            scores["answer_scores"] = (score_2d + score_3d) / 2.0
        return scores, fused, question_mask

    def _rank_with_decoder(self, decoder, question_states, question_mask, answer_ids, answer_mask,
                           k: int, layernorm_idx: int = 0):
        """First-token probabilities pick the top k answers of the list,
        then each is scored in full. ``answer_ids`` (A, La) is the answer
        table, bos first. Returns (topk_ids (B, k), log-prob sums (B, k))."""
        num_ques = question_states.shape[0]
        with span("scoring/first_token"):
            bos = torch.full((num_ques, 1), self.cfg.bos_token_id, dtype=answer_ids.dtype,
                             device=answer_ids.device)
            start_logits, _ = decoder(bos, None, question_states, question_mask,
                                      layernorm_idx=layernorm_idx)
            prob_first = torch.softmax(start_logits[:, 0].float(), dim=1)[:, answer_ids[:, 1]]
        with span("scoring/topk"):
            topk_ids = top_k_stable(prob_first, k)
            la = answer_ids.shape[1]
            input_ids = answer_ids[topk_ids].reshape(num_ques * k, la)
            input_atts = answer_mask[topk_ids].reshape(num_ques * k, la)
            targets = torch.where(input_ids == self.cfg.pad_token_id, IGNORE_INDEX, input_ids)
        with span("scoring/answers"):
            # the question states stay at batch B: grouped cross-attention
            # shares each question's K/V across its k answers
            _, loss = decoder(input_ids, input_atts, question_states, question_mask,
                              labels=targets, loss_chunk_size=self.cfg.rank_loss_chunk_size,
                              layernorm_idx=layernorm_idx)
            return topk_ids, (-loss).reshape(num_ques, k)

    def rank(self, image, question_ids, question_mask, answer_ids, answer_mask,
             scene_object_embeds, scene_object_mask, k_test: int = 128,
             output_attentions: bool = False):
        """Rank-answer inference with the 2D/3D decoder ensemble. Returns
        (fused_hidden, scores dict, question_mask); scores cover the whole
        answer list, -1e4 where an answer was not scored. With
        ``output_attentions`` the scores dict also holds the twin encoder's
        last self and cross probabilities under the reference's dump keys
        (``2d_self_attention``, ``3d_self_attention``, ``2d_cross_attention``,
        ``3d_cross_attention``)."""
        image_embeds = self.encode_image(image)
        encoded = self.encode_question(image_embeds, question_ids, question_mask,
                                       scene_object_embeds, scene_object_mask,
                                       output_attentions=output_attentions)
        h2d, h3d = encoded[:2]
        batch, num_answers = h2d.shape[0], answer_ids.shape[0]
        k = min(k_test, num_answers)

        def scatter_scores(topk_ids, scores):
            # an explicit scored mask, not a `score == 0` sentinel
            full = torch.full((batch, num_answers), -1e4, dtype=torch.float32, device=scores.device)
            return full.scatter(1, topk_ids, scores.float())

        with span("scoring"):
            ids_2d, scores_2d = self._rank_with_decoder(self.text_decoder, h2d, question_mask,
                                                        answer_ids, answer_mask, k)
            all_2d = scatter_scores(ids_2d, scores_2d)
        with span("scoring"):
            ids_3d, scores_3d = self._rank_with_decoder(self._decoder_scene(), h3d,
                                                        question_mask, answer_ids, answer_mask,
                                                        k, self._scene_layernorm_idx())
            all_3d = scatter_scores(ids_3d, scores_3d)
        with span("heads"):
            # likelihood-space ensemble: exp(s_2d) + exp(1.05 * s_3d)
            ensemble = torch.exp(all_2d) + torch.exp(self.cfg.scene_ensemble_weight * all_3d)
            fused = self.fuse_2d3d(h2d, h3d)
        scores = {"answer_scores": ensemble, "answer_scores_scene": all_3d,
                  "answer_scores_2d": all_2d}
        if output_attentions:
            last = encoded[2]
            scores.update({"2d_self_attention": last["self_2d"],
                           "3d_self_attention": last["self_3d"],
                           "2d_cross_attention": last["cross_2d"],
                           "3d_cross_attention": last["cross_3d"]})
        return fused, scores, question_mask

    def generate(self, image, question_ids, question_mask, scene_object_embeds,
                 scene_object_mask, *, num_beams: int | None = None,
                 max_length: int | None = None, min_length: int | None = None):
        """Open-ended answer generation: beam search with ``2 * num_beams``
        beams per question, half attending to the 2D question states and half
        to the 3D ones, decoded by the 2D ``text_decoder`` (as the reference
        does), eos = [SEP]. KV-cached unless ``use_kv_cache`` is off.

        Returns (best_ids (B, max_length), fused_hidden, question_mask)."""
        c = self.cfg
        num_beams = num_beams if num_beams is not None else c.num_beams
        max_length = max_length if max_length is not None else c.generate_max_length
        min_length = min_length if min_length is not None else c.generate_min_length
        tokens = dict(bos_token_id=c.bos_token_id, eos_token_id=c.sep_token_id,
                      pad_token_id=c.pad_token_id, max_length=max_length, min_length=min_length)

        h2d, h3d = self.encode_question(self.encode_image(image), question_ids, question_mask,
                                        scene_object_embeds, scene_object_mask)
        question_states = interleave_streams(h2d, h3d, num_beams)
        batch = h2d.shape[0]
        if c.use_kv_cache:
            k = 2 * num_beams
            cache = self.text_decoder.init_cache(
                question_states, question_mask.repeat_interleave(k, dim=0), max_length)
            ids, _ = beam_search_cached(self.text_decoder.decode_step, cache, batch, k, **tokens)
            best_ids = ids[:, 0]
        else:
            warnings.warn(
                "use_kv_cache=False: the prefix-rerun beam search re-interprets "
                "a beam's prefix under its destination row's question stream when "
                "beams hop between the 2D/3D halves; sequences can differ from "
                "the (default, reference-matching) cached path. Prefer "
                "use_kv_cache=True.",
                stacklevel=2,
            )
            best_ids, _ = generate_answers(self.decode_step, question_states, question_mask,
                                           batch, num_beams, **tokens)
        return best_ids, self.fuse_2d3d(h2d, h3d), question_mask

    def decode_step(self, input_ids, input_mask, question_states, question_mask):
        """One full-prefix pass of the 2D decoder: input_ids (B, L) -> logits
        (B, L, V)."""
        logits, _ = self.text_decoder(input_ids, input_mask, question_states, question_mask)
        return logits
