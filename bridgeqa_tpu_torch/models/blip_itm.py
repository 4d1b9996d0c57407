"""BLIP-ITM, the image-text matching model of view selection (counterpart of
``bridgeqa_tpu/models/blip_itm.py``).

A ViT image tower and a med-BERT text tower with two heads:

- ``itc`` (contrastive): the 256-wide L2-normalised projections of the image
  CLS and the text CLS, scored by their cosine. View selection ranks frames
  with it.
- ``itm`` (matching): the text tower cross-attends to every image token, and
  a 2-way head on its CLS state scores match against no match.

The JAX model is built with ``dtype=None``, so it computes in f32, and so
does this one: ``set_compute_dtype`` is not called on it. In eval mode and
without grad the image tower takes the fused ViT path (``ops/vit_block.py``,
hand-written kernels on the card) where ``vit_block.FUSED_MODE`` allows, as
the JAX model does on the TPU; the text tower is the module path, as in JAX.
The normalisation divides by the plain L2 norm, with no eps, as JAX does.
"""

import dataclasses

import torch
from torch import nn

from bridgeqa_tpu_torch.models.layers import Dense
from bridgeqa_tpu_torch.models.med import BertModel, MedConfig
from bridgeqa_tpu_torch.models.vit import create_vit


@dataclasses.dataclass(frozen=True)
class BlipITMConfig:
    med: MedConfig = dataclasses.field(default_factory=MedConfig)
    image_size: int = 384
    vit: str = "base"
    embed_dim: int = 256
    vit_custom_embed_dim: int = 64  # vit='custom' (tests)
    vit_custom_depth: int = 2
    vit_custom_heads: int = 4


def _normalised(feat: torch.Tensor) -> torch.Tensor:
    return feat / torch.linalg.vector_norm(feat, dim=-1, keepdim=True)


class BLIPITM(nn.Module):
    def __init__(self, cfg: BlipITMConfig, device: torch.device | str = "cuda"):
        """Built on ``device`` (the card unless the caller asks for the CPU),
        in eval mode: the model is inference-only, as the JAX one is."""
        super().__init__()
        self.cfg = c = cfg
        with torch.device(device):
            self.visual_encoder, vision_width = create_vit(
                c.vit, c.image_size, custom_embed_dim=c.vit_custom_embed_dim,
                custom_depth=c.vit_custom_depth, custom_heads=c.vit_custom_heads)
            med = c.med
            self.text_encoder = BertModel(dataclasses.replace(med, encoder_width=vision_width))
            self.vision_proj = Dense(vision_width, c.embed_dim)
            self.text_proj = Dense(med.hidden_size, c.embed_dim)
            self.itm_head = Dense(med.hidden_size, 2)
        self.eval()

    def encode_images(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> L2-normalised (B, embed_dim) itc features."""
        embeds = self.visual_encoder(images)
        return _normalised(self.vision_proj(embeds[:, 0, :]))

    def encode_texts(self, text_ids: torch.Tensor, text_mask: torch.Tensor) -> torch.Tensor:
        """Text-only encode (``mode='text'``) -> normalised (B, embed_dim)."""
        out = self.text_encoder(text_ids, text_mask, multimodal=False)
        return _normalised(self.text_proj(out[:, 0, :]))

    def itc_scores(self, images, text_ids, text_mask) -> torch.Tensor:
        """Cosine similarity matrix (num_texts, num_images)."""
        return self.encode_texts(text_ids, text_mask) @ self.encode_images(images).T

    def itm_scores(self, images, text_ids, text_mask) -> torch.Tensor:
        """Cross-attention matching logits (B, 2) of paired inputs; every
        image token is attended (mask all ones)."""
        image_embeds = self.visual_encoder(images)
        image_atts = torch.ones(image_embeds.shape[:2], dtype=torch.int32,
                                device=image_embeds.device)
        out = self.text_encoder(text_ids, text_mask, encoder_hidden_states=image_embeds,
                                encoder_attention_mask=image_atts)
        return self.itm_head(out[:, 0, :])

    def forward(self, images, text_ids, text_mask, match_head: str = "itc"):
        if match_head == "itc":
            return self.itc_scores(images, text_ids, text_mask)
        return self.itm_scores(images, text_ids, text_mask)
