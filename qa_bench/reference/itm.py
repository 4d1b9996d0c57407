"""BLIP-ITM's contrastive head in plain PyTorch, float32: the reference the
view-selection cell holds the port to. Frozen from
``bridgeqa_tpu_torch/models/blip_itm.py`` (``encode_images``,
``encode_texts``) and the ranking of ``tools/view_select.py``; module names
are the port's."""

import torch
from torch import nn

from qa_bench.reference.med import BertModel
from qa_bench.reference.nn import Dense
from qa_bench.reference.vit import vit

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"


def normalised(feat: torch.Tensor) -> torch.Tensor:
    return feat / torch.linalg.vector_norm(feat, dim=-1, keepdim=True)


class BlipITM(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        med = c["med"]
        self.visual_encoder = vit(c)
        width = self.visual_encoder.dim
        self.text_encoder = BertModel(med, width)
        self.vision_proj = Dense(width, c["embed_dim"])
        self.text_proj = Dense(med["hidden_size"], c["embed_dim"])
        self.itm_head = Dense(med["hidden_size"], 2)

    def encode_images(self, images: torch.Tensor, block: int = 32) -> torch.Tensor:
        """(N, H, W, 3) -> normalised (N, embed_dim), ``block`` images at a time."""
        return torch.cat([normalised(self.vision_proj(self.visual_encoder(part)[:, 0]))
                          for part in images.split(block)])

    def encode_texts(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return normalised(self.text_proj(self.text_encoder(ids, mask)[:, 0]))


def tokenize(sentences, words, length: int):
    """Whole-word ids, ``[CLS]`` first and ``[SEP]`` last, padded with
    ``[PAD]`` (0) to ``length``: the vocabulary is the five specials followed
    by ``words`` in order, and every word of a sentence is in it."""
    vocab = {w: i for i, w in enumerate([PAD, UNK, CLS, SEP, MASK] + list(words))}
    ids = torch.zeros((len(sentences), length), dtype=torch.int32)
    for r, s in enumerate(sentences):
        row = [vocab[CLS]] + [vocab[w] for w in s.split()][: length - 2] + [vocab[SEP]]
        ids[r, : len(row)] = torch.tensor(row, dtype=torch.int32)
    return ids, (ids != 0).to(torch.int32)
