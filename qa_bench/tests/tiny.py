"""Tiny configurations and traffic of each kind, for the CPU tests."""

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def load(path: str) -> dict:
    return json.loads((ROOT / path).read_text())


def rank_config() -> dict:
    c = copy.deepcopy(load("configs/bridgeqa-scanqa.json"))
    c.update(num_answers=30, num_proposal=32, hidden_size=32, mcan_num_layers=1,
             backbone_sa_npoints=[256, 128, 64, 32], backbone_sa_nsamples=[16, 16, 8, 8])
    c["blip"].update(image_size=64, vit="custom", vit_custom_embed_dim=128, vit_custom_depth=2,
                     vit_custom_heads=2, num_answers=30)
    c["blip"]["med"].update(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                            intermediate_size=256, max_position_embeddings=128,
                            encoder_width=128)
    return c


def rank_traffic() -> dict:
    t = copy.deepcopy(load("workloads/rank-f32-b8.json"))
    t.update(batch=2, k_test=8, points=2048, question_len=16, question_words=[2, 10],
             answer_len=6, answer_words=[1, 3], pool_batches=2, warmup=1)
    return t


def views_config() -> dict:
    c = copy.deepcopy(load("configs/blip-itm-base.json"))
    c.update(image_size=64, vit="custom", vit_custom_embed_dim=128, vit_custom_depth=2,
             vit_custom_heads=2)
    c["med"].update(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                    intermediate_size=256, max_position_embeddings=128, encoder_width=128)
    return c


def views_traffic() -> dict:
    t = copy.deepcopy(load("workloads/views-f32-b64.json"))
    t.update(scene_frames=[5, 11, 7], sentences=6, sentence_words=[3, 12], image_batch=4,
             text_batch=4, text_len=12)
    return t
