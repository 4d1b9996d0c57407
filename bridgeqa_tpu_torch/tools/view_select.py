"""Question-conditional view selection, the i2tfile producer (counterpart
of ``bridgeqa_tpu/tools/view_select.py``).

For every scene, encode all of its frames with the BLIP-ITM image tower,
encode each question's declarative rewrite with the text tower, rank the
frames by cosine similarity, and keep ``{"view": qid -> [frame names
best-first], "itm_scores": qid -> scores}``: the mapping the data pipeline
reads (``data/views.py::load_scene_view_map``).

Frames are encoded once per scene, in batches of one fixed size (the last
padded with copies of the last frame, as the JAX tool pads for its jitted
program), and reused across that scene's questions. The ranking runs on the
host with numpy's ``argsort(-sims, axis=1)``, as in JAX
(``tools/view_select.py:87``), so ties resolve alike. The JAX
``make_encoders`` (two jitted closures) has no counterpart: the model's
methods are called directly.

Spans (``utils/profiling.py``): ``scene`` (one scene), ``images`` and
``texts`` (each tower's batches), and under them ``prepare`` (the host's
copies and padding), ``upload``, ``encode`` and ``readback``; ``tokenize``;
``rank`` (the similarities, the sort and the two dicts). Counters:
``views/frames`` (a scene's frames) and ``views/frames_encoded`` (the rows
the image tower ran, padding included, counted as they are encoded).
"""

import json
import os

import numpy as np
import torch

from bridgeqa_tpu_torch.utils.profiling import count, span


def _pad_batch(arr, batch: int):
    """Pad the leading dim up to a multiple of ``batch`` with copies of the
    last row."""
    n = arr.shape[0]
    pad = (-n) % batch
    if pad:
        arr = np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)], axis=0)
    return arr, n


def encode_in_batches(encode_fn, arrays, batch: int, device, *, counter=None):
    """Apply ``encode_fn`` over padded fixed-size batches of the numpy
    ``arrays``, each batch moved to ``device``, without grad; returns the
    (N, D) numpy result. ``counter``, if given, counts the rows encoded."""
    with span("prepare"):
        padded, n = _pad_batch(arrays[0], batch)
        rest = [_pad_batch(a, batch)[0] for a in arrays[1:]]
    outs = []
    with torch.no_grad():
        for i in range(0, padded.shape[0], batch):
            with span("prepare"):
                chunk = [np.ascontiguousarray(c)
                         for c in [padded[i:i + batch]] + [r[i:i + batch] for r in rest]]
            with span("upload"):
                inputs = [torch.from_numpy(c).to(device) for c in chunk]
            with span("encode"):
                out = encode_fn(*inputs)
            if counter is not None:
                count(counter, inputs[0].shape[0])
            with span("readback"):
                outs.append(out.cpu().numpy())
    return np.concatenate(outs)[:n]


def select_best_views(model, records, tokenizer, load_scene_frames, *, decl_map=None,
                      image_batch: int = 64, text_batch: int = 64, text_len: int = 40):
    """records: ScanQA question records. ``model``: a ``BLIPITM`` in eval
    mode; the frames and texts go to its device. load_scene_frames(scene_id)
    -> (frame names, images (N, H, W, 3) float32). decl_map: optional
    question_id -> declarative sentence (the LLM rewrite); the raw question
    otherwise, as the reference's no-decl path.

    Returns the i2t dict {"view": ..., "itm_scores": ...}."""
    device = next(model.parameters()).device
    by_scene = {}
    for rec in records:
        by_scene.setdefault(rec["scene_id"], []).append(rec)

    view_map, score_map = {}, {}
    for scene_id, recs in by_scene.items():
        with span("scene"):
            names, images = load_scene_frames(scene_id)
            with span("images"):
                with span("prepare"):
                    images = images.astype(np.float32)
                img_feat = encode_in_batches(model.encode_images, [images], image_batch, device,
                                             counter="views/frames_encoded")
            count("views/frames", images.shape[0])

            texts = []
            for rec in recs:
                qid = str(rec["question_id"])
                texts.append((decl_map or {}).get(qid, rec["question"]))
            with span("tokenize"):
                ids, mask = tokenizer.encode_batch(texts, text_len)
            with span("texts"):
                txt_feat = encode_in_batches(model.encode_texts, [ids, mask], text_batch, device)

            with span("rank"):
                sims = txt_feat @ img_feat.T  # (num_questions, num_frames)
                order = np.argsort(-sims, axis=1)
                for r, rec in enumerate(recs):
                    qid = str(rec["question_id"])
                    view_map[qid] = [names[j] for j in order[r]]
                    score_map[qid] = sims[r, order[r]].tolist()
    return {"view": view_map, "itm_scores": score_map}


def save_i2tfile(i2t, path):
    """Persist as .json (the loader's native format) or pickle."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if str(path).endswith(".json"):
        with open(path, "w") as f:
            json.dump(i2t, f)
    else:
        import pickle

        with open(path, "wb") as f:
            pickle.dump(i2t, f)
