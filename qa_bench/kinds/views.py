"""Traffic kind "views": question-conditional view selection, the i2tfile
producer, one scene at a time through ``tools/view_select.py::
select_best_views``.

Set-up builds ``BLIPITM`` from the configuration file with the weights drawn
from the seed, and makes one cycle of scenes: scene ``s`` has
``scene_frames[s]`` frames (``image_size`` images, smooth colour fields plus
noise, drawn on the device and held in host memory as the tool's frame
loader hands them over) and ``sentences`` declarative sentences of words
from ``words.txt`` (a fixed set of lengths in [``sentence_words``], which
the seed reorders). The frame counts are the same for every seed; the seed
sets only the content. The tokenizer is the port's ``WordPieceTokenizer``
over the five specials and ``words.txt``, the arithmetic of
``data/sources.py::synthetic_tokenizer``. Batch ``i`` is scene ``i %
len(scene_frames)``: ``select_best_views`` with ``image_batch``,
``text_batch`` and ``text_len``, whose ranking ends on the host.
"""

import dataclasses
from pathlib import Path

import numpy as np
import torch

from qa_bench import compare, flops, weights
from qa_bench.harness import ROOT, load_json, log
from qa_bench.kinds.rank import fixed_lengths, images
from qa_bench.reference.nn import computing, held

FRAME_STREAM, TEXT_STREAM = 3, 4


def port_config(cfg: dict):
    from bridgeqa_tpu_torch.models.blip_itm import BlipITMConfig
    from bridgeqa_tpu_torch.models.med import MedConfig

    def pick(cls, d):
        names = {f.name for f in dataclasses.fields(cls)}
        return {k: v for k, v in d.items() if k in names}

    return BlipITMConfig(**{**pick(BlipITMConfig, cfg), "med": MedConfig(**pick(MedConfig,
                                                                               cfg["med"]))})


def reference_model(cfg: dict, device, seed: int):
    from qa_bench.reference.itm import BlipITM as Reference

    with torch.device("meta"):
        ref = Reference(cfg)
    ref = ref.to_empty(device=device)
    ref.load_state_dict(weights.make_state(weights.schema_of(ref), seed, device))
    return ref.eval()


def schema(cfg: dict) -> dict:
    from qa_bench.reference.itm import BlipITM as Reference

    with torch.device("meta"):
        return weights.schema_of(Reference(cfg))


def read_words(path: Path) -> list:
    return sorted({w for line in path.read_text().split("\n") for w in line.split()})


class Recording:
    """The model as the tool sees it, keeping copies of the features of a
    sampled scene's encodes."""

    def __init__(self, model):
        self.model, self.images, self.texts = model, None, None

    def parameters(self):
        return self.model.parameters()

    def encode_images(self, x):
        out = self.model.encode_images(x)
        if self.images is not None:
            self.images.append(out.clone())
        return out

    def encode_texts(self, ids, mask):
        out = self.model.encode_texts(ids, mask)
        if self.texts is not None:
            self.texts.append(out.clone())
        return out


class Session:
    rate_metric, rate_unit, unit_name = "frames_per_s", "frames/s", "frames"
    tail_metric = "scene_ms_p90"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from bridgeqa_tpu_torch.data.tokenization import WordPieceTokenizer, build_test_vocab
        from bridgeqa_tpu_torch.models.blip_itm import BLIPITM

        self.cfg, self.t, self.seed, self.device = cfg, traffic, seed, device
        model = BLIPITM(port_config(cfg), device=device)
        model.load_state_dict(weights.make_state(schema(cfg), seed, device))
        self.model = Recording(model.eval())
        self.words = read_words(ROOT / "workloads" / traffic["words"])
        self.tokenizer = WordPieceTokenizer(build_test_vocab(self.words))
        gen = torch.Generator(device=device).manual_seed(weights.stream_seed(seed, FRAME_STREAM))
        sizes = traffic["scene_frames"]
        self.frames = []
        for n in sizes:
            self.frames.append(images(n, cfg["image_size"], gen, device).cpu().numpy())
        count = len(sizes) * traffic["sentences"]
        lengths = fixed_lengths(count, *traffic["sentence_words"], seed, 13).tolist()
        rng = np.random.default_rng(weights.stream_seed(seed, TEXT_STREAM))
        picks = rng.integers(0, len(self.words), size=sum(lengths))
        text, at = [], 0
        for n in lengths:
            text.append(" ".join(self.words[j] for j in picks[at:at + n]))
            at += n
        per = traffic["sentences"]
        self.records = [[{"scene_id": f"scene{s:04d}_00", "question_id": f"{s}-{q}",
                          "question": text[s * per + q]} for q in range(per)]
                        for s in range(len(sizes))]
        self.kept = {}
        peaks = load_json(ROOT / "peaks.json")
        self.peak_flops = peaks["flops_per_s"]["float32"]
        self.hbm_bytes_per_s = peaks["hbm_bytes_per_s"]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)

    def _scene(self, i: int) -> int:
        return i % len(self.frames)

    def warm(self) -> None:
        """One scene of each count of image batches the cycle uses."""
        b = self.t["image_batch"]
        seen = set()
        for s, n in enumerate(self.t["scene_frames"]):
            if -(-n // b) not in seen:
                seen.add(-(-n // b))
                self.batch(s, None)

    def batch(self, i: int, slot) -> int:
        from bridgeqa_tpu_torch.tools.view_select import select_best_views

        s = self._scene(i)
        frames = self.frames[s]
        names = [f"{j:05d}.jpg" for j in range(frames.shape[0])]
        if slot is not None:
            self.model.images, self.model.texts = [], []
        i2t = select_best_views(self.model, self.records[s], self.tokenizer,
                                lambda _scene: (names, frames),
                                image_batch=self.t["image_batch"],
                                text_batch=self.t["text_batch"], text_len=self.t["text_len"])
        if slot is not None:
            img = torch.cat(self.model.images)[: frames.shape[0]]
            txt = torch.cat(self.model.texts)[: len(self.records[s])]
            self.model.images = self.model.texts = None
            self.kept[slot] = (i, img, txt, i2t)
        return frames.shape[0]

    def stages(self) -> dict:
        m = self.model.model
        return {"vit": [m.visual_encoder], "text": [m.text_encoder]}

    def flops(self, i: int) -> int:
        """The useful work of a scene: its frames through the image tower
        and its sentences through the text tower (padding frames excluded)."""
        s = self._scene(i)
        return (flops.itm_image_flops(self.cfg, self.frames[s].shape[0])
                + flops.itm_text_flops(self.cfg, len(self.records[s]), self.t["text_len"]))

    def products(self, group: str, i: int) -> list:
        """The fused ViT's products of every image batch of scene ``i``,
        padding included (the kernels run them)."""
        if group != "gemm":
            return []
        b = self.t["image_batch"]
        dim, mlp_dim, depth, _ = flops.vit_dims(self.cfg)
        tokens = (self.cfg["image_size"] // 16) ** 2 + 1
        encodes = -(-self.frames[self._scene(i)].shape[0] // b)
        return flops.vit_gemm_calls(b, tokens, dim, mlp_dim, depth, 4) * encodes

    def release(self) -> None:
        del self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def numbers(self, control: bool = False, exact: tuple = ()) -> list:
        """The comparison numbers of each kept scene against the reference
        (float32, TF32 off). With ``control``, the reference computed one
        precision below (``control``: "tf32") takes the program's place; the
        reference's submodules named in ``exact`` then stay in float32."""
        from qa_bench.reference.itm import tokenize

        ref = reference_model(self.cfg, self.device, self.seed)
        kept = [ref.get_submodule(name) for name in exact]
        found = []
        for slot in sorted(self.kept):
            i, img, txt, i2t = self.kept[slot]
            s = self._scene(i)
            recs = self.records[s]
            frames = torch.from_numpy(self.frames[s]).to(self.device)
            ids, mask = tokenize([r["question"] for r in recs], self.words, self.t["text_len"])
            ids, mask = ids.to(self.device), mask.to(self.device)
            qids = [r["question_id"] for r in recs]
            sims = np.asarray([i2t["itm_scores"][q] for q in qids])
            order = np.asarray([[int(name[:5]) for name in i2t["view"][q]] for q in qids])
            # the tool keeps each row's scores in its ranked order; put them
            # back in frame order
            frame_sims = np.empty_like(sims)
            np.put_along_axis(frame_sims, order, sims, axis=1)
            with torch.no_grad():
                if control:
                    with computing(torch.float32, self.t["control"]), held(kept, torch.float32):
                        img, txt = ref.encode_images(frames), ref.encode_texts(ids, mask)
                    frame_sims = (txt @ img.T).cpu().numpy()
                    order = np.argsort(-frame_sims, axis=1)
                with computing(torch.float32):
                    img_ref, txt_ref = ref.encode_images(frames), ref.encode_texts(ids, mask)
            found.append(compare.view_numbers(img, img_ref, txt, txt_ref, frame_sims, order))
            log(f"scene {i} ({self.frames[s].shape[0]} frames)"
                f"{' control' if control else ''}: {found[-1]}")
        return found

    def check(self) -> list:
        found = self.numbers()
        worst = {k: max(n[k] for n in found) for k in found[0]}
        return compare.within(worst, self.t["limits"])
