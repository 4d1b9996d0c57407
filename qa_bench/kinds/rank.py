"""Traffic kind "rank": ScanQA questions answered by ranking the answer list,
a closed loop with one batch in flight, as ``scripts/eval.py`` runs it.

Set-up builds ``BridgeQA`` from the configuration file, loads the weights
drawn from the seed (``qa_bench/weights.py``), and makes a pool of
``pool_batches`` distinct batches on the device: for each row a fresh scene
(``points`` points in a 6 x 6 x 2.5 m room with the height channel), a view
(an ``image_size`` image, smooth colour fields plus noise) and a question
(``[ENC]``, words, ``[SEP]``, padded to ``question_len``), and one answer
list of ``num_answers`` answers (``[DEC]``, words, ``[SEP]``, padded to
``answer_len``). The question and answer lengths are one fixed set of sizes
that the seed only reorders. Batch ``i`` is the pool's batch ``i %
pool_batches``: ``BridgeQA.forward(batch, inference="rank", k_test=...)``
without grad, then the top-1 answer and the grounded box of each question
are read back to the host, which ends the batch.
"""

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from qa_bench import compare, flops, weights
from qa_bench.harness import ROOT, load_json, log
from qa_bench.reference.nn import computing, held

POOL_STREAM = 2
ENC_TOKEN, DEC_TOKEN, SEP_TOKEN = 30523, 30522, 102
FIRST_WORD, LAST_WORD = 1996, 30000  # the word-piece range of BERT's vocabulary
# the outputs the check reads, copied for sampled batches (a program that
# replays a CUDA graph writes its outputs into the same buffers each batch)
KEPT = ("aggregated_vote_features", "objectness_scores", "center", "sem_cls_scores",
        "bbox_corner", "answer_scores_2d", "answer_scores_scene", "cluster_ref",
        "lang_scores")


def port_config(cfg: dict):
    """The port's ``BridgeQAConfig`` from the configuration file's fields."""
    from bridgeqa_tpu_torch.models.blip_vqa3d import BlipVQA3DConfig
    from bridgeqa_tpu_torch.models.bridgeqa import BridgeQAConfig
    from bridgeqa_tpu_torch.models.med import MedConfig

    def pick(cls, d):
        names = {f.name for f in dataclasses.fields(cls)}
        return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items() if k in names}

    med = MedConfig(**pick(MedConfig, cfg["blip"]["med"]))
    blip = BlipVQA3DConfig(**{**pick(BlipVQA3DConfig, cfg["blip"]), "med": med})
    return BridgeQAConfig(**{**pick(BridgeQAConfig, cfg), "blip": blip})


def reference_model(cfg: dict, device, seed: int):
    """The plain reference on ``device`` with the seed's weights."""
    from qa_bench.reference.bridgeqa import BridgeQA as Reference

    with torch.device("meta"):
        ref = Reference(cfg)
    ref = ref.to_empty(device=device)
    ref.load_state_dict(weights.make_state(weights.schema_of(ref), seed, device))
    ref.detector.proposal.mean_size.copy_(torch.tensor(cfg["mean_size_arr"]))
    return ref.eval()


def schema(cfg: dict) -> dict:
    from qa_bench.reference.bridgeqa import BridgeQA as Reference

    with torch.device("meta"):
        return weights.schema_of(Reference(cfg))


def fixed_lengths(n: int, low: int, high: int, seed: int, tag: int) -> torch.Tensor:
    """``n`` lengths in [low, high], one set for every seed, in the seed's order."""
    lengths = np.random.RandomState(tag).randint(low, high + 1, size=n)
    order = np.random.default_rng(weights.stream_seed(seed, tag)).permutation(n)
    return torch.from_numpy(lengths[order])


def token_rows(lengths: torch.Tensor, width: int, first: int, gen, device):
    """Rows of ``first``, ``length`` random words, ``[SEP]``, then padding:
    (ids, mask) (n, width) int32."""
    n = lengths.shape[0]
    ids = torch.randint(FIRST_WORD, LAST_WORD, (n, width), generator=gen, device=device,
                        dtype=torch.int32)
    pos = torch.arange(width, device=device)[None]
    lengths = lengths.to(device)[:, None]
    ids[:, 0] = first
    ids = torch.where(pos == lengths + 1, SEP_TOKEN, ids)
    mask = (pos <= lengths + 1).to(torch.int32)
    return ids * mask, mask


def images(n: int, size: int, gen, device) -> torch.Tensor:
    """(n, size, size, 3) channel-last: smooth colour fields plus noise."""
    low = torch.randn(n, 3, size // 16, size // 16, generator=gen, device=device)
    smooth = F.interpolate(low, size=(size, size), mode="bilinear", align_corners=False)
    noise = torch.randn(n, 3, size, size, generator=gen, device=device)
    return (0.8 * smooth + 0.3 * noise).permute(0, 2, 3, 1).contiguous()


def make_pool(cfg: dict, t: dict, seed: int, device) -> list:
    gen = torch.Generator(device=device).manual_seed(weights.stream_seed(seed, POOL_STREAM))
    b, pool = t["batch"], t["pool_batches"]
    rows, n = b * pool, t["points"]
    xy = torch.rand(rows, n, 2, generator=gen, device=device) * 6.0 - 3.0
    z = torch.rand(rows, n, 1, generator=gen, device=device) * 2.5
    clouds = torch.cat([xy, z, z - z.amin(dim=1, keepdim=True)], dim=-1)
    views = images(rows, cfg["blip"]["image_size"], gen, device)
    q_len = fixed_lengths(rows, *t["question_words"], seed, 11)
    q_ids, q_mask = token_rows(q_len, t["question_len"], ENC_TOKEN, gen, device)
    a_len = fixed_lengths(cfg["num_answers"], *t["answer_words"], seed, 12)
    a_ids, a_mask = token_rows(a_len, t["answer_len"], DEC_TOKEN, gen, device)
    answers = {"answer_list_ids": a_ids.long(), "answer_list_mask": a_mask}
    return [{"point_clouds": clouds[s:s + b], "images": views[s:s + b],
             "question_ids": q_ids[s:s + b].long(), "question_mask": q_mask[s:s + b],
             **answers} for s in range(0, rows, b)]


class Session:
    rate_metric, rate_unit, unit_name = "qa_per_s", "QA/s", "questions"
    tail_metric = "batch_ms_p90"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from bridgeqa_tpu_torch.models.bridgeqa import BridgeQA
        from bridgeqa_tpu_torch.models.layers import set_compute_dtype

        self.cfg, self.t, self.seed, self.device = cfg, traffic, seed, device
        self.k = min(traffic["k_test"], cfg["num_answers"])
        self.dtype = getattr(torch, traffic["dtype"])
        model = BridgeQA(port_config(cfg), np.asarray(cfg["mean_size_arr"], np.float32),
                         device=device)
        model.load_state_dict(weights.make_state(schema(cfg), seed, device))
        if self.dtype != torch.float32:
            set_compute_dtype(model, self.dtype)
        self.model = model.eval()
        self.pool = make_pool(cfg, traffic, seed, device)
        self.kept = {}
        peaks = load_json(ROOT / "peaks.json")
        self.peak_flops = peaks["flops_per_s"][traffic["dtype"]]
        self.hbm_bytes_per_s = peaks["hbm_bytes_per_s"]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)

    def warm(self) -> None:
        for i in range(self.t["warmup"]):
            self.batch(i, None)

    def batch(self, i: int, slot) -> int:
        b = self.pool[i % len(self.pool)]
        with torch.no_grad():
            out = self.model(b, inference="rank", k_test=self.k)
            rows = torch.arange(out["cluster_ref"].shape[0], device=self.device)
            box = out["bbox_corner"][rows, out["cluster_ref"].argmax(dim=1)]
            top = out["answer_scores"].argmax(dim=1)
            torch.cat([top[:, None].float(), box.flatten(1).float()], dim=1).cpu()
        if slot is not None:
            self.kept[slot] = (i, {k: out[k].clone() for k in KEPT})
        return top.shape[0]

    def stages(self) -> dict:
        blip = self.model.blip_model
        return {"detector": [self.model.detector], "vit": [blip.visual_encoder],
                "twin": [blip.text_encoder],
                "scoring": [blip.text_decoder, blip._decoder_scene()]}

    def flops(self, i: int) -> int:
        t = self.t
        return flops.rank_flops(self.cfg, t["batch"], self.k, t["question_len"], t["answer_len"])

    def products(self, group: str, i: int) -> list:
        t, elem = self.t, self.dtype.itemsize
        blip = self.cfg["blip"]
        dim, mlp_dim, depth, _ = flops.vit_dims(blip)
        tokens = (blip["image_size"] // 16) ** 2 + 1
        if group == "gemm":
            return (flops.vit_gemm_calls(t["batch"], tokens, dim, mlp_dim, depth, elem)
                    + flops.scoring_gemm_calls(self.cfg, t["batch"], self.k, t["answer_len"],
                                               elem))
        if group == "vocab":
            return flops.vocab_calls(self.cfg, t["batch"], self.k, t["answer_len"], elem)
        return []

    def release(self) -> None:
        """Free the program's state; the kept outputs stay."""
        del self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def numbers(self, control: bool = False, exact: tuple = ()) -> list:
        """The comparison numbers of each kept batch against the reference,
        computed in the cell's precision (``dtype``; float32 with TF32 off).
        With ``control``, the reference computed one precision below
        (``control``: "tf32" or "fp8") takes the program's place; the
        reference's submodules named in ``exact`` (such as "detector") then
        stay in the cell's precision."""
        ref = reference_model(self.cfg, self.device, self.seed)
        weight = self.cfg["blip"]["scene_ensemble_weight"]
        kept = [ref.get_submodule(name) for name in exact]
        found = []
        for slot in sorted(self.kept):
            i, got = self.kept[slot]
            batch = self.pool[i % len(self.pool)]
            with torch.no_grad():
                if control:
                    with computing(self.dtype, self.t["control"]), held(kept, self.dtype):
                        got = ref(batch, self.k)
                with computing(self.dtype):
                    want = ref(batch, self.k)
            found.append(compare.rank_numbers(got, want, weight))
            log(f"batch {i}{' control' if control else ''}: {found[-1]}")
        return found

    def check(self) -> list:
        found = self.numbers()
        worst = {k: max(n[k] for n in found) for k in found[0]}
        return compare.within(worst, self.t["limits"])

