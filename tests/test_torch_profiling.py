"""The port's spans and counters (``bridgeqa_tpu_torch/utils/profiling.py``)
on the CPU: off they record nothing while the counters count; inside
``recording()`` a tiny rank forward yields the span tree of its layers, with
outputs bitwise those of the same forward with spans off; under
``torch.profiler`` the spans are ranges named ``bridgeqa/<name>``, nested as
the recorder nests them; the view selection tool records its host work and
counts its padding; ``maybe_trace``'s card time leaves user annotations out.
"""

import json

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from bridgeqa_tpu_torch.data.sources import synthetic_tokenizer
from bridgeqa_tpu_torch.models import blip_itm, blip_vqa3d, bridgeqa, med
from bridgeqa_tpu_torch.models.layers import init_weights
from bridgeqa_tpu_torch.tools import view_select
from bridgeqa_tpu_torch.utils import profiling
from tests.synthetic import make_batch

# one rank forward, in the order the spans open: (name, name of the parent)
RANK_TREE = [("forward", None), ("detector", "forward"), ("heads", "forward"),
             ("vit", "forward"), ("twin", "forward")] + [
    (name, parent) for _ in range(2) for name, parent in (
        ("scoring", "forward"), ("scoring/first_token", "scoring"),
        ("scoring/topk", "scoring"), ("scoring/answers", "scoring"))] + [
    ("heads", "forward"), ("heads", "forward")]


@pytest.fixture(scope="module")
def tiny_rank():
    """A tiny BridgeQA with drawn weights and a batch of 2 questions."""
    mcfg = med.MedConfig(vocab_size=120, hidden_size=64, num_hidden_layers=2,
                         num_attention_heads=4, intermediate_size=128,
                         max_position_embeddings=64, encoder_width=64, fused_scoring="off")
    bcfg = blip_vqa3d.BlipVQA3DConfig(med=mcfg, image_size=32, num_answers=30, scene_size=32,
                                      bos_token_id=110, vit="custom", vit_custom_embed_dim=64,
                                      vit_custom_depth=2, vit_custom_heads=4,
                                      vit_drop_path_rate=0.0)
    cfg = bridgeqa.BridgeQAConfig(num_answers=30, num_proposal=32, hidden_size=32, blip=bcfg,
                                  mcan_num_layers=1, input_feature_dim=1)
    model = bridgeqa.BridgeQA(cfg, device="cpu")
    init_weights(model, torch.Generator().manual_seed(0)).eval()
    rng = np.random.RandomState(7)
    pc = make_batch(rng, batch_size=2, num_points=2048)["point_clouds"]
    height = pc[..., 2:3] - pc[..., 2:3].min(axis=1, keepdims=True)
    answers = rng.randint(1, 100, (30, 5))
    answers[:, 0] = 110
    batch = dict(point_clouds=np.concatenate([pc, height], axis=-1).astype(np.float32),
                 images=rng.rand(2, 32, 32, 3).astype(np.float32),
                 question_ids=rng.randint(1, 100, (2, 12)),
                 question_mask=np.ones((2, 12), np.int32),
                 answer_list_ids=answers, answer_list_mask=np.ones((30, 5), np.int32))
    return model, {k: torch.from_numpy(v) for k, v in batch.items()}


def _rank(model, batch):
    with torch.no_grad():
        return model(batch, inference="rank", k_test=8)


def _tree(spans):
    return [(s.name, None if s.parent is None else spans[s.parent].name) for s in spans]


def test_spans_off_record_nothing_while_counters_count():
    before = profiling.counts()
    assert profiling.span("forward") is profiling.span("vit")  # one shared no-op
    with profiling.span("forward"):
        profiling.count("test/things", 3)
        profiling.count("test/things")
    assert profiling.counts()["test/things"] == before["test/things"] + 4
    assert profiling._recorder is None
    with profiling.recording() as rec:
        profiling.count("test/things", 2)
    assert rec.spans == [] and rec.counts == {"test/things": 2}
    profiling.reset_counts()
    assert profiling.counts() == {}


def test_recordings_do_not_nest():
    with profiling.recording():
        with pytest.raises(RuntimeError):
            with profiling.recording():
                pass
    assert profiling._recorder is None


def test_rank_forward_records_its_layers(tiny_rank):
    model, batch = tiny_rank
    want = _rank(model, batch)
    with profiling.recording() as rec:
        got = _rank(model, batch)
        again = _rank(model, batch)
    assert set(got) == set(want)
    for key, value in want.items():
        assert torch.equal(got[key], value) and torch.equal(again[key], value), key
    spans = rec.spans
    assert _tree(spans) == RANK_TREE * 2
    assert [s.request for s in spans] == [0] * len(RANK_TREE) + [1] * len(RANK_TREE)
    for s in spans:
        assert s.stream_ms is None and s.self_stream_ms is None  # no card
        assert s.end_ns >= s.start_ns and s.host_ms == (s.end_ns - s.start_ns) / 1e6
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    for k, s in enumerate(spans):
        children = sum(c.host_ms for c in spans if c.parent == k)
        assert s.self_host_ms == pytest.approx(s.host_ms - children, abs=1e-9)
    totals = rec.totals()
    assert totals["heads"]["calls"] == 6 and totals["scoring/topk"]["calls"] == 4
    assert "stream_ms" not in totals["forward"]


def test_profiler_ranges_nest_as_the_recorder(tiny_rank, tmp_path):
    """Inside ``recording()`` and under a bare profiler alike, the spans are
    the profiler's ranges ``bridgeqa/<name>``, in the recorder's order and
    nesting, and no user annotations."""
    model, batch = tiny_rank
    acts = [torch.profiler.ProfilerActivity.CPU]
    for record in (True, False):
        with torch.profiler.profile(activities=acts) as prof:
            if record:
                with profiling.recording() as rec:
                    _rank(model, batch)
            else:
                _rank(model, batch)
        events = prof.profiler.kineto_results.events()
        ranges = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                         for e in events if e.name().startswith(profiling.PREFIX)),
                        key=lambda r: (r[1], -r[2]))
        assert not any(e.is_user_annotation() for e in events
                       if e.name().startswith(profiling.PREFIX))
        parents = []
        for k, (_, a, b) in enumerate(ranges):
            holding = [j for j in range(k) if ranges[j][1] <= a and b <= ranges[j][2]]
            parents.append(max(holding) if holding else None)
        tree = [(n[len(profiling.PREFIX):], None if p is None else
                 ranges[p][0][len(profiling.PREFIX):]) for (n, _, _), p in zip(ranges, parents)]
        assert tree == RANK_TREE
        if record:
            assert tree == _tree(rec.spans)
    with profiling.maybe_trace(str(tmp_path), step=3) as summary:
        _rank(model, batch)
    names = {e.get("name") for e in json.loads(open(summary.path).read())["traceEvents"]}
    assert {"bridgeqa/forward", "bridgeqa/scoring/topk", "bridgeqa/heads"} <= names
    assert summary.device_ms == 0.0 and summary.wall_ms > 0


class _Event:
    def __init__(self, device, ns, annotation=False):
        self.device, self.ns, self.annotation = device, ns, annotation

    def device_type(self):
        return self.device

    def duration_ns(self):
        return self.ns

    def is_user_annotation(self):
        return self.annotation


def test_device_ms_leaves_annotations_out():
    events = [_Event(DeviceType.CUDA, 2_000_000), _Event(DeviceType.CUDA, 500_000),
              _Event(DeviceType.CUDA, 9_000_000, annotation=True),
              _Event(DeviceType.CPU, 7_000_000)]
    assert profiling.device_ms(events) == 2.5


def test_view_selection_records_its_host_work():
    """A scene of 100 frames at ``image_batch`` 64: 100 frames counted, 128
    encoded (two image batches), and every layer of the tool under the
    scene."""
    mcfg = med.MedConfig(vocab_size=200, hidden_size=64, num_hidden_layers=2,
                         num_attention_heads=4, intermediate_size=128,
                         max_position_embeddings=64, encoder_width=128)
    cfg = blip_itm.BlipITMConfig(med=mcfg, image_size=32, vit="custom", embed_dim=32,
                                 vit_custom_embed_dim=128, vit_custom_depth=2,
                                 vit_custom_heads=2)
    model = init_weights(blip_itm.BLIPITM(cfg, device="cpu"), torch.Generator().manual_seed(1))
    frames = np.random.RandomState(2).rand(100, 32, 32, 3).astype(np.float32)
    records = [{"scene_id": "scene0000_00", "question_id": q,
                "question": "what is on the table"} for q in range(5)]
    with profiling.recording() as rec:
        i2t = view_select.select_best_views(
            model.eval(), records, synthetic_tokenizer(),
            lambda _s: ([f"{j}.jpg" for j in range(100)], frames), image_batch=64,
            text_batch=64, text_len=12)
    assert len(i2t["view"]) == 5 and all(len(v) == 100 for v in i2t["view"].values())
    assert rec.counts["views/frames"] == 100 and rec.counts["views/frames_encoded"] == 128
    spans = rec.spans
    assert spans[0].name == "scene" and spans[0].parent is None
    assert all(s.request == 0 for s in spans)
    tree = _tree(spans)
    for name in ("images", "texts", "tokenize", "rank"):
        assert (name, "scene") in tree, name
    for name in ("prepare", "upload", "encode", "readback"):
        assert (name, "images") in tree and (name, "texts") in tree, name
    assert tree.count(("encode", "images")) == 2 and tree.count(("encode", "texts")) == 1
