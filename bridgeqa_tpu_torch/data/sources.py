"""Where a dataset's scenes, views and multiview features come from: the
preprocessed ScanNet files, or synthetic scenes and images made from a seed
(so every driver runs without a ScanNet download). The drivers' part of
``scripts/common.py``, numpy only, so that the feed's worker processes,
which receive the dataset pickled (forked by a fork server, not by the parent), import no more
than the data modules.

What a dataset holds must pickle, so the scene loader and the view and
multiview lookups are module-level classes where the JAX drivers use
closures. The synthetic lookups seed their draws from ``zlib.crc32`` of
their ids, not from Python's ``hash``, which is salted in every process:
the JAX drivers' synthetic images therefore differ from process to process,
and from the port's. ``tests/test_torch_feed.py`` holds the rest equal to
``scripts/common.py``.
"""

import os
import zlib

import numpy as np

from bridgeqa_tpu_torch.data.pipeline import load_scene_npy
from bridgeqa_tpu_torch.data.scannet_config import ScannetDatasetConfig
from bridgeqa_tpu_torch.data.tokenization import WordPieceTokenizer, build_test_vocab


class SceneLoader:
    """``scene_id`` -> the preprocessed scene's npys, cached per process."""

    def __init__(self, data_root: str):
        self.scannet_dir = os.path.join(data_root, "scannet_data")
        self.cache = {}

    def __call__(self, scene_id):
        if scene_id not in self.cache:
            self.cache[scene_id] = load_scene_npy(self.scannet_dir, scene_id)
        return self.cache[scene_id]


def make_scene_loader(data_root: str):
    return SceneLoader(data_root)


# --- synthetic demo data ------------------------------------------------

_SYN_QUESTIONS = [
    ("what color is the chair", ["brown"]),
    ("where is the table", ["next to the wall"]),
    ("how many doors are there", ["two"]),
    ("what is on the desk", ["monitor"]),
]


def synthetic_records(n: int, num_scenes: int = 4):
    recs = []
    for i in range(n):
        q, a = _SYN_QUESTIONS[i % len(_SYN_QUESTIONS)]
        recs.append({
            "scene_id": f"synth{i % num_scenes:04d}_00",
            "question": q,
            "question_id": f"synth-q{i:04d}",
            "answers": a,
            "object_ids": [0],
            "object_names": ["chair"],
        })
    return recs


def synthetic_scene_data(num_scenes: int, num_points: int = 50000, seed: int = 0):
    """Scene dicts shaped like the preprocessed ScanNet npys."""
    dc = ScannetDatasetConfig()
    scenes = {}
    for s in range(num_scenes):
        rng = np.random.RandomState(seed + s)
        num_obj = rng.randint(4, 9)
        verts, ins, sem = [], [], []
        bboxes = np.zeros((num_obj, 8), dtype=np.float32)
        pts_per = num_points // (num_obj + 1)
        for i in range(num_obj):
            center = rng.uniform(-2.5, 2.5, 3)
            center[2] = rng.uniform(0.3, 1.5)
            size = rng.uniform(0.3, 1.2, 3)
            p = center + (rng.rand(pts_per, 3) - 0.5) * size
            rgb = rng.randint(0, 255, (pts_per, 3)).astype(np.float32)
            verts.append(np.concatenate([p, rgb], axis=1))
            ins.append(np.full(pts_per, i + 1))
            cls = rng.randint(0, dc.num_class)
            sem.append(np.full(pts_per, dc.nyu40ids[cls]))
            bboxes[i] = [*center, *size, dc.nyu40ids[cls], i]
        n_bg = num_points - pts_per * num_obj
        bg = rng.uniform(-3, 3, (n_bg, 3))
        bg[:, 2] = rng.uniform(0, 2.5, n_bg)
        verts.append(np.concatenate([bg, rng.randint(0, 255, (n_bg, 3)).astype(np.float32)], axis=1))
        ins.append(np.zeros(n_bg))
        sem.append(np.zeros(n_bg))
        scenes[f"synth{s:04d}_00"] = {
            "mesh_vertices": np.concatenate(verts).astype(np.float32),
            "instance_labels": np.concatenate(ins).astype(np.int64),
            "semantic_labels": np.concatenate(sem).astype(np.int64),
            "instance_bboxes": bboxes,
            "axis_align_matrix": np.eye(4),
        }
    return scenes


def stable_seed(*ids) -> int:
    """A seed from ids that every process computes alike (``zlib.crc32`` of
    the ids joined by "/"; Python's ``hash`` of a string is salted per
    process)."""
    return zlib.crc32("/".join(str(i) for i in ids).encode()) % (2 ** 31)


class SyntheticViewLookup:
    """A random image per question, seeded from its ids."""

    def __init__(self, image_size: int):
        self.image_size = image_size

    def __call__(self, scene_id, question_id):
        rng = np.random.RandomState(stable_seed(scene_id, question_id))
        images = rng.rand(1, self.image_size, self.image_size, 3).astype(np.float32)
        depths = np.zeros((1, 8, 8), np.float32)
        poses = np.tile(np.eye(4, dtype=np.float32).reshape(1, 16), (1, 1))
        return images, depths, poses


def synthetic_view_lookup(image_size: int, seed: int = 0):
    return SyntheticViewLookup(image_size)


class MultiviewFiles:
    """Per-scene projected multiview features, ``<root>/<scene_id>.npy``."""

    def __init__(self, root: str):
        self.root = root

    def __call__(self, scene_id):
        return np.load(os.path.join(self.root, f"{scene_id}.npy"))


class SyntheticMultiview:
    """Random 128-d per-point features for each synthetic scene, seeded from
    its id; ``num_points``: {scene_id: its point count}, 50000 for others."""

    def __init__(self, num_points: dict):
        self.num_points = num_points

    def __call__(self, scene_id):
        r = np.random.RandomState(stable_seed(scene_id))
        return r.rand(self.num_points.get(scene_id, 50000), 128).astype(np.float32)


def synthetic_tokenizer():
    words = sorted({w for q, ans in _SYN_QUESTIONS for w in (q + " " + " ".join(ans)).split()})
    return WordPieceTokenizer(build_test_vocab(words))
