"""Per-question scene view loading + on-host image preprocessing.

Equivalents of ``SceneViewsPoolLite`` (``lib/dataset.py:113-152``) and
``preprocess_vqa`` (``utils/blip_utils.py:96-111``): resolve
``frames_square/<scene>/color|depth|pose`` files, resize to 480x480 bicubic,
normalize with the CLIP mean/std, channel-last float32. The eager threaded
pool (``utils/blip_utils.py:136-231``) is replaced by an LRU-cached lazy
loader — the data pipeline threads already overlap IO with device compute.

A copy of ``bridgeqa_tpu/data/views.py``, kept in the port because the
port imports nothing of the JAX package, with one change: the lookup
``make_view_lookup`` returns is a module-level class (``ViewLookup``), not a
closure, and ``SceneViewsPool`` pickles without its cache, so that a
dataset holding them pickles into the feed's worker processes. PIL is
imported where a frame is read, so the module imports without it.
``tests/test_torch_feed.py`` holds the two equal.
"""

import functools
import os

import numpy as np

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)
IMAGE_SIZE = 480


def preprocess_vqa(image, image_size: int = IMAGE_SIZE):
    """PIL image -> (H, W, 3) float32, CLIP-normalized (channel-last)."""
    from PIL import Image

    image = image.convert("RGB").resize((image_size, image_size), Image.BICUBIC)
    arr = np.asarray(image, dtype=np.float32) / 255.0
    return (arr - CLIP_MEAN) / CLIP_STD


def is_blank(image, ratio: float = 0.5) -> bool:
    """``isblank`` (``blip_utils.py:130-134``): mostly-white frames."""
    pix = np.asarray(image)
    blank = (pix == 255).all(axis=-1).sum()
    return blank > pix.shape[0] * pix.shape[1] * ratio


class SceneViewsPool:
    """Lazy per-question view loader over the frames_square layout."""

    def __init__(self, dset_views_path, image_size: int = IMAGE_SIZE, cache_size: int = 256):
        self.root = dset_views_path
        self.image_size = image_size
        self.cache_size = cache_size
        self._load = functools.lru_cache(maxsize=cache_size)(self._load_uncached)

    def __getstate__(self):
        # the cache wraps a bound method, which does not pickle: a worker
        # process starts its own
        state = dict(self.__dict__)
        state.pop("_load")
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._load = functools.lru_cache(maxsize=self.cache_size)(self._load_uncached)

    def _paths(self, scene_id, image_name):
        stem = os.path.splitext(image_name)[0]
        base = os.path.join(self.root, scene_id)
        return (
            os.path.join(base, "color", f"{stem}.jpg"),
            os.path.join(base, "depth", f"{stem}.png"),
            os.path.join(base, "pose", f"{stem}.txt"),
        )

    def _load_uncached(self, scene_id, image_name):
        from PIL import Image

        color_p, depth_p, pose_p = self._paths(scene_id, image_name)
        image = preprocess_vqa(Image.open(color_p), self.image_size)
        depth = np.asarray(Image.open(depth_p), dtype=np.float32) / 1000.0 if os.path.exists(depth_p) else np.zeros((1, 1), np.float32)
        pose = np.loadtxt(pose_p).astype(np.float32) if os.path.exists(pose_p) else np.eye(4, dtype=np.float32)
        return image, depth, pose

    def get(self, scene_id, image_name):
        return self._load(scene_id, image_name)

    def get_all_views(self, scene_id):
        color_dir = os.path.join(self.root, scene_id, "color")
        return sorted(os.listdir(color_dir))


class ViewLookup:
    """The ``view_lookup(scene_id, question_id)`` used by the dataset: the
    i2tfile's ranked views per question (``dataset.py:333-349``), stacked to
    (num_views, ...) arrays. Poses flatten to 16 like
    ``qa_module.load_image`` (``qa_module.py:372-377``)."""

    def __init__(self, pool: SceneViewsPool, scene_view_map, topk: int = 1):
        self.pool = pool
        self.scene_view_map = scene_view_map
        self.topk = topk

    def __call__(self, scene_id, question_id):
        image_names = self.scene_view_map[question_id][:self.topk]
        data = [self.pool.get(scene_id, name) for name in image_names]
        images = np.stack([d[0] for d in data])
        depths = np.stack([d[1] for d in data])
        poses = np.stack([d[2].reshape(-1) for d in data])
        return images, depths, poses


def make_view_lookup(pool: SceneViewsPool, scene_view_map, topk: int = 1):
    """Build the ``view_lookup(scene_id, question_id)`` used by the dataset
    (a picklable ``ViewLookup``)."""
    return ViewLookup(pool, scene_view_map, topk)


def load_scene_view_map(i2tfile):
    """Load the question -> ranked-views mapping (the i2tfile produced by
    view selection). Accepts .json or torch-style .pkl with a 'view' key."""
    import json
    import pickle

    if str(i2tfile).endswith(".json"):
        with open(i2tfile) as f:
            obj = json.load(f)
    else:
        with open(i2tfile, "rb") as f:
            obj = pickle.load(f)
    return obj["view"] if isinstance(obj, dict) and "view" in obj else obj
