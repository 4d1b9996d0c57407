"""The port's data feed against the JAX package's, on the CPU.

- Each module the port copied is held to its original: its definitions'
  code (docstrings dropped, ``bridgeqa_tpu_torch`` read as ``bridgeqa_tpu``
  and the port's ``scripts`` as the pre-port ``scripts``) must be the same,
  save the few each copy changes, which are held by their outputs instead.
- The port's ``BatchIterator`` gives batches bitwise equal to the JAX one's
  for one seed: serially in ``stream`` mode, and through its two-worker
  ``forkserver`` pool against the JAX fork pool in ``per_sample`` mode. Both
  datasets hold the same picklable view lookup (the port's
  ``SyntheticViewLookup``; the JAX drivers' closure seeds from Python's
  salted ``hash`` and cannot pickle).
- ``device_batches`` turns the feed's numpy into tensors equal to it, keeps
  the host fields, raises a worker's failure and stops when closed (its
  pinned copy to the card is a card test, ``tests/test_torch_cuda.py``).
"""

import ast
import inspect
import pickle
import re

import numpy as np
import pytest
import torch

from bridgeqa_tpu import native as jnative
from bridgeqa_tpu.data import answers as janswers
from bridgeqa_tpu.data import pipeline as jpipeline
from bridgeqa_tpu.data import scannet_config as jscannet_config
from bridgeqa_tpu.data import tokenization as jtokenization
from bridgeqa_tpu.data import views as jviews
from bridgeqa_tpu_torch import native
from bridgeqa_tpu_torch.data import answers, device_feed, pipeline, scannet_config, sources
from bridgeqa_tpu_torch.data import tokenization, views
from scripts import common as jcommon


def _jax_name(module: str) -> str:
    module = re.sub(r"^bridgeqa_tpu_torch\.scripts\b", "scripts", module)
    return re.sub(r"^bridgeqa_tpu_torch\b", "bridgeqa_tpu", module)


def _normalised(node):
    for n in ast.walk(node):
        if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = n.body
            if (body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                n.body = body[1:] or [ast.Pass()]
        if isinstance(n, ast.ImportFrom) and n.module:
            n.module = _jax_name(n.module)
        if isinstance(n, ast.Import):
            for alias in n.names:
                alias.name = _jax_name(alias.name)
    return node


def definitions(module) -> dict:
    """{name: normalised code} of a module's top-level functions, classes
    (each method as "Class.method", the rest of the class as "Class") and
    assignments."""
    out = {}
    for node in _normalised(ast.parse(inspect.getsource(module))).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = ast.dump(node)
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{item.name}"] = ast.dump(item)
            node.body = [i for i in node.body
                         if not isinstance(i, (ast.FunctionDef, ast.AsyncFunctionDef))] or [ast.Pass()]
            out[node.name] = ast.dump(node)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    out[t.id] = ast.dump(node.value)
    return out


def assert_same_code(port_module, jax_module, changed=(), names=None):
    """Every definition of ``jax_module`` (or those in ``names``) but the
    ``changed`` ones is in ``port_module`` with the same code."""
    port, jax_defs = definitions(port_module), definitions(jax_module)
    for name in names if names is not None else jax_defs:
        if name in changed:
            continue
        assert name in port, f"{port_module.__name__} lacks {name}"
        assert port[name] == jax_defs[name], f"{port_module.__name__}.{name} differs from the JAX copy"
    assert set(changed) <= set(jax_defs), "a name listed as changed is not in the original"


@pytest.mark.parametrize("port_module,jax_module,changed", [
    (answers, janswers, ()),
    (tokenization, jtokenization, ()),
    (scannet_config, jscannet_config, ()),
    # the lookup became a class (held by test_view_lookup_matches_the_closure)
    # and the pool keeps its cache size to remake the cache when unpickled
    (views, jviews, ("make_view_lookup", "SceneViewsPool.__init__")),
    # forkserver instead of fork, batches handed over in shared memory, a
    # worker's failure raised in the parent
    (pipeline, jpipeline, ("_proc_worker", "BatchIterator._ensure_procs",
                           "BatchIterator.__iter__", "BatchIterator.shutdown")),
    # the library's path and its build under a temporary name
    (native, jnative, ("_LIB_PATH", "_build")),
], ids=["answers", "tokenization", "scannet_config", "views", "pipeline", "native"])
def test_copies_match_originals(port_module, jax_module, changed):
    assert_same_code(port_module, jax_module, changed)


def test_sources_match_the_drivers_common():
    """``data/sources.py`` holds the JAX drivers' synthetic data and scene
    loading; the closures became classes (held by the feed tests)."""
    assert_same_code(sources, jcommon, names=("_SYN_QUESTIONS", "synthetic_records",
                                              "synthetic_scene_data", "synthetic_tokenizer"))
    recs = sources.synthetic_records(9)
    assert recs == jcommon.synthetic_records(9)
    for k, scene in sources.synthetic_scene_data(2, num_points=3000).items():
        want = jcommon.synthetic_scene_data(2, num_points=3000)[k]
        for field, arr in scene.items():
            np.testing.assert_array_equal(arr, want[field], err_msg=field)


def test_native_source_and_votes_match():
    """The C++ source is the same file; the port's votes equal the JAX
    package's, native and numpy paths both, on a scene with a skipped
    instance (its first point's class is not a target)."""
    with open(native._SRC) as f, open(jnative._SRC) as g:
        assert f.read() == g.read()
    rng = np.random.RandomState(3)
    pts = rng.rand(3000, 3).astype(np.float32) * 4
    inst = rng.randint(0, 7, 3000).astype(np.int32)
    sem = (rng.rand(3000) > 0.3).astype(np.uint8)
    want = jnative.compute_votes(pts, inst, sem)
    got = native.compute_votes(pts, inst, sem)
    assert native.available() == jnative.available()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    lib = native._lib
    try:
        native._lib, native._build_error = None, RuntimeError("numpy path")
        numpy_votes = native.compute_votes(pts, inst, sem)
    finally:
        native._lib, native._build_error = lib, None
    for g, w in zip(numpy_votes, want):
        np.testing.assert_array_equal(g, w)


class _Pool:
    """A frame pool that makes each view from its names."""

    def get(self, scene_id, name):
        rng = np.random.RandomState(len(scene_id) * 100 + len(name))
        return rng.rand(4, 4, 3).astype(np.float32), rng.rand(2, 2), np.eye(4) * len(name)


def test_view_lookup_matches_the_closure():
    view_map = {"q1": ["a.jpg", "bbb.jpg", "cc.jpg"], "q2": ["dddd.jpg"]}
    for topk in (1, 2):
        lookup = views.make_view_lookup(_Pool(), view_map, topk)
        again = pickle.loads(pickle.dumps(lookup))
        closure = jviews.make_view_lookup(_Pool(), view_map, topk)
        for qid in view_map:
            for got in (lookup("scene0", qid), again("scene0", qid)):
                for g, w in zip(got, closure("scene0", qid)):
                    np.testing.assert_array_equal(g, w)


def test_scene_views_pool_pickles_without_its_cache(tmp_path):
    pool = views.SceneViewsPool(str(tmp_path), image_size=32, cache_size=7)
    again = pickle.loads(pickle.dumps(pool))
    assert (again.root, again.image_size, again.cache_size) == (str(tmp_path), 32, 7)
    assert again._load.cache_info().maxsize == 7
    assert again._paths("s", "f.jpg") == pool._paths("s", "f.jpg")


def _datasets(rng_mode, num_points=2048, records=12):
    """The same train dataset built by both packages, holding one
    ``SyntheticViewLookup``."""
    recs = jcommon.synthetic_records(records)
    scenes = jcommon.synthetic_scene_data(4, num_points=3000)
    cands, counter = janswers.build_answer_vocab(recs, recs)
    lookup = sources.SyntheticViewLookup(32)
    kw = dict(answer_cands=cands, answer_counter=counter, split="train", num_points=num_points,
              augment=True, view_lookup=lookup, rng_mode=rng_mode, seed=5)
    return (pipeline.ScanQADataset(recs, scenes, tokenizer=sources.synthetic_tokenizer(), **kw),
            jpipeline.ScanQADataset(recs, scenes, tokenizer=jcommon.synthetic_tokenizer(), **kw))


def _assert_batches_equal(got, want):
    assert list(got) == list(want)
    for k, w in want.items():
        if isinstance(w, list):
            assert got[k] == w, k
        else:
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_serial_feed_is_bitwise_the_jax_feed():
    """``stream`` mode (one shared rng, the serial path), two epochs."""
    port_ds, jax_ds = _datasets("stream")
    port = pipeline.BatchIterator(port_ds, 4, seed=3, num_workers=4)  # stream mode: serial
    jax_it = jpipeline.BatchIterator(jax_ds, 4, seed=3, num_workers=4)
    for _ in range(2):
        batches = list(port)
        assert len(batches) == 3
        for got, want in zip(batches, jax_it):
            _assert_batches_equal(got, want)
    assert port._procs == []


def test_forkserver_pool_is_bitwise_the_jax_fork_pool(monkeypatch):
    """``per_sample`` mode: the port's two forkserver workers against the JAX
    package's two forked ones and against the port's serial path, two
    epochs, then an epoch abandoned after one batch and a whole one after
    it; then a batch that raises in a worker raises in the parent."""
    monkeypatch.setattr(pipeline.os, "cpu_count", lambda: 8)
    monkeypatch.setattr(jpipeline.os, "cpu_count", lambda: 8)
    port_ds, jax_ds = _datasets("per_sample")
    serial_ds, _ = _datasets("per_sample")
    port = pipeline.BatchIterator(port_ds, 4, seed=3, num_workers=2)
    jax_it = jpipeline.BatchIterator(jax_ds, 4, seed=3, num_workers=2)
    serial = pipeline.BatchIterator(serial_ds, 4, seed=3, num_workers=1)
    try:
        for _ in range(2):
            for got, want, same in zip(port, jax_it, serial):
                _assert_batches_equal(got, want)
                _assert_batches_equal(same, want)
        assert len(port._procs) == 2
        assert all(p._popen.method == "forkserver" for p in port._procs)
        # an epoch abandoned after one batch, then a whole one
        for it in (iter(port), iter(serial)):
            next(it)
            it.close()
        for got, want in zip(port, serial):
            _assert_batches_equal(got, want)

        # a scene the workers cannot find: the worker reports, the parent raises
        port_ds.scene_data = {}
        broken = pipeline.BatchIterator(port_ds, 4, seed=3, num_workers=2)
        try:
            with pytest.raises(pipeline.WorkerError, match="KeyError"):
                next(iter(broken))
        finally:
            broken.shutdown()
    finally:
        port.shutdown()
        jax_it.shutdown()
    assert port._procs == []


def test_device_batches_on_the_cpu():
    """Tensors equal to the feed's arrays, dtypes kept, host fields as they
    are, every batch in order; an error in the feed raises in the caller;
    closing stops the thread and closes the feed's iterator."""
    rng = np.random.RandomState(0)
    feed = [{"x": rng.rand(2, 3).astype(np.float32), "i": rng.randint(0, 9, (2,)).astype(np.int32),
             "ids": ["a", "b"]} for _ in range(5)]
    got = list(device_feed.device_batches(feed, "cpu"))
    assert len(got) == 5
    for g, w in zip(got, feed):
        assert g["ids"] == w["ids"]
        for k in ("x", "i"):
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), w[k])

    def failing():
        yield feed[0]
        raise ValueError("feed broke")

    it = device_feed.device_batches(failing(), "cpu")
    next(it)
    with pytest.raises(ValueError, match="feed broke"):
        next(it)

    closed = []

    def endless():
        try:
            while True:
                yield feed[1]
        finally:
            closed.append(True)

    it = device_feed.device_batches(endless(), torch.device("cpu"), prefetch=1)
    next(it)
    it.close()
    assert closed == [True]
