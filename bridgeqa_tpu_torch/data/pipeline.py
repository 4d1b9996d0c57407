"""ScanQA data pipeline: scene loading, augmentation, vote labels, batching.

Equivalent of ``lib/dataset.py`` (``ScannetQADataset``, 155-816) rebuilt
torch-free: every sample is a dict of fixed-shape numpy arrays ready for
the device. Key reference semantics preserved:

- color normalization ``(rgb - MEAN_COLOR_RGB) / 256`` (``dataset.py:385``);
- height channel = z - 0.99th percentile floor (``dataset.py:392-394``);
- random sampling to ``num_points`` (``dataset.py:415``);
- augmentation: YZ/XZ flips (p=.5), ±5° rotations about x, y, z applied in
  that order with box extents recomputed per axis, ±0.5 m translation
  (``dataset.py:447-491``);
- **votes computed after augmentation** from instance masks: per instance,
  vote = (0.5(min+max) of its points) − point, tiled x3 (``501-510``);
- frequency-weighted answer soft scores (``309-327``);
- padding boxes parked at −100 so Chamfer never matches them (``423``).

The batch iterator replaces torch DataLoader + DistributedSampler with a
thread-prefetched numpy pipeline; ``data/device_feed.py`` moves its batches
to the card.

A copy of ``bridgeqa_tpu/data/pipeline.py``, kept in the port because the
port imports nothing of the JAX package, with one change: ``BatchIterator``'s
worker processes start by ``forkserver``, not ``fork``. A parent that has
initialised CUDA must not fork; the fork server is a fresh process that
never touches CUDA, imports the main module and the data modules once, and
forks each worker from itself, so a worker starts in milliseconds where a
``spawn`` worker imports the main module (and torch with it) afresh. The
dataset reaches a worker pickled, so it must pickle (the port's scene
loaders and view lookups are module-level classes). The vote library is
built (or found) in the parent before the workers start. In ``per_sample`` mode the batches
stay bitwise equal to the serial path's, and to the JAX iterator's for the
same dataset. A worker hands its batch over in shared memory, not through
the queue's pipe (``_to_shared``). A batch that raises in a worker, or a
worker that dies, raises in the parent (``WorkerError``) instead of leaving
it waiting.
``tests/test_torch_feed.py`` holds the two equal.
"""

import os
import threading
import time
import traceback
import queue as queue_mod

import numpy as np

from bridgeqa_tpu_torch.data.answers import Answer, get_answer_score
from bridgeqa_tpu_torch.data.scannet_config import ScannetDatasetConfig, rotate_aligned_boxes_along_axis

MAX_NUM_OBJ = 128
MEAN_COLOR_RGB = np.array([109.8, 97.2, 83.8])
MAX_TEXT_LEN = 36  # CONF.TRAIN.MAX_TEXT_LEN (lib/config.py)


def rotx(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def roty(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def rotz(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def random_sampling(pc, num_sample, rng, return_choices=False):
    """Sample to fixed size, with replacement iff the cloud is smaller."""
    n = pc.shape[0]
    replace = n < num_sample
    choices = rng.choice(n, num_sample, replace=replace)
    if return_choices:
        return pc[choices], choices
    return pc[choices]


def load_scene_npy(scannet_data_dir, scene_id):
    """Load one preprocessed ScanNet scene (the ``_load_data`` cache unit,
    ``dataset.py:765-801``): aligned verts / instance / semantic labels /
    aligned bboxes (+ axis-align matrix when present)."""
    import os

    base = os.path.join(scannet_data_dir, scene_id)
    scene = {
        "mesh_vertices": np.load(base + "_aligned_vert.npy"),
        "instance_labels": np.load(base + "_ins_label.npy"),
        "semantic_labels": np.load(base + "_sem_label.npy"),
        "instance_bboxes": np.load(base + "_aligned_bbox.npy"),
    }
    align_path = base + "_axis_align_matrix.npy"
    scene["axis_align_matrix"] = np.load(align_path) if os.path.exists(align_path) else np.eye(4)
    return scene


class ScanQADataset:
    """Per-sample assembly of the ScanQA training dict (numpy)."""

    def __init__(
        self,
        records,
        scene_data,
        *,
        answer_cands=None,
        answer_counter=None,
        split="train",
        num_points=40000,
        use_color=False,
        use_height=True,
        use_normal=False,
        use_multiview=False,
        multiview_lookup=None,
        augment=False,
        use_unanswerable=False,
        glove=None,
        tokenizer=None,
        question_len=80,
        answer_len=16,
        view_lookup=None,
        dataset_config=None,
        seed=0,
        rng_mode="stream",
    ):
        """records: list of ScanQA dicts (question/answers/scene_id/object_ids/
        object_names/question_id). scene_data: scene_id -> scene dict (see
        ``load_scene_npy``) or a callable. view_lookup: optional
        question_id -> (images, depths, poses) callable (the i2t best-view
        hookup). glove: word -> 300d vector dict for the MCAN path.
        tokenizer: WordPieceTokenizer for the BLIP path.
        """
        self.dc = dataset_config or ScannetDatasetConfig()
        if split in ("train", "val") and not use_unanswerable and answer_cands is not None:
            records = [d for d in records if len(set(d["answers"]) & set(answer_cands)) > 0]
        self.records = records
        self.scene_data = scene_data
        self.answer_cands = answer_cands or []
        self.answer_counter = answer_counter
        self.answer_vocab = Answer(self.answer_cands)
        self.num_answers = len(self.answer_cands)
        self.split = split
        self.num_points = num_points
        self.use_color = use_color
        self.use_height = use_height
        self.use_normal = use_normal
        self.use_multiview = use_multiview
        self.multiview_lookup = multiview_lookup
        self.augment = augment
        self.glove = glove
        self.tokenizer = tokenizer
        self.question_len = question_len
        self.answer_len = answer_len
        self.view_lookup = view_lookup
        self.seed = seed
        # "stream": one shared RandomState (the reference's global np.random
        # semantics; required for the seeded __getitem__ golden).
        # "per_sample": an independent RandomState per (seed, epoch, idx) —
        # deterministic under multi-worker prefetch (torch worker idiom).
        self.rng_mode = rng_mode
        self.epoch = 0
        self.rng = np.random.RandomState(seed)
        # raw object name -> class (others bucket = 17), dataset.py:625-645
        self.raw2label = {name: i for name, i in self.dc.type2class.items()}

    def __len__(self):
        return len(self.records)

    def _get_scene(self, scene_id):
        if callable(self.scene_data):
            return self.scene_data(scene_id)
        return self.scene_data[scene_id]

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def __getitem__(self, idx):
        if self.rng_mode == "per_sample":
            rng = np.random.RandomState((self.seed * 1000003 + self.epoch * 9176 + idx) % (2**31))
        else:
            rng = self.rng
        rec = self.records[idx]
        scene_id = rec["scene_id"]
        scene = self._get_scene(scene_id)

        object_ids = rec.get("object_ids") if self.split != "test" and not rec.get("sideload") else None
        object_names = (
            [" ".join(n.split("_")) for n in rec["object_names"]]
            if rec.get("object_names") and object_ids is not None
            else None
        )
        answers = rec.get("answers", [])
        question = rec["question"]

        # --- answer supervision
        answer_cats = np.zeros(self.num_answers, dtype=np.float32)
        answer_cat_scores = np.zeros(self.num_answers, dtype=np.float32)
        for answer in answers:
            ind = self.answer_vocab.stoi(answer)
            if ind < 0:
                continue
            answer_cats[ind] = 1
            if self.answer_counter is not None:
                answer_cat_scores[ind] = get_answer_score(self.answer_counter.get(answer, 0))
        answer_cat = int(answer_cats.argmax()) if self.num_answers else 0

        # --- point cloud features
        mesh_vertices = scene["mesh_vertices"].copy()
        instance_labels = scene["instance_labels"].copy()
        semantic_labels = scene["semantic_labels"].copy()
        instance_bboxes = scene["instance_bboxes"].copy()

        if not self.use_color:
            point_cloud = mesh_vertices[:, 0:3].copy()
        else:
            point_cloud = mesh_vertices[:, 0:6].copy()
            point_cloud[:, 3:6] = (point_cloud[:, 3:6] - MEAN_COLOR_RGB) / 256.0
        if self.use_normal:
            point_cloud = np.concatenate([point_cloud, mesh_vertices[:, 6:9]], 1)
        if self.use_height:
            floor_height = np.percentile(point_cloud[:, 2], 0.99)
            height = point_cloud[:, 2] - floor_height
            point_cloud = np.concatenate([point_cloud, height[:, None]], 1)
        if self.use_multiview and self.multiview_lookup is not None:
            point_cloud = np.concatenate([point_cloud, self.multiview_lookup(scene_id)], 1)

        point_cloud, choices = random_sampling(point_cloud, self.num_points, rng, return_choices=True)
        instance_labels = instance_labels[choices]
        semantic_labels = semantic_labels[choices]

        # --- labels
        target_bboxes = np.zeros((MAX_NUM_OBJ, 6)) - 1e2
        target_bboxes_mask = np.zeros(MAX_NUM_OBJ)
        angle_classes = np.zeros(MAX_NUM_OBJ)
        angle_residuals = np.zeros(MAX_NUM_OBJ)
        size_classes = np.zeros(MAX_NUM_OBJ)
        size_residuals = np.zeros((MAX_NUM_OBJ, 3))
        ref_box_label = np.zeros(MAX_NUM_OBJ)
        ref_center_label = np.zeros(3)
        ref_heading_class_label = 0
        ref_heading_residual_label = 0
        ref_size_class_label = 0
        ref_size_residual_label = np.zeros(3)

        if self.split != "test":
            num_bbox = min(instance_bboxes.shape[0], MAX_NUM_OBJ)
            target_bboxes_mask[:num_bbox] = 1
            target_bboxes[:num_bbox] = instance_bboxes[:MAX_NUM_OBJ, 0:6]

            point_votes = np.zeros((self.num_points, 3))
            point_votes_mask = np.zeros(self.num_points)

            if self.augment:
                if rng.random_sample() > 0.5:  # YZ-plane flip
                    point_cloud[:, 0] = -point_cloud[:, 0]
                    target_bboxes[:, 0] = -target_bboxes[:, 0]
                if rng.random_sample() > 0.5:  # XZ-plane flip
                    point_cloud[:, 1] = -point_cloud[:, 1]
                    target_bboxes[:, 1] = -target_bboxes[:, 1]
                for rot_fn, axis in ((rotx, "x"), (roty, "y"), (rotz, "z")):
                    rot_angle = (rng.random_sample() * np.pi / 18) - np.pi / 36  # ±5°
                    rot_mat = rot_fn(rot_angle)
                    point_cloud[:, 0:3] = np.dot(point_cloud[:, 0:3], rot_mat.T)
                    target_bboxes = rotate_aligned_boxes_along_axis(target_bboxes, rot_mat, axis)
                factor = rng.choice(np.arange(-0.5, 0.501, 0.001), size=3)
                point_cloud[:, 0:3] += factor
                target_bboxes[:, 0:3] += factor

            # votes AFTER augmentation, from instance extents (dataset.py:496-510)
            # — one-pass native kernel (numpy fallback inside)
            from bridgeqa_tpu_torch import native

            sem_ok = np.isin(semantic_labels, self.dc.nyu40ids).astype(np.uint8)
            point_votes, point_votes_mask = native.compute_votes(
                point_cloud[:, :3], instance_labels.astype(np.int32), sem_ok
            )

            class_ind = [self.dc.nyu40id2class[int(x)] for x in instance_bboxes[:num_bbox, -2]]
            size_classes[:num_bbox] = class_ind
            size_residuals[:num_bbox] = target_bboxes[:num_bbox, 3:6] - self.dc.mean_size_arr[class_ind]

            if object_ids is not None:
                for i, gt_id in enumerate(instance_bboxes[:num_bbox, -1]):
                    if gt_id == object_ids[0]:
                        ref_box_label[i] = 1
                        ref_center_label = target_bboxes[i, 0:3]
                        ref_heading_class_label = angle_classes[i]
                        ref_heading_residual_label = angle_residuals[i]
                        ref_size_class_label = size_classes[i]
                        ref_size_residual_label = size_residuals[i]
        else:
            num_bbox = 1
            point_votes = np.zeros((self.num_points, 9))
            point_votes_mask = np.zeros(self.num_points)

        target_bboxes_semcls = np.zeros(MAX_NUM_OBJ)
        try:
            target_bboxes_semcls[:num_bbox] = [
                self.dc.nyu40id2class[int(x)] for x in instance_bboxes[:num_bbox, -2]
            ]
        except KeyError:
            pass

        object_name = None if object_names is None else object_names[0]
        object_cat = self.raw2label.get(object_name, 17)

        data = {
            "point_clouds": point_cloud.astype(np.float32),
            "center_label": target_bboxes[:, 0:3].astype(np.float32),
            "target_bboxes": target_bboxes[:, 0:6].astype(np.float32),
            "heading_class_label": angle_classes.astype(np.int32),
            "heading_residual_label": angle_residuals.astype(np.float32),
            "size_class_label": size_classes.astype(np.int32),
            "size_residual_label": size_residuals.astype(np.float32),
            "num_bbox": np.int32(num_bbox),
            "sem_cls_label": target_bboxes_semcls.astype(np.int32),
            "box_label_mask": target_bboxes_mask.astype(np.float32),
            "vote_label": point_votes.astype(np.float32),
            "vote_label_mask": point_votes_mask.astype(np.float32),
            "ref_box_label": ref_box_label.astype(np.int32),
            "ref_center_label": ref_center_label.astype(np.float32),
            "ref_heading_class_label": np.int32(ref_heading_class_label),
            "ref_heading_residual_label": np.float32(ref_heading_residual_label),
            "ref_size_class_label": np.int32(ref_size_class_label),
            "ref_size_residual_label": ref_size_residual_label.astype(np.float32),
            "object_cat": np.int32(object_cat),
            "ref_obj_mask": np.int32(object_ids is not None),
            "answer_cat": np.int32(answer_cat),
            "answer_cats": answer_cats,
            "answer_cat_scores": answer_cat_scores,
            "scene_id_str": scene_id,
            "question_id_str": str(rec["question_id"]),
            "question": question,
            "answers": "###".join(answers),
        }

        # --- text features
        if self.tokenizer is not None:
            qids, qmask = self.tokenizer.encode(question, self.question_len,
                                                first_token=self.tokenizer.enc_token_id)
            data["question_ids"] = qids
            data["question_mask"] = qmask
            if answers:
                pick = answers[rng.randint(len(answers))] if self.split == "train" else answers[0]
                aids, amask = self.tokenizer.encode(pick, self.answer_len,
                                                    first_token=self.tokenizer.bos_token_id)
                data["answer_ids"] = aids
                data["answer_mask"] = amask
        if self.glove is not None:
            tokens = question.replace("?", " ?").split()
            emb = np.zeros((MAX_TEXT_LEN, 300), dtype=np.float32)
            for i in range(min(len(tokens), MAX_TEXT_LEN)):
                emb[i] = self.glove.get(tokens[i].lower(), self.glove.get("unk", 0))
            data["lang_feat"] = emb
            data["lang_len"] = np.int32(min(len(tokens), MAX_TEXT_LEN))

        # --- question-conditioned view
        if self.view_lookup is not None:
            images, depths, poses = self.view_lookup(scene_id, str(rec["question_id"]))
            data["images"] = images.astype(np.float32)
            data["depths"] = depths.astype(np.float32)
            data["poses"] = poses.astype(np.float32)

        return data


def collate(samples):
    """Stack a list of sample dicts; string fields become lists."""
    out = {}
    for k in samples[0]:
        v0 = samples[0][k]
        if isinstance(v0, str):
            out[k] = [s[k] for s in samples]
        else:
            out[k] = np.stack([np.asarray(s[k]) for s in samples])
    return out


class WorkerError(RuntimeError):
    """A batch failed in a worker process; the message holds its traceback."""


class _SharedArray(tuple):
    """(name, shape, dtype) of an array a worker left in shared memory."""


def _to_shared(batch):
    """The batch with each array moved into a shared-memory block of its
    own: the parent then reads a small message, not the whole batch, through
    the queue's pipe, whose many small reads otherwise stall behind the
    training loop's thread on the interpreter lock. The block stays
    registered with the resource tracker until the parent unlinks it, so a
    batch that never reaches the parent is freed when the program ends."""
    from multiprocessing import shared_memory

    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            shm = shared_memory.SharedMemory(create=True, size=max(v.nbytes, 1))
            np.ndarray(v.shape, v.dtype, buffer=shm.buf)[...] = v
            out[k] = _SharedArray((shm.name, v.shape, v.dtype.str))
            shm.close()
        else:
            out[k] = v
    return out


def _from_shared(batch, keep=True):
    """Take a worker's batch out of shared memory (``keep=False``: only free
    it); every block is unlinked."""
    from multiprocessing import shared_memory

    out = {}
    for k, v in batch.items():
        if isinstance(v, _SharedArray):
            name, shape, dtype = v
            shm = shared_memory.SharedMemory(name=name)
            try:
                if keep:
                    view = np.ndarray(shape, np.dtype(dtype), buffer=shm.buf)
                    out[k] = view.copy()
                    del view
            finally:
                shm.close()
                shm.unlink()
        else:
            out[k] = v
    return out


def _proc_worker(dataset, task_q, out_q):
    """Batch-assembly worker process body: pull (gen, epoch, batch_idx,
    sample_idxs), build + collate, push (gen, batch_idx, batch) with the
    batch's arrays in shared memory (``_to_shared``), or (gen, batch_idx,
    WorkerError) when the batch raised, for the parent to raise.

    Exits via ``os._exit``, so that no atexit handler of the modules the
    child imported runs in it."""
    try:
        while True:
            task = task_q.get()
            if task is None:
                break
            gen, epoch, b, idxs = task
            try:
                if hasattr(dataset, "set_epoch"):
                    dataset.set_epoch(epoch)
                out = _to_shared(collate([dataset[int(i)] for i in idxs]))
            except Exception:  # noqa: BLE001 — reported to the parent, which raises it
                out = WorkerError(f"batch {b} failed in worker {os.getpid()}:\n"
                                  + traceback.format_exc())
            out_q.put((gen, b, out))
    except (KeyboardInterrupt, EOFError, BrokenPipeError):
        pass
    finally:
        out_q.cancel_join_thread()
        task_q.cancel_join_thread()
        os._exit(0)


class BatchIterator:
    """Shuffling, prefetched batch iterator with optional host sharding.

    Replaces torch DataLoader + DistributedSampler (``train.py:241-247``):
    ``shard(i, n)`` gives each host its contiguous slice; device placement
    happens in the training loop (``data/device_feed.py``).

    ``num_workers`` > 1 assembles whole batches in worker PROCESSES
    (the torch ``DataLoader(num_workers=N)`` role). Threads were measured
    GIL-bound on this workload (40k-point numpy per sample: 4 threads run
    *slower* than 1), so parallelism has to come from processes; each
    worker builds and collates a full batch, so the parent only unpickles.
    Workers start once (forked by the fork server; each receives the
    dataset pickled, so it must pickle) and persist across epochs. Batches are yielded
    in deterministic order (reorder buffer keyed on batch index) and the
    per-(seed, epoch, idx) dataset rng makes the content identical for any
    worker count in ``per_sample`` mode. A shared-stream dataset rng
    (``rng_mode="stream"``, the reference's global-np.random semantics) is
    position-dependent, so it forces the serial in-process path.
    """

    def __init__(self, dataset, batch_size, *, shuffle=True, seed=0, drop_last=True,
                 num_shards=1, shard_index=0, prefetch=2, num_workers=4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.prefetch = prefetch
        self.num_workers = num_workers
        self.epoch = 0
        self._procs = []
        self._task_q = None
        self._out_q = None
        self._gen = 0  # bumped per __iter__; stale worker outputs are dropped

    def __len__(self):
        n = len(self.dataset) // self.num_shards
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    # ---- process-pool management -------------------------------------
    def _ensure_procs(self, workers):
        alive = [p for p in self._procs if p.is_alive()]
        if len(alive) == workers and len(alive) == len(self._procs):
            return
        self.shutdown()
        import multiprocessing as mp

        from bridgeqa_tpu_torch import native

        native.available()  # build the vote library once, here, not in each worker
        ctx = mp.get_context("forkserver")
        ctx.set_forkserver_preload(["__main__", "bridgeqa_tpu_torch.data.pipeline",
                                    "bridgeqa_tpu_torch.data.sources"])
        self._task_q = ctx.Queue()
        # bound: every in-flight task can complete + the reorder margin
        self._out_q = ctx.Queue(maxsize=workers + max(2, self.prefetch) + 1)
        self._procs = [
            ctx.Process(target=_proc_worker, args=(self.dataset, self._task_q, self._out_q),
                        daemon=True)
            for _ in range(workers)
        ]
        for p in self._procs:
            p.start()

    def _drain(self):
        """Free the batches waiting in the output queue (a worker blocked on
        a full queue can then take its stop task)."""
        while True:
            try:
                _, _, batch = self._out_q.get(timeout=0.05)
            except (queue_mod.Empty, ValueError, OSError, EOFError):
                return
            if isinstance(batch, dict):
                _from_shared(batch, keep=False)

    def shutdown(self):
        """Stop worker processes (idempotent; also safe mid-epoch)."""
        if self._task_q is not None:
            try:
                for _ in self._procs:
                    self._task_q.put(None)
            except (ValueError, OSError):
                pass
        for p in self._procs:
            deadline = time.monotonic() + 5
            while p.is_alive() and time.monotonic() < deadline:
                if self._out_q is not None:
                    self._drain()
                p.join(timeout=0.05)
            if p.is_alive():
                p.terminate()
        if self._out_q is not None:
            self._drain()
        self._procs = []
        self._task_q = None
        self._out_q = None

    def __del__(self):
        try:
            self.shutdown()
        except Exception:
            pass

    # ---- iteration -----------------------------------------------------
    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        order = order[self.shard_index :: self.num_shards]
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self.epoch)
        epoch = self.epoch
        self.epoch += 1
        self._gen += 1
        gen = self._gen

        nb = len(order) // self.batch_size if self.drop_last else (len(order) + self.batch_size - 1) // self.batch_size

        workers = self.num_workers
        if workers > 1 and getattr(self.dataset, "rng_mode", "per_sample") == "stream":
            # a shared-stream dataset rng is position-dependent: parallel
            # assembly would change sample randomness; stay serial
            workers = 1
        if workers > 1:
            # process workers only help with spare cores: on a 1-2 core host
            # the pool pays IPC (pickle through a pipe) for no
            # parallelism and measures *slower* than the serial path
            workers = min(workers, max(1, (os.cpu_count() or 1) - 1))

        if workers > 1:
            self._ensure_procs(workers)
            task_q, out_q = self._task_q, self._out_q
            window = workers + max(2, self.prefetch)
            sem = threading.Semaphore(window)
            stop = threading.Event()

            def feeder():
                for b in range(nb):
                    sem.acquire()
                    if stop.is_set():
                        return
                    idxs = [int(i) for i in order[b * self.batch_size : (b + 1) * self.batch_size]]
                    task_q.put((gen, epoch, b, idxs))

            ft = threading.Thread(target=feeder, daemon=True)
            ft.start()
            pending = {}
            try:
                for want in range(nb):
                    while want not in pending:
                        try:
                            g, b, batch = out_q.get(timeout=1.0)
                        except queue_mod.Empty:
                            # a worker that died (at start-up, say) never answers
                            dead = [p.exitcode for p in self._procs if not p.is_alive()]
                            if dead:
                                raise WorkerError(f"a feed worker exited (codes {dead})")
                            continue
                        if isinstance(batch, WorkerError):
                            if g != gen:
                                continue
                            raise batch
                        if g != gen:  # stale batch from an abandoned epoch
                            _from_shared(batch, keep=False)
                            continue
                        pending[b] = _from_shared(batch)
                    yield pending.pop(want)
                    sem.release()
            finally:
                # abandoned mid-epoch: unblock + stop the feeder; stale
                # outputs are dropped by the next epoch's gen check
                stop.set()
                sem.release()
            return

        # serial path: one background thread builds while the main thread
        # consumes (enough overlap for stream-rng/golden runs)
        q = queue_mod.Queue(maxsize=self.prefetch)

        def worker():
            for b in range(nb):
                idxs = order[b * self.batch_size : (b + 1) * self.batch_size]
                q.put(collate([self.dataset[int(i)] for i in idxs]))
            q.put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            batch = q.get()
            if batch is None:
                return
            yield batch
