"""The feed's batches on the device (the counterpart of
``Solver._device_batch``, ``bridgeqa_tpu/train/solver.py:230-241``).

``device_batches`` turns each numpy batch of the feed into tensors in a host
thread of its own, pinned when the device is a CUDA card (as
``torch.utils.data.DataLoader``'s ``pin_memory`` does: the feed's worker
processes hand over plain numpy, since pinned memory does not cross a
process), and the caller's thread issues the copies with
``non_blocking=True``, so a copy waits for nothing on the host. String and
list fields (ids, questions, answers) stay on the host.
"""

import queue
import threading

import numpy as np
import torch

_END = object()


class _Failure:
    def __init__(self, error: BaseException):
        self.error = error


def host_tensors(batch: dict, pin: bool) -> dict:
    """The batch's numpy arrays as CPU tensors (pinned copies when ``pin``,
    else sharing the arrays' memory); other fields as they are."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(v)
            out[k] = t.pin_memory() if pin else t
        else:
            out[k] = v
    return out


def to_device(batch: dict, device: torch.device) -> dict:
    """Each tensor of ``batch`` copied to ``device`` without waiting on the
    host (the copy is asynchronous from pinned memory)."""
    return {k: v.to(device, non_blocking=True) if isinstance(v, torch.Tensor) else v
            for k, v in batch.items()}


def device_batches(batches, device, prefetch: int = 2):
    """Yield each batch of the iterable ``batches`` (dicts of numpy arrays
    and host fields) with its arrays as tensors on ``device``. A host thread
    pulls batches and makes their tensors (pinned for a CUDA device) up to
    ``prefetch`` ahead; an error there is raised here. Closing the generator
    (or leaving it) stops the thread and closes ``batches``' iterator before
    it returns, so the next epoch of the same loader starts alone."""
    device = torch.device(device)
    pin = device.type == "cuda"
    q = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def pinner():
        it = iter(batches)
        try:
            for batch in it:
                if not put(host_tensors(batch, pin)):
                    return
            put(_END)
        except BaseException as e:  # noqa: BLE001 — handed to the consumer, which raises it
            put(_Failure(e))
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    thread = threading.Thread(target=pinner, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, _Failure):
                raise item.error
            yield to_device(item, device)
    finally:
        stop.set()
        thread.join()
