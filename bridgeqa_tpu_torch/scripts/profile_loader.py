"""Data-feed throughput: can the loader keep the card fed? (counterpart of
``scripts/profile_loader.py``)

The reference's known input bottleneck is ``ScannetQADataset``: multi-GB
scene loads and per-sample numpy work inside ``__getitem__``
(``lib/dataset.py:155-816``), overlapped only by ``DataLoader`` workers.
This measures the port's counterpart, ``data/pipeline.BatchIterator`` (worker
processes, prefetch, the native C++ vote kernel), at production settings
(40k-point sampling, box-consistent augmentation, votes after augmentation,
the 480x480 view) and reports samples/s, to set beside the train step's
rate. Each batch is placed on ``--device`` as the train loop places it
(``data/device_feed.device_batches``); the card by default, and without one
it raises.

Synthetic scenes stand in for the ScanNet npys: the per-sample numpy work
(sampling, augmentation, vote build, tokenize) is the production path; only
the disk and jpeg-decode cost of real data is absent (the 480^2 view is
drawn from numpy's generator).

Usage: python -m bridgeqa_tpu_torch.scripts.profile_loader [--batch 16] [--num_workers 4]
Prints one JSON line.
"""

import argparse
import json
import os
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--num_workers", type=int, default=4)
    ap.add_argument("--num_points", type=int, default=40000)
    ap.add_argument("--image_size", type=int, default=480)
    ap.add_argument("--min_samples", type=int, default=192,
                    help="measure until at least this many samples drawn")
    ap.add_argument("--device", type=str, default="cuda")
    cli = ap.parse_args(argv)

    from bridgeqa_tpu_torch.data.device_feed import device_batches
    from bridgeqa_tpu_torch.data.pipeline import BatchIterator
    from bridgeqa_tpu_torch.scripts import common
    from bridgeqa_tpu_torch.scripts import train as train_script

    device = common.resolve_device(cli.device)
    args = train_script.parse_args([
        "--synthetic", "--batch_size", str(cli.batch),
        # long synthetic epochs: the production ScanQA train split is ~25k
        # samples, so steady-state (not epoch-restart) throughput is the
        # representative number
        "--synthetic_records", str(max(cli.min_samples * 2, 256)),
        "--num_points", str(cli.num_points), "--image_size", str(cli.image_size),
        "--num_workers", str(cli.num_workers),
    ])
    datasets, _, _, _ = common.build_datasets(args, splits=("train",))
    ds = datasets["train"]

    loader = BatchIterator(ds, cli.batch, shuffle=True, seed=0, num_workers=cli.num_workers)
    try:
        # one batch first: starts the workers and fills the scene caches
        feed = device_batches(loader, device)
        warm = next(feed)
        n_keys = len(warm)
        feed.close()

        drawn = 0
        t0 = time.perf_counter()
        while drawn < cli.min_samples:
            feed = device_batches(loader, device)
            for batch in feed:
                drawn += len(batch["scene_id_str"])
                if drawn >= cli.min_samples:
                    break
            feed.close()
        if device.type == "cuda":
            import torch

            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
    finally:
        loader.shutdown()
    sps = drawn / dt

    print(json.dumps({
        "metric": "loader samples/sec (feed to the device, synthetic scenes)",
        "samples_per_sec": round(sps, 2),
        "batch": cli.batch,
        "num_workers": cli.num_workers,
        "host_cpus": os.cpu_count(),
        "num_points": cli.num_points,
        "image_size": cli.image_size,
        "batch_keys": n_keys,
        "device": str(device),
        "note": "production __getitem__ path (40k sampling, augmentation, native "
                "vote kernel, 480^2 view, tokenize) and the copy to the device; synthetic "
                "scenes, so real disk/jpeg decode is excluded and the view is RNG-generated",
    }))
    return sps


if __name__ == "__main__":
    main()
