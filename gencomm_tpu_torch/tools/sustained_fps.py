"""Sustained frames a second: the host pipeline, the device, and both
overlapped.

Counterpart of ``gencomm_tpu/tools/sustained_fps.py``:

    python -m gencomm_tpu_torch.tools.sustained_fps -y <yaml> [--frames N] \
        [--batch_size B] [--workers N] [--half] [--device cuda|cpu]

For one config it reports, as one JSON line:
  host_items_per_s   the host pipeline alone (sampling, labels and the C++
                     pillar decoration);
  device_fps         the model's forward alone on a batch already on the
                     device, by CUDA events (by the host clock on the CPU,
                     which is not a device time);
  sustained_fps      the two together: the host pipeline on a prefetch
                     thread (``data/prefetch.py``, depth 2) or ``--workers``
                     spawned processes, the device taking each batch as it
                     comes (host clock, ending in a synchronize).
The model has seeded random weights. Runs on ``cuda`` unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import functools
import json
import time

import torch

from gencomm_tpu_torch import resolve_device


def host_batches(hypes: dict, batch_size: int, seed: int, worker: int = 0):
    """The host pipeline's batches: synthetic samples, pillar modalities
    decorated on the host (a module-level function, so that a worker
    process can be sent it)."""
    from gencomm_tpu_torch.data.decorate import HostDecoration
    from gencomm_tpu_torch.tools.train import batches, build_dataset

    dataset = build_dataset(hypes, True, "synthetic")
    decorate = HostDecoration(hypes)
    for host in batches(dataset, batch_size, seed * 100 + worker,
                        "synthetic"):
        yield decorate(host)


def sustained(hypes: dict, frames: int = 60, batch_size: int = 1,
              workers: int = 0, device=None) -> dict:
    from gencomm_tpu_torch.data.prefetch import multi_worker_iter, prefetch_iter
    from gencomm_tpu_torch.models import create_model
    from gencomm_tpu_torch.pipeline import batch_to_device
    from gencomm_tpu_torch.tools.profiler import latency
    from gencomm_tpu_torch.weights import random_state_dict

    device = resolve_device(device)
    # the host pipeline alone; its first batch may pay one-time set-up
    it = host_batches(hypes, batch_size, 0)
    host = next(it)
    t0 = time.perf_counter()
    for _ in range(frames):
        host = next(it)
    host_rate = frames * batch_size / (time.perf_counter() - t0)

    model = create_model(hypes, device=device)
    model.load_state_dict(random_state_dict(model, 0))
    gen = torch.Generator(device=device)

    def forward(batch):
        with torch.inference_mode():
            return model(batch, generator=gen.manual_seed(0))["cls_preds"]

    dbatch = batch_to_device(host, device)
    dev = latency(lambda: forward(dbatch), iters=frames, device=device)

    if workers > 0:
        src = multi_worker_iter(functools.partial(
            host_batches, hypes, batch_size, 1), workers)
    else:
        src = prefetch_iter(host_batches(hypes, batch_size, 1), depth=2)
    try:
        forward(batch_to_device(next(src), device))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(frames):
            forward(batch_to_device(next(src), device))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        rate = frames * batch_size / (time.perf_counter() - t0)
    finally:
        src.close()
    return {"host_items_per_s": host_rate,
            "device_fps": batch_size * dev["throughput_fps"],
            "sustained_fps": rate, "workers": workers,
            "batch_size": batch_size, "device": dev["device"]}


def main(argv=None) -> dict:
    from gencomm_tpu_torch.config.yaml_utils import load_yaml

    parser = argparse.ArgumentParser()
    parser.add_argument("--hypes_yaml", "-y", required=True)
    parser.add_argument("--dataset", default="synthetic",
                        choices=["synthetic"])
    parser.add_argument("--frames", type=int, default=60)
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--workers", type=int, default=0,
                        help="the host pipeline in N spawned processes")
    parser.add_argument("--half", action="store_true",
                        help="bf16 activations")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    hypes = load_yaml(args.hypes_yaml)
    if args.half:
        hypes["model"]["args"]["half"] = True
    res = dict(config=args.hypes_yaml, **sustained(
        hypes, args.frames, args.batch_size, args.workers, args.device))
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
