"""Latency and parameters of the modules each heterogeneous method adds.

Counterpart of ``gencomm_tpu/tools/inference_time.py``:

    python -m gencomm_tpu_torch.tools.inference_time [--hw H W] [--ch C] \
        [--iters N] [--device cuda|cpu]

Times, on a BEV feature of (2, H, W, C) (default 64 x 128 x 128), the
modules GenComm adds (the message extractor, kernel K1, and the 3-step
diffusion), MPDA's (the learnable resizer and the cross-domain encoder),
CodeFilling's (the UMGM quantizer) and STAMP's (a ConvNeXt adapter), each
with seeded random weights, over a pool of distinct inputs; ms a call by
CUDA events on a card (by the host clock on the CPU, which is not a device
time), and parameters in M. Prints one JSON object. Runs on ``cuda`` unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json

import torch

from gencomm_tpu_torch import resolve_device
from gencomm_tpu_torch.tools.profiler import latency, param_count
from gencomm_tpu_torch.weights import random_state_dict


def _pool(shape, n: int, device, seed: int):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).to(device) for _ in range(n)]


def _timed(module, fn, pool, iters: int, device) -> dict:
    module.load_state_dict(random_state_dict(module, 0))
    module.to(device).eval()
    it = iter(range(10 ** 9))

    def call():
        with torch.inference_mode():
            return fn(pool[next(it) % len(pool)])

    lat = latency(call, iters=iters, device=device)
    return {"ms": lat["latency_ms"], "params_M": param_count(module) / 1e6,
            "device": lat["device"]}


def added_modules(h: int = 64, w: int = 128, c: int = 128, iters: int = 20,
                  device=None) -> dict:
    """{module: {"ms", "params_M", "device"}} for the methods' added
    modules on a (2, h, w, c) feature."""
    from gencomm_tpu_torch.models.codebook import UMGMQuantizer
    from gencomm_tpu_torch.models.gencomm.diffusion import GenCommDiffusion
    from gencomm_tpu_torch.models.gencomm.message_extractor import (
        MessageExtractor,
    )
    from gencomm_tpu_torch.models.mpda import (
        CrossDomainFusionEncoder, LearnableResizer,
    )
    from gencomm_tpu_torch.models.stamp import StampAdapter

    device = resolve_device(device)
    n = max(iters, 8)
    feats = _pool((2, h, w, c), n, device, 0)
    msgs = _pool((2, h, w, 2), n, device, 1)
    res = {}
    me = MessageExtractor(c, 2)
    res["gencomm_message_extractor"] = _timed(me, me, feats, iters, device)
    gc = GenCommDiffusion(feat_ch=c, msg_ch=2, num_timesteps=3)
    gen = torch.Generator(device=device)
    res["gencomm_diffusion"] = _timed(
        gc, lambda x: gc(x, msgs[0], generator=gen.manual_seed(1)), feats,
        iters, device)
    rs = LearnableResizer(c, c, wg_depth=1, window_size=8)
    res["mpda_resizer"] = _timed(rs, lambda x: rs(x, x), feats, iters, device)
    cdt = CrossDomainFusionEncoder(c, depth=1, window_size=8)
    res["mpda_cdt"] = _timed(cdt, lambda x: cdt(x, x), feats, iters, device)
    q = UMGMQuantizer(c, 2, (64, 64, 64))
    flat = [f.reshape(-1, c) for f in feats]
    res["codefilling_quantizer"] = _timed(q, q, flat, iters, device)
    rng = (-51.2, -25.6, -3.0, 51.2, 25.6, 1.0)
    # the JAX tool's block (``depth`` is read by neither package: 3 blocks)
    # at the feature's width
    ad = StampAdapter.from_config(
        {"core_method": "adapterconvnext",
         "args": {"depth": 1, "in_channels": c, "out_channels": c}}, rng, rng)
    res["stamp_adapter"] = _timed(ad, lambda x: ad(x, (h, w)), feats, iters,
                                  device)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hw", type=int, nargs=2, default=(64, 128),
                    help="BEV feature H W")
    ap.add_argument("--ch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    res = added_modules(args.hw[0], args.hw[1], args.ch, args.iters,
                        args.device)
    print(json.dumps(res, indent=2))
    return res


if __name__ == "__main__":
    main()
