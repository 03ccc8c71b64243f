"""Profiler of the port: parameters, FLOPs, latency, MFU and device traces.

Counterpart of ``gencomm_tpu/tools/profiler.py``:

    python -m gencomm_tpu_torch.tools.profiler --hypes_yaml <yaml> \
        [--model_dir <run>] [--train] [--half] [--by_module] \
        [--trace [DIR]] [--peak_tflops T] [--no_host_decorate] \
        [--device cuda|cpu]

``param_count`` counts a model's parameters. ``flop_count`` counts a
callable's operations in two parts: the library operators that
``torch.utils.flop_counter.FlopCounterMode`` sees (products and
convolutions), and the port's hand-written kernels, which it cannot see
(they are launched through ctypes): those are counted by formula from their
arguments (``KERNEL_OPS``), the same counts as the bound column of
``chip_smoke.py``'s kernel table, and the kernels' plain versions (which a
CPU tensor takes) are kept out of the library part. ``peak_flops_per_s``
looks the card up by ``torch.cuda.get_device_name()`` (H100 SXM: fp32
67e12, bf16 989e12; an unknown card raises unless a peak is given) and
``mfu`` divides the achieved rate by the peak of the dtype that ran.
``latency`` times a callable by CUDA events on a card (by the host clock on
the CPU, which is not a device time). ``trace_op_breakdown`` and
``trace_by_module`` read a ``torch.profiler`` session: the top operators by
device time, and the device time by model module (hooks open a
``record_function`` range per module; each operator's own kernels go to
the innermost range holding it).

The CLI profiles the eval frame of ``InferencePipeline`` (model, decode,
NMS) on a synthetic batch of the hypes' sampler: looped (``run``) and
streamed (``run_stream``, a CUDA graph) latency, FLOPs and MFU; ``--train``
a train step (ms/step, FLOPs, MFU, peak memory); TF32 off, as the port's
measurements run. ``--trace`` profiles streamed frames and captures the frame
graph anew, outside the profiler, right before its session (ROADMAP p9);
``--by_module`` profiles eager frames. Runs on ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import time

import torch

# peak rates of a card by name (NVIDIA data sheets, dense, at the full
# power limit): fp32 outside the tensor cores, bf16 on them; the first key
# in the card's name wins
PEAKS = (("H100 PCIe", {"fp32": 51e12, "bf16": 756e12}),
         ("H100", {"fp32": 67e12, "bf16": 989e12}))


def param_count(model) -> int:
    """The number of parameters (running statistics excluded, as the JAX
    tool counts the ``params`` collection)."""
    return sum(p.numel() for p in model.parameters())


def _deform_ops(x, offsets, weight, *_):
    """K1: per output pixel the 3x3 product, 2 * 9 * Cin * Cout, and each
    tap's bilinear sample, 8 operations a channel."""
    b, h, w, cin = x.shape
    return b * h * w * (2 * 9 * cin * weight.shape[-1] + 8 * 9 * cin)


def _deform_bwd_ops(x, offsets, weight, g, *_):
    """K1b: the input and weight gradients' products, 4 * 9 * Cin * Cout a
    pixel, and the taps' 24 operations a channel."""
    b, h, w, cin = x.shape
    return b * h * w * (4 * 9 * cin * weight.shape[-1] + 24 * 9 * cin)


def _warp_ops(src, *rest):
    """K3: a bilinear sample, 8 operations an output element (the pair
    entry warps its score map too)."""
    score = rest[0] if len(rest) == 2 else None
    return 8 * (src.numel() + (score.numel() if score is not None else 0))


def _splat_ops(dvals, feats, *_):
    """K4: each of the P x K selected depths times the C-wide feature,
    added into its cell."""
    return 2 * dvals.numel() * feats.shape[-1]


def _splat_bwd_ops(dvals, feats, *_):
    return 4 * dvals.numel() * feats.shape[-1]


def _canvas_ops(rows, *_):
    """K2 and K2b: one comparison a row element."""
    return rows.numel()


def _nms_ops(overlap, *_):
    """N1: one decision a pair of the (K, K) overlap matrix."""
    return overlap.numel()


# the hand-written kernels' dispatch functions (module, attribute) and the
# operations of a call from its arguments
KERNEL_OPS = {
    "deform_conv3x3": ("deform_conv", "deform_conv3x3_fwd", _deform_ops),
    "deform_conv3x3_bwd": ("deform_conv", "deform_conv3x3_bwd",
                           _deform_bwd_ops),
    "pillar_canvas": ("pillar_canvas", "pillar_canvas_fwd", _canvas_ops),
    "pillar_canvas_bwd": ("pillar_canvas", "pillar_canvas_bwd", _canvas_ops),
    "warp_affine": ("warp", "warp_affine_fwd", _warp_ops),
    "warp_affine_pair": ("warp", "warp_affine_pair_fwd", _warp_ops),
    "warp_affine_bwd": ("warp", "warp_affine_bwd", _warp_ops),
    "splat_topk": ("splat", "splat_topk_fwd", _splat_ops),
    "splat_topk_bwd": ("splat", "splat_topk_bwd", _splat_bwd_ops),
    "nms_closure": ("nms", "nms_closure", _nms_ops),
}


def kernel_ops(name: str, *args) -> int:
    """The operations of one call of hand-written kernel ``name`` on
    ``args`` (the dispatch function's arguments)."""
    return int(KERNEL_OPS[name][2](*args))


@contextlib.contextmanager
def count_hand_kernels():
    """Within the block, every call of a hand-written kernel's dispatch
    function adds its operations to the yielded tally ({name: {"calls",
    "flops"}}), and runs with the dispatch modes off, so that a flop
    counter does not also count the plain version a CPU tensor takes."""
    import importlib

    from torch.utils._python_dispatch import _disable_current_modes

    tally = collections.defaultdict(lambda: {"calls": 0, "flops": 0})
    saved = []
    for name, (mod, attr, ops) in KERNEL_OPS.items():
        module = importlib.import_module(f"gencomm_tpu_torch.ops.{mod}")
        real = getattr(module, attr)

        def counted(*args, _real=real, _name=name, _ops=ops, **kw):
            tally[_name]["calls"] += 1
            tally[_name]["flops"] += int(_ops(*args))
            with _disable_current_modes():
                return _real(*args, **kw)

        saved.append((module, attr, real))
        setattr(module, attr, counted)
    try:
        yield tally
    finally:
        for module, attr, real in saved:
            setattr(module, attr, real)


def flop_count(fn, *args) -> dict:
    """FLOPs of one call ``fn(*args)``: {"library": the operators
    FlopCounterMode sees, "hand_kernels": the hand-written kernels by
    formula, "by_kernel": their calls and FLOPs, "total"}."""
    from torch.utils.flop_counter import FlopCounterMode

    with count_hand_kernels() as tally, \
            FlopCounterMode(display=False) as counter:
        fn(*args)
    library = int(counter.get_total_flops())
    hand = sum(v["flops"] for v in tally.values())
    return {"library": library, "hand_kernels": hand,
            "by_kernel": {k: dict(v) for k, v in sorted(tally.items())},
            "total": library + hand}


def peak_flops_per_s(dtype: str = "fp32", device_name: str | None = None,
                     peak_tflops: float | None = None) -> float:
    """The card's peak rate for ``dtype`` ("fp32" or "bf16"): ``peak_tflops``
    if given, else looked up by the card's name; an unknown card raises."""
    if peak_tflops:
        return float(peak_tflops) * 1e12
    name = device_name or torch.cuda.get_device_name()
    for key, rates in PEAKS:
        if key in name:
            return rates[dtype]
    raise ValueError(f"no peak rate known for {name!r}: pass --peak_tflops")


def mfu(flops: float | None, latency_s: float, peak: float) -> float | None:
    """Model FLOPs utilization: the achieved rate over ``peak``."""
    if not flops or not latency_s:
        return None
    return flops / latency_s / peak


def latency(fn, *args, iters: int = 20, device=None) -> dict:
    """The first call's seconds (builds, captures) and the steady-state
    ms a call over ``iters`` calls: by CUDA events on a card, by the host
    clock on the CPU (``device`` names where it ran)."""
    device = torch.device(device or "cpu")
    t0 = time.perf_counter()
    fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    first_s = time.perf_counter() - t0
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / iters
        where = torch.cuda.get_device_name(device)
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        ms = (time.perf_counter() - t0) * 1e3 / iters
        where = "cpu (host clock)"
    return {"first_s": first_s, "latency_ms": ms,
            "throughput_fps": 1e3 / ms, "device": where}


def _profile(fn, iters: int, device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    return prof


def _device_us(evt, on_cuda: bool) -> float:
    if on_cuda:
        return float(getattr(evt, "self_device_time_total", 0.0)
                     or getattr(evt, "self_cuda_time_total", 0.0))
    return float(evt.self_cpu_time_total)


def trace_op_breakdown(fn, iters: int = 5, trace_dir: str | None = None,
                       top: int = 20, device=None) -> list:
    """The top operators and kernels by device time (CPU time on the CPU)
    over ``iters`` calls of ``fn()``: [(us a call, calls a call, name)].
    ``trace_dir``: a Chrome trace is written there."""
    on_cuda = torch.device(device or "cpu").type == "cuda"
    prof = _profile(fn, iters, device or "cpu")
    if trace_dir:
        import os

        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    rows = sorted(((_device_us(e, on_cuda) / iters, e.count // iters, e.key)
                   for e in prof.key_averages()), reverse=True)[:top]
    rows = [r for r in rows if r[0] > 0]
    print(f"top operators by {'device' if on_cuda else 'CPU'} time:")
    for us, n, name in rows:
        print(f"  {us:>10.1f} us/call x{n:<5} {name[:80]}")
    return rows


def trace_by_module(model, fn, iters: int = 5, depth: int = 2,
                    top: int = 25, device=None) -> list:
    """Device time (CPU time on the CPU) by model module over ``iters``
    calls of ``fn()``: every module at ``depth`` (and every shallower leaf)
    opens a ``record_function`` range named by its path, and each operator's
    own device time (its kernels', its child operators' left out) goes to
    the innermost range that holds it, so every kernel is counted once.
    Returns [(us a call, share, path)]; what no range holds is reported as
    unattributed."""
    on_cuda = torch.device(device or "cpu").type == "cuda"
    prefix = "module::"
    handles, opened = [], {}
    for path, mod in model.named_modules():
        d = path.count(".") + 1 if path else 0
        if not path or d > depth or (d < depth and list(mod.children())):
            continue

        def pre(m, a, _path=path):
            rf = torch.autograd.profiler.record_function(prefix + _path)
            rf.__enter__()
            opened.setdefault(_path, []).append(rf)

        def post(m, a, out, _path=path):
            opened[_path].pop().__exit__(None, None, None)

        handles.append(mod.register_forward_pre_hook(pre))
        handles.append(mod.register_forward_hook(post))
    try:
        prof = _profile(fn, iters, device or "cpu")
    finally:
        for h in handles:
            h.remove()
    agg, total = collections.Counter(), 0.0
    for e in prof.events():
        if e.name.startswith(prefix) or (
                on_cuda and str(e.device_type).endswith("CUDA")):
            continue
        own = float(_device_us(e, on_cuda))
        if not own:
            continue
        total += own
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith(prefix):
            parent = parent.cpu_parent
        agg[parent.name[len(prefix):] if parent is not None
            else "<unattributed>"] += own
    if not total:
        print("no time in the trace; no per-module breakdown")
        return []
    rows = [(us / iters, us / total, path) for path, us in agg.most_common(top)]
    print(f"{'device' if on_cuda else 'CPU'} total {total / iters:.0f} "
          f"us/call, by module (unattributed "
          f"{agg.get('<unattributed>', 0.0) / total * 100:.0f}%):")
    for us, share, path in rows:
        print(f"  {us:>9.0f} us  {share * 100:5.1f}%  {path}")
    return rows


def _setup(args):
    """The hypes, model (random weights from seed 0, or the run's
    checkpoint), pipeline and one decorated batch on the device."""
    from gencomm_tpu_torch import resolve_device
    from gencomm_tpu_torch.config.yaml_utils import load_yaml
    from gencomm_tpu_torch.data.bucketing import trim_agent_slots
    from gencomm_tpu_torch.data.postprocessor import generate_anchor_box
    from gencomm_tpu_torch.models import create_model
    from gencomm_tpu_torch.pipeline import InferencePipeline, batch_to_device
    from gencomm_tpu_torch.tools.train import build_dataset
    from gencomm_tpu_torch.train import checkpoint
    from gencomm_tpu_torch.weights import random_state_dict

    device = resolve_device(args.device)
    hypes = load_yaml(args.hypes_yaml, args.model_dir)
    if args.half:
        hypes["model"]["args"]["half"] = True
    model = create_model(hypes, device=device)
    ckpt = (checkpoint.latest_checkpoint(args.model_dir)
            if args.model_dir else None)
    if ckpt:
        model.load_state_dict(checkpoint.load_into(
            model.state_dict(), checkpoint.load_checkpoint(ckpt)["state_dict"]))
    else:
        model.load_state_dict(random_state_dict(model, 0))
    pipe = InferencePipeline(model, generate_anchor_box(
        hypes["postprocess"]["anchor_args"],
        hypes["postprocess"].get("order", "hwl")), hypes["postprocess"],
        device=device)
    dataset = build_dataset(hypes, args.train, args.dataset)
    host = trim_agent_slots(dataset.sample(0, args.batch),
                            buckets=model.agent_buckets)
    if not args.no_host_decorate:
        host = pipe.decorate(host)
    return hypes, model, pipe, host, batch_to_device(host, device), device


def profile_eval(model, pipe, host, batch, device, iters: int = 20,
                 dtype: str = "fp32", peak_tflops: float | None = None
                 ) -> dict:
    """The eval frame's params, FLOPs, looped and streamed latency and MFU
    (MFU only on a card, or with ``peak_tflops``)."""
    gen = torch.Generator(device=device)

    def frame():
        with torch.inference_mode():
            return pipe._frame(batch, generator=gen.manual_seed(0))

    flops = flop_count(frame)
    looped = latency(lambda: pipe.run(batch, seed=0), iters=iters,
                     device=device)
    frames = {k: v[None].expand((iters,) + tuple(v.shape))
              for k, v in batch.items()}
    seeds = list(range(iters))
    streamed = latency(lambda: pipe.run_stream(frames, seeds), iters=1,
                       device=device)
    streamed["latency_ms"] /= iters
    streamed["throughput_fps"] = 1e3 / streamed["latency_ms"]
    result = {"params": param_count(model), "flops": flops,
              "looped": looped, "streamed": streamed, "dtype": dtype}
    peak = None
    if torch.device(device).type == "cuda" or peak_tflops:
        peak = peak_flops_per_s(dtype, peak_tflops=peak_tflops)
    result["peak_flops_per_s"] = peak
    for key in ("looped", "streamed"):
        result[key]["mfu"] = (mfu(flops["total"],
                                  result[key]["latency_ms"] / 1e3, peak)
                              if peak else None)
    return result


def profile_train(hypes, model, host, device, iters: int = 10,
                  peak_tflops: float | None = None) -> dict:
    """A train step's FLOPs (forward and backward), ms/step by CUDA
    events, MFU and peak device memory."""
    from gencomm_tpu_torch.loss import create_loss
    from gencomm_tpu_torch.pipeline import batch_to_device
    from gencomm_tpu_torch.train import trainer

    batch = batch_to_device(host, device)
    opt, sched = trainer.make_optimizer(hypes, model.named_parameters())
    step = trainer.make_train_step(model, create_loss(hypes), opt, sched)
    gen = torch.Generator(device=device)
    flops = flop_count(lambda: step(batch, generator=gen.manual_seed(0)))
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    lat = latency(lambda: step(batch, generator=gen), iters=iters,
                  device=device)
    peak = (peak_flops_per_s("fp32", peak_tflops=peak_tflops)
            if torch.device(device).type == "cuda" or peak_tflops else None)
    out = {"flops": flops, "step": lat,
           "mfu": mfu(flops["total"], lat["latency_ms"] / 1e3, peak)
           if peak else None}
    if torch.device(device).type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    model.eval()
    return out


def _print_flops(label, flops):
    parts = ", ".join(f"{k} {v['calls']} calls {v['flops'] / 1e9:.3f} G"
                      for k, v in flops["by_kernel"].items())
    print(f"{label} FLOPs: {flops['total'] / 1e9:.3f} G = library operators "
          f"{flops['library'] / 1e9:.3f} G (FlopCounterMode) + hand kernels "
          f"{flops['hand_kernels'] / 1e9:.3f} G ({parts or 'none'})")


def _fresh_capture(pipe, batch):
    """The frame graph captured anew, outside any profiler session."""
    pipe.graphs.clear()
    frames = {k: v[None] for k, v in batch.items()}
    pipe.run_stream(frames, [0])
    return frames


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_dir", default=None)
    parser.add_argument("--hypes_yaml", default=None)
    parser.add_argument("--dataset", default="synthetic",
                        choices=["synthetic"])
    parser.add_argument("--iters", type=int, default=20,
                        help="calls timed a latency, and calls traced")
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--half", action="store_true",
                        help="bf16 activations; MFU against the bf16 peak")
    parser.add_argument("--train", action="store_true",
                        help="also profile a train step")
    parser.add_argument("--by_module", action="store_true",
                        help="device time by model module")
    parser.add_argument("--trace", default=None, nargs="?", const="",
                        help="the top operators by device time; optional "
                             "value: a directory for the Chrome trace")
    parser.add_argument("--peak_tflops", type=float, default=None,
                        help="the card's peak TFLOP/s for MFU (default: by "
                             "the card's name; an unknown card raises)")
    parser.add_argument("--no_host_decorate", action="store_true",
                        help="raw points to the device (the pillar "
                             "encoders' raw-point path)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if not (args.hypes_yaml or args.model_dir):
        raise SystemExit("--hypes_yaml or --model_dir is required")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    hypes, model, pipe, host, batch, device = _setup(args)
    on_card = device.type == "cuda"
    if on_card and not args.peak_tflops:
        peak_flops_per_s("bf16" if args.half else "fp32")  # raises if unknown
    n = param_count(model)
    print(f"total params: {n / 1e6:.3f} M")
    for name, mod in model.named_children():
        print(f"  {name:32s} {param_count(mod) / 1e6:8.3f} M")
    dtype = "bf16" if args.half else "fp32"
    res = profile_eval(model, pipe, host, batch, device, args.iters, dtype,
                       args.peak_tflops)
    _print_flops("eval frame", res["flops"])
    for key in ("looped", "streamed"):
        r = res[key]
        m = (f", MFU {r['mfu'] * 100:.3f}% of {res['peak_flops_per_s'] / 1e12:.0f}"
             f" TFLOP/s ({dtype})" if r["mfu"] is not None
             else ", MFU not measured (no card)")
        print(f"{key}: {r['latency_ms']:.3f} ms/frame "
              f"({r['throughput_fps']:.1f} frames/s) on {r['device']}{m}")
    gen = torch.Generator(device=device)
    if args.trace is not None:
        frames = _fresh_capture(pipe, batch)
        trace_op_breakdown(lambda: pipe.run_stream(frames, [0]),
                           iters=args.iters, trace_dir=args.trace or None,
                           device=device)
    if args.by_module:
        # eager frames: no graph is replayed in this session

        def eager():
            with torch.inference_mode():
                pipe._frame(batch, generator=gen.manual_seed(0))
        res["by_module"] = trace_by_module(model, eager, iters=args.iters,
                                           device=device)
    if args.train:
        tres = profile_train(hypes, model, host, device,
                             max(args.iters // 2, 3), args.peak_tflops)
        _print_flops("train step", tres["flops"])
        mem = (f", peak device memory {tres['peak_bytes'] / 2 ** 20:.0f} MiB"
               if "peak_bytes" in tres else "")
        m = (f", MFU {tres['mfu'] * 100:.3f}% (fp32)"
             if tres["mfu"] is not None else "")
        print(f"train step: {tres['step']['latency_ms']:.3f} ms/step on "
              f"{tres['step']['device']}{m}{mem}")
        res["train"] = tres
    print(json.dumps({"params": n, "flops": res["flops"]["total"],
                      "flops_library": res["flops"]["library"],
                      "flops_hand_kernels": res["flops"]["hand_kernels"],
                      "looped_ms": res["looped"]["latency_ms"],
                      "streamed_ms": res["streamed"]["latency_ms"],
                      "mfu_streamed": res["streamed"]["mfu"],
                      "train_ms": res.get("train", {}).get(
                          "step", {}).get("latency_ms"),
                      "train_mfu": res.get("train", {}).get("mfu"),
                      "device": res["looped"]["device"], "dtype": dtype}))
    return res


if __name__ == "__main__":
    main()
