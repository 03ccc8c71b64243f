"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (``build/kernels/lib<name>.so`` beside the
package) and bound with ctypes. A library is built at first use, or again
when its source or any shared header (``csrc/*.cuh``) is newer;
``build_all`` starts one ``nvcc`` per source at once. Nothing is built while
a module is imported.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# C entry points: name -> (symbol, argument types[, source]); the source is
# csrc/<source>.cu, by default csrc/<name>.cu; every entry returns
# cudaError_t
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "deform_conv": ("deform_conv3x3_f32",
                    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "deform_conv_bf16": ("deform_conv3x3_bf16",
                         [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
                         "deform_conv"),
    "pillar_canvas": ("pillar_canvas_bf16", [_P, _P, _P, _L, _L, _I, _I, _I, _P]),
    "warp_affine": ("warp_affine_f32", [_P, _P, _P, _I, _I, _I, _I, _P]),
    "warp_affine_bf16": ("warp_affine_bf16", [_P, _P, _P, _I, _I, _I, _I, _P],
                         "warp_affine"),
    "warp_affine_pair": ("warp_affine_pair_f32",
                         [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
                         "warp_affine"),
    "deform_conv_bwd": ("deform_conv3x3_bwd_f32",
                        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, _I, _P]),
    "pillar_canvas_bwd": ("pillar_canvas_bwd_bf16",
                          [_P, _P, _P, _P, _P, _P, _L, _L, _I, _I, _I, _P]),
    "warp_affine_bwd": ("warp_affine_bwd_f32",
                        [_P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "splat_topk": ("splat_topk_f32",
                   [_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P]),
    "splat_topk_bwd": ("splat_topk_bwd_f32",
                       [_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _P]),
    "nms_closure": ("nms_closure", [_P, _P, _P, _P, _I, _P]),
}

_loaded: dict = {}
build_log: dict = {}  # name -> nvcc's output (ptxas register/smem report)
# kernel launches per wrapper, counted where each wrapper launches its kernel
LAUNCHES = {"deform_conv3x3": 0, "deform_conv3x3_bf16": 0,
            "pillar_canvas": 0, "warp_affine": 0, "warp_affine_bf16": 0,
            "deform_conv3x3_bwd": 0, "pillar_canvas_bwd": 0,
            "warp_affine_bwd": 0, "splat_topk": 0, "splat_topk_bwd": 0,
            "nms_closure": 0}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def source(name: str) -> str:
    """The source (``csrc/<source>.cu``) that holds entry ``name``."""
    sig = SIGNATURES[name]
    return sig[2] if len(sig) > 2 else name


def _paths(src: str):
    return (os.path.join(CSRC_DIR, f"{src}.cu"),
            os.path.join(BUILD_DIR, f"lib{src}.so"))


def _stale(name: str) -> bool:
    src, so = _paths(name)
    if not os.path.exists(so):
        return True
    headers = [os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
               if f.endswith(".cuh")]
    return os.path.getmtime(so) < max(os.path.getmtime(f)
                                      for f in [src, *headers])


def build_all(names=None) -> float:
    """Compile the sources of the named entries (default: all) in parallel,
    one nvcc a source; returns the wall seconds taken. Raises with nvcc's
    output if any build fails."""
    names = [n for n in dict.fromkeys(source(e) for e in (names or SIGNATURES))
             if _stale(n)]
    t0 = time.perf_counter()
    if not names:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in names:
        src, so = _paths(n)
        tmp = f"{so}.{os.getpid()}.tmp"
        procs[n] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, so)
    failed = []
    for n, (proc, tmp, so) in procs.items():
        log, _ = proc.communicate()
        build_log[n] = log
        if proc.returncode != 0:
            failed.append(f"--- {n} (exit {proc.returncode})\n{log}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str):
    """The ctypes function of kernel ``name``, built on first use."""
    fn = _loaded.get(name)
    if fn is None:
        build_all([name])
        lib = ctypes.CDLL(_paths(source(name))[1])
        sym, argtypes = SIGNATURES[name][:2]
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn


def launch(name: str, *args) -> None:
    """Call kernel ``name`` on PyTorch's current stream; raise on a CUDA
    error reported by the launch."""
    fn = library(name)
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")


def check_cuda_tensor(t: torch.Tensor, name: str, dtype, shape=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (or of
    one of the types of a tuple ``dtype``; and ``shape`` where given)."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be {' or '.join(map(str, dtypes))}, "
                         f"got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
