"""Host utilities copied from ``gencomm_tpu/utils/misc_utils.py``."""

from __future__ import annotations

import zlib
from typing import Dict

import numpy as np


def cpm_size_bytes(payload: np.ndarray,
                   quantize: str | None = "float16") -> Dict[str, int]:
    """Cooperative-perception-message size: the raw and the zlib-deflated
    byte counts of the payload (fp16-quantized by default), one octet count
    per message."""
    arr = np.asarray(payload)
    if quantize == "float16":
        arr = arr.astype(np.float16)
    raw = arr.tobytes()
    return {"raw_bytes": len(raw),
            "compressed_bytes": len(zlib.compress(raw, 6))}


def code_stream_bytes(codes: np.ndarray, dict_size: int) -> Dict[str, int]:
    """A CodeFilling code-index stream's size, exactly: fixed-width packed
    bits (``raw_bytes``), the empirical Shannon bound (``entropy_bytes``)
    and a zlib pass over the packed stream (``compressed_bytes``)."""
    codes = np.asarray(codes).reshape(-1).astype(np.int64)
    n = codes.size
    bits_per_code = max(int(np.ceil(np.log2(max(dict_size, 2)))), 1)
    packed_bits = np.zeros(n * bits_per_code, np.uint8)
    for b in range(bits_per_code):
        packed_bits[b::bits_per_code] = (codes >> b) & 1
    packed = np.packbits(packed_bits).tobytes()
    hist = np.bincount(codes, minlength=dict_size).astype(np.float64)
    p = hist[hist > 0] / max(n, 1)
    entropy_bits = float(-(p * np.log2(p)).sum()) * n
    return {
        "raw_bytes": (n * bits_per_code + 7) // 8,
        "entropy_bytes": int(np.ceil(entropy_bits / 8)),
        "compressed_bytes": len(zlib.compress(packed, 6)),
    }
