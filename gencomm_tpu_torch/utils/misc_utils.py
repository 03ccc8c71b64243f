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
