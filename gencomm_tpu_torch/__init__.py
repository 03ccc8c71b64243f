"""PyTorch and CUDA port of gencomm_tpu, for NVIDIA Hopper (H100).

The package mirrors the layout of ``gencomm_tpu`` module by module. It
imports ``torch`` and numpy, never JAX and never ``gencomm_tpu``. Tensors at
public functions are NHWC, as in the JAX package.

Entry points run on the card unless the caller passes ``device="cpu"``;
with no device given and no CUDA device present they raise.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless one is given; a
    CUDA device, asked for or by default, must be present."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return device
