"""The precision of K1 bf16's split product, emulated on the CPU.

K1's tensor-core route on a bf16 map (``csrc/deform_conv.cu``, ``band::``)
blends each sample in fp32, splits it once into bf16 hi = rn(s) and lo =
rn(s - hi), splits the fp32 weights the same way, and takes hi*hi + hi*lo +
lo*hi on the bf16 tensor cores with fp32 sums. Here that product is
emulated in PyTorch on seeded numpy inputs, at the two bf16 eval shapes with
the tensor-core route's channels (128 -> 64) and at a small shape, and held
against the fp32 contraction of the plain version
(``deform_conv3x3_plain`` on the widened map): the deviation stays below
1e-5 of the output's largest value, and the outputs whose bf16 rounding it
flips (under 1%) each move by at most one bf16 step (taken at no less than
2^-8 of the largest value). One bf16 pass (hi*hi alone) does not come
close. The package itself carries no emulation: the kernel runs only on the
card, where ``test_torch_kernels.py`` and ``chip_smoke.py`` hold it.
"""

import numpy as np
import pytest
import torch

from chip_smoke import bf16_step
from gencomm_tpu_torch.ops.deform_conv import (
    MAX_OFFSET, _corners, _geometry, deform_conv3x3_plain, kernel_route,
)


def _inputs(seed, b, h, w, cin, cout):
    """A bf16-representable map, offsets within the clamp, fp32 weights."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, h, w, cin).astype(np.float32))
    off = (rng.randn(b, h, w, 18) * 1.5).clip(-MAX_OFFSET, MAX_OFFSET)
    wt = (rng.randn(3, 3, cin, cout) * 0.05).astype(np.float32)
    return (x.to(torch.bfloat16).float(), torch.from_numpy(off.astype(np.float32)),
            torch.from_numpy(wt))


def _samples(x, offsets):
    """The fp32 samples (B*H*W, 9*Cin) that the plain version contracts."""
    b, h, w, cin = x.shape
    y0, x0, wy0, wy1, wx0, wx1 = _geometry(offsets, b, h, w)
    flat = x.reshape(b * h * w, cin)
    wts = (wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1)
    s = sum(flat[idx] * (wt * inb)[..., None]
            for (idx, inb), wt in zip(_corners(x, y0, x0), wts))
    return s.reshape(b * h * w, 9 * cin)


def _split(a):
    """fp32 -> (hi, lo), both bf16 values held in fp32: hi = rn(a), lo =
    rn(a - hi); a - hi is exact in fp32."""
    hi = a.to(torch.bfloat16).float()
    return hi, (a - hi).to(torch.bfloat16).float()


@pytest.mark.parametrize("shape", [(2, 64, 128, 128, 64),  # lidar eval bf16
                                   (2, 64, 64, 128, 64),   # camera eval bf16
                                   (1, 9, 11, 32, 64)])
def test_split_bf16_product_holds_fp32_level(shape):
    b, h, w, cin, cout = shape
    assert kernel_route(cin, cout) == "mma"
    x, off, wt = _inputs(sum(shape), b, h, w, cin, cout)
    want = deform_conv3x3_plain(x, off, wt).reshape(-1, cout)
    s = _samples(x, off)
    # the samples are the plain version's: their product is its output
    assert torch.allclose(s @ wt.reshape(9 * cin, cout), want, rtol=0,
                          atol=1e-6 * float(want.abs().max()))
    s_hi, s_lo = _split(s)
    w_hi, w_lo = _split(wt.reshape(9 * cin, cout))
    assert torch.equal(s_hi + (s - s_hi), s)  # the remainder is exact
    got = s_lo @ w_hi + s_hi @ w_lo + s_hi @ w_hi
    scale = float(want.abs().max())
    err3 = float((got - want).abs().max())
    err1 = float((s_hi @ w_hi - want).abs().max())
    assert err3 <= 1e-5 * scale, (err3, scale)
    assert err1 > 20 * err3  # one bf16 pass is far from fp32 level
    # rounded once to bf16, the split product flips few outputs, each by one
    # step of the fp32 contraction's rounded value
    got16, want16 = got.to(torch.bfloat16).float(), want.to(torch.bfloat16).float()
    flipped = int((got16 != want16).sum())
    assert bool(((got16 - want16).abs() <= bf16_step(want16, scale)).all())
    assert flipped <= 0.01 * want.numel(), flipped
