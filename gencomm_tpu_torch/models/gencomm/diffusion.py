"""GenComm conditional DDPM: generate each agent's BEV feature at the
receiver from the ego feature and the agent's 2-channel message.

Counterpart of ``gencomm_tpu/models/gencomm/diffusion.py``: linear-in-sqrt
beta schedule, x0 parameterization, chain x_{T-1} = q_sample(ego) -> T-1
reverse steps with posterior noise -> the last step returns the model
output. The noise is an input: ``noises`` lists the q_sample draw and then
one draw per reverse step, t = T-1 .. 1 (the order of the JAX draws);
without it, the draws come from ``generator``. With ``dtype`` (bf16 under
``half``) the ego feature, the condition and each fp32 noise draw are cast
to it and the chain runs in it; the schedule's coefficients are Python
floats, which do not promote a bf16 tensor and, as JAX's weakly typed
scalars are, are rounded to bf16 first.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from gencomm_tpu_torch.models.gencomm.unet import DiffusionUNet
from gencomm_tpu_torch.models.layers import as_dtype


def make_schedule(num_timesteps: int, linear_start: float = 5e-3,
                  linear_end: float = 5e-2) -> dict:
    betas = np.linspace(np.sqrt(linear_start), np.sqrt(linear_end),
                        num_timesteps) ** 2
    alphas = 1.0 - betas
    ac = np.cumprod(alphas)
    ac_prev = np.append(1.0, ac[:-1])
    posterior_variance = betas * (1.0 - ac_prev) / (1.0 - ac)
    return {
        "betas": betas,
        "sqrt_alphas_cumprod": np.sqrt(ac),
        "sqrt_one_minus_alphas_cumprod": np.sqrt(1.0 - ac),
        "posterior_mean_coef1": betas * np.sqrt(ac_prev) / (1.0 - ac),
        "posterior_mean_coef2": (1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac),
        "posterior_log_variance_clipped": np.log(
            np.maximum(posterior_variance, 1e-20)),
        "posterior_std": np.exp(0.5 * np.log(
            np.maximum(posterior_variance, 1e-20))),
    }


class GenCommDiffusion(nn.Module):
    def __init__(self, feat_ch: int = 128, msg_ch: int = 2,
                 num_timesteps: int = 3, unet_ch: int = 8,
                 unet_ch_mult: Sequence[int] = (1, 1),
                 unet_num_res_blocks: int = 2,
                 unet_attn_resolutions: Sequence[int] = (16,), dtype=None):
        super().__init__()
        self.num_timesteps, self.dtype = num_timesteps, dtype
        self.denoiser = DiffusionUNet(
            in_ch=feat_ch + msg_ch, out_ch=feat_ch, ch=unet_ch,
            ch_mult=unet_ch_mult, num_res_blocks=unet_num_res_blocks,
            attn_resolutions=unet_attn_resolutions, dtype=dtype)
        # the coefficients as the chain applies them (rounded to ``dtype``)
        self._sched = {k: [as_dtype(float(v), dtype) for v in vals]
                       for k, vals in make_schedule(num_timesteps).items()}

    def draw_noises(self, shape, generator, device):
        """The chain's draws from ``generator``: ``num_timesteps`` fp32
        standard normals of ``shape`` (the ego feature's), in the order
        ``forward`` reads them."""
        return [torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device)
                for _ in range(self.num_timesteps)]

    def forward(self, ego_feature, conditions, noises=None, generator=None):
        """ego_feature (N, H, W, C): each slot's ego feature; conditions
        (N, H, W, msg_ch): each slot's message -> generated (N, H, W, C)."""
        s = self._sched
        t_max = self.num_timesteps - 1
        n = ego_feature.shape[0]
        if noises is None:
            noises = self.draw_noises(ego_feature.shape, generator,
                                      ego_feature.device)
        if len(noises) != self.num_timesteps:
            raise ValueError(f"expected {self.num_timesteps} noise tensors, "
                             f"got {len(noises)}")
        if self.dtype is not None:
            ego_feature = ego_feature.to(self.dtype)
            conditions = conditions.to(self.dtype)
            noises = [z.to(self.dtype) for z in noises]
        x = (s["sqrt_alphas_cumprod"][t_max] * ego_feature
             + s["sqrt_one_minus_alphas_cumprod"][t_max] * noises[0])
        for step, t in enumerate(range(t_max, -1, -1)):
            t_vec = torch.full((n,), t, dtype=torch.int32,
                               device=ego_feature.device)
            model_out = self.denoiser(torch.cat([conditions, x], dim=-1), t_vec)
            if t == 0:
                x = model_out
            else:
                mean = (s["posterior_mean_coef1"][t] * model_out
                        + s["posterior_mean_coef2"][t] * x)
                x = mean + s["posterior_std"][t] * noises[step + 1]
        return x
