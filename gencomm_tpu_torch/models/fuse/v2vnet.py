"""V2VNet fusion: iterative message passing with a ConvGRU update.

Counterpart of ``gencomm_tpu/models/fuse/v2vnet.py`` (``ConvGRUCell``,
``V2VNetFusion``). Each of ``num_iteration`` rounds updates every agent i:
the whole (B, L) node stack and a 1-channel map of ones are warped into
agent i's frame with ``affine[:, i]`` (two K3 launches, so 2 L
``num_iteration`` a forward; the map of ones needs no gradient, so K3b runs
L ``num_iteration`` times in a backward), a 3x3 conv makes each agent's
message from [warped map, agent i's map], masked by the warped ones and the
valid slots, the messages are averaged (``avg``) or max-pooled over agents,
and a ConvGRU from a zero hidden state (``v2vnet.py:83-88``) or a residual
add updates agent i. The ego's node goes through ``mlp``.
"""

from __future__ import annotations

import torch
from torch import nn

from gencomm_tpu_torch.models.fuse.fusion import warp_all_to
from gencomm_tpu_torch.models.layers import Conv, Dense, sigmoid


class ConvGRUCell(nn.Module):
    def __init__(self, in_ch: int, hidden_dim: int, kernel: int = 3):
        super().__init__()
        self.conv_gates = Conv(in_ch + hidden_dim, 2 * hidden_dim, kernel)
        self.conv_can = Conv(in_ch + hidden_dim, hidden_dim, kernel)

    def forward(self, x, h):
        gates = sigmoid(self.conv_gates(torch.cat([x, h], dim=-1)))
        reset, update = gates.chunk(2, dim=-1)
        cand = torch.tanh(self.conv_can(torch.cat([x, reset * h], dim=-1)))
        return (1.0 - update) * h + update * cand


class V2VNetFusion(nn.Module):
    """``in_channels`` is the config's, held and unused as in the JAX
    package (the channels are the input's)."""

    def __init__(self, in_ch: int, in_channels: int | None = None,
                 num_iteration: int = 2, gru_flag: bool = True,
                 agg_operator: str = "avg"):
        super().__init__()
        self.in_channels, self.num_iteration = in_channels, num_iteration
        self.gru_flag, self.agg_operator = gru_flag, agg_operator
        self.msg_cnn = Conv(2 * in_ch, in_ch, 3)
        if gru_flag:  # flax makes no GRU parameters it never calls
            self.conv_gru = ConvGRUCell(2 * in_ch, in_ch)
        self.mlp = Dense(in_ch, in_ch)

    def forward(self, x, affine, agent_mask):
        b, l, h, w, c = x.shape
        ones = torch.ones((b, l, h, w, 1), dtype=x.dtype, device=x.device)
        valid = agent_mask[..., None, None, None].to(x.dtype)
        node = x
        for _ in range(self.num_iteration):
            updated = []
            for i in range(l):
                warped = warp_all_to(node, affine, i)
                roi = warp_all_to(ones, affine, i)
                ego = node[:, i:i + 1].expand(warped.shape)
                msg = self.msg_cnn(torch.cat([warped, ego], dim=-1).reshape(
                    b * l, h, w, 2 * c)).reshape(b, l, h, w, c) * roi
                msg = msg * valid
                if self.agg_operator == "avg":
                    denom = agent_mask.sum(dim=1).clamp_min(1).to(x.dtype)
                    agg = msg.sum(dim=1) / denom[:, None, None, None]
                else:
                    agg = torch.where(valid > 0, msg,
                                      torch.full_like(msg, -1e9)).amax(dim=1)
                if self.gru_flag:
                    updated.append(self.conv_gru(
                        torch.cat([node[:, i], agg], dim=-1),
                        torch.zeros_like(agg)))
                else:
                    updated.append(node[:, i] + agg)
            node = torch.stack(updated, dim=1)
        return self.mlp(node[:, 0])
