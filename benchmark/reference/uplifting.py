"""The uplifting transformer of the configuration ('connectstage', 'dynamic' table tokens,
RoPE over time) in plain float32 PyTorch, with the port's state-dict names, and the
transform of its spin into the flight frame.

As the paper's model: pre-LN blocks (epsilon 1e-6) of attention with RoPE over the
timestamps (positions round(t * max_fps), interleaved pairs) on q and k and an additive
mask on both the query and the key axis, then a ReLU MLP of ratio 1; per timestep the ball
token attends to the 13 embedded table keypoints (invisible ones masked, fake times
arange(13) / (max_fps / 5)); a first stage predicts positions, a second the spin from the
first stage's tokens.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.numerics import Products

NEG_INF = -1e9
KEYPOINT_VISIBLE = 1


class Mlp2(nn.Module):
    def __init__(self, i, d):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(i, d), nn.Linear(d, d)

    def forward(self, x, P):
        return P.linear(torch.relu(P.linear(x, self.fc1.weight, self.fc1.bias)),
                        self.fc2.weight, self.fc2.bias)


class Head3(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.fc1, self.fc2, self.fc3 = nn.Linear(d, d // 2), nn.Linear(d // 2, d // 4), \
            nn.Linear(d // 4, 3)

    def forward(self, x, P):
        x = torch.relu(P.linear(x, self.fc1.weight, self.fc1.bias))
        x = torch.relu(P.linear(x, self.fc2.weight, self.fc2.bias))
        return P.linear(x, self.fc3.weight, self.fc3.bias)


def rope(x, times, max_fps):
    """x (..., H, N, Dh) rotated by the positions round(times * max_fps) (..., N)."""
    hd = x.shape[-1]
    inv = 1.0 / (10000.0 ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    ang = torch.round(times * max_fps)[..., None] * inv
    cos, sin = torch.cos(ang)[..., None, :, :], torch.sin(ang)[..., None, :, :]
    xr = x.reshape(*x.shape[:-1], hd // 2, 2)
    a, b = xr[..., 0], xr[..., 1]
    return torch.stack([a * cos - b * sin, a * sin + b * cos], -1).reshape(x.shape)


class Attn(nn.Module):
    def __init__(self, d, h):
        super().__init__()
        self.d, self.h = d, h
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d, bias=False)

    def forward(self, x, mask_add, times, ncls, P, max_fps):
        h, d = self.h, self.d
        qkv = P.linear(x, self.qkv.weight, self.qkv.bias).reshape(*x.shape[:-1], 3, h, d // h)
        q, k, v = torch.movedim(qkv, (-3, -2), (0, -3))

        def rot(t):
            if ncls == 0:
                return rope(t, times, max_fps)
            return torch.cat([t[..., :ncls, :], rope(t[..., ncls:, :], times, max_fps)], -2)

        q, k = rot(q), rot(k)
        logits = P.einsum("...hqd,...hkd->...hqk", q, k) * (d // h) ** -0.5
        logits = logits + (mask_add[..., None, :, None] + mask_add[..., None, None, :])
        out = P.einsum("...hqk,...hkd->...hqd", torch.softmax(logits, -1), v)
        return P.linear(torch.movedim(out, -3, -2).reshape(*x.shape[:-1], d), self.proj.weight)


class Layer(nn.Module):
    def __init__(self, d, h, eps):
        super().__init__()
        self.norm1, self.norm2 = nn.LayerNorm(d, eps=eps), nn.LayerNorm(d, eps=eps)
        self.attn = Attn(d, h)
        self.mlp1 = Mlp2(d, d)

    def forward(self, x, mask_add, times, ncls, P, max_fps):
        x = x + self.attn(F.layer_norm(x, x.shape[-1:], self.norm1.weight, self.norm1.bias,
                                       self.norm1.eps), mask_add, times, ncls, P, max_fps)
        return x + self.mlp1(F.layer_norm(x, x.shape[-1:], self.norm2.weight, self.norm2.bias,
                                          self.norm2.eps), P)


def _layers(mod, prefix, n, d, h, eps):
    names = [f"{prefix}_{i}" for i in range(n)]
    for nm in names:
        mod.add_module(nm, Layer(d, h, eps))
    return names


class TableStage(nn.Module):
    def __init__(self, d, h, depth, eps):
        super().__init__()
        self.table_embed = Mlp2(2, d)
        self.names = _layers(self, "pos_layers", depth, d, h, eps)

    def forward(self, x, table, P, max_fps):
        B, T, D = x.shape
        N = table.shape[-2]
        tmask = torch.where(table[..., 2] == KEYPOINT_VISIBLE, 0.0, NEG_INF)
        mask_add = torch.cat([torch.zeros_like(tmask[:, :1]), tmask], 1)[:, None]
        ttimes = (torch.arange(N, dtype=x.dtype, device=x.device) / (max_fps / 5)).expand(B, 1, N)
        tok = self.table_embed(table[..., :2], P)[:, None].expand(B, T, N, D)
        tokens = torch.cat([x[:, :, None, :], tok], 2)
        for nm in self.names:
            tokens = getattr(self, nm)(tokens, mask_add, ttimes, 1, P, max_fps)
        return tokens[:, :, 0, :]


class FirstStage(nn.Module):
    def __init__(self, d, depth, h, table_depth, eps):
        super().__init__()
        self.ball_embed = Mlp2(2, d)
        self.table_stage = TableStage(d, h, table_depth, eps)
        self.names = _layers(self, "layers", depth, d, h, eps)
        self.position_head = Head3(d)

    def forward(self, ball, table, mask_add, times, P, max_fps):
        x = self.table_stage(self.ball_embed(ball, P), table, P, max_fps)
        for nm in self.names:
            x = getattr(self, nm)(x, mask_add, times, 0, P, max_fps)
        return self.position_head(x, P), x


class Uplifting(nn.Module):
    """forward(ball (B, L, 2), table (B, 13, 3), mask (B, L), times (B, L), P) ->
    (spin in the world frame (B, 3), positions (B, L, 3))."""

    def __init__(self, cfg):
        super().__init__()
        d, h, eps = cfg["dim"], cfg["heads"], cfg["ln_eps"]
        self.dim, self.max_fps = d, cfg["max_fps"]
        self.firststage = FirstStage(d, cfg["depth"] - cfg["depth_secondstage"], h,
                                     cfg["table_depth"], eps)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.names = _layers(self, "secondstage", cfg["depth_secondstage"], d, h, eps)
        self.rotation_head = Head3(d)

    def forward(self, ball, table, mask, times, P: Products):
        B = ball.shape[0]
        mask_add = torch.where(mask > 0.5, 0.0, NEG_INF)
        pos, tok = self.firststage(ball, table, mask_add, times, P, self.max_fps)
        x = torch.cat([self.cls_token.expand(B, 1, self.dim), tok], 1)
        m2 = torch.cat([torch.zeros_like(mask_add[:, :1]), mask_add], 1)
        for nm in self.names:
            x = getattr(self, nm)(x, m2, times, 1, P, self.max_fps)
        return self.rotation_head(x[:, 0], P), pos


def flight_frame(pos):
    """The frame of the first step of pos (T, 3): e_x the initial x-y direction of flight,
    e_z up, e_y = e_z x e_x; as the rows of a (3, 3) matrix."""
    v = pos[1, :2] - pos[0, :2]
    e_x = torch.cat([v, torch.zeros_like(v[:1])]) / torch.linalg.norm(v)
    e_z = torch.zeros_like(e_x)
    e_z[2] = 1.0
    return torch.stack([e_x, torch.linalg.cross(e_z, e_x), e_z])


def from_flight_frame(spin_local, pos):
    """A spin the pipeline gave in the flight frame of its own positions, back in the world
    frame: the model's own output, free of how ill-conditioned that frame is."""
    return flight_frame(pos).t() @ spin_local
