"""Fat-matmul re-association of the dilated stack, in plain PyTorch.

Counterpart of ``wavenet_tpu/kernels/fat.py`` (pure jnp there too; no
kernel consumes it in either package). Substituting
c_s = c_{s-1} + z_{s-1} @ Wd_{s-1} + bd_{s-1} into layer s's conv turns
every layer into ONE matmul over the widened state
X_s = [S_d(c_{s-1}) | c_{s-1} | S_d(z_{s-1}) | z_{s-1}]:

    [a_s | c_s] = X_s @ F_s + beta_s

with the block weight

    F_s = [[ W1_s            | 0        ]      rows 0:R    (c past)
           [ W2_s            | I_R      ]      rows R:2R   (c)
           [ Wd_{s-1} @ W1_s | 0        ]      rows 2R:2R+D (z past)
           [ Wd_{s-1} @ W2_s | Wd_{s-1} ]]     rows 2R+D:  (z)
    beta_s = [ bd_{s-1} @ (W1_s + W2_s) + add_s | bd_{s-1} ]

The shifted c-stream is padded with -bd_{s-1} (``c_pad_fill``) instead of
zeros, which cancels the uniform bd @ W1 term at t < d. ``one_tanh``
folds 0.5 into the gate columns so that sigmoid(a_g) = 0.5 + 0.5 *
tanh(a_g / 2). Assembly is differentiable: autograd maps (dF, dbeta)
back onto (w_fg, wd, add, bd).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from wavenet_torch.models.config import WaveNetConfig

__all__ = ["assemble_fat_weights", "fat_forward_reference",
           "gated_from_onetanh", "fat_widths"]


def fat_widths(config: WaveNetConfig) -> Tuple[int, int]:
    """(K, N) of the fat matmul: K = 2R+2D input lanes, N = 2D+R out."""
    R, D = config.residual_channels, config.dilation_channels
    return 2 * R + 2 * D, 2 * D + R


def assemble_fat_weights(w_fg, wd, add, bd, config: WaveNetConfig,
                         one_tanh: bool = True, with_y_step: bool = True):
    """Fat step weights from the packed stack weights (w_fg [L,2R,2D], wd
    [L,D,R], add [L,B,2D], bd [L,1,R]) -> (F [L(+1), 2R+2D, 2D+R], beta
    [L(+1), B, 2D+R], c_pad_fill [L, R]: the value the shifted c-stream of
    step s is padded with at sequence start, -bd_{s-1}, zeros at s=0).
    ``with_y_step`` appends step L, which emits y = c_L."""
    c = config
    L, R, D = c.num_layers, c.residual_channels, c.dilation_channels
    B = add.shape[1]
    kw = dict(dtype=w_fg.dtype, device=w_fg.device)
    eye = torch.eye(R, **kw)
    zR = torch.zeros((R, R), **kw)
    zD = torch.zeros((D, R), **kw)

    fs, betas = [], []
    for s in range(L):
        w1, w2 = w_fg[s, :R], w_fg[s, R:]
        if s == 0:
            rows_zp = rows_z = torch.zeros((D, 2 * D), **kw)
            col_c = torch.cat([zR, eye, zD, zD], dim=0)
            beta_a = add[s]
            beta_c = torch.zeros((B, R), **kw)
        else:
            wd_p, bd_p = wd[s - 1], bd[s - 1]          # [D, R], [1, R]
            rows_zp = wd_p @ w1
            rows_z = wd_p @ w2
            col_c = torch.cat([zR, eye, zD, wd_p], dim=0)
            beta_a = bd_p @ (w1 + w2) + add[s]          # [B, 2D]
            beta_c = bd_p.expand(B, R)
        cols_a = torch.cat([w1, w2, rows_zp, rows_z], dim=0)
        fs.append(torch.cat([cols_a, col_c], dim=1))
        betas.append(torch.cat([beta_a.expand(B, 2 * D), beta_c], dim=1))

    if with_y_step:
        wd_p, bd_p = wd[L - 1], bd[L - 1]
        cols_a = torch.zeros((2 * R + 2 * D, 2 * D), **kw)
        col_c = torch.cat([zR, eye, zD, wd_p], dim=0)
        fs.append(torch.cat([cols_a, col_c], dim=1))
        betas.append(torch.cat([torch.zeros((B, 2 * D), **kw),
                                bd_p.expand(B, R)], dim=1))

    Fw = torch.stack(fs)                                # [L(+1), K, N]
    beta = torch.stack(betas)                           # [L(+1), B, N]
    if one_tanh:
        gate = torch.cat([torch.ones((D,), **kw), torch.full((D,), 0.5, **kw),
                          torch.ones((R,), **kw)])
        Fw = Fw * gate
        beta = beta * gate
    c_pad_fill = torch.cat([torch.zeros((1, R), **kw), -bd[:L - 1, 0, :]],
                           dim=0)
    return Fw, beta, c_pad_fill


def gated_from_onetanh(th: torch.Tensor, D: int) -> torch.Tensor:
    """z = tanh(a_f) * sigmoid(a_g) from th = tanh([a_f | a_g/2])."""
    return th[..., :D] * (0.5 + 0.5 * th[..., D:])


def fat_forward_reference(x, Fw, beta, c_pad_fill, config: WaveNetConfig,
                          one_tanh: bool = True):
    """The fat recurrence over x [B, T, R] (the stack input) with the
    weights of ``assemble_fat_weights(..., with_y_step=True)`` -> (y
    [B,T,R], z_all [B,T,L*D])."""
    c = config
    L, D = c.num_layers, c.dilation_channels
    B, T, _ = x.shape

    def shift(v, d, fill=None):
        if fill is None:
            return F.pad(v, (0, 0, d, 0))[:, :T]
        head = fill.to(v.dtype).expand(B, d, v.shape[-1])
        return torch.cat([head, v[:, :max(T - d, 0)]], dim=1)[:, :T]

    cur = x
    z = torch.zeros((B, T, D), dtype=x.dtype, device=x.device)
    outs = []
    for s in range(L):
        d = c.dilations[s]
        X = torch.cat([shift(cur, d, c_pad_fill[s]), cur, shift(z, d), z],
                      dim=-1)
        O = X @ Fw[s] + beta[s][:, None, :]
        if one_tanh:
            z = gated_from_onetanh(torch.tanh(O[..., :2 * D]), D)
        else:
            z = torch.tanh(O[..., :D]) * torch.sigmoid(O[..., D:2 * D])
        cur = O[..., 2 * D:]
        outs.append(z)
    # The y step: no shifted stream contributes (its W1 = W2 = 0 blocks).
    Xl = torch.cat([torch.zeros_like(cur), cur, torch.zeros_like(z), z],
                   dim=-1)
    y = (Xl @ Fw[L] + beta[L][:, None, :])[..., 2 * D:]
    return y, torch.cat(outs, dim=-1)
