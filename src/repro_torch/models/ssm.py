"""Mamba2 block of the port: the SSD (state-space duality) in plain PyTorch.

Twin of ``repro/models/ssm.py``.  The reference computes the block with
plain ``jnp`` outside any Pallas kernel, so the port's is plain PyTorch
too: the four projections (``z``, ``x``, ``B``/``C``, ``dt``) and the
output projection as ``torch.matmul``, the depthwise causal conv1d
(``_causal_conv``) as K shifted multiply-adds, and the SSD as einsums.

``_ssd_chunked`` is the chunked SSD: within a chunk of ``cfg.ssm_chunk``
tokens an attention-like (Q x Q) product, across chunks a recurrence on
the (B, H, N, P) float32 state.  The intra-chunk products of every chunk
run at once; only the state's pass over the chunks is a loop, its length
a host int.  ``_ssd_recurrent`` is the per-token recurrence.

Which one runs.  The reference's ``mamba_apply`` picks its algorithm by
whether a state is passed: without one the chunked SSD from a zero
state, with one (every served prefill, chunk and decode step) the
per-token recurrence over all L tokens.  The port runs the chunked SSD
seeded with the carried state whenever L > 1, and the recurrence only at
L = 1 (decode): the same function, in another order of float sums
(``tests/test_torch_ssm.py`` holds the two equal at the reference's own
rtol/atol 1e-4).  A prompt padded to a whole number of chunks gets the
final state of the unpadded one, since the padded ``dt`` is 0.

State is never updated in place: ``mamba_apply`` returns new state and
conv-tail tensors and leaves the caller's as they were, so a serving
step that fails and is retried starts from the committed state.  It
makes no host sync.

Layout.  Parameters keep the reference's leaves (``z_proj``, ``x_proj``,
``bc_proj``, ``dt_proj``, ``conv_x_w``/``conv_x_b``,
``conv_bc_w``/``conv_bc_b``, ``a_log``, ``d_skip``, ``dt_bias``,
``norm``, ``out_proj``), stacked on a leading ``L`` axis as the port's
other leaves are.  ``d_inner`` column j feeds head ``j % H`` at position
``j // H`` of its head dimension (the reference's p-major layout), so
weights carried across mean the same in both packages.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers

Params = Dict[str, torch.Tensor]
State = Tuple[torch.Tensor, torch.Tensor]


def init_mamba(gen: torch.Generator, cfg, n_layers: int, device) -> Params:
    """``n_layers`` Mamba2 blocks' weights drawn from ``gen`` on
    ``device`` with the reference's scales: projections N(0,
    2/(d_in+d_out)) and conv weights N(0, 0.01) in ``cfg.param_dtype``,
    conv biases 0; ``a_log = log(1..H)``, ``d_skip`` 1, ``dt_bias`` 0 and
    the gated norm's scale 1, float32."""
    d, di = cfg.d_model, cfg.d_inner
    n, h, k = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
    dt = getattr(torch, cfg.param_dtype)
    f32 = dict(dtype=torch.float32, device=device)

    def normal(shape, std):
        return (torch.randn((n_layers,) + shape, generator=gen,
                            device=device) * std).to(dt)

    def dense(d_in, d_out):
        return normal((d_in, d_out), (2.0 / (d_in + d_out)) ** 0.5)

    return {
        "z_proj": dense(d, di), "x_proj": dense(d, di),
        "bc_proj": dense(d, 2 * n), "dt_proj": dense(d, h),
        "conv_x_w": normal((k, di), 0.1),
        "conv_x_b": torch.zeros((n_layers, di), dtype=dt, device=device),
        "conv_bc_w": normal((k, 2 * n), 0.1),
        "conv_bc_b": torch.zeros((n_layers, 2 * n), dtype=dt, device=device),
        "a_log": torch.log(torch.arange(1, h + 1, **f32)).expand(
            n_layers, h).contiguous(),
        "d_skip": torch.ones((n_layers, h), **f32),
        "dt_bias": torch.zeros((n_layers, h), **f32),
        "norm": torch.ones((n_layers, di), **f32),
        "out_proj": dense(di, d),
    }


def init_ssm_state(cfg, batch: int, device=None) -> State:
    """Zero (state (B, H, N, P), conv tail (B, K-1, d_inner + 2N)),
    float32."""
    h, n, p = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros((batch, h, n, p), **f32),
            torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner + 2 * n),
                        **f32))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d.  x: (B, L, C); w: (K, C); ``tail`` the
    K-1 inputs before ``x`` (zeros when None).  Returns (y, the last K-1
    inputs), both of ``x``'s type."""
    k, length = w.shape[0], x.shape[1]
    if tail is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([tail.to(x.dtype), x], dim=1)
    y = xp[:, :length] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + length] * w[i]
    return y + b, (xp[:, -(k - 1):] if k > 1 else None)


def _ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 bmat: torch.Tensor, cmat: torch.Tensor, chunk: int,
                 s0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD from the state ``s0`` (zeros when None).

    xh: (B, L, H, P); dt: (B, L, H) float32 (after the softplus); a: (H,)
    negative; bmat/cmat: (B, L, N); s0: (B, H, N, P) float32.  L is
    zero-padded to a whole number of chunks (a padded ``dt`` of 0 leaves
    the state as it was).  Returns (y (B, L, H, P) float32, each chunk's
    output rounded to ``xh``'s type as the reference's are, final state
    (B, H, N, P) float32).
    """
    bsz, length, h, p = xh.shape
    n = bmat.shape[-1]
    pad = (-length) % chunk
    if pad:
        xh, dt, bmat, cmat = (F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
                              for t in (xh, dt, bmat, cmat))
    nc, q, f32 = (length + pad) // chunk, chunk, torch.float32
    x = xh.reshape(bsz, nc, q, h, p).to(f32)
    dtc = dt.reshape(bsz, nc, q, h).to(f32)
    bc = bmat.reshape(bsz, nc, q, n).to(f32)
    cc = cmat.reshape(bsz, nc, q, n).to(f32)

    cum = torch.cumsum(dtc * a, dim=2)                  # (B,C,Q,H) inclusive
    seg = cum[:, :, -1]                                 # (B,C,H)
    # intra-chunk: y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j,
    # the masked entries zeroed before the exp (j > i would overflow)
    mask = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()
    mask = mask[:, :, None]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,C,Qi,Qj,H)
    lmat = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)), 0.0)
    scores = cc @ bc.transpose(-1, -2)                   # (B,C,Qi,Qj)
    w = scores[..., None] * lmat * dtc[:, :, None, :, :]
    y = (w.permute(0, 1, 4, 2, 3) @ x.permute(0, 1, 3, 2, 4)
         ).permute(0, 1, 3, 2, 4)                        # (B,C,Q,H,P)

    # each chunk's own state: sum_j exp(seg - cum_j) dt_j B_j x_j
    decay_to_end = torch.exp(seg[:, :, None, :] - cum)   # (B,C,Q,H)
    xw = (dtc * decay_to_end)[..., None] * x             # (B,C,Q,H,P)
    s_local = (bc.transpose(-1, -2) @ xw.reshape(bsz, nc, q, h * p)
               ).reshape(bsz, nc, n, h, p).transpose(2, 3)  # (B,C,H,N,P)
    # the state entering each chunk: S = exp(seg) S_prev + S_local
    s = (torch.zeros((bsz, h, n, p), dtype=f32, device=xh.device)
         if s0 is None else s0.to(f32))
    decay = torch.exp(seg)[..., None, None]              # (B,C,H,1,1)
    entering = []
    for c in range(nc):
        entering.append(s)
        s = s * decay[:, c] + s_local[:, c]
    s_prev = torch.stack(entering, dim=1)                # (B,C,H,N,P)
    # inter-chunk: y_i += exp(cum_i) C_i S_prev
    y_inter = (cc @ s_prev.transpose(2, 3).reshape(bsz, nc, n, h * p)
               ).reshape(bsz, nc, q, h, p) * torch.exp(cum)[..., None]
    y = (y + y_inter).to(xh.dtype).to(f32)
    return y.reshape(bsz, nc * q, h, p)[:, :length], s


def _ssd_recurrent(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   bmat: torch.Tensor, cmat: torch.Tensor,
                   s0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-token recurrence from ``s0``, a token at a time:
    S_t = exp(dt_t a) S_{t-1} + dt_t B_t x_t, y_t = C_t S_t.  The same
    arguments as ``_ssd_chunked``.  Returns (y (B, L, H, P), final state),
    float32."""
    f32 = torch.float32
    s = s0.to(f32)
    ys = []
    for t in range(xh.shape[1]):
        x_t, dt_t = xh[:, t].to(f32), dt[:, t].to(f32)      # (B,H,P),(B,H)
        b_t, c_t = bmat[:, t].to(f32), cmat[:, t].to(f32)   # (B,N)
        s = s * torch.exp(dt_t * a)[..., None, None] \
            + b_t[:, None, :, None] * (dt_t[..., None] * x_t)[:, :, None, :]
        ys.append((c_t[:, None, None, :] @ s)[:, :, 0])     # (B,H,P)
    return torch.stack(ys, dim=1), s


def mamba_apply(p: Params, x: torch.Tensor, cfg,
                state: Optional[State] = None
                ) -> Tuple[torch.Tensor, Optional[State]]:
    """Mamba2 block.  x: (B, L, D).

    ``state`` = (ssm state (B, H, N, P), conv tail (B, K-1, d_inner +
    2N)), both float32, carries the recurrence across calls; the new
    state comes back as new tensors (None without a ``state``, as in the
    reference).  L > 1 runs the chunked SSD from the state, L = 1 the
    recurrence.  Returns (out (B, L, D) of ``x``'s type, new state)."""
    bsz, length, _ = x.shape
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    pdim = cfg.ssm_headdim

    z = x @ p["z_proj"]
    xin = x @ p["x_proj"]
    bc = x @ p["bc_proj"]
    dt = x @ p["dt_proj"]

    tail = state[1] if state is not None else None
    xin, tail_x = _causal_conv(xin, p["conv_x_w"], p["conv_x_b"],
                               None if tail is None else tail[:, :, :di])
    bc, tail_bc = _causal_conv(bc, p["conv_bc_w"], p["conv_bc_b"],
                               None if tail is None else tail[:, :, di:])
    xin, bc = F.silu(xin), F.silu(bc)
    bmat, cmat = bc[..., :n], bc[..., n:]

    dt = F.softplus(dt.float() + p["dt_bias"])                # (B,L,H)
    a = -torch.exp(p["a_log"])                                # (H,) < 0
    # p-major heads: d_inner column j is (p = j // H, h = j % H)
    xh = xin.reshape(bsz, length, pdim, h).transpose(2, 3)    # (B,L,H,P)

    if state is not None and length == 1:
        y, s_final = _ssd_recurrent(xh, dt, a, bmat, cmat, state[0])
    else:
        y, s_final = _ssd_chunked(xh, dt, a, bmat, cmat, cfg.ssm_chunk,
                                  None if state is None else state[0])
    new_state = None
    if state is not None:
        new_tail = (None if tail_x is None else
                    torch.cat([tail_x, tail_bc], dim=-1).float())
        new_state = (s_final, new_tail)

    y = y + p["d_skip"][:, None] * xh.float()
    y = y.transpose(2, 3).reshape(bsz, length, di).to(x.dtype)
    y = layers.rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    return y @ p["out_proj"], new_state
