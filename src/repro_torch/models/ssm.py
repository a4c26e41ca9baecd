"""Mamba2 (State Space Duality) block: the SSM of the hybrid family
(counterpart of ``repro.models.ssm``).

Training and prefill run the chunked SSD algorithm (Mamba2 paper, Listing
1): the sequence is split into chunks of length ``Qc``; within a chunk the
recurrence is a masked quadratic form, and across chunks only the
``(H, P, N)`` states are carried, by a Python loop over the chunks (the
reference's ``lax.scan``).  A sequence shorter than the chunk is one
chunk; a longer one is padded to a multiple of the chunk with ``dt = 0``
(no input, decay 1), and the padded outputs are cut off.  Decode is the
one-token recurrence.

Shapes follow the paper: ``x (B, S, H, P)``, shared single-group ``B, C
(B, S, N)``, a scalar per head ``A (H,)``, ``dt (B, S, H)``; ``d_inner =
expand · d_model``, ``H = d_inner / headdim``.  Every op keeps the
reference's dtypes: at bf16 compute the scan runs in bf16 and the decode
cache holds float32.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import linear, rms_norm
from repro_torch.models.module import param


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_model: int
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    chunk: int = 128            # SSD chunk length
    heads_padded: int = 0       # set by the model builder (TP multiple)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def nheads(self) -> int:
        return self.d_inner // self.headdim

    @property
    def nheads_padded(self) -> int:
        return self.heads_padded or self.nheads

    @property
    def d_inner_padded(self) -> int:
        return self.nheads_padded * self.headdim


class Mamba(nn.Module):
    """``in_z``/``in_x (d, din)``, ``in_B``/``in_C (d, N)``, ``in_dt (d,
    H)``, ``dt_bias``/``A_log``/``D (H,)``, ``conv (K, din + 2N)``, ``norm
    (din,)``, ``out (din, d)``."""

    def __init__(self, cfg: MambaConfig, device):
        super().__init__()
        dm, din, n, h = (cfg.d_model, cfg.d_inner_padded, cfg.d_state,
                         cfg.nheads_padded)
        self.in_z = param(dm, din, device=device)
        self.in_x = param(dm, din, device=device)
        self.in_B = param(dm, n, device=device)
        self.in_C = param(dm, n, device=device)
        self.in_dt = param(dm, h, device=device)
        self.dt_bias = param(h, device=device)
        self.A_log = param(h, device=device)
        self.D = param(h, device=device)
        self.conv = param(cfg.d_conv, din + 2 * n, device=device)
        self.norm = param(din, device=device)
        self.out = param(din, dm, device=device)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` at every x
    (``F.softplus`` returns x itself above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def causal_conv(xbc: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C) with kernel (K, C), then SiLU:
    K shifted products added in order."""
    k = w.shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(k):
        out = out + pad[:, i:i + xbc.shape[1]] * w[i][None, None, :]
    return F.silu(out)


def segsum(log_a: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = Σ_{j<k<=i} log_a[..., k] as a difference of
    cumulative sums (else -inf)."""
    n = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((n, n), dtype=torch.bool,
                                 device=log_a.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(x, dt, a, b, c, chunk: int):
    """Chunked SSD scan.

    x (B,S,H,P), dt (B,S,H) [post-softplus], a = A (H,) negative, b/c
    (B,S,N) single group -> (y (B,S,H,P), final state (B,H,P,N))."""
    bsz, s_orig, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, s_orig)
    s = (s_orig + q - 1) // q * q
    if s != s_orig:
        # padded steps carry dt = 0: x·dt = 0, decay 1
        x = F.pad(x, (0, 0, 0, 0, 0, s - s_orig))
        dt = F.pad(dt, (0, 0, 0, s - s_orig))
        b = F.pad(b, (0, 0, 0, s - s_orig))
        c = F.pad(c, (0, 0, 0, s - s_orig))
    nc = s // q

    da = dt * a[None, None, :]                           # (B,S,H)
    xdt = x * dt[..., None]                              # dt folded into x
    xc = xdt.reshape(bsz, nc, q, h, p)
    dac = da.reshape(bsz, nc, q, h)
    bc = b.reshape(bsz, nc, q, n)
    cc = c.reshape(bsz, nc, q, n)

    # intra-chunk (diagonal blocks): the quadratic masked form
    lmat = torch.exp(segsum(dac.permute(0, 1, 3, 2)))   # (B,NC,H,Q,Q)
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)     # (B,NC,Q,Q)
    y_diag = torch.einsum("bcij,bchij,bcjhp->bcihp", scores, lmat, xc)

    # chunk states: decay-weighted outer products
    da_cum = torch.cumsum(dac, dim=2)                    # (B,NC,Q,H)
    da_tot = da_cum[:, :, -1]                            # (B,NC,H)
    decay_to_end = torch.exp(da_tot[:, :, None] - da_cum)
    states = torch.einsum("bcqn,bcqh,bcqhp->bchpn", bc, decay_to_end, xc)

    # inter-chunk recurrence: the state entering each chunk
    h_prev = x.new_zeros(bsz, h, p, n)
    h_in = []
    for ci in range(nc):
        h_in.append(h_prev)
        h_prev = (h_prev * torch.exp(da_tot[:, ci])[..., None, None]
                  + states[:, ci])
    h_in = torch.stack(h_in, dim=1)                      # (B,NC,H,P,N)

    # off-diagonal contribution: C_t · the decayed incoming state
    decay_from_start = torch.exp(da_cum)
    y_off = torch.einsum("bcqn,bcqh,bchpn->bcqhp", cc, decay_from_start, h_in)
    y = (y_diag + y_off).reshape(bsz, s, h, p)[:, :s_orig]
    return y, h_prev


def _in_proj(p: dict, u: torch.Tensor):
    z = linear(u, p["in_z"])
    xraw = linear(u, p["in_x"])
    braw = linear(u, p["in_B"])
    craw = linear(u, p["in_C"])
    dt = softplus(linear(u, p["in_dt"]) + p["dt_bias"].to(u.dtype))
    return z, torch.cat([xraw, braw, craw], dim=-1), dt


def _a(p: dict, dtype: torch.dtype) -> torch.Tensor:
    return (-torch.exp(p["A_log"].to(torch.float32))).to(dtype)


def mamba_forward(p: dict, cfg: MambaConfig, u: torch.Tensor) -> torch.Tensor:
    """Full-sequence Mamba2 block. u (B, S, d_model) -> (B, S, d_model)."""
    din, n = cfg.d_inner_padded, cfg.d_state
    z, xbc, dt = _in_proj(p, u)
    xbc = causal_conv(xbc, p["conv"].to(u.dtype))
    x, b, c = torch.split(xbc, [din, n, n], dim=-1)
    x = x.reshape(*x.shape[:2], cfg.nheads_padded, cfg.headdim)
    y, _ = ssd_chunked(x, dt, _a(p, u.dtype), b, c, cfg.chunk)
    y = y + x * p["D"].to(u.dtype)[None, None, :, None]
    y = y.reshape(*u.shape[:2], din)
    y = rms_norm(y * F.silu(z), p["norm"])
    return linear(y, p["out"])


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_mamba_cache(batch: int, cfg: MambaConfig, dtype=torch.float32,
                     device=None, layers: int = 0) -> dict:
    """``ssm (B, H, P, N)`` and ``conv (B, K-1, din + 2N)`` zeros, with a
    leading ``layers`` dim when ``layers > 0``."""
    din, n = cfg.d_inner_padded, cfg.d_state
    lead = (layers,) if layers else ()
    return {
        "ssm": torch.zeros(lead + (batch, cfg.nheads_padded, cfg.headdim, n),
                           dtype=dtype, device=device),
        "conv": torch.zeros(lead + (batch, cfg.d_conv - 1, din + 2 * n),
                            dtype=dtype, device=device),
    }


def mamba_decode(p: dict, cfg: MambaConfig, u: torch.Tensor, cache: dict):
    """One-token step. u (B, 1, d_model) -> out (B, 1, d); ``cache``'s
    ``ssm`` and ``conv`` are written in place."""
    din, n = cfg.d_inner_padded, cfg.d_state
    z, xbc_t, dt = _in_proj(p, u)
    dt = dt[:, 0]                                        # (B,H)
    conv_win = torch.cat([cache["conv"].to(u.dtype), xbc_t], dim=1)
    xbc = F.silu(torch.einsum("bkc,kc->bc", conv_win, p["conv"].to(u.dtype)))
    x, b, c = torch.split(xbc, [din, n, n], dim=-1)
    x = x.reshape(-1, cfg.nheads_padded, cfg.headdim)
    decay = torch.exp(dt * _a(p, u.dtype)[None])        # (B,H)
    ssm = (cache["ssm"].to(u.dtype) * decay[..., None, None]
           + torch.einsum("bhp,bh,bn->bhpn", x, dt, b))
    y = (torch.einsum("bhpn,bn->bhp", ssm, c)
         + x * p["D"].to(u.dtype)[None, :, None])
    y = rms_norm(y.reshape(-1, 1, din) * F.silu(z), p["norm"])
    cache["ssm"].copy_(ssm)
    cache["conv"].copy_(conv_win[:, 1:])
    return linear(y, p["out"])
