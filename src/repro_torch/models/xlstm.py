"""xLSTM blocks: mLSTM (matrix memory, parallelisable) and sLSTM (scalar
memory, recurrent), arXiv:2405.04517 (counterpart of
``repro.models.xlstm``).

mLSTM's training and prefill form is the paper's parallel quadratic form:
with log-sigmoid forget gates F and input gates I,

    D[i,j] = exp( Σ_{k=j+1..i} log σ(f_k) + i_j − m_i )       (stabilised)
    H      = ((Q Kᵀ/√d ⊙ D) V) / max(|row-sum|, 1)

and above ``2·chunk`` positions the chunkwise form
(``mlstm_inner_chunked``: intra-chunk quadratic blocks and a carried
``(C, n, m)``), which equals it.  The stabiliser ``m`` is ``torch.amax``,
which shares the gradient among ties as JAX's ``max`` does: the row
normaliser makes the output depend on ``m`` when ``|row-sum| < 1``.
Decode carries ``C (B,H,P,P)``, ``n (B,H,P)``, ``m (B,H)`` and the conv
window.

sLSTM is a Python loop over time with exponential-gate stabilisation and
block-diagonal recurrent weights; the forward holds its state in the
compute dtype, the decode cache holds whatever dtype it was made with
(float32 by default), and mixed operands promote as JAX promotes them.
Neither block has a separate FFN (``d_ff = 0``): mLSTM projects up by 2,
sLSTM ends in a gated GELU (tanh form) MLP of factor 4/3.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import linear, rms_norm
from repro_torch.models.module import param


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    d_model: int
    num_heads: int = 4
    conv_kernel: int = 4
    mlstm_pf: float = 2.0
    slstm_pf: float = 4.0 / 3.0
    chunk: int = 256       # chunkwise-parallel block length (long sequences)

    @property
    def hp(self) -> int:
        # the family runs with replicated params (no head padding)
        return self.num_heads

    @property
    def d_inner(self) -> int:
        return int(self.mlstm_pf * self.d_model)


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + pad[:, i:i + x.shape[1]] * w[i][None, None, :]
    return F.silu(out)


def _conv_step(cache_conv: torch.Tensor, x_t: torch.Tensor,
               w: torch.Tensor):
    """One decode step of the causal conv: (silu(window · w) (B, C), the
    window (B, K, C))."""
    win = torch.cat([cache_conv.to(x_t.dtype), x_t], dim=1)
    return F.silu(torch.einsum("bkc,kc->bc", win, w.to(x_t.dtype))), win


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTMBlock(nn.Module):
    INIT_SCALE = {"w_i": 0.01, "w_f": 0.01}

    def __init__(self, cfg: XLSTMConfig, device):
        super().__init__()
        dm, din, h = cfg.d_model, cfg.d_inner, cfg.hp
        hd = din // h
        self.ln = param(dm, device=device)
        self.up = param(dm, din, device=device)
        self.up_z = param(dm, din, device=device)
        self.conv = param(cfg.conv_kernel, din, device=device)
        self.wq = param(din, h, hd, device=device)
        self.wk = param(din, h, hd, device=device)
        self.wv = param(din, h, hd, device=device)
        self.w_i = param(din, h, device=device)
        self.w_f = param(din, h, device=device)
        self.b_i = param(h, device=device)
        self.b_f = param(h, device=device)      # +3 applied in the forward
        self.mnorm = param(din, device=device)
        self.down = param(din, dm, device=device)


def _mlstm_gates(p: dict, xc: torch.Tensor):
    dt = xc.dtype
    i_pre = linear(xc, p["w_i"]) + p["b_i"].to(dt)
    f_pre = linear(xc, p["w_f"]) + p["b_f"].to(dt) + 3.0  # bias to remember
    return i_pre.to(torch.float32), f_pre.to(torch.float32)


def mlstm_forward(p: dict, cfg: XLSTMConfig, u: torch.Tensor) -> torch.Tensor:
    """Parallel (quadratic, or chunkwise above 2·chunk) mLSTM block.
    u (B,S,d) -> (B,S,d)."""
    b, s, _ = u.shape
    din = cfg.d_inner
    hd = din // cfg.hp
    x = rms_norm(u, p["ln"])
    xu = linear(x, p["up"])
    z = linear(x, p["up_z"])
    xc = _causal_conv(xu, p["conv"].to(x.dtype))
    q = linear(xc, p["wq"])
    k = linear(xc, p["wk"])
    v = linear(xu, p["wv"])
    i_pre, f_pre = _mlstm_gates(p, xc)                   # (B,S,H) float32
    if s > 2 * cfg.chunk:
        out = mlstm_inner_chunked(q, k, v, i_pre, f_pre, cfg.chunk)
    else:
        fcum = torch.cumsum(F.logsigmoid(f_pre), dim=1)  # (B,S,H)
        # log decay: dmat[i,j] = fcum_i - fcum_j + i_pre_j  (j <= i)
        dmat = (fcum[:, :, None, :] - fcum[:, None, :, :]
                + i_pre[:, None, :, :])                  # (B,S,S,H)
        causal = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                       device=u.device))
        dmat = torch.where(causal[None, :, :, None], dmat, -torch.inf)
        m = torch.amax(dmat, dim=2, keepdim=True)        # stabiliser
        d = torch.exp(dmat - m)
        scores = torch.einsum("bihk,bjhk->bijh", q, k) / math.sqrt(hd)
        w = scores.to(i_pre.dtype) * d
        norm = torch.clamp(torch.abs(torch.sum(w, dim=2)), min=1.0)
        out = (torch.einsum("bijh,bjhk->bihk", w, v.to(i_pre.dtype))
               / norm[..., None]).to(x.dtype)
    out = out.reshape(b, s, din)
    out = rms_norm(out, p["mnorm"]) * F.silu(z)
    return u + linear(out, p["down"])


def mlstm_inner_chunked(q, k, v, i_pre, f_pre, chunk: int):
    """Chunkwise-parallel mLSTM: intra-chunk quadratic blocks and a carried
    (C, n, m), by a Python loop over the chunks.

    q/k/v (B,S,H,D), gates (B,S,H) float32 -> h (B,S,H,D) in q's dtype.
    The same stabilisation as the quadratic form (running max m, row
    normaliser ``max(|ñ·q|, 1)``); padded steps have f = +1e9 (no decay)
    and i = -1e9 (no input)."""
    b, s, hh, dd = q.shape
    qc = min(chunk, s)
    s_pad = (s + qc - 1) // qc * qc
    if s_pad != s:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, s_pad - s)) for t in (q, k, v))
        i_pre = F.pad(i_pre, (0, 0, 0, s_pad - s), value=-1e9)
        f_pre = F.pad(f_pre, (0, 0, 0, s_pad - s), value=1e9)
    nc = s_pad // qc
    scale = 1.0 / math.sqrt(dd)

    def chunks(t):
        return t.reshape(b, nc, qc, *t.shape[2:])

    qs, ks, vs = chunks(q), chunks(k), chunks(v)
    ip = chunks(i_pre)
    a = torch.cumsum(F.logsigmoid(chunks(f_pre)), dim=2)  # (B,NC,Qc,H)
    a_tot = a[:, :, -1]                                  # (B,NC,H)
    wl = ip - a                                          # log weight vs chunk start
    causal = torch.tril(torch.ones((qc, qc), dtype=torch.bool,
                                   device=q.device))

    # carried state: Ĉ (B,H,D,D), n̂ (B,H,D), m̂ (B,H); C = Ĉ·exp(m̂)
    f32 = i_pre.dtype
    c_h = q.new_zeros((b, hh, dd, dd), dtype=f32)
    n_h = q.new_zeros((b, hh, dd), dtype=f32)
    m_h = torch.full((b, hh), -1e30, dtype=f32, device=q.device)
    outs = []
    for ci in range(nc):
        qj, kj, vj = qs[:, ci], ks[:, ci], vs[:, ci]     # (B,Qc,H,D)
        aj, wj, atot = a[:, ci], wl[:, ci], a_tot[:, ci]
        w_max = torch.amax(wj, dim=1)                    # (B,H)
        # row outputs: m_i = a_i + max(m̂, max_{j<=i} w_j)
        w_run = torch.cummax(wj, dim=1).values           # (B,Qc,H)
        m_row = aj + torch.maximum(m_h[:, None], w_run)
        dmat = aj[:, :, None] + wj[:, None, :]           # (B,Qc,Qc,H)
        dmat = torch.where(causal[None, :, :, None], dmat, -torch.inf)
        dstab = torch.exp(dmat - m_row[:, :, None])
        scores = torch.einsum("bihd,bjhd->bijh", qj, kj) * scale
        wmat = scores.to(f32) * dstab
        s_coef = torch.exp(aj + m_h[:, None] - m_row)    # (B,Qc,H)
        qf = qj.to(f32)
        num = (torch.einsum("bijh,bjhd->bihd", wmat, vj.to(f32))
               + s_coef[..., None] * torch.einsum("bhdk,bihd->bihk", c_h, qf))
        den = torch.sum(wmat, dim=2) + s_coef * torch.einsum(
            "bhd,bihd->bih", n_h, qf)
        outs.append(num / torch.clamp(torch.abs(den), min=1.0)[..., None])
        # state update
        m_new = torch.maximum(m_h + atot, atot + w_max)
        decay = torch.exp(m_h + atot - m_new)            # (B,H)
        inw = torch.exp(wj + atot[:, None] - m_new[:, None])   # (B,Qc,H)
        ksc = kj.to(f32) * scale
        c_h = c_h * decay[..., None, None] + torch.einsum(
            "bjh,bjhd,bjhk->bhdk", inw, ksc, vj.to(f32))
        n_h = n_h * decay[..., None] + torch.einsum("bjh,bjhd->bhd", inw, ksc)
        m_h = m_new
    hs = torch.stack(outs, dim=1).reshape(b, s_pad, hh, dd)
    return hs[:, :s].to(q.dtype)


def init_mlstm_cache(batch: int, cfg: XLSTMConfig, dtype=torch.float32,
                     device=None) -> dict:
    h = cfg.hp
    hd = cfg.d_inner // h
    return {
        "C": torch.zeros((batch, h, hd, hd), dtype=dtype, device=device),
        "n": torch.zeros((batch, h, hd), dtype=dtype, device=device),
        "m": torch.full((batch, h), -1e9, dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, cfg.d_inner),
                            dtype=dtype, device=device),
    }


def mlstm_decode(p: dict, cfg: XLSTMConfig, u: torch.Tensor, cache: dict):
    """Recurrent one-token step. u (B,1,d) -> y; ``cache`` written in
    place."""
    bsz = u.shape[0]
    din = cfg.d_inner
    hd = din // cfg.hp
    x = rms_norm(u, p["ln"])
    f32 = torch.float32
    xu = linear(x, p["up"])
    z = linear(x, p["up_z"])
    xc, win = _conv_step(cache["conv"], xu, p["conv"])
    xc = xc[:, None]
    q = linear(xc, p["wq"])[:, 0]
    k = linear(xc, p["wk"])[:, 0]
    v = linear(xu, p["wv"])[:, 0]
    i_pre, f_pre = _mlstm_gates(p, xc)
    i_pre, f_pre = i_pre[:, 0], f_pre[:, 0]              # (B,H)
    logf = F.logsigmoid(f_pre)

    m_old = cache["m"].to(f32)
    m_new = torch.maximum(logf + m_old, i_pre)
    decay = torch.exp(logf + m_old - m_new)[..., None, None]
    inp = torch.exp(i_pre - m_new)[..., None, None]
    ks = k.to(f32) / math.sqrt(hd)
    c_new = cache["C"].to(f32) * decay + inp * torch.einsum(
        "bhk,bhl->bhkl", v.to(f32), ks)
    n_new = cache["n"].to(f32) * decay[..., 0] + inp[..., 0] * ks
    num = torch.einsum("bhkl,bhl->bhk", c_new, q.to(f32))
    den = torch.clamp(torch.abs(torch.einsum("bhl,bhl->bh", n_new,
                                             q.to(f32))), min=1.0)
    out = (num / den[..., None]).to(x.dtype).reshape(bsz, 1, din)
    out = rms_norm(out, p["mnorm"]) * F.silu(z)
    y = u + linear(out, p["down"])
    for name, t in (("C", c_new), ("n", n_new), ("m", m_new),
                    ("conv", win[:, 1:])):
        cache[name].copy_(t)
    return y


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLSTMBlock(nn.Module):
    INIT_SCALE = {f"r_{g}": 0.1 for g in "ifzo"}

    def __init__(self, cfg: XLSTMConfig, device):
        super().__init__()
        dm, h = cfg.d_model, cfg.hp
        hd = dm // cfg.num_heads
        dh = h * hd
        self.ln = param(dm, device=device)
        self.conv = param(cfg.conv_kernel, dm, device=device)
        for g in "ifzo":
            setattr(self, f"w_{g}", param(dm, dh, device=device))
            setattr(self, f"r_{g}", param(h, hd, hd, device=device))
            setattr(self, f"b_{g}", param(dh, device=device))
        self.gnorm = param(dh, device=device)
        pf = int(cfg.slstm_pf * dm)
        self.proj_up = param(dh, 2 * pf, device=device)
        self.proj_down = param(pf, dm, device=device)


def init_slstm_cache(batch: int, cfg: XLSTMConfig, dtype=torch.float32,
                     device=None) -> dict:
    shape = (batch, cfg.hp, cfg.d_model // cfg.num_heads)

    def z():
        return torch.zeros(shape, dtype=dtype, device=device)

    return {"c": z(), "n": z() + 1e-6, "h": z(), "m": z(),
            "conv": torch.zeros((batch, cfg.conv_kernel - 1, cfg.d_model),
                                dtype=dtype, device=device)}


def _promoted(a: torch.Tensor, b: torch.Tensor):
    """Both operands in their promoted dtype, as ``jnp.einsum`` promotes
    mixed operands."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _slstm_cell(p: dict, cfg: XLSTMConfig, x_t, xc_t, state: dict) -> dict:
    """One sLSTM time step.  x_t (B, d) raw, xc_t conv-SiLU'd; the new
    state in the dtype of ``state["h"]``."""
    h = cfg.hp
    hd = cfg.d_model // cfg.num_heads
    f32 = torch.float32
    hprev = state["h"]                                   # (B,H,hd)

    def gate(name, src):
        wx = linear(src, p[f"w_{name}"]).reshape(-1, h, hd)
        rh = torch.einsum("bhk,hkl->bhl",
                          *_promoted(hprev, p[f"r_{name}"].to(src.dtype)))
        return (wx + rh + p[f"b_{name}"].to(src.dtype).reshape(h, hd)).to(f32)

    i_pre = gate("i", xc_t)
    f_pre = gate("f", xc_t) + 3.0
    z_pre = gate("z", x_t)
    o_pre = gate("o", x_t)

    m_old = state["m"].to(f32)
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + m_old, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(logf + m_old - m_new)
    c_new = f_g * state["c"].to(f32) + i_g * torch.tanh(z_pre)
    n_new = f_g * state["n"].to(f32) + i_g
    h_new = torch.sigmoid(o_pre) * c_new / torch.clamp(n_new, min=1e-6)
    dt = hprev.dtype
    return {"c": c_new.to(dt), "n": n_new.to(dt), "h": h_new.to(dt),
            "m": m_new.to(dt)}


def _slstm_out(p: dict, u: torch.Tensor, hs: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """Group norm, the gated GELU MLP (weights cast to ``dtype``, the
    block's compute dtype, then promoted with ``hs``) and the residual."""
    hs = rms_norm(hs, p["gnorm"])
    a, g = torch.chunk(linear(hs, p["proj_up"].to(dtype)), 2, dim=-1)
    return u + linear(a * F.gelu(g, approximate="tanh"),
                      p["proj_down"].to(dtype))


def slstm_forward(p: dict, cfg: XLSTMConfig, u: torch.Tensor) -> torch.Tensor:
    """Sequential sLSTM block (a loop over time). u (B,S,d); the state in
    u's dtype."""
    b, s, _ = u.shape
    x = rms_norm(u, p["ln"])
    xc = _causal_conv(x, p["conv"].to(x.dtype))
    state = {k: v for k, v in init_slstm_cache(b, cfg, x.dtype,
                                               u.device).items()
             if k != "conv"}
    hs = []
    for t in range(s):
        state = _slstm_cell(p, cfg, x[:, t], xc[:, t], state)
        hs.append(state["h"])
    hs = torch.stack(hs, dim=1).reshape(b, s, -1)
    return _slstm_out(p, u, hs, x.dtype)


def slstm_decode(p: dict, cfg: XLSTMConfig, u: torch.Tensor, cache: dict):
    """One-token step. u (B,1,d) -> y; ``cache`` written in place."""
    b = u.shape[0]
    x = rms_norm(u, p["ln"])
    xc, win = _conv_step(cache["conv"], x, p["conv"])
    new = _slstm_cell(p, cfg, x[:, 0], xc,
                      {k: cache[k] for k in ("c", "n", "h", "m")})
    y = _slstm_out(p, u, new["h"].reshape(b, 1, -1), x.dtype)
    for name, t in new.items():
        cache[name].copy_(t)
    cache["conv"].copy_(win[:, 1:])
    return y
