"""Recurrent blocks: Mamba2 (chunked SSD) and xLSTM (mLSTM, sLSTM).

Port of ``repro.models.ssm``. Each cell is an ``nn.Module`` with its
weights in the JAX package's ``(in, out)`` orientation and a state cache
(``MambaCache``, ``MLSTMCache``, ``SLSTMCache``); ``forward(x, state)``
returns (out, final state) and ``decode(x, state)`` takes one token. The
caller starts from the zero state (``init_cache``) or from a cache, and
writes the final state back into the cache (``transformer.py``).

- Mamba2 runs the chunked SSD form: quadratic within a chunk of
  ``chunk_size`` steps, a recurrence across chunks, all in float32. The
  within-chunk products of every chunk are computed at once (batched over
  the chunks) and only the state is carried chunk by chunk; the JAX package
  scans the chunks, which gives the same sums. Its decay matrix is masked
  before the exponential (``exp`` of -inf above the diagonal) where the JAX
  package masks after it: the kept entries are the same numbers, but the JAX
  form overflows to inf above the diagonal once a chunk's log decay spans
  more than ~88 (a chunk of 256 steps at dt ~0.7), and its backward pass then
  turns the masked zeros into NaN (0 x inf).
- mLSTM runs the chunkwise-parallel form (chunk 256, the JAX default), a
  chunk at a time since each chunk's stabiliser depends on the last; a
  single token takes the one-step form, as the JAX package does for L = 1.
- sLSTM is a loop over time steps with the block-diagonal recurrence
  ``r`` (4, H, dh, dh), as the JAX ``lax.scan``.

``A_log``, ``dt_bias`` and ``D`` (Mamba2), ``if_bias`` (mLSTM) and ``b``
(sLSTM) are float32 in a bf16 model, as the JAX init draws them. The gated
norms go through ``kernels.ops.rmsnorm``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.common.config import ModelConfig
from repro_torch.models.layers import RMSNorm, truncated_normal

MLSTM_CHUNK = 256           # mlstm_forward's chunk in the JAX package
NEG_INIT = -1e9             # the stabilisers' initial value, as the JAX package's


def _init_linear(w: torch.Tensor, generator: torch.Generator) -> None:
    """(in, out) weight with std in^-0.5, as the JAX inits draw them."""
    w.copy_(truncated_normal(w.shape, w.shape[0] ** -0.5, w.dtype, w.device, generator))


# ===========================================================================
# Mamba2 (SSD)
# ===========================================================================

class MambaCache(NamedTuple):
    conv: torch.Tensor   # (B, W-1, conv_dim) trailing conv inputs, param dtype
    ssm: torch.Tensor    # (B, H, P, N) state, float32


def mamba_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(d_inner, heads, conv_dim)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = s.num_heads or d_inner // s.head_dim
    return d_inner, n_heads, d_inner + 2 * s.state_dim


def causal_depthwise_conv(x, w, b, init_state=None):
    """x: (B, L, C); w: (W, C) depthwise, left-causal; init_state (B, W-1, C)
    or zeros. Returns (silu(conv + b), the trailing W-1 inputs)."""
    width = w.shape[0]
    if init_state is None:
        init_state = x.new_zeros((x.shape[0], width - 1, x.shape[-1]))
    xp = torch.cat([init_state.to(x.dtype), x], dim=1)
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + xp[:, i:i + x.shape[1]] * w[i].to(x.dtype)
    state = xp[:, xp.shape[1] - (width - 1):] if width > 1 else init_state
    return F.silu(out + b.to(x.dtype)), state


def ssd_chunk_scan(xh, dt, a_log, Bm, Cm, s0, chunk: int):
    """Chunked SSD. xh: (B, L, H, P); dt: (B, L, H) softplus'd step sizes;
    a_log: (B, L, H) per-step log decay (dt * A, negative); Bm, Cm: (B, L, N);
    s0: (B, H, P, N). Returns y (B, L, H, P) and the final state, float32.
    The tail chunk is padded with zeros (dt = 0: no input, no decay)."""
    b, l, h, p = xh.shape
    q = min(chunk, l)
    nc = -(-l // q)
    pad = nc * q - l
    if pad:
        xh, dt, a_log, Bm, Cm = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                                 for t in (xh, dt, a_log, Bm, Cm))

    def chunks(t):
        return t.float().reshape((b, nc, q) + t.shape[2:])

    xs, dts, als, bs, cs = map(chunks, (xh, dt, a_log, Bm, Cm))
    lc = torch.cumsum(als, dim=2)                                     # (B,c,q,H)
    # within a chunk (j <= i): att[i, j] = exp(l_i - l_j) * (C_i . B_j) * dt_j
    cb = torch.einsum("bcin,bcjn->bcij", cs, bs)
    mask = torch.ones(q, q, dtype=torch.bool, device=xh.device).tril()
    seg = torch.where(mask[None, None, :, :, None],
                      lc[:, :, :, None, :] - lc[:, :, None, :, :], float("-inf"))
    att = cb[..., None] * torch.exp(seg) * dts[:, :, None, :, :]       # (B,c,i,j,H)
    y = torch.einsum("bcijh,bcjhp->bcihp", att, xs)
    del att, seg
    # each chunk's own contribution to the state at its end
    w = torch.exp(lc[:, :, -1:, :] - lc) * dts                          # (B,c,q,H)
    s_chunk = torch.einsum("bcjh,bcjn,bcjhp->bchpn", w, bs, xs)
    decay = torch.exp(lc[:, :, -1])                                     # (B,c,H)
    s = s0.float()
    entry = []                      # the state entering each chunk
    for c in range(nc):
        entry.append(s)
        s = decay[:, c, :, None, None] * s + s_chunk[:, c]
    # across chunks: y_i += exp(l_i) * C_i . s_entry
    y = y + torch.einsum("bcin,bchpn,bcih->bcihp", cs, torch.stack(entry, 1), torch.exp(lc))
    return y.reshape(b, nc * q, h, p)[:, :l], s


class Mamba2(nn.Module):
    """``init_mamba2``'s parameters: ``in_proj`` (d, 2 d_inner + 2 N + H),
    ``conv_w`` (W, conv_dim), ``conv_b``, float32 ``A_log``, ``dt_bias``,
    ``D`` (H,), the gated ``norm`` (d_inner) and ``out_proj``."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        s = cfg.ssm
        self.cfg = cfg
        d = cfg.d_model
        d_inner, h, conv_dim = mamba_dims(cfg)
        kw = dict(dtype=dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.in_proj = nn.Parameter(torch.empty(d, 2 * d_inner + 2 * s.state_dim + h, **kw))
        self.conv_w = nn.Parameter(torch.empty(s.conv_width, conv_dim, **kw))
        self.conv_b = nn.Parameter(torch.zeros(conv_dim, **kw))
        self.A_log = nn.Parameter(torch.zeros(h, **f32))
        self.dt_bias = nn.Parameter(torch.zeros(h, **f32))
        self.D = nn.Parameter(torch.ones(h, **f32))
        self.norm = RMSNorm(d_inner, cfg.norm_eps, dtype, device)
        self.out_proj = nn.Parameter(torch.empty(d_inner, d, **kw))

    def init_weights(self, generator: torch.Generator) -> None:
        """As ``init_mamba2``: the projections with std in^-0.5, ``conv_w``
        with std 0.1; ``A_log``, ``dt_bias``, ``conv_b`` 0, ``D`` 1."""
        _init_linear(self.in_proj, generator)
        _init_linear(self.out_proj, generator)
        self.conv_w.copy_(truncated_normal(self.conv_w.shape, 0.1, self.conv_w.dtype,
                                           self.conv_w.device, generator))
        for t, v in ((self.conv_b, 0.0), (self.A_log, 0.0), (self.dt_bias, 0.0), (self.D, 1.0)):
            t.fill_(v)

    def init_cache(self, batch: int, dtype) -> MambaCache:
        s = self.cfg.ssm
        _, h, conv_dim = mamba_dims(self.cfg)
        dev = self.in_proj.device
        return MambaCache(torch.zeros(batch, s.conv_width - 1, conv_dim, dtype=dtype, device=dev),
                          torch.zeros(batch, h, s.head_dim, s.state_dim, dtype=torch.float32,
                                      device=dev))

    def _split(self, zxbcdt):
        d_inner, h, conv_dim = mamba_dims(self.cfg)
        return (zxbcdt[..., :d_inner], zxbcdt[..., d_inner:d_inner + conv_dim],
                zxbcdt[..., zxbcdt.shape[-1] - h:])

    def _out(self, y, z, use_kernel: bool):
        y = self.norm(y * F.silu(z), use_kernel)
        return y @ self.out_proj.to(y.dtype)

    def forward(self, x, state: Optional[MambaCache] = None, use_kernel: bool = True):
        """Full sequence (``mamba2_forward``). x: (B, L, D). Returns (out,
        MambaCache of the final conv inputs, in x's dtype, and SSM state)."""
        s = self.cfg.ssm
        d_inner, h, _ = mamba_dims(self.cfg)
        b, l, _ = x.shape
        z, xbc, dt_raw = self._split(x @ self.in_proj.to(x.dtype))
        xbc, conv_state = causal_depthwise_conv(xbc, self.conv_w, self.conv_b,
                                                None if state is None else state.conv)
        xin = xbc[..., :d_inner].reshape(b, l, h, s.head_dim)
        Bm = xbc[..., d_inner:d_inner + s.state_dim]
        Cm = xbc[..., d_inner + s.state_dim:]
        dt = F.softplus(dt_raw.float() + self.dt_bias)
        a_log = dt * -torch.exp(self.A_log)
        s0 = (state.ssm if state is not None else
              x.new_zeros((b, h, s.head_dim, s.state_dim), dtype=torch.float32))
        y, s_final = ssd_chunk_scan(xin, dt, a_log, Bm, Cm, s0, s.chunk_size)
        y = y + self.D[None, None, :, None] * xin.float()
        y = y.reshape(b, l, d_inner).to(x.dtype)
        return self._out(y, z, use_kernel), MambaCache(conv_state.to(x.dtype), s_final)

    def decode(self, x, state: MambaCache, use_kernel: bool = True):
        """One token (``mamba2_decode``). x: (B, 1, D)."""
        s = self.cfg.ssm
        d_inner, h, _ = mamba_dims(self.cfg)
        b = x.shape[0]
        z, xbc_t, dt_raw = self._split(x[:, 0] @ self.in_proj.to(x.dtype))
        window = torch.cat([state.conv.to(x.dtype), xbc_t[:, None]], dim=1)    # (B, W, C)
        xbc = F.silu(torch.einsum("bwc,wc->bc", window, self.conv_w.to(x.dtype))
                     + self.conv_b.to(x.dtype))
        xin = xbc[..., :d_inner].reshape(b, h, s.head_dim)
        Bm = xbc[..., d_inner:d_inner + s.state_dim]
        Cm = xbc[..., d_inner + s.state_dim:]
        dt = F.softplus(dt_raw.float() + self.dt_bias)                         # (B, H)
        a = torch.exp(dt * -torch.exp(self.A_log))
        s_new = (a[:, :, None, None] * state.ssm
                 + torch.einsum("bh,bn,bhp->bhpn", dt, Bm.float(), xin.float()))
        y = torch.einsum("bn,bhpn->bhp", Cm.float(), s_new)
        y = y + self.D[None, :, None] * xin.float()
        y = y.reshape(b, 1, d_inner).to(x.dtype)
        return self._out(y, z[:, None], use_kernel), MambaCache(window[:, 1:], s_new)


# ===========================================================================
# xLSTM: mLSTM (matrix memory)
# ===========================================================================

class MLSTMCache(NamedTuple):
    C: torch.Tensor  # (B, H, P, P) matrix memory
    n: torch.Tensor  # (B, H, P) normaliser
    m: torch.Tensor  # (B, H) stabiliser


def mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(d_inner, heads, head width)."""
    d_inner = 2 * cfg.d_model
    return d_inner, cfg.n_heads, d_inner // cfg.n_heads


def mlstm_step(state: MLSTMCache, q, k, v, i_raw, f_raw):
    """One time step. q/k/v: (B, H, P); i_raw/f_raw: (B, H). Stabilised
    exponential gating: the stored state is C~ = C e^{-m};
    h = C~ q / max(|n~ . q|, e^{-m})."""
    C, n, m = state
    f_log = F.logsigmoid(f_raw)
    m_new = torch.maximum(f_log + m, i_raw)
    i_g = torch.exp(i_raw - m_new)
    f_g = torch.exp(f_log + m - m_new)
    k_s = k / (q.shape[-1] ** 0.5)
    C_new = f_g[..., None, None] * C + i_g[..., None, None] * torch.einsum("bhp,bhq->bhpq",
                                                                          v, k_s)
    n_new = f_g[..., None] * n + i_g[..., None] * k_s
    num = torch.einsum("bhpq,bhq->bhp", C_new, q)
    den = torch.maximum(torch.einsum("bhp,bhp->bh", n_new, q).abs(), torch.exp(-m_new))
    return MLSTMCache(C_new, n_new, m_new), num / den[..., None]


def mlstm_chunk_scan(q, k, v, i_raw, f_raw, state: MLSTMCache, chunk: int):
    """Chunkwise-parallel mLSTM: attention-like within a chunk, the state
    carried across chunks. q/k/v: (B, L, H, P) float32; i_raw/f_raw: (B, L, H)
    float32. Padded steps are the identity (i = -1e9: no input; f = +1e9:
    log sigmoid 0, no decay). Returns (B, L, H, P) and the final state."""
    b, l, h, p = q.shape
    qn = min(chunk, l)
    nc = -(-l // qn)
    pad = nc * qn - l
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        i_raw = F.pad(i_raw, (0, 0, 0, pad), value=-1e9)
        f_raw = F.pad(f_raw, (0, 0, 0, pad), value=1e9)
    k = k / (p ** 0.5)
    mask = torch.ones(qn, qn, dtype=torch.bool, device=q.device).tril()[None, :, :, None]
    C, n, m0 = (t.float() for t in state)
    ys = []
    for c in range(nc):
        sl = slice(c * qn, (c + 1) * qn)
        qc, kc, vc, ic, fc = q[:, sl], k[:, sl], v[:, sl], i_raw[:, sl], f_raw[:, sl]
        ell = torch.cumsum(F.logsigmoid(fc), dim=1)                  # (B, q, H)
        # log-weights D[i, j] = ell_i - ell_j + i_j for j <= i
        D = torch.where(mask, ell[:, :, None, :] - ell[:, None, :, :] + ic[:, None, :, :],
                        float("-inf"))
        g = ell + m0[:, None, :]                                      # the state's path
        m_i = torch.maximum(D.amax(dim=2), g)                         # (B, q, H)
        s = torch.exp(D - m_i[:, :, None, :]) * torch.einsum("bihp,bjhp->bijh", qc, kc)
        u = torch.exp(g - m_i)
        num = (torch.einsum("bijh,bjhp->bihp", s, vc)
               + u[..., None] * torch.einsum("bhpq,bihq->bihp", C, qc))
        den_dot = s.sum(dim=2) + u * torch.einsum("bhp,bihp->bih", n, qc)
        ys.append(num / torch.maximum(den_dot.abs(), torch.exp(-m_i))[..., None])
        # the state at the chunk's end
        lq = ell[:, -1:, :]
        m_state = torch.maximum(lq[:, 0] + m0, (lq - ell + ic).amax(dim=1))
        wS = torch.exp(lq - ell + ic - m_state[:, None, :])           # (B, q, H)
        carry = torch.exp(lq[:, 0] + m0 - m_state)
        C = carry[:, :, None, None] * C + torch.einsum("bjh,bjhp,bjhq->bhpq", wS, vc, kc)
        n = carry[:, :, None] * n + torch.einsum("bjh,bjhp->bhp", wS, kc)
        m0 = m_state
    ys[-1] = ys[-1][:, :qn - pad]            # the padded steps' outputs
    return torch.cat(ys, dim=1), MLSTMCache(C, n, m0)


class MLSTM(nn.Module):
    """``init_mlstm``'s parameters: ``up`` (d, 2 d_inner), ``wq``/``wk``/``wv``
    (d_inner, d_inner), ``wif`` (d_inner, 2H), float32 ``if_bias`` (2H),
    ``norm`` (d_inner), ``down`` (d_inner, d)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        d_inner, h, _ = mlstm_dims(cfg)
        kw = dict(dtype=dtype, device=device)
        self.up = nn.Parameter(torch.empty(d, 2 * d_inner, **kw))
        self.wq = nn.Parameter(torch.empty(d_inner, d_inner, **kw))
        self.wk = nn.Parameter(torch.empty(d_inner, d_inner, **kw))
        self.wv = nn.Parameter(torch.empty(d_inner, d_inner, **kw))
        self.wif = nn.Parameter(torch.empty(d_inner, 2 * h, **kw))
        self.if_bias = nn.Parameter(torch.zeros(2 * h, dtype=torch.float32, device=device))
        self.norm = RMSNorm(d_inner, cfg.norm_eps, dtype, device)
        self.down = nn.Parameter(torch.empty(d_inner, d, **kw))

    def init_weights(self, generator: torch.Generator) -> None:
        for w in (self.up, self.wq, self.wk, self.wv, self.wif, self.down):
            _init_linear(w, generator)
        self.if_bias.zero_()

    def init_cache(self, batch: int, dtype=None) -> MLSTMCache:
        """The zero state, float32 whatever the model's dtype."""
        _, h, p = mlstm_dims(self.cfg)
        kw = dict(dtype=torch.float32, device=self.up.device)
        return MLSTMCache(torch.zeros(batch, h, p, p, **kw), torch.zeros(batch, h, p, **kw),
                          torch.full((batch, h), NEG_INIT, **kw))

    def forward(self, x, state: Optional[MLSTMCache] = None, use_kernel: bool = True):
        """``mlstm_forward``: one step for L = 1, else the chunked form."""
        d_inner, h, p = mlstm_dims(self.cfg)
        b, l, _ = x.shape
        up = x @ self.up.to(x.dtype)
        xi, z = up[..., :d_inner], up[..., d_inner:]
        q, k, v = ((xi @ w.to(x.dtype)).reshape(b, l, h, p).float()
                   for w in (self.wq, self.wk, self.wv))
        if_raw = (xi @ self.wif.to(x.dtype)).float() + self.if_bias
        i_raw, f_raw = if_raw[..., :h], if_raw[..., h:]
        if state is None:
            state = self.init_cache(b)
        if l == 1:
            state, hs = mlstm_step(state, q[:, 0], k[:, 0], v[:, 0], i_raw[:, 0], f_raw[:, 0])
            hs = hs[:, None]
        else:
            hs, state = mlstm_chunk_scan(q, k, v, i_raw, f_raw, state, MLSTM_CHUNK)
        hs = self.norm(hs.reshape(b, l, d_inner).to(x.dtype), use_kernel) * F.silu(z)
        return hs @ self.down.to(x.dtype), state

    decode = forward


# ===========================================================================
# xLSTM: sLSTM (scalar memory, block-diagonal recurrence)
# ===========================================================================

class SLSTMCache(NamedTuple):
    c: torch.Tensor  # (B, H, Dh)
    n: torch.Tensor  # (B, H, Dh)
    h: torch.Tensor  # (B, H, Dh)
    m: torch.Tensor  # (B, H, Dh)


def slstm_step(r_cat, state: SLSTMCache, wx_t):
    """One time step. r_cat: (H, Dh, 4 Dh), the recurrence with the four
    gates' columns side by side; wx_t: (B, 4, H, Dh) input projections for
    the gates i, f, z, o."""
    c, n, h_prev, m = state
    b, hh, dh = h_prev.shape
    rec = torch.bmm(h_prev.transpose(0, 1), r_cat).reshape(hh, b, 4, dh).permute(1, 2, 0, 3)
    i_raw, f_raw, z_raw, o_raw = (wx_t + rec).unbind(1)
    f_log_m = F.logsigmoid(f_raw) + m
    m_new = torch.maximum(f_log_m, i_raw)
    i_g = torch.exp(i_raw - m_new)
    f_g = torch.exp(f_log_m - m_new)
    c_new = f_g * c + i_g * torch.tanh(z_raw)
    n_new = f_g * n + i_g
    h_new = torch.sigmoid(o_raw) * c_new / torch.clamp_min(n_new, 1.0)
    return SLSTMCache(c_new, n_new, h_new, m_new)


class SLSTM(nn.Module):
    """``init_slstm``'s parameters: ``w`` (d, 4d) for the gates i, f, z, o,
    ``r`` (4, H, dh, dh), float32 ``b`` (4d), ``norm`` (d), ``out`` (d, d)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        d, h = cfg.d_model, cfg.n_heads
        dh = d // h
        kw = dict(dtype=dtype, device=device)
        self.w = nn.Parameter(torch.empty(d, 4 * d, **kw))
        self.r = nn.Parameter(torch.empty(4, h, dh, dh, **kw))
        self.b = nn.Parameter(torch.zeros(4 * d, dtype=torch.float32, device=device))
        self.norm = RMSNorm(d, cfg.norm_eps, dtype, device)
        self.out = nn.Parameter(torch.empty(d, d, **kw))

    def init_weights(self, generator: torch.Generator) -> None:
        """As ``init_slstm``: ``w``, ``out`` std in^-0.5, ``r`` std dh^-0.5."""
        _init_linear(self.w, generator)
        _init_linear(self.out, generator)
        self.r.copy_(truncated_normal(self.r.shape, self.r.shape[-1] ** -0.5, self.r.dtype,
                                      self.r.device, generator))
        self.b.zero_()

    def init_cache(self, batch: int, dtype=None) -> SLSTMCache:
        """The zero state (m at -1e9), float32."""
        h = self.cfg.n_heads
        shape = (batch, h, self.cfg.d_model // h)
        kw = dict(dtype=torch.float32, device=self.w.device)
        return SLSTMCache(torch.zeros(shape, **kw), torch.zeros(shape, **kw),
                          torch.zeros(shape, **kw), torch.full(shape, NEG_INIT, **kw))

    def forward(self, x, state: Optional[SLSTMCache] = None, use_kernel: bool = True):
        """``slstm_forward``: the time-step loop from ``state`` (or zeros)."""
        d, h = self.cfg.d_model, self.cfg.n_heads
        dh = d // h
        b, l, _ = x.shape
        wx = ((x @ self.w.to(x.dtype)).float() + self.b).reshape(b, l, 4, h, dh)
        r_cat = self.r.float().permute(1, 2, 0, 3).reshape(h, dh, 4 * dh)
        if state is None:
            state = self.init_cache(b)
        hs = []
        for t in range(l):
            state = slstm_step(r_cat, state, wx[:, t])
            hs.append(state.h)
        hs = torch.stack(hs, dim=1).reshape(b, l, d).to(x.dtype)
        return self.norm(hs, use_kernel) @ self.out.to(x.dtype), state

    decode = forward
