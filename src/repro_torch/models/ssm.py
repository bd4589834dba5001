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

On a mesh whose ``model`` size divides a cell's heads (``heads_split``), the
cell computes on this rank's heads, from the shards the rules store
(``parallel.tensor``): each projection on the rank's contiguous column
block, its output's columns moved to the heads that read them
(``tp.to_heads``, one all-to-all; the columns every head reads, Mamba2's B
and C and mLSTM's xi, to every rank), the weights the rules place on the
heads (``A_log``, ``dt_bias``, ``D``, mLSTM's q/k/v columns, sLSTM's ``r``)
as they are, a weight the rules leave whole cut to the rank's heads
(``tp.chunk``), the norm over every head in the RMSNorm kernel's split mode,
and the output projection row-parallel on the heads, summed over ``model``
(``tp.reduce_out``). sLSTM's ``out`` is stored column-split with its rows
over ``data``; its rows are moved to the heads (``tp.rows_of``, an
all-to-all of d^2 / model weights) rather than the normed input gathered
whole (an all-gather of every token's d columns, larger in training and
prefill), so its input stays on the heads and its norm in the split mode.
The body of each cell is one for both: a ``_View`` holds what differs.

Where ``model`` is a multiple g·H of an xLSTM cell's H heads (xlstm-125m's 4
at 8 and 16; ``tp.parts_over_model``), the cell computes one head's 1/g: rank
r takes head r // g and part r % g of its width (``tp.head_part``). The rules'
column blocks of ``up``, ``wq``/``wk``/``wv``, ``w``, ``down``'s rows and
``out`` are then each exactly the rank's part, so the exchanges, the norm's
split mode and the output projections run as on whole heads; a weight the
rules leave whole (``wif``, ``if_bias``, sLSTM's ``r``) is cut to the rank's
head (and part), its gradient gathered; the gates are computed by each of a
head's g ranks. What a head's ranks share goes over the head's group
(``HeadPart``), as XLA's GSPMD places the reference's cells:

- mLSTM (``mlstm_chunk_scan``/``mlstm_step`` with ``part``): q, k and v are
  the rank's P/g columns of its head; C holds its P/g value rows against
  every key column and n its P/g key columns. The scores q·k and the
  normaliser n·q are partial sums over the rank's columns, summed over the
  head's ranks (one all-reduce a chunk, both together); C·q and C's update
  read the chunk's q and k across the head's width, gathered over its ranks
  (one all-gather of both a chunk). Gathering the head's ``wq``/``wk``
  columns instead (q and k computed whole by each of its ranks) would move
  d_inner × P weights a call and compute g times the q and k projections:
  a rank's share of the cell at g = 4 about 0.5, not 0.25. The compiled
  reference does the same in its chunk loop: it gathers k and q and
  all-reduces the two partial sums together. A chunk's collectives stay in
  its own backward, so a longer sequence only repeats chunks (what the dry
  run's extrapolation in the length reads).
- sLSTM (``slstm_step`` with ``part``): the rank holds its head's Dh/g units
  of every gate (``w``'s blocks moved to it, as on whole heads) and of the
  state; each step gathers the head's hidden state over its ranks (B, Dh)
  and multiplies it by ``r[:, head, :, part]``. The compiled reference also
  issues one collective a step over the head's ranks, but of the gates'
  input projections (it holds a gate of a head a rank and the head's state
  whole on each of its ranks): four times the bytes, and each rank runs the
  head's whole recurrence.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.common.config import ModelConfig
from repro_torch.models.layers import RMSNorm, truncated_normal

MLSTM_CHUNK = 256           # mlstm_forward's chunk in the JAX package
NEG_INIT = -1e9             # the stabilisers' initial value, as the JAX package's


class _View(NamedTuple):
    """What a cell's body reads on this rank: its number of heads, its
    input projection(s) of x (``proj``), the weights by name, the norm of
    a (..., this rank's heads' columns) tensor and the output projection;
    ``part`` (``tensor.HeadPart``) where it holds a part of one head."""
    heads: int
    proj: Callable
    w: dict
    norm: Callable
    out: Callable
    part: Optional[object] = None


def _heads_cols(tp, x: torch.Tensor, w: torch.Tensor, ex) -> torch.Tensor:
    """``x @ w`` on this rank's stored column block of ``w``, its columns
    moved to this rank's heads by ``ex`` (``tp.to_heads``)."""
    y = tp.copy_in(x) @ tp.gather_batch(w).to(x.dtype)
    return tp.to_heads(y, ex, y.dim() - 1)


def _head_cols(tp, x: torch.Tensor, heads: int, dim: int) -> torch.Tensor:
    """This rank's heads of ``dim`` of ``x``, which the rules leave whole:
    its ``1/model`` of them, or the one head it holds a part of (each head
    repeated for its g ranks). The backward gathers the ranks' gradients
    (a head's g summed), so each rank's is the whole's."""
    g = tp.size // heads
    return tp.chunk(x.repeat_interleave(g, dim) if g > 1 else x, dim)


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

    tp = None

    def heads_split(self) -> bool:
        """The cell computes on this rank's heads: a mesh whose ``model``
        divides the heads, and the rules' placements (columns of
        ``in_proj``/``conv_w``/``conv_b``, heads of ``A_log``/``dt_bias``/
        ``D``, rows of ``out_proj`` over ``model``)."""
        tp = self.tp
        return (tp is not None and tp.heads_over_model(mamba_dims(self.cfg)[1])
                and tp.split_on((self.in_proj, 1), (self.conv_w, 1), (self.conv_b, 0),
                                (self.A_log, 0), (self.dt_bias, 0), (self.D, 0),
                                (self.out_proj, 0)))

    def exchanges(self):
        """The ``ColumnExchange`` of in_proj's columns (z | x | B | C | dt: a
        rank reads its heads' z, x and dt and every B and C column) and of
        the conv channels (x | B | C)."""
        s, tp = self.cfg.ssm, self.tp
        d_inner, h, conv_dim = mamba_dims(self.cfg)
        bc = 2 * s.state_dim
        return (tp.exchange(2 * d_inner + bc + h, ((0, d_inner, False), (d_inner, d_inner, False),
                                                   (2 * d_inner, bc, True),
                                                   (2 * d_inner + bc, h, False))),
                tp.exchange(conv_dim, ((0, d_inner, False), (d_inner, bc, True))))

    def _view(self, use_kernel: bool) -> _View:
        names = ("conv_w", "conv_b", "A_log", "dt_bias", "D")
        if not self.heads_split():
            return _View(mamba_dims(self.cfg)[1], lambda x: x @ self.in_proj.to(x.dtype),
                         {n: getattr(self, n) for n in names},
                         lambda y: self.norm(y, use_kernel),
                         lambda y: y @ self.out_proj.to(y.dtype))
        tp = self.tp
        ex_in, ex_conv = self.exchanges()
        w = {n: tp.to_heads(getattr(self, n), ex_conv, getattr(self, n).dim() - 1)
             for n in ("conv_w", "conv_b")}
        w.update({n: getattr(self, n) for n in ("A_log", "dt_bias", "D")})
        return _View(mamba_dims(self.cfg)[1] // tp.size,
                     lambda x: _heads_cols(tp, x, self.in_proj, ex_in), w,
                     lambda y: self.norm(y, use_kernel, tp),
                     lambda y: tp.reduce_out(y @ tp.gather_batch(self.out_proj).to(y.dtype)))

    def _split(self, zxbcdt, h: int):
        """z, xBC and dt of ``h`` heads' columns (this rank's)."""
        s = self.cfg.ssm
        d_inner = h * s.head_dim
        conv_dim = d_inner + 2 * s.state_dim
        return (zxbcdt[..., :d_inner], zxbcdt[..., d_inner:d_inner + conv_dim],
                zxbcdt[..., zxbcdt.shape[-1] - h:])

    def forward(self, x, state: Optional[MambaCache] = None, use_kernel: bool = True):
        """Full sequence (``mamba2_forward``). x: (B, L, D). Returns (out,
        MambaCache of the final conv inputs, in x's dtype, and SSM state);
        on this rank's heads (and their conv channels) where ``heads_split``."""
        s = self.cfg.ssm
        v = self._view(use_kernel)
        h = v.heads
        d_inner = h * s.head_dim
        b, l, _ = x.shape
        z, xbc, dt_raw = self._split(v.proj(x), h)
        xbc, conv_state = causal_depthwise_conv(xbc, v.w["conv_w"], v.w["conv_b"],
                                                None if state is None else state.conv)
        xin = xbc[..., :d_inner].reshape(b, l, h, s.head_dim)
        Bm = xbc[..., d_inner:d_inner + s.state_dim]
        Cm = xbc[..., d_inner + s.state_dim:]
        dt = F.softplus(dt_raw.float() + v.w["dt_bias"])
        a_log = dt * -torch.exp(v.w["A_log"])
        s0 = (state.ssm if state is not None else
              x.new_zeros((b, h, s.head_dim, s.state_dim), dtype=torch.float32))
        y, s_final = ssd_chunk_scan(xin, dt, a_log, Bm, Cm, s0, s.chunk_size)
        y = y + v.w["D"][None, None, :, None] * xin.float()
        y = y.reshape(b, l, d_inner).to(x.dtype)
        return v.out(v.norm(y * F.silu(z))), MambaCache(conv_state.to(x.dtype), s_final)

    def decode(self, x, state: MambaCache, use_kernel: bool = True):
        """One token (``mamba2_decode``). x: (B, 1, D)."""
        s = self.cfg.ssm
        v = self._view(use_kernel)
        h = v.heads
        d_inner = h * s.head_dim
        b = x.shape[0]
        z, xbc_t, dt_raw = self._split(v.proj(x[:, 0]), h)
        window = torch.cat([state.conv.to(x.dtype), xbc_t[:, None]], dim=1)    # (B, W, C)
        xbc = F.silu(torch.einsum("bwc,wc->bc", window, v.w["conv_w"].to(x.dtype))
                     + v.w["conv_b"].to(x.dtype))
        xin = xbc[..., :d_inner].reshape(b, h, s.head_dim)
        Bm = xbc[..., d_inner:d_inner + s.state_dim]
        Cm = xbc[..., d_inner + s.state_dim:]
        dt = F.softplus(dt_raw.float() + v.w["dt_bias"])                         # (B, H)
        a = torch.exp(dt * -torch.exp(v.w["A_log"]))
        s_new = (a[:, :, None, None] * state.ssm
                 + torch.einsum("bh,bn,bhp->bhpn", dt, Bm.float(), xin.float()))
        y = torch.einsum("bn,bhpn->bhp", Cm.float(), s_new)
        y = y + v.w["D"][None, :, None] * xin.float()
        y = y.reshape(b, 1, d_inner).to(x.dtype)
        return v.out(v.norm(y * F.silu(z[:, None]))), MambaCache(window[:, 1:], s_new)

    def state_to_heads(self, cache: MambaCache) -> MambaCache:
        """A cache of the rules' shards -> this rank's conv channels and heads
        (``cache_spec`` puts ``model`` on the conv channels, which it divides
        where it divides the heads)."""
        tp = self.tp
        return MambaCache(self.exchanges()[1].move(cache.conv, tp.model, 2),
                          tp.cache_to_heads(cache.ssm, 1))

    def keep_state(self, cache: MambaCache, state: MambaCache) -> None:
        """This rank's new conv channels and heads written into its shards."""
        tp = self.tp
        cache.conv.copy_(self.exchanges()[1].restore(state.conv, tp.model, 2))
        tp.keep_heads(cache.ssm, state.ssm, 1)


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


def _whole_qk(q, k, part):
    """q and k across the head's width: themselves, or on a part of a head
    gathered over its ranks (one all-gather of both)."""
    if part is None:
        return q, k
    return part.gather(torch.stack([q, k]), -1).unbind(0)


def mlstm_step(state: MLSTMCache, q, k, v, i_raw, f_raw, part=None):
    """One time step. q/k/v: (B, H, P); i_raw/f_raw: (B, H). Stabilised
    exponential gating: the stored state is C~ = C e^{-m};
    h = C~ q / max(|n~ . q|, e^{-m}). On a part of a head (``part``): q/k/v
    its P/g columns, C (B, 1, P/g, P), n its P/g key columns (module
    docstring)."""
    C, n, m = state
    f_log = F.logsigmoid(f_raw)
    m_new = torch.maximum(f_log + m, i_raw)
    i_g = torch.exp(i_raw - m_new)
    f_g = torch.exp(f_log + m - m_new)
    k_s = k / (q.shape[-1] * (part.g if part else 1)) ** 0.5
    q_all, k_all = _whole_qk(q, k_s, part)
    C_new = f_g[..., None, None] * C + i_g[..., None, None] * torch.einsum("bhp,bhq->bhpq",
                                                                          v, k_all)
    n_new = f_g[..., None] * n + i_g[..., None] * k_s
    num = torch.einsum("bhpq,bhq->bhp", C_new, q_all)
    nq = torch.einsum("bhp,bhp->bh", n_new, q)
    den = torch.maximum((nq if part is None else part.sum(nq)).abs(), torch.exp(-m_new))
    return MLSTMCache(C_new, n_new, m_new), num / den[..., None]


def mlstm_chunk_scan(q, k, v, i_raw, f_raw, state: MLSTMCache, chunk: int, part=None):
    """Chunkwise-parallel mLSTM: attention-like within a chunk, the state
    carried across chunks. q/k/v: (B, L, H, P) float32; i_raw/f_raw: (B, L, H)
    float32. Padded steps are the identity (i = -1e9: no input; f = +1e9:
    log sigmoid 0, no decay). Returns (B, L, H, P) and the final state. On a
    part of a head (``part``) as ``mlstm_step``: each chunk's q and k
    gathered over the head's ranks in one all-gather, its scores and
    normaliser summed over them in one all-reduce."""
    b, l, h, p = q.shape
    qn = min(chunk, l)
    nc = -(-l // qn)
    pad = nc * qn - l
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        i_raw = F.pad(i_raw, (0, 0, 0, pad), value=-1e9)
        f_raw = F.pad(f_raw, (0, 0, 0, pad), value=1e9)
    k = k / (p * (part.g if part else 1)) ** 0.5
    mask = torch.ones(qn, qn, dtype=torch.bool, device=q.device).tril()[None, :, :, None]
    C, n, m0 = (t.float() for t in state)
    ys = []
    for c in range(nc):
        sl = slice(c * qn, (c + 1) * qn)
        qc, kc, vc, ic, fc = q[:, sl], k[:, sl], v[:, sl], i_raw[:, sl], f_raw[:, sl]
        qa, ka = _whole_qk(qc, kc, part)
        ell = torch.cumsum(F.logsigmoid(fc), dim=1)                  # (B, q, H)
        # log-weights D[i, j] = ell_i - ell_j + i_j for j <= i
        D = torch.where(mask, ell[:, :, None, :] - ell[:, None, :, :] + ic[:, None, :, :],
                        float("-inf"))
        g = ell + m0[:, None, :]                                      # the state's path
        m_i = torch.maximum(D.amax(dim=2), g)                         # (B, q, H)
        qk = torch.einsum("bihp,bjhp->bijh", qc, kc)
        nq = torch.einsum("bhp,bihp->bih", n, qc)
        if part is not None:
            both = part.sum(torch.cat([qk.flatten(1), nq.flatten(1)], dim=1))
            qk, nq = both[:, :qk[0].numel()].view_as(qk), both[:, qk[0].numel():].view_as(nq)
        s = torch.exp(D - m_i[:, :, None, :]) * qk
        u = torch.exp(g - m_i)
        num = (torch.einsum("bijh,bjhp->bihp", s, vc)
               + u[..., None] * torch.einsum("bhpq,bihq->bihp", C, qa))
        den_dot = s.sum(dim=2) + u * nq
        ys.append(num / torch.maximum(den_dot.abs(), torch.exp(-m_i))[..., None])
        # the state at the chunk's end
        lq = ell[:, -1:, :]
        m_state = torch.maximum(lq[:, 0] + m0, (lq - ell + ic).amax(dim=1))
        wS = torch.exp(lq - ell + ic - m_state[:, None, :])           # (B, q, H)
        carry = torch.exp(lq[:, 0] + m0 - m_state)
        C = carry[:, :, None, None] * C + torch.einsum("bjh,bjhp,bjhq->bhpq", wS, vc, ka)
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

    tp = None

    def heads_split(self) -> bool:
        """The cell computes on a share of its heads on this rank: ``model``
        divides the heads (the rank's heads) or is a multiple of them whose
        factor divides the head width (a part of one head, ``head_part``),
        and the rules' placements hold (columns of ``up`` and ``wq``/``wk``/
        ``wv``, rows of ``down`` over ``model``; ``wif`` whole over it)."""
        tp = self.tp
        _, h, p = mlstm_dims(self.cfg)
        return (tp is not None
                and (tp.heads_over_model(h) or tp.parts_over_model(h, p))
                and tp.split_on((self.up, 1), (self.wq, 1), (self.wk, 1), (self.wv, 1),
                                (self.down, 0))
                and tp.split_dim(self.wif) is None)

    def head_part(self):
        """This rank's head and part (``tensor.HeadPart``) where the cell
        computes on a part of one head, else None."""
        _, h, p = mlstm_dims(self.cfg)
        split = self.heads_split() and self.tp.parts_over_model(h, p)
        return self.tp.head_part(h) if split else None

    def _view(self, use_kernel: bool) -> _View:
        names = ("wq", "wk", "wv", "wif", "if_bias")
        if not self.heads_split():
            return _View(self.cfg.n_heads, lambda x: x @ self.up.to(x.dtype),
                         {n: getattr(self, n) for n in names},
                         lambda y: self.norm(y, use_kernel),
                         lambda y: y @ self.down.to(y.dtype))
        tp, part = self.tp, self.head_part()
        d_inner, h, _ = mlstm_dims(self.cfg)
        hl = 1 if part else h // tp.size
        # up's columns xi | z: every head reads all of xi, a rank its heads' z
        # (or its part of its head's)
        ex = tp.exchange(2 * d_inner, ((0, d_inner, True), (d_inner, d_inner, False)))
        w = {n: tp.gather_batch(getattr(self, n)) for n in ("wq", "wk", "wv")}
        w["wif"] = _head_cols(tp, tp.gather_batch(self.wif).reshape(d_inner, 2, h), h,
                              2).reshape(d_inner, 2 * hl)
        w["if_bias"] = _head_cols(tp, self.if_bias.reshape(2, h), h, 1).reshape(2 * hl)
        return _View(hl, lambda x: _heads_cols(tp, x, self.up, ex), w,
                     lambda y: self.norm(y, use_kernel, tp),
                     lambda y: tp.reduce_out(y @ tp.gather_batch(self.down).to(y.dtype)), part)

    def _zero_state(self, batch: int, heads: int, g: int = 1) -> MLSTMCache:
        """Zeros (m at -1e9) for ``heads`` heads, or a head's 1/``g``."""
        p = mlstm_dims(self.cfg)[2]
        kw = dict(dtype=torch.float32, device=self.up.device)
        return MLSTMCache(torch.zeros(batch, heads, p // g, p, **kw),
                          torch.zeros(batch, heads, p // g, **kw),
                          torch.full((batch, heads), NEG_INIT, **kw))

    def init_cache(self, batch: int, dtype=None) -> MLSTMCache:
        """The zero state, float32 whatever the model's dtype."""
        return self._zero_state(batch, self.cfg.n_heads)

    def forward(self, x, state: Optional[MLSTMCache] = None, use_kernel: bool = True):
        """``mlstm_forward``: one step for L = 1, else the chunked form; on
        this rank's heads, or its part of one, where ``heads_split``."""
        d_inner, _, p = mlstm_dims(self.cfg)
        v = self._view(use_kernel)
        h, part = v.heads, v.part
        g = part.g if part else 1
        b, l, _ = x.shape
        up = v.proj(x)
        xi, z = up[..., :d_inner], up[..., d_inner:]
        q, k, vv = ((xi @ v.w[n].to(x.dtype)).reshape(b, l, h, p // g).float()
                    for n in ("wq", "wk", "wv"))
        if_raw = (xi @ v.w["wif"].to(x.dtype)).float() + v.w["if_bias"]
        i_raw, f_raw = if_raw[..., :h], if_raw[..., h:]
        if state is None:
            state = self._zero_state(b, h, g)
        if l == 1:
            state, hs = mlstm_step(state, q[:, 0], k[:, 0], vv[:, 0], i_raw[:, 0], f_raw[:, 0],
                                   part)
            hs = hs[:, None]
        else:
            hs, state = mlstm_chunk_scan(q, k, vv, i_raw, f_raw, state, MLSTM_CHUNK, part)
        hs = v.norm(hs.reshape(b, l, h * p // g).to(x.dtype)) * F.silu(z)
        return v.out(hs), state

    decode = forward

    def state_to_heads(self, cache: MLSTMCache) -> MLSTMCache:
        """A cache of the rules' shards -> this rank's heads (C on its P
        columns, as ``cache_spec`` puts it, moved to the heads), or its part
        of one (C's value rows, n's key columns, the head's m)."""
        tp, part = self.tp, self.head_part()
        if part is None:
            return MLSTMCache(*(tp.cache_to_heads(t, 1) for t in cache))
        return MLSTMCache(*(tp.cache_to_part(t, part, d) for t, d in zip(cache, (2, 2, None))))

    def keep_state(self, cache: MLSTMCache, state: MLSTMCache) -> None:
        tp, part = self.tp, self.head_part()
        for dst, src, d in zip(cache, state, (2, 2, None)):
            if part is None:
                tp.keep_heads(dst, src, 1)
            else:
                tp.keep_part(dst, src, part, d)


# ===========================================================================
# xLSTM: sLSTM (scalar memory, block-diagonal recurrence)
# ===========================================================================

class SLSTMCache(NamedTuple):
    c: torch.Tensor  # (B, H, Dh)
    n: torch.Tensor  # (B, H, Dh)
    h: torch.Tensor  # (B, H, Dh)
    m: torch.Tensor  # (B, H, Dh)


def slstm_step(r_cat, state: SLSTMCache, wx_t, part=None):
    """One time step. r_cat: (H, Dh, 4 Dh), the recurrence with the four
    gates' columns side by side; wx_t: (B, 4, H, Dh) input projections for
    the gates i, f, z, o. On a part of a head (``part``): the state and wx_t
    on the rank's Dh/g units, r_cat (1, Dh, 4 Dh/g) its units' columns, and
    the head's hidden state gathered over its ranks first."""
    c, n, h_prev, m = state
    h_in = h_prev if part is None else part.gather(h_prev, 2)
    b, hh, dh = h_prev.shape
    rec = torch.bmm(h_in.transpose(0, 1), r_cat).reshape(hh, b, 4, dh).permute(1, 2, 0, 3)
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

    tp = None

    def heads_split(self) -> bool:
        """The cell computes on a share of its heads on this rank: ``model``
        divides the heads and the rules put ``r``'s heads over it (the
        rank's heads), or it is a multiple of them whose factor divides the
        head width and ``r`` is whole (a part of one head, ``head_part``);
        and the rules' columns of ``w`` and ``out`` over ``model``."""
        tp = self.tp
        h = self.cfg.n_heads
        return (tp is not None and tp.split_on((self.w, 1), (self.out, 1))
                and (tp.heads_over_model(h) and tp.split_on((self.r, 1))
                     or tp.parts_over_model(h, self.cfg.d_model // h)
                     and tp.split_dim(self.r) is None))

    def head_part(self):
        """This rank's head and part (``tensor.HeadPart``) where the cell
        computes on a part of one head, else None."""
        h = self.cfg.n_heads
        split = self.heads_split() and self.tp.parts_over_model(h, self.cfg.d_model // h)
        return self.tp.head_part(h) if split else None

    def _view(self, use_kernel: bool) -> _View:
        if not self.heads_split():
            return _View(self.cfg.n_heads, lambda x: x @ self.w.to(x.dtype),
                         {"b": self.b, "r": self.r},
                         lambda y: self.norm(y, use_kernel),
                         lambda y: y @ self.out.to(y.dtype))
        tp, part = self.tp, self.head_part()
        d, h = self.cfg.d_model, self.cfg.n_heads
        dh = d // h
        # w's columns are the gates i | f | z | o: a rank reads its units' of
        # each (its heads', or its part of its head's)
        ex = tp.exchange(4 * d, tuple((g * d, d, False) for g in range(4)))
        w = {"b": tp.chunk(self.b.reshape(4, d), 1).reshape(-1)}
        if part is None:
            w["r"] = tp.gather_batch(self.r)
        else:       # r[:, head, :, part]: (4, 1, Dh, Dh/g)
            cols = tp.gather_batch(self.r).permute(0, 2, 1, 3).reshape(4, dh, d)
            w["r"] = tp.chunk(cols, 2)[:, None]
        return _View(1 if part else h // tp.size, lambda x: _heads_cols(tp, x, self.w, ex), w,
                     lambda y: self.norm(y, use_kernel, tp),
                     lambda y: tp.reduce_out(y @ tp.rows_of(tp.gather_batch(self.out)).to(y.dtype)),
                     part)

    def _zero_state(self, batch: int, heads: int, g: int = 1) -> SLSTMCache:
        """Zeros (m at -1e9) for ``heads`` heads, or a head's 1/``g``."""
        shape = (batch, heads, self.cfg.d_model // self.cfg.n_heads // g)
        kw = dict(dtype=torch.float32, device=self.w.device)
        return SLSTMCache(torch.zeros(shape, **kw), torch.zeros(shape, **kw),
                          torch.zeros(shape, **kw), torch.full(shape, NEG_INIT, **kw))

    def init_cache(self, batch: int, dtype=None) -> SLSTMCache:
        """The zero state (m at -1e9), float32."""
        return self._zero_state(batch, self.cfg.n_heads)

    def forward(self, x, state: Optional[SLSTMCache] = None, use_kernel: bool = True):
        """``slstm_forward``: the time-step loop from ``state`` (or zeros); on
        this rank's heads where ``heads_split``."""
        v = self._view(use_kernel)
        h, part = v.heads, v.part
        g = part.g if part else 1
        dh = self.cfg.d_model // self.cfg.n_heads
        b, l, _ = x.shape
        wx = (v.proj(x).float() + v.w["b"]).reshape(b, l, 4, h, dh // g)
        r_cat = v.w["r"].float().permute(1, 2, 0, 3).reshape(h, dh, 4 * dh // g)
        if state is None:
            state = self._zero_state(b, h, g)
        hs = []
        for wx_t in wx.unbind(1):      # one backward node for every step's slice
            state = slstm_step(r_cat, state, wx_t, part)
            hs.append(state.h)
        hs = torch.stack(hs, dim=1).reshape(b, l, h * dh // g).to(x.dtype)
        return v.out(v.norm(hs)), state

    decode = forward

    def state_to_heads(self, cache: SLSTMCache) -> SLSTMCache:
        """A cache of the rules' shards (on Dh, as ``cache_spec`` puts it) ->
        this rank's heads, or its units of one."""
        tp, part = self.tp, self.head_part()
        if part is None:
            return SLSTMCache(*(tp.cache_to_heads(t, 1) for t in cache))
        return SLSTMCache(*(tp.cache_to_part(t, part, 2) for t in cache))

    def keep_state(self, cache: SLSTMCache, state: SLSTMCache) -> None:
        tp, part = self.tp, self.head_part()
        for dst, src in zip(cache, state):
            if part is None:
                tp.keep_heads(dst, src, 1)
            else:
                tp.keep_part(dst, src, part, 2)
