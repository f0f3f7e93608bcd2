"""Mamba2 SSD block (state-space duality, arXiv:2405.21060) — the port of
``repro.models.ssm``, full-sequence path.

The sequence transform is the chunked SSD scan, run through
``kernels.ops.ssd_scan``: the hand-written kernel on a CUDA tensor, the
plain chunked version on a CPU tensor.  Rounding follows the reference:
``in_proj`` accumulates in f32 and is cast to the activation dtype; the
depthwise conv accumulates tap by tap in f32, then applies silu and casts;
softplus of dt runs in f32; ``d_skip`` is added in the activation dtype; the
gated RMSNorm and an f32-accumulated ``out_proj`` come last.  The one-token
decode path (``apply_decode``, ``ssd_decode_step``) is plain PyTorch, as the
reference computes it in jnp: the conv over the cached inputs and the new
one, then one step of the recurrence on the f32 state.

Tensor parallel over "model" (the production layout of
``repro_torch.sharding``, where the axis divides the heads and the state,
:func:`splits`): when ``a_log`` holds fewer heads than the config, the
leaves are this rank's shards (``in_proj``'s columns ``[z_r, x_r, B_r,
C_r, dt_r]``, the conv's channels ``[x_r, B_r, C_r]``, the heads' ``norm``
rows and ``out_proj`` rows) and the block runs its local heads, read from
the shards' shapes.  The normed input enters through *f*.  Every head
reads all of B and C (one state group), so the full-sequence path
gathers their columns of ``in_proj``, ``conv_w`` and ``conv_b`` over
"model" (``sharding.gather_model_sum``: a rank's gradient of them is its
heads' part, summed in the backward) and computes B and C whole; the
scan runs on (B, L, H / mp, P).  The gated RMSNorm divides by the whole
inner width's statistic: each rank's sum of squares is all-reduced
(``sharding.sum_over_model``).  ``out_proj``'s output is a partial sum
that *g* adds in f32.  The decode step computes its B and C channels
locally (the conv is depthwise) and all-gathers them; its caches hold the
rank's conv channels ``[x_r, B_r, C_r]`` and its heads' states.  With
whole leaves the block is the single-device one.  On the
activation-gathered route ``in_proj`` (its d rows a "data" shard, the
gathered B / C columns too) goes through ``layers.dense`` and
``out_proj`` through ``layers.row_parallel``.

Shapes (per layer):
  x   (B, L, H, P)   values (H = d_inner/head_dim heads, P = head_dim)
  dt  (B, L, H)      positive step sizes (softplus)
  A   (H,)           negative decay rates
  Bm  (B, L, N)      input projections (single state group, mamba2 default)
  Cm  (B, L, N)      output projections
  state (B, H, P, N) recurrent state
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import sharding as shlib
from repro_torch.config import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.params import P

F32 = torch.float32


class SSMCache(NamedTuple):
    conv: torch.Tensor    # (B, d_conv-1, conv_dim) trailing conv inputs
    state: torch.Tensor   # (B, H, P, N)


def dims(cfg: ArchConfig) -> Dict[str, int]:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    conv_dim = d_in + 2 * s.d_state
    return dict(d_in=d_in, H=H, P=s.head_dim, N=s.d_state,
                conv_dim=conv_dim, Q=s.chunk, d_conv=s.d_conv)


def splits(cfg: ArchConfig, mp: int) -> bool:
    """Whether the block runs tensor-parallel over a "model" axis of
    ``mp`` ranks: ``mp`` divides its heads and its state width."""
    m = dims(cfg)
    return mp > 1 and m["H"] % mp == 0 and m["N"] % mp == 0


def spec(cfg: ArchConfig) -> Dict:
    d = cfg.d_model
    m = dims(cfg)
    proj_out = 2 * m["d_in"] + 2 * m["N"] + m["H"]
    conv = (m["d_in"], m["N"], m["N"])
    return {
        "in_proj": P((d, proj_out), ("embed", "inner"),
                     parts=(m["d_in"],) + conv + (m["H"],)),
        "conv_w": P((m["d_conv"], m["conv_dim"]), ("conv", "inner"), "small",
                    parts=conv),
        "conv_b": P((m["conv_dim"],), ("inner",), "zeros", parts=conv),
        "a_log": P((m["H"],), ("ssm_heads",), "small", 0.5),
        "d_skip": P((m["H"],), ("ssm_heads",), "ones"),
        "dt_bias": P((m["H"],), ("ssm_heads",), "small", 0.5),
        "norm": P((m["d_in"],), ("inner",), "ones"),
        "out_proj": P((m["d_in"], d), ("inner", "embed_r")),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv. u: (B, L, C); w: (K, C); returns (B, L, C).
    The taps are summed one by one in f32 (no cuDNN: its f32 convolutions
    run in TF32 by default); a long sequence without gradients a piece of
    outputs at a time (``layers.seq_pieces``), each from the K - 1 inputs
    before it on."""
    K, L = w.shape[0], u.shape[1]
    wf = w.to(F32)

    def taps(s: int, n: int) -> torch.Tensor:
        """Outputs [s, s + n) from inputs [s - K + 1, s + n), zero before
        the first."""
        up = F.pad(u[:, max(s - K + 1, 0):s + n],
                   (0, 0, max(K - 1 - s, 0), 0)).to(F32)
        # the reference's sum 0 + p0 + p1 + ..., rounded at the same places
        out = up[:, :n] * wf[0]
        for i in range(1, K):
            out += up[:, i:i + n] * wf[i]
        return F.silu(out + b.to(F32)).to(u.dtype)

    return layers.seq_pieces(taps, L)


def _local(p: Dict, cfg: ArchConfig):
    """(``dims`` at this rank's heads (its d_in and H), its share ``n`` of
    the state's B and C columns (N without tensor parallelism), the
    "model" group or None), read from ``a_log``'s shard."""
    m = dims(cfg)
    tp = shlib.tp_for(p["a_log"].shape[-1], m["H"])
    if tp is not None:
        m["H"] //= tp.size
        m["d_in"] //= tp.size
    return m, (m["N"] if tp is None else m["N"] // tp.size), tp


def _split_proj(m: Dict, zxbcdt: torch.Tensor, n: int):
    """(z, x, B and C, dt) of the projection, at the widths of ``m`` and
    B and C ``n`` wide each."""
    return torch.split(zxbcdt, [m["d_in"], m["d_in"], 2 * n, m["H"]],
                       dim=-1)


def _whole_bc(p: Dict, m: Dict, n: int, tp) -> Tuple[torch.Tensor, ...]:
    """``in_proj``, ``conv_w`` and ``conv_b`` at this rank's heads with
    the B and C columns whole: the ranks' B and C columns of the three
    gathered over "model" in one collective (its backward sums each
    rank's part of their gradient) and put back in order."""
    w, cw, cb = p["in_proj"], p["conv_w"], p["conv_b"]
    d_in, d, K = m["d_in"], w.shape[0], cw.shape[0]
    bc = torch.cat([w[:, 2 * d_in:2 * d_in + 2 * n], cw[:, d_in:],
                    cb[None, d_in:]], 0)
    bc = shlib.unpack(shlib.gather_model_sum(bc, 1, tp), 1,
                      (m["N"], m["N"]), tp.size)
    return (torch.cat([w[:, :2 * d_in], bc[:d], w[:, 2 * d_in + 2 * n:]], 1),
            torch.cat([cw[:, :d_in], bc[d:d + K]], 1),
            torch.cat([cb[:d_in], bc[d + K]], 0))


def _norm_and_out(p: Dict, cfg: ArchConfig, y: torch.Tensor,
                  xh: torch.Tensor, z: torch.Tensor, tp) -> torch.Tensor:
    """The skip (``d_skip`` times the scan's input xh, both (B, S, H, P)),
    the gated RMSNorm over the inner width (its statistic over every
    rank's slice under tensor parallelism) and ``out_proj`` (its f32
    partial sums added by *g* and rounded once).  Whole heads take a long
    sequence without gradients in pieces (``layers.seq_pieces``)."""
    def norm_out(y, xh, z):
        y = y + xh * p["d_skip"].to(xh.dtype)[:, None]
        y = y.reshape(*z.shape[:2], -1)
        y = layers.rmsnorm(p["norm"], y * F.silu(z.to(F32)).to(y.dtype),
                           cfg.norm_eps, tp)
        return layers.row_parallel(y, p["out_proj"], tp, cfg.d_model)

    if tp is None:
        return layers.seq_pieces(lambda s, n: norm_out(
            y[:, s:s + n], xh[:, s:s + n], z[:, s:s + n]), y.shape[1])
    return shlib.reduce_from_model(norm_out(y, xh, z), tp, y.dtype)


def apply_full(p: Dict, cfg: ArchConfig, x: torch.Tensor, *,
               return_cache: bool = False
               ) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    """Full-sequence SSD block. x: (B, S, d).  Under tensor parallelism
    (module docstring) the cache holds the rank's conv channels and its
    heads' states."""
    m, n, tp = _local(p, cfg)
    B, S, _ = x.shape
    w_in, conv_w, conv_b = p["in_proj"], p["conv_w"], p["conv_b"]
    if tp is not None:
        x = shlib.copy_to_model(x, tp)
        w_in, conv_w, conv_b = _whole_bc(p, m, n, tp)
    zxbcdt = layers.dense(x, w_in)
    z, _, _, dt_raw = _split_proj(m, zxbcdt, m["N"])
    # x, B and C: adjacent columns of the projection, read in place
    conv_in = zxbcdt[..., m["d_in"]:2 * (m["d_in"] + m["N"])]
    conv_out = _causal_conv(conv_in, conv_w, conv_b)
    xin = conv_out[..., :m["d_in"]]
    bm = conv_out[..., m["d_in"]:m["d_in"] + m["N"]]
    cm = conv_out[..., m["d_in"] + m["N"]:]
    dt = F.softplus(dt_raw.to(F32) + p["dt_bias"].to(F32)).contiguous()
    a = -torch.exp(p["a_log"].to(F32))
    xh = xin.reshape(B, S, m["H"], m["P"])
    y, final_state = ops.ssd_scan(xh, dt, a, bm, cm, chunk=m["Q"])
    out = _norm_and_out(p, cfg, y, xh, z, tp)
    cache = None
    if return_cache:
        tail = conv_in[:, S - (m["d_conv"] - 1):, :]
        if tp is not None:     # the rank's [x_r, B_r, C_r] channels
            tail = torch.cat([tail[..., :m["d_in"]], shlib.pack_cut(
                tail[..., m["d_in"]:], 2, (m["N"], m["N"]), tp.size,
                tp.rank)], -1)
        cache = SSMCache(conv=tail, state=final_state)
    return out, cache


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    a: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrence. state (B,H,P,N); x (B,H,P); dt (B,H);
    bm/cm (B,N). Returns (y (B,H,P), new_state (f32))."""
    dA = torch.exp(dt.to(F32) * a.to(F32))                # (B,H)
    upd = torch.einsum("bh,bn,bhp->bhpn", dt.to(F32), bm.to(F32),
                       x.to(F32))
    new_state = state.to(F32) * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, cm.to(F32))
    return y.to(x.dtype), new_state


def apply_decode(p: Dict, cfg: ArchConfig, x: torch.Tensor, cache: SSMCache
                 ) -> Tuple[torch.Tensor, SSMCache]:
    """One-token decode. x: (B, 1, d).  Returns the output and the new
    cache (the conv window moved by one; the state after this token).
    Under tensor parallelism the conv runs on the rank's channels and the
    B and C outputs are gathered over "model" whole."""
    m, n, tp = _local(p, cfg)
    B = x.shape[0]
    if tp is not None:
        x = shlib.copy_to_model(x, tp)
    zxbcdt = layers.dense(x, p["in_proj"])
    z, xin, bc, dt_raw = _split_proj(m, zxbcdt, n)
    conv_in = torch.cat([xin, bc], dim=-1)                 # (B,1,conv_dim)
    full = torch.cat([cache.conv.to(x.dtype), conv_in], dim=1)
    co = (full.to(F32) * p["conv_w"].to(F32)[None]).sum(dim=1) \
        + p["conv_b"].to(F32)
    co = F.silu(co).to(x.dtype)                            # (B, conv_dim)
    xin1 = co[:, :m["d_in"]].reshape(B, m["H"], m["P"])
    bc1 = co[:, m["d_in"]:]
    if tp is not None:
        bc1 = shlib.unpack(shlib.gather_model(bc1, 1, tp), 1,
                           (m["N"], m["N"]), tp.size)
    bm1, cm1 = bc1[:, :m["N"]], bc1[:, m["N"]:]
    dt = F.softplus(dt_raw[:, 0].to(F32) + p["dt_bias"].to(F32))
    a = -torch.exp(p["a_log"].to(F32))
    y, new_state = ssd_decode_step(cache.state, xin1, dt, a, bm1, cm1)
    out = _norm_and_out(p, cfg, y[:, None], xin1[:, None], z, tp)
    return out, SSMCache(conv=full[:, 1:, :], state=new_state)


def init_cache_shapes(cfg: ArchConfig, batch: int):
    m = dims(cfg)
    return {
        "conv": ((batch, m["d_conv"] - 1, m["conv_dim"]),
                 ("batch", None, "inner")),
        "state": ((batch, m["H"], m["P"], m["N"]),
                  ("batch", "ssm_heads", None, None)),
    }
