"""Plain PyTorch versions of the hand-written kernels: the functions the
kernel wrappers compute, written with tensor ops.  ``kernels/ops.py`` routes
CPU tensors here; the tests hold them against the JAX package's oracles, and
``chip_smoke.py`` holds each CUDA kernel against them on the card."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

F32 = torch.float32
NEG_INF = -1e30
LOG2PI = math.log(2.0 * math.pi)


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int
            ) -> torch.Tensor:
    """Masked, scaled scores (B, Sq, K, G, Sk) in f32 (GQA groups split)."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, D).to(F32)
    s = torch.einsum("bskgd,btkd->bskgt", qg, k.to(F32)) * (D ** -0.5)
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window > 0:
        ok &= kp > qp - window
    return torch.where(ok[None, :, None, None, :], s,
                       torch.tensor(NEG_INF, dtype=F32, device=q.device))


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): ``flash_attention_ref``'s output, bitwise, and each row's
    log-sum-exp of the masked, scaled scores, f32 (B, H, Sq) — the
    statistic the backward recomputes the probabilities from."""
    B, Sq, H, _ = q.shape
    s = _scores(q, k, causal, window)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bskgt,btkd->bskgd", p, v.to(F32))
    lse = torch.logsumexp(s, dim=-1).reshape(B, Sq, H).transpose(1, 2)
    return (o.reshape(B, Sq, H, v.shape[-1]).to(q.dtype),
            lse.contiguous())


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B,Sq,H,D); k/v: (B,Sk,K,D/Dv) -> (B,Sq,H,Dv), softmax in f32."""
    return flash_attention_fwd_ref(q, k, v, causal=causal, window=window)[0]


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor, *,
                            causal: bool = True, window: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention_ref`` at upstream gradient ``do``,
    written out from the forward's ``lse`` (B, H, Sq), in f32 and cast to
    the inputs' dtypes:

        P = exp(S - lse),  dV = P^T dO,  dP = dO V^T,
        D_i = sum_d dO_i O_i,  dS = P (dP - D),
        dQ = scale dS K,  dK = scale dS^T Q

    with dK and dV summed over the query heads of each GQA group.  ``o`` is
    the forward's output as the caller kept it (rounded to its dtype), as
    the kernel's delta pass reads it."""
    B, Sq, H, D = q.shape
    K = k.shape[2]
    G = H // K
    scale = D ** -0.5
    s = _scores(q, k, causal, window)
    lse_g = lse.transpose(1, 2).reshape(B, Sq, K, G, 1)
    p = torch.exp(s - lse_g)
    del s
    dog = do.reshape(B, Sq, K, G, -1).to(F32)
    dv = torch.einsum("bskgt,bskgd->btkd", p, dog)
    dp = torch.einsum("bskgd,btkd->bskgt", dog, v.to(F32))
    delta = (dog * o.reshape(B, Sq, K, G, -1).to(F32)).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    del p, dp
    qg = q.reshape(B, Sq, K, G, D).to(F32)
    dq = torch.einsum("bskgt,btkd->bskgd", ds, k.to(F32)) * scale
    dk = torch.einsum("bskgt,bskgd->btkd", ds, qg) * scale
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def sde_step_ref(v: torch.Tensor, x: torch.Tensor, t, t_next,
                 eps: torch.Tensor, *, eta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flow-SDE Euler–Maruyama step + Gaussian log-prob (paper Eq. 1).

    v, x, eps: (B, ...); t, t_next: scalars.  Returns (x_next, logp (B,)),
    both float32."""
    dev = x.device
    t = torch.as_tensor(t, dtype=F32, device=dev)
    t_next = torch.as_tensor(t_next, dtype=F32, device=dev)
    xf, vf = x.to(F32), v.to(F32)
    # σ argument clamped (FlowSDEScheduler.t_sigma_max); drift uses raw t
    tc = torch.clamp(t, 1e-4, 0.96)
    sigma = eta * torch.sqrt(tc / (1.0 - tc))
    delta = t - t_next
    drift = vf + (sigma ** 2 / (2.0 * t)) * (xf + (1.0 - t) * vf)
    mean = xf - drift * delta
    std = sigma * torch.sqrt(delta)
    x_next = mean + std * eps.to(F32)
    z = (x_next - mean) / std
    logp = -0.5 * (z * z + LOG2PI) - torch.log(std)
    return x_next, logp.reshape(x.shape[0], -1).sum(-1)


def grpo_loss_ref(logp_new: torch.Tensor, logp_old: torch.Tensor,
                  adv: torch.Tensor, *, clip: float, guard: bool = False,
                  ratio_mean: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PPO-clip objective per sample (optionally GRPO-Guard RatioNorm).

    logp_new/logp_old/adv: (B,).  Under ``guard`` the ratio is divided by
    max(``ratio_mean``, 1e-6), where ``ratio_mean`` defaults to the
    batch's own mean ratio (not differentiated).  Returns (per-sample loss,
    clip fraction), f32."""
    ratio = torch.exp(torch.clamp(logp_new - logp_old, -20.0, 20.0))
    if guard:
        mean = (ratio.detach().mean() if ratio_mean is None
                else torch.as_tensor(ratio_mean, dtype=F32,
                                     device=ratio.device).reshape(()))
        ratio = ratio / torch.clamp_min(mean, 1e-6)
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv
    loss = -torch.minimum(unclipped, clipped)
    frac = (torch.abs(ratio - 1.0) > clip).to(F32)
    return loss, frac


def grpo_loss_bwd_ref(logp_new: torch.Tensor, logp_old: torch.Tensor,
                      adv: torch.Tensor, g: torch.Tensor, *, clip: float
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closed-form VJP of the unguarded ``grpo_loss_ref`` at upstream
    gradient ``g`` (the reference's ``_gld_bwd``): (d_logp_new, d_logp_old,
    d_adv).  The log-ratio is active when the unclipped branch is the min,
    or when the ratio lies inside the clip band."""
    ratio = torch.exp(torch.clamp(logp_new - logp_old, -20.0, 20.0))
    a = adv.to(F32)
    unclipped = ratio * a
    rc = torch.clamp(ratio, 1.0 - clip, 1.0 + clip)
    clipped = rc * a
    in_band = torch.abs(ratio - 1.0) <= clip
    unclipped_min = unclipped <= clipped
    active = unclipped_min | in_band
    gf = g.to(F32)
    d_lpn = -a * ratio * active.to(F32) * gf
    d_adv = -torch.where(unclipped_min, ratio, rc) * gf
    return d_lpn, -d_lpn, d_adv


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 bm: torch.Tensor, cm: torch.Tensor, *,
                 init_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential (non-chunked) SSD recurrence — the ground truth, one step
    per token (for small shapes: at L = 4608 it is 4608 steps of small ops).

    x: (B,L,H,P); dt: (B,L,H); a: (H,); bm/cm: (B,L,N).
    Returns (y (B,L,H,P) in x's dtype, final_state (B,H,P,N) f32)."""
    B, L, H, P = x.shape
    N = bm.shape[-1]
    h = (torch.zeros((B, H, P, N), dtype=F32, device=x.device)
         if init_state is None else init_state.to(F32))
    af = a.to(F32)
    ys = []
    for t in range(L):
        dt_t = dt[:, t].to(F32)                                # (B,H)
        decay = torch.exp(dt_t * af)
        upd = torch.einsum("bh,bn,bhp->bhpn", dt_t, bm[:, t].to(F32),
                           x[:, t].to(F32))
        h = h * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, cm[:, t].to(F32)))
    return torch.stack(ys, dim=1).to(x.dtype), h


def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    bm: torch.Tensor, cm: torch.Tensor, chunk: int,
                    init_state: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan in f32 (``repro.models.ssm.ssd_chunked``): within a
    chunk the quadratic dual form, across chunks a recurrence over the
    (P, N) chunk states.  Shapes as ``ssd_scan_ref``; L must be a multiple
    of min(chunk, L)."""
    B, L, H, Pd = x.shape
    N = bm.shape[-1]
    Q = min(chunk, L)
    if L % Q:
        raise ValueError(f"ssd scan: sequence length {L} is no multiple of "
                         f"the chunk {Q}")
    nc = L // Q
    xf = x.to(F32).reshape(B, nc, Q, H, Pd)
    dtf = dt.to(F32).reshape(B, nc, Q, H)
    bf = bm.to(F32).reshape(B, nc, Q, N)
    cf = cm.to(F32).reshape(B, nc, Q, N)
    cum = torch.cumsum((dtf * a.to(F32)).transpose(2, 3), dim=-1)  # (B,nc,H,Q)

    # within-chunk (dual / quadratic form); exp only below the diagonal
    seg = cum[..., :, None] - cum[..., None, :]            # sum_{j+1..i}
    lower = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(lower, seg, float("-inf")))
    scores = cf @ bf.transpose(-1, -2)                     # (B,nc,Q,Q)
    xdt = (xf * dtf[..., None]).transpose(2, 3)            # (B,nc,H,Q,P)
    y = (scores[:, :, None] * decay) @ xdt                 # (B,nc,H,Q,P)
    del seg, decay

    # chunk states, then the recurrence over chunks
    total = cum[..., -1:]                                  # (B,nc,H,1)
    w = xdt * torch.exp(total - cum)[..., None]            # (B,nc,H,Q,P)
    states = w.transpose(-1, -2) @ bf[:, :, None]          # (B,nc,H,P,N)
    chunk_decay = torch.exp(total[..., 0])                 # (B,nc,H)
    h = (torch.zeros((B, H, Pd, N), dtype=F32, device=x.device)
         if init_state is None else init_state.to(F32))
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)                                  # state entering c
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                   # (B,nc,H,P,N)

    # carried-state contribution
    y_off = (cf[:, :, None] @ h_prev.transpose(-1, -2)) * torch.exp(
        cum)[..., None]                                    # (B,nc,H,Q,P)
    y = (y + y_off).transpose(2, 3).reshape(B, L, H, Pd)
    return y.to(x.dtype), h


def ssd_tensor_core_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                        bm: torch.Tensor, cm: torch.Tensor, chunk: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked scan as the bf16 tensor-core kernel rounds it
    (``csrc/ssd_scan.cu: ssd_scan_wgmma``), chunk by chunk from a zero
    state: S = C B^T exact; L' = S exp(cum[q] - cum[k]) dt[k] and the
    carried state h_prev rounded once to bf16 as product operands;
    xw = exp(total - cum) dt x split into bf16 hi + lo for the state
    update; every sum in f32.  Shapes and outputs as ``ssd_chunked_ref``.
    The kernel's own arithmetic, for rehearsing its precision; not a
    reference of the function."""
    B, L, H, Pd = x.shape
    N = bm.shape[-1]
    Q = min(chunk, L)
    if L % Q:
        raise ValueError(f"ssd scan: sequence length {L} is no multiple of "
                         f"the chunk {Q}")
    nc = L // Q
    bf16 = torch.bfloat16
    xf = x.to(F32).reshape(B, nc, Q, H, Pd).transpose(2, 3)   # (B,nc,H,Q,P)
    dtf = dt.to(F32).reshape(B, nc, Q, H).transpose(2, 3)     # (B,nc,H,Q)
    bf = bm.to(F32).reshape(B, nc, Q, N)
    cf = cm.to(F32).reshape(B, nc, Q, N)
    cum = torch.cumsum(dtf * a.to(F32)[:, None], dim=-1)
    lower = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    h = torch.zeros((B, H, Pd, N), dtype=F32, device=x.device)
    ys = []
    for c in range(nc):
        cu, d = cum[:, c], dtf[:, c]                          # (B,H,Q)
        s = cf[:, c] @ bf[:, c].transpose(-1, -2)             # (B,Q,Q)
        seg = torch.where(lower, cu[..., :, None] - cu[..., None, :], 0.0)
        lp = torch.where(lower, s[:, None] * torch.exp(seg)
                         * d[..., None, :], 0.0)
        y = (cf[:, c][:, None] @ h.to(bf16).to(F32).transpose(-1, -2)
             ) * torch.exp(cu)[..., None]
        ys.append(y + lp.to(bf16).to(F32) @ xf[:, c])
        total = cu[..., -1:]
        xw = (torch.exp(total - cu) * d)[..., None] * xf[:, c]
        hi = xw.to(bf16).to(F32)
        lo = (xw - hi).to(bf16).to(F32)
        bc = bf[:, c][:, None]
        h = (torch.exp(total)[..., None] * h + hi.transpose(-1, -2) @ bc
             + lo.transpose(-1, -2) @ bc)
    y = torch.stack(ys, dim=1).transpose(2, 3).reshape(B, L, H, Pd)
    return y.to(x.dtype), h


def ssd_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                     bm: torch.Tensor, cm: torch.Tensor, dy: torch.Tensor,
                     dhT: Optional[torch.Tensor], chunk: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor, torch.Tensor]:
    """(dx, ddt, da, dbm, dcm) of ``ssd_chunked_ref`` from a zero state at
    upstream gradients dy (of y) and dhT (of the final state; ``None`` for
    zero), written out in closed form along the kernel's own dataflow
    (``csrc/ssd_scan_bwd.cu``), in f32; dx, dbm and dcm are cast to their
    inputs' dtypes.  Per (b, h) and chunk, with cum the running sum of
    dA = dt a, total = cum[Q-1], S = C B^T (shared by the heads),
    E[q,k] = exp(cum[q] - cum[k]) and M = E dt[k] on and below the
    diagonal, w[k] = exp(total - cum[k]) dt[k], and dh the gradient of the
    state leaving the chunk:

        dh_prev = exp(total) dh + sum_q exp(cum[q]) dy[q] C[q]^T
        dx[k]   = sum_q S[q,k] M[q,k] dy[q] + w[k] dh B[k]
        dS      = sum_h M (dy x^T)                     (then dC, dB)
        dC[q]   = sum_k dS[q,k] B[k] + sum_h exp(cum[q]) h_prev^T dy[q]
        dB[k]   = sum_q dS[q,k] C[q] + sum_h w[k] dh^T x[k]
        ddt[k]  = sum_q S E (dy.x)[q,k] + exp(total - cum[k]) x[k].dh B[k]
                  + a dA[k]

    where dA is the reverse running sum of the gradient of cum:
    T = S M (dy x^T), U[k] = w[k] x[k].dh B[k],
    dcum[q] = sum_k T[q,k] - sum_k T[k,q] + exp(cum[q]) dy[q].h_prev C[q]
    - U[q], and dcum[Q-1] also takes exp(total) <dh, h_prev> + sum_k U[k]
    (total is cum[Q-1]); da = sum over (b, l) of dt dA.  exp is evaluated
    only on and below the diagonal, as the forward does."""
    B, L, H, Pd = x.shape
    N = bm.shape[-1]
    Q = min(chunk, L)
    if L % Q:
        raise ValueError(f"ssd scan: sequence length {L} is no multiple of "
                         f"the chunk {Q}")
    nc = L // Q
    af = a.to(F32)
    xf = x.to(F32).reshape(B, nc, Q, H, Pd).transpose(2, 3)   # (B,nc,H,Q,P)
    dyf = dy.to(F32).reshape(B, nc, Q, H, Pd).transpose(2, 3)
    dtf = dt.to(F32).reshape(B, nc, Q, H).transpose(2, 3)     # (B,nc,H,Q)
    bf = bm.to(F32).reshape(B, nc, 1, Q, N)
    cf = cm.to(F32).reshape(B, nc, 1, Q, N)
    cum = torch.cumsum(dtf * af[:, None], dim=-1)
    total = cum[..., -1:]
    lower = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    seg = torch.where(lower, cum[..., :, None] - cum[..., None, :], 0.0)
    E = torch.where(lower, torch.exp(seg), 0.0)               # (B,nc,H,Q,Q)
    del seg
    S = cf @ bf.transpose(-1, -2)                             # (B,nc,1,Q,Q)
    ecum = torch.exp(cum)
    e2 = torch.exp(total - cum)
    w = e2 * dtf

    # the states entering (h_prev) and the gradients leaving (dh) each chunk
    states = (xf * w[..., None]).transpose(-1, -2) @ bf       # (B,nc,H,P,N)
    own = (dyf * ecum[..., None]).transpose(-1, -2) @ cf
    decay = torch.exp(total[..., 0])                          # (B,nc,H)
    h = torch.zeros((B, H, Pd, N), dtype=F32, device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)
    s = (torch.zeros((B, H, Pd, N), dtype=F32, device=x.device)
         if dhT is None else dhT.to(F32))
    dh = [None] * nc
    for c in reversed(range(nc)):
        dh[c] = s
        s = s * decay[:, c, :, None, None] + own[:, c]
    dh = torch.stack(dh, dim=1)
    del states, own, h, s

    G = dyf @ xf.transpose(-1, -2)                            # (B,nc,H,Q,Q)
    Sd = S * E * G                                            # S E (dy.x)
    M = E * dtf[..., None, :]
    del E
    dS = (M * G).sum(2, keepdim=True)                         # (B,nc,1,Q,Q)
    T = Sd * dtf[..., None, :]
    del G
    V = bf @ dh.transpose(-1, -2)                             # dh B[k]
    dx = (S * M).transpose(-1, -2) @ dyf + w[..., None] * V
    del M
    xv = (xf * V).sum(-1)                                     # (B,nc,H,Q)
    del V
    dyz = (dyf * (cf @ h_prev.transpose(-1, -2))).sum(-1)     # dy.h_prev C
    dc = (dS @ bf)[:, :, 0] + ((dyf * ecum[..., None]) @ h_prev).sum(2)
    db = (dS.transpose(-1, -2) @ cf)[:, :, 0] + (
        (xf * w[..., None]) @ dh).sum(2)
    U = w * xv
    dcum = T.sum(-1) - T.sum(-2) + ecum * dyz - U
    dcum[..., -1] += decay * (dh * h_prev).sum((-1, -2)) + U.sum(-1)
    dA = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
    ddt = Sd.sum(-2) + e2 * xv + af[:, None] * dA
    da = (dtf * dA).sum((0, 1, 3))
    return (dx.transpose(2, 3).reshape(B, L, H, Pd).to(x.dtype),
            ddt.transpose(2, 3).reshape(B, L, H), da,
            db.reshape(B, L, N).to(bm.dtype), dc.reshape(B, L, N).to(cm.dtype))


# the operands the tensor-core backward splits into bf16 hi + lo (all of
# them by default; ``ssd_tensor_core_bwd_ref`` takes a subset to show what
# each split buys)
TC_BWD_SPLITS = ("h_prev", "dh", "ed")


def ssd_tensor_core_bwd_ref(x: torch.Tensor, dt: torch.Tensor,
                            a: torch.Tensor, bm: torch.Tensor,
                            cm: torch.Tensor, dy: torch.Tensor,
                            dhT: Optional[torch.Tensor], chunk: int, *,
                            splits=TC_BWD_SPLITS
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """(dx, ddt, da, dbm, dcm) as the bf16 tensor-core backward rounds
    them (``csrc/ssd_scan_bwd_wgmma.cu``), in the equations of
    ``ssd_scan_bwd_ref``.  x, B, C and dy are bf16 and enter every product
    exactly; every sum is f32.  The f32 factors that become product
    operands are rounded where they do:

    * the states entering the chunks come from the tensor-core forward's
      update (``ssd_tensor_core_ref``) and are stored as bf16 hi + lo
      (``h_prev``): both parts feed dy.(h_prev C) and <dh, h_prev>, which
      reach ddt and da; the hi part alone feeds dC's carried term;
    * dh, the gradient of the state leaving a chunk, is split as it feeds
      x.(dh B) and dx's carried term (``dh``); its hi part alone feeds dB's
      carried term;
    * exp(cum) dy, the operand of dh's update, is split (``ed``);
    * S M (dx's product) and each head's dS = M (dy x^T) are rounded once
      to bf16; dS summed over the heads in f32 is split again for dS B and
      dS^T C; exp(cum) dy and w x for the carried terms of dC and dB are
      rounded once.

    ``splits`` names the hi + lo splits kept (the others keep the hi part
    alone).  The kernel's own arithmetic, for rehearsing its precision; not
    a reference of the function."""
    B, L, H, Pd = x.shape
    N = bm.shape[-1]
    Q = min(chunk, L)
    if L % Q:
        raise ValueError(f"ssd scan: sequence length {L} is no multiple of "
                         f"the chunk {Q}")
    nc = L // Q
    bf16 = torch.bfloat16

    def rnd(t):
        return t.to(bf16).to(F32)

    def split(t, name):
        hi = rnd(t)
        return hi + rnd(t - hi) if name in splits else hi

    af = a.to(F32)
    xf = x.to(F32).reshape(B, nc, Q, H, Pd).transpose(2, 3)   # (B,nc,H,Q,P)
    dyf = dy.to(F32).reshape(B, nc, Q, H, Pd).transpose(2, 3)
    dtf = dt.to(F32).reshape(B, nc, Q, H).transpose(2, 3)     # (B,nc,H,Q)
    bf = bm.to(F32).reshape(B, nc, 1, Q, N)
    cf = cm.to(F32).reshape(B, nc, 1, Q, N)
    cum = torch.cumsum(dtf * af[:, None], dim=-1)
    lower = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()

    # the states entering each chunk, as the forward's update forms them
    h = torch.zeros((B, H, Pd, N), dtype=F32, device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        cu, d = cum[:, c], dtf[:, c]
        total = cu[..., -1:]
        xw = (torch.exp(total - cu) * d)[..., None] * xf[:, c]
        hi = rnd(xw)
        h = (torch.exp(total)[..., None] * h + hi.transpose(-1, -2) @ bf[:, c]
             + rnd(xw - hi).transpose(-1, -2) @ bf[:, c])

    dh = (torch.zeros((B, H, Pd, N), dtype=F32, device=x.device)
          if dhT is None else dhT.to(F32))
    dx, ddt, db, dc = [None] * nc, [None] * nc, [None] * nc, [None] * nc
    da = torch.zeros(H, dtype=F32, device=x.device)
    for c in reversed(range(nc)):
        cu, d = cum[:, c], dtf[:, c]                          # (B,H,Q)
        total = cu[..., -1:]
        xc, dyc, bc, cc = xf[:, c], dyf[:, c], bf[:, c], cf[:, c]
        seg = torch.where(lower, cu[..., :, None] - cu[..., None, :], 0.0)
        E = torch.where(lower, torch.exp(seg), 0.0)           # [q, k]
        S = cc @ bc.transpose(-1, -2)                         # (B,1,Q,Q)
        G = dyc @ xc.transpose(-1, -2)                        # (B,H,Q,Q)
        M = E * d[..., None, :]
        sd = S * E * G
        col_sd = sd.sum(-2)                                   # over q
        row_t = (sd * d[..., None, :]).sum(-1)                # over k
        w = torch.exp(total - cu) * d
        e2 = torch.exp(total - cu)
        ecum = torch.exp(cu)
        hp = split(h_prev[c], "h_prev")
        V = bc @ split(dh, "dh").transpose(-1, -2)            # dh B[k]
        dx[c] = (rnd(S * M).transpose(-1, -2) @ dyc + w[..., None] * V)
        xv = (xc * V).sum(-1)
        dyz = (dyc * (cc @ hp.transpose(-1, -2))).sum(-1)     # dy.h_prev C
        U = w * xv
        dcum = row_t - d * col_sd + ecum * dyz - U
        dcum[..., -1] += (torch.exp(total[..., 0])
                          * (dh * hp).sum((-1, -2)) + U.sum(-1))
        dA = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
        ddt[c] = col_sd + e2 * xv + af[:, None] * dA
        da += (d * dA).sum((0, 2))
        dS = rnd(M * G).sum(1, keepdim=True)                  # (B,1,Q,Q)
        dsp = rnd(dS) + rnd(dS - rnd(dS))
        db[c] = (dsp.transpose(-1, -2) @ cc)[:, 0] + (
            rnd(w[..., None] * xc) @ rnd(dh)).sum(1)
        dc[c] = (dsp @ bc)[:, 0] + (
            rnd(ecum[..., None] * dyc) @ rnd(h_prev[c])).sum(1)
        if c > 0:
            ed = split(ecum[..., None] * dyc, "ed")
            dh = (torch.exp(total)[..., None] * dh
                  + ed.transpose(-1, -2) @ cc)
    dx = torch.stack(dx, 1).transpose(2, 3).reshape(B, L, H, Pd)
    ddt = torch.stack(ddt, 1).transpose(2, 3).reshape(B, L, H)
    return (dx.to(x.dtype), ddt, da,
            torch.stack(db, 1).reshape(B, L, N).to(bm.dtype),
            torch.stack(dc, 1).reshape(B, L, N).to(cm.dtype))
