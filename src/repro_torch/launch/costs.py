"""Analytic per-step cost model — FLOPs and HBM traffic for every
(arch × shape) pair; the port of ``repro.launch.costs``, held against it
term for term (``tests/test_torch_launch.py`` compares every arch and
shape with ``==``).

The counts come from the model math alone, not from a trace: they are the
same for the port's program as for the reference's, and they pair with the
collective bytes the dry run records (``launch.hlo_stats``).

Conventions:
  * 1 MAC = 2 FLOPs; matmul FLOPs = 2·M·N·K.
  * the plain attention computes the full Sq×Sk score matrix (the causal
    mask is applied, not exploited) — ``flops``; the hand-written attention
    kernel skips fully-masked blocks — ``flops_kernel`` (≈half for causal,
    window-bounded for sliding windows).  Both are reported.
  * backward = 2× forward; remat="block" recomputes forward once → ×4 total.
  * ``model_flops`` counts the text tokens only: a frontend arch's prefix
    tokens are not in ``shape.seq_len``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.config import ArchConfig, InputShape
from repro_torch.models import tasks


@dataclasses.dataclass
class StepCosts:
    flops: float               # total step FLOPs (global, plain path)
    flops_kernel: float        # ditto if the flash/SSD kernels are used
    model_flops: float         # 6·N_active·tokens (the MFU numerator)
    hbm_bytes: float           # global HBM traffic
    notes: str = ""

    def asdict(self) -> Dict[str, float]:
        return {"flops": self.flops, "flops_kernel": self.flops_kernel,
                "model_flops": self.model_flops, "hbm_bytes": self.hbm_bytes,
                "notes": self.notes}


# ---------------------------------------------------------------------------
# per-layer pieces
# ---------------------------------------------------------------------------

def _attn_matmul_params(cfg: ArchConfig) -> int:
    hd = cfg.resolved_head_dim
    if cfg.mla:
        m = cfg.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        return (cfg.d_model * m.q_lora_rank
                + m.q_lora_rank * cfg.n_heads * qk
                + cfg.d_model * (m.kv_lora_rank + m.qk_rope_head_dim)
                + m.kv_lora_rank * cfg.n_heads * (m.qk_nope_head_dim
                                                  + m.v_head_dim)
                + cfg.n_heads * m.v_head_dim * cfg.d_model)
    return (cfg.d_model * cfg.n_heads * hd
            + 2 * cfg.d_model * cfg.n_kv_heads * hd
            + cfg.n_heads * hd * cfg.d_model)


def _ffn_matmul_params(cfg: ArchConfig, *, active: bool) -> float:
    """Per *MoE/FFN layer* active matmul params (token-averaged)."""
    if cfg.moe and cfg.moe.n_experts:
        m = cfg.moe
        router = cfg.d_model * m.n_experts
        k_eff = m.top_k + m.n_shared_experts
        experts = (k_eff if active else m.n_experts + m.n_shared_experts) \
            * 3 * cfg.d_model * m.expert_d_ff
        return router + experts
    return 3 * cfg.d_model * cfg.d_ff


def _ssm_matmul_params(cfg: ArchConfig) -> int:
    from repro_torch.models import ssm as ssm_lib
    m = ssm_lib.dims(cfg)
    proj_out = 2 * m["d_in"] + 2 * m["N"] + m["H"]
    return cfg.d_model * proj_out + m["d_in"] * cfg.d_model


def _ssd_seq_flops(cfg: ArchConfig, n_tokens: float) -> float:
    from repro_torch.models import ssm as ssm_lib
    m = ssm_lib.dims(cfg)
    Q, N, d_in = m["Q"], m["N"], m["d_in"]
    return 2.0 * n_tokens * (Q * N + Q * d_in + 2.0 * d_in * N)


def _attn_seq_flops(cfg: ArchConfig, B: float, Sq: float, Sk: float,
                    *, window: int, causal: bool) -> Dict[str, float]:
    """(QK + AV) FLOPs for one attention layer: plain path vs kernel path."""
    if cfg.mla:
        qk = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
        v = cfg.mla.v_head_dim
    else:
        qk = v = cfg.resolved_head_dim
    full = 2.0 * B * Sq * Sk * cfg.n_heads * (qk + v)
    if window and window < Sk:
        eff = float(window)
        kernel = 2.0 * B * Sq * eff * cfg.n_heads * (qk + v)
    elif causal and Sq == Sk:
        kernel = full / 2.0
    else:
        kernel = full
    return {"full": full, "kernel": kernel}


def _mla_decode_attn_flops(cfg: ArchConfig, B: float, T: float) -> float:
    m = cfg.mla
    # absorbed path: scores in rank space + rope, output back through rank
    return 2.0 * B * T * cfg.n_heads * (m.kv_lora_rank
                                        + m.qk_rope_head_dim
                                        + m.kv_lora_rank)


# ---------------------------------------------------------------------------
# layer schedule
# ---------------------------------------------------------------------------

def _layer_counts(cfg: ArchConfig):
    """Returns (n_attn_layers, n_ffn_layers, n_dense_ffn, n_ssm_layers)."""
    if cfg.family == "ssm":
        return 0, 0, 0, cfg.n_layers
    if cfg.family == "hybrid":
        sites = cfg.n_layers // cfg.hybrid.attn_every
        return sites, sites, sites, cfg.n_layers   # shared blocks have mlp
    if cfg.family == "moe" and cfg.moe.first_k_dense:
        fk = cfg.moe.first_k_dense
        return cfg.n_layers, cfg.n_layers - fk, fk, 0
    return cfg.n_layers, 0 if cfg.family == "moe" else cfg.n_layers, \
        (cfg.n_layers if cfg.family != "moe" else 0), 0


def matmul_params_active(cfg: ArchConfig) -> float:
    """Active matmul params per token (excl. embedding gather, incl. head)."""
    fam = cfg.family
    total = cfg.d_model * cfg.vocab_size        # lm head (tied or not)
    if fam == "ssm":
        return total + cfg.n_layers * _ssm_matmul_params(cfg)
    if fam == "hybrid":
        sites = cfg.n_layers // cfg.hybrid.attn_every
        return (total + cfg.n_layers * _ssm_matmul_params(cfg)
                + sites * (_attn_matmul_params(cfg)
                           + 3 * cfg.d_model * cfg.d_ff))
    attn = cfg.n_layers * _attn_matmul_params(cfg)
    if fam == "moe":
        fk = cfg.moe.first_k_dense
        ffn = (cfg.n_layers - fk) * _ffn_matmul_params(cfg, active=True) \
            + fk * 3 * cfg.d_model * cfg.d_ff
    else:
        ffn = cfg.n_layers * 3 * cfg.d_model * cfg.d_ff
    if cfg.frontend.kind != "none":
        total += cfg.frontend.embed_dim * cfg.d_model
    return total + attn + ffn


# ---------------------------------------------------------------------------
# step costs
# ---------------------------------------------------------------------------

def step_costs(cfg: ArchConfig, shape: InputShape) -> StepCosts:
    B, S = float(shape.global_batch), float(shape.seq_len)
    window = tasks.effective_window(cfg, shape)
    N = float(cfg.n_params())
    N_active = float(cfg.n_active_params())
    p_bytes = 2.0 * N                       # bf16 params

    if shape.kind in ("train", "prefill"):
        tokens = B * S
        mm = 2.0 * matmul_params_active(cfg) * tokens
        att = {"full": 0.0, "kernel": 0.0}
        n_attn = (cfg.n_layers // cfg.hybrid.attn_every
                  if cfg.family == "hybrid" else
                  (cfg.n_layers if cfg.family != "ssm" else 0))
        if n_attn:
            per = _attn_seq_flops(cfg, B, S, S, window=window, causal=True)
            att = {k: n_attn * v for k, v in per.items()}
        ssd = 0.0
        if cfg.family in ("ssm", "hybrid"):
            ssd = cfg.n_layers * _ssd_seq_flops(cfg, tokens)
        fwd_full = mm + att["full"] + ssd
        fwd_kern = mm + att["kernel"] + ssd
        model_flops = 6.0 * N_active * tokens

        if shape.kind == "train":
            flops = 4.0 * fwd_full          # fwd + bwd(2×) + remat(1×)
            flops_k = 4.0 * fwd_kern
            # params ×3 passes + grads 2 + opt (read µν, write µν+p) f32
            hbm = (3.0 * p_bytes + 2.0 * p_bytes + 5.0 * 4.0 * N
                   + 6.0 * cfg.n_layers * tokens * cfg.d_model * 2.0)
            note = "train: 4x fwd (remat block); opt f32 moments"
        else:
            flops = fwd_full
            flops_k = fwd_kern
            model_flops = 2.0 * N_active * tokens   # inference MFU basis
            hbm = (p_bytes
                   + 2.0 * cfg.n_layers * tokens * cfg.d_model * 2.0)
            note = "prefill: 1x fwd + cache write"
        return StepCosts(flops, flops_k, model_flops, hbm, note)

    # ---- decode: one token per sequence against a cache -------------------
    T = float(tasks.effective_cache_len(cfg, shape))
    tokens = B
    mm = 2.0 * matmul_params_active(cfg) * tokens
    att = ssd = 0.0
    cache_bytes = 0.0
    if cfg.family in ("ssm", "hybrid"):
        from repro_torch.models import ssm as ssm_lib
        m = ssm_lib.dims(cfg)
        ssd = cfg.n_layers * 4.0 * B * m["d_in"] * m["N"]
        cache_bytes += cfg.n_layers * B * (m["H"] * m["P"] * m["N"]) * 4.0 * 2
    n_attn = (cfg.n_layers // cfg.hybrid.attn_every
              if cfg.family == "hybrid" else
              (cfg.n_layers if cfg.family != "ssm" else 0))
    if n_attn:
        if cfg.mla:
            att = n_attn * _mla_decode_attn_flops(cfg, B, T)
            per_tok_cache = (cfg.mla.kv_lora_rank
                             + cfg.mla.qk_rope_head_dim) * 2.0
        else:
            hd = cfg.resolved_head_dim
            att = n_attn * 2.0 * B * T * cfg.n_heads * 2 * hd
            per_tok_cache = 2.0 * cfg.n_kv_heads * hd * 2.0
        cache_bytes += n_attn * B * T * per_tok_cache
    flops = mm + att + ssd
    model_flops = 2.0 * N_active * tokens
    hbm = p_bytes + cache_bytes
    return StepCosts(flops, flops, model_flops, hbm,
                     f"decode: cache_len={int(T)} (window={window})")
