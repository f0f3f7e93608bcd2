#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero, and without a CUDA device the
script exits 2 before printing any result.

1. Device: CUDA with capability (9, 0); prints ``nvidia-smi``'s name and
   power limit.
2. Build: compiles every ``src/repro_torch/kernels/csrc/*.cu`` (one nvcc per
   source, all started together) and prints the build seconds, and the
   counts of ``HGMMA``, ``UTMALDG`` and ``HMMA`` in the SASS of each
   library with a bf16 tensor-core kernel (``cuobjdump``): the attention
   forward and backward, ``ssd_scan`` and its tensor-core backward run on
   wgmma and TMA, and the phase fails if one of them has no HGMMA or no
   UTMALDG.
3. Kernels against their plain PyTorch versions on the card, at the shapes
   the serving and training paths give them and at small, odd, causal,
   windowed, GQA and ragged shapes: ``sde_step``, the attention forward
   (with and without its LSE output, ``o`` bitwise equal), the attention
   backward (against its plain version and against torch.autograd through
   the plain forward), ``grpo_loss`` and its backward; then the kernel,
   plain, bound and (for attention) SDPA times at the path shapes, with
   CUDA events and replayed CUDA graphs.  The attention cases include the
   dense path's shape (4, 4609, 15 query heads over 5 kv heads of 64,
   causal, bf16: a GQA group of 3 and a one-row last query tile), held to
   the same band relative to max |plain| as the flux path shape, and timed
   beside SDPA (``enable_gqa``) and the causal bound.  Beside the
   ``grpo_loss`` rows, the device time of an empty kernel launch
   (``torch.cuda._sleep(0)`` from a replayed graph): their floor.
4. ``FlowAdapter.velocity`` at full ``flux_dit`` width, depth 2, through the
   kernels and through the plain versions, at the bf16 band.
5. The main path: ``repro_torch.launch.serve.main`` serving 4 requests of
   full ``flux_dit`` (38 blocks, bf16, random weights from a seed) at
   FLUX.1-dev's 1024x1024 geometry (4096 latent tokens of width 64, a
   512-token condition of width 4096) under ``flow_sde``, 4 steps.  The
   kernels' launch counts must match the path: ``sde_step`` 4 per batch and
   ``flash_attention`` 38 x 4 per batch.
6. One denoising step of the engine that phase 5 built, traced with
   ``torch.profiler``: device time by kernel group and the device's idle
   share over the step.
7. adaLN-zero leaves every fresh block the identity, so phase 5's latents
   never depend on attention or the MLP.  The modulation is drawn from a
   seed, the same 4 requests are served again through the engine and the
   kernels, and held against ``rollout_keyed`` through the plain versions.
8. The train path: ``repro_torch.launch.train.main`` trains ``flux_dit``
   at full width with 4 blocks (bf16, random weights from a seed) at the
   same geometry, ``flow_grpo`` under ``flow_sde`` with T = 4, 2 prompts x
   group 2, rewards ``text_render``/``pickscore``/``latent_norm`` under
   ``gdpo``, for 2 steps.  Launch counts per step must match the path
   (``sde_step`` T, attention forward 2 x 4 x T, attention backward 4 x T,
   ``grpo_loss`` and its backward T each); metrics must be finite and the
   params must move.  Prints s per train step, peak memory, the clip
   fraction and max |logp_new - logp_old| at rollout params, and a
   ``torch.profiler`` breakdown of one more train step.
9. One update (rollout, rewards, loss gradient, clip, AdamW) of each of the
   five trainers (``flow_grpo``, ``mix_grpo``, ``grpo_guard``, ``nft``,
   ``awm``) at full width, depth 2, batch 2, modulation drawn, through the
   kernels and, on the same injected draws (x_init, the rollout's eps, and
   for NFT/AWM the update's t and noise), through the plain versions: loss,
   grad norm, the attention weights' grads and the params after AdamW at
   stated bands.
10. ``ssd_scan`` against its plain chunked version (and the sequential
   recurrence at small lengths) over the reference's sweep, odd shapes
   (H = 1, L = Q, L = 3Q, a ragged 21-token chunk), Mamba-2's init, a slow
   decay (|dA| near 1e-3) in which the state carried across chunks makes
   most of y, and the path shape (B 4, L 4608, 32 heads of 64, N 128, Q
   128), in f32 and bf16, bitwise on rerun.  Each case must run the variant
   its dtype and shape call for: bf16 at head dim 64, state 128 and chunk
   128 the tensor-core kernel (held also against its own rounding written
   out, ``ref.ssd_tensor_core_ref``, as a diagnostic), the rest the f32
   FMA passes.  Then the tensor-core kernel's, the FMA passes', the plain
   version's and the bound's times at the path shape, at batch 4 and 1.
11. ``FlowAdapter.velocity`` of ``mamba2-370m`` at full width, depth 2, over
   511 + 1 + 4096 tokens, with the SSM leaves drawn from Mamba-2's init,
   through the kernels (every scan on the tensor-core kernel) and through
   the plain versions at the bf16 band; then with ``ops.ssd_scan`` stubbed
   to zeros, which must move it by ten bands.
12. The Mamba-2 serving path: ``repro_torch.launch.serve.main`` serving 4
   requests of ``mamba2-370m`` (48 layers, bf16, random weights from a
   seed) over a 511-token condition of width 4096, one time token and 4096
   latent tokens of width 64 (4608 = 36 x 128 tokens: the scan takes no
   ragged chunk) under ``flow_sde``, 4 steps.  Launch counts must match the
   path (``ssd_scan`` 48 x 4 and ``sde_step`` 4 per batch), every
   ``ssd_scan`` launch on the tensor-core kernel; prints s per step, req/s,
   peak memory and a profile of one step.
13. The same 4 requests served in f32 through ``serve.main``, then again
   with the SSM leaves drawn, through the engine and the kernels: the
   latents equal ``rollout_keyed``'s through the kernels bitwise, and each
   of its steps is held against the same step through the plain versions
   from the same state.  With the leaves drawn the 48 layers amplify any
   rounding difference, so the replay is held in f32 and step by step; the
   phase prints one velocity's gap between the kernels and the plain
   versions beside the gap between two chunkings of the plain scan, in f32
   and bf16.
14. The ``ssd_scan`` backward (``ssd_scan_bwd``) against its plain closed
   form (``ref.ssd_scan_bwd_ref``) and against torch.autograd through the
   plain chunked forward, on phase 10's cases and the path shape at batch
   4 and 1, x, bm and cm as column slices of one buffer (as the model
   passes them), f32 and bf16, dhT absent and drawn, bitwise on rerun,
   each gradient within its band of max |plain|; the slow-decay cases must
   make the gradient carried across chunks most of dx.  Each case must run
   the variant its dtype and shape call for: bf16 at head dim 64, state
   128, chunk 128 (``tensor_core_bwd_route``) the tensor-core backward
   (held also against its own rounding written out,
   ``ref.ssd_tensor_core_bwd_ref``, as a diagnostic), the rest the f32 FMA
   passes.  Then ``ops.ssd_scan`` with an input requiring grad must run
   ``SSDScanFn`` through both tensor-core kernels, and the tensor-core
   backward's, the FMA passes', the plain version's and the bound's times
   at the path shape, at batch 4 and 1.
15. ``FlowAdapter.velocity`` of ``smollm-360m`` (D 64, 15 query heads over 5
   kv heads) and ``qwen3-32b`` (qk_norm, D 128, 64 over 8) at full width,
   depth 2, over 512 + 1 + 4096 tokens, causal, through the kernels and the
   plain versions at the bf16 band (smollm-360m with wq/wk drawn: at the
   repository's init its attention is nearly one-hot, and the gap there is
   printed without a band).
16. The dense serving path: ``repro_torch.launch.serve.main`` serving 4
   requests of ``smollm-360m`` (32 layers, bf16, random weights from a
   seed) over a 512-token condition of width 4096, one time token and 4096
   latent tokens of width 64 under ``flow_sde``, 4 steps.  Launch counts
   must match the path (``flash_attention`` 32 x 4 and ``sde_step`` 4 per
   batch); prints s per step, req/s, peak memory and a profile of one step;
   then, with wq/wk drawn, serves the requests again and holds them
   against ``rollout_keyed`` through the plain versions.
17. The dense train path: ``repro_torch.launch.train.main`` at
   ``smollm-360m``'s full width and all 32 layers, phase 8's geometry,
   batch and rewards: ``flow_grpo`` for 2 steps (and a traced third), then
   ``mix_grpo``, ``grpo_guard``, ``nft`` and ``awm`` for 1 step each, with
   wq/wk drawn at train start (at the repository's init the gradients grow
   ~5x a layer and overflow), each with launch counts that match its path
   (the attention backward 32 per loss backward, ``grpo_loss`` only for
   flow_grpo and mix_grpo, no ``sde_step`` in the NFT/AWM rollouts), finite
   metrics, params that move, s per step and peak memory.
18. One update of each of the five trainers on ``mamba2-370m`` at full
   width, depth 2, batch 2, with the SSM leaves drawn, through the kernels
   and through the plain versions on the same injected draws, as phase 9:
   loss, grad norm, the grads of ``in_proj``, ``conv_w``, ``a_log`` and
   ``dt_bias``, and the params after AdamW at stated bands; every scan
   backward through the kernels runs the tensor-core variant.
19. The SSM train path: ``repro_torch.launch.train.main`` at
   ``mamba2-370m``'s full width and all 48 layers, bf16, phase 12's
   geometry and phase 8's batch and rewards: ``flow_grpo`` for 2 steps
   (and a traced third), then ``mix_grpo``, ``grpo_guard``, ``nft`` and
   ``awm`` for 1 step each, with the SSM leaves drawn at train start, each
   with launch counts that match its path (the scan forward 48 x T in the
   rollout and 48 per loss forward, every one on the tensor-core kernel;
   the backward 48 per loss backward, every one on the tensor-core
   backward), finite metrics, every layer's
   ``a_log`` and ``dt_bias`` gradient at the first update finite and
   nonzero, params that move, s per step and peak memory.
20. ``mamba2-370m`` at all 48 layers through ``launch.train`` under
   ``--set perf.remat=block --set perf.log_memory=true``, phase 19's
   geometry, batch, T and rewards: ``flow_grpo`` for 2 steps and a traced
   third, with launch counts (every scan forward twice per layer and SDE
   step of the loss: once in the forward, once recomputed in the
   backward), s per step, peak memory and ``memory_stats``; then 1 step
   each under ``none``, ``scan`` and ``scan`` + ``remat_offload``, whose
   loss, grad norm and reward must be bitwise equal; then one update at
   depth 2 under ``block`` against ``none`` on one set of injected draws,
   to the reference's band.
21. The fused, pipelined step on the same model at 48 layers:
   ``--set perf.fuse_step=true --set perf.remat=block --set
   perf.offload_rewards=true --set perf.policy_dtype=bfloat16 --set
   loop.pipeline=2``, 4 steps: one capture and three CUDA-graph replays,
   launch counts (each kernel counted for the eager step and the capture),
   s per step, peak memory, the reward towers' bytes freed, and a profile
   of one more replay.  At depth 2 from one state and one set of injected
   draws: a replayed fused step against the eager step, to the reference's
   fuse_step band (and whether bitwise); an eager step under
   ``torch.cuda.set_sync_debug_mode("error")``; the ``policy_dtype=
   "float32"`` velocity on bf16 parameters through the kernels' f32
   variants against the plain versions (``mamba2-370m`` and
   ``flux_dit``).
22. ``flux_dit`` at full width and 16 of its 38 blocks under
   ``perf.remat=block`` through ``launch.train``, ``flow_grpo`` for 2
   steps at phase 8's geometry, batch and rewards; then ``smollm-360m`` at
   all 32 layers under ``block`` for 1 step; launch counts, s per step and
   peak memory.
23. ``distributed/`` on a one-rank NCCL group (the machine has one card,
   and NCCL takes one rank per device): (a) the group over a ``file://``
   store and its (1, 1) ("data", "model") mesh through
   ``distributed.build_mesh``, with the per-layer gather's all-gather and
   reduce-scatter on NCCL (bitwise the identity on one rank); (b) one
   ``flow_grpo`` step of ``flux_dit`` and ``mamba2-370m`` at full width,
   depth 2, through the mesh path (the reward gather, the gradient
   all-reduce, the loss and metric reductions on NCCL) against the
   no-mesh path, bitwise; ``dist.microbatch=2`` against 0 in f32 (one
   loss and backward on one trajectory), against the reference's band and
   held to the stated one; the fused step with ``microbatch=2`` on the
   mesh (1 capture with its collectives, 1 replay bitwise the eager
   step); (c) ``mamba2-370m`` at 48 layers under ``none`` and ``flux_dit``
   at 16 blocks under ``block``, each with ``microbatch=2`` on the mesh,
   through ``launch.train``, 2 steps: launch counts, s a step, steps/s,
   peak memory, and the gradient all-reduce's device time against the
   step; (d) the mesh trainer's checkpoint restored without a mesh,
   bitwise; (e) ``mamba2-370m`` at 48 layers served on the mesh against
   the engine without one, a bucket of 4, per request bitwise.
24. Training through the serving engine: ``flow_grpo`` on
   ``mamba2-370m`` at its published width and all 48 layers, bf16, phase
   19's geometry, batch and rewards, through ``Experiment.build_trainer()``,
   ``trainer.attach_engine(ServingEngine.for_trainer(trainer,
   max_batch=2))`` and ``Experiment.train()`` for 2 steps: each rollout of
   2 prompts x group 2 runs in 2 chunks of bucket 2 (the engine's
   dispatches ``{"b2/s4": 4}``, no padded lane); launch counts per step
   (``sde_step`` 8, the scan forward 48 x 4 x 2 in the rollout and 48 x 4
   in the loss, its backward 48 x 4, ``grpo_loss`` and its backward 4
   each), finite metrics, first-update gradients, params that move, s a
   step and memory beside phase 19's engine-free run.  Then at depth 2 in
   f32 on injected draws: ``flow_grpo`` through the engine in one chunk
   bitwise the engine-free step, in two chunks within stated bands of one
   (trajectory, loss, every leaf's gradient), ``awm`` likewise; and the
   two-chunk engine step on a one-rank NCCL mesh bitwise the no-mesh one.
25. The attention kernels at head dim 80 (zamba2-2.7b's shared attention:
   tiles padded to 96 columns on the tensor cores) against their plain
   versions and torch.autograd, forward (o and LSE) and backward, at the
   path shape (4, 4608, 32 / 32 heads of 80, causal) in bf16 on the
   tensor-core kernels and in f32 on the FMA kernels, ragged (1, 129, 2 /
   1) and (2, 77, 4 / 2), a window and a bidirectional case, each call on
   the variant its dtype calls for (``variant_launches``); the kernel, FMA,
   plain and SDPA times and the bounds at the path shape.  Then the scan
   and its backward at the hybrid's shape (4, 4608, 80 heads of 64, state
   64, chunk 128, bf16), which run the FMA passes, against the plain
   versions, with times and byte bounds.
26. The hybrid serving path: ``repro_torch.launch.serve.main`` serving 4
   requests of ``zamba2-2.7b`` (54 layers in 9 groups of 6 Mamba-2 blocks
   and one shared attention block, bf16, random weights from a seed) over
   511 + 1 + 4096 tokens under ``flow_sde``, 4 steps: launch counts (a
   velocity: ``ssd_scan`` 54, all on the FMA passes, ``flash_attention``
   9, all on the tensor cores; ``sde_step`` 4 per batch), the latents
   bitwise ``rollout_keyed``'s through the kernels, s per step, req/s,
   peak memory and a profile of one step; then the velocity at depth 2 (2
   groups of one SSM block) with the SSM leaves and the shared wq/wk
   drawn, through the kernels against the plain versions in f32 and bf16.
27. The hybrid train path: ``repro_torch.launch.train.main`` at
   ``zamba2-2.7b``'s full width and all 54 layers under
   ``perf.remat=block``, ``flow_grpo`` for 2 steps and a traced third at
   phase 19's geometry, batch and rewards, SSM leaves and shared wq/wk
   drawn at train start: launch counts on their variants, every layer's
   a_log and dt_bias gradient, s per step, peak memory and
   ``memory_stats``; then one update of each of the five trainers at depth
   2 against the plain versions, as phase 18.
28. The attention kernels at a query/key dim of 192 and a value dim of 128
   (DeepSeek-V2's latent attention: 128 + 64 rope dims of query and key,
   128 of value, scale 192^-1/2) against their plain versions and
   torch.autograd, forward (o and LSE) and backward, at the path shape (4,
   4608, 128 / 128 heads, causal) in bf16 on the tensor-core kernels and in
   f32 on the FMA kernels, ragged (1, 129, 2 / 1) and (2, 77 queries over
   130 keys, 4 / 2), a window and a bidirectional case, each on the
   variant its dtype calls for; at the path shape every row (query row of
   o and dq, key row of dk and dv) within ``ROW_BAND`` of its own max
   |plain|, a band that two deliberately wrong kernels must fail; the
   wrapper refuses (192, 64); then the kernel, FMA, plain and SDPA times
   (SDPA on its fused backends) and the bounds at the path shape.
29. ``deepseek-v2-236b`` served: ``repro_torch.launch.serve.main`` serving 4
   requests at full width and 6 layers (the dense one and 5 MoE layers of
   160 routed experts top-6 and 2 shared; ~21.3 B params; 236 B do not fit
   one card) over 511 + 1 + 4096 tokens under ``flow_sde``, 4 steps:
   launch counts (``flash_attention`` 6 a velocity, all on the tensor
   cores; ``sde_step`` 4 per batch), the latents bitwise
   ``rollout_keyed``'s, the share of routed assignments dropped at
   capacity per MoE layer, s per step, req/s, peak memory and a profile of
   one step; then the velocity at depth 2, batch 1, w_uq/w_uk drawn,
   through the kernels against the plain versions on the kernel pass's
   expert assignments, in bf16 and f32 (the unforced gap, the differing
   assignments and the gap at the repository's init printed beside it).
30. ``deepseek-v2-236b`` trained: ``repro_torch.launch.train.main`` at full
   width and 2 layers (the dense one and one MoE layer) under
   ``perf.remat=block`` with the reward towers offloaded
   (``perf.offload_rewards``) under the allocator's expandable segments
   (``PYTORCH_CUDA_ALLOC_CONF``, which the script sets for itself unless
   the caller has), ``flow_grpo`` for 2 steps and a traced third at
   phase 19's batch, T and rewards over 511 + 1 + 4096 tokens: launch
   counts (the attention backward 2 per loss backward, ``grpo_loss`` and
   its backward T each), the router's and expert tables' first-update
   gradients, finite metrics, params that move, s per step, peak memory
   and ``memory_stats``; then one update of each of the five trainers at
   depth 2 (32 routed experts, 511 + 1 + 512 tokens) through the kernels
   against the plain versions on the kernel pass's routing.
31. ``grok-1-314b`` served at full width and 4 layers (8 experts top-2 of
   width 32768, 48 query heads over 8 kv heads of 128; ~21.4 B params) as
   phase 29, and its velocity at depth 2 as phase 29's.  grok is not
   trained on one card: one full-width layer is ~59 GB of training state.
32. The attention kernels at the frontend archs' shapes, head dim 64,
   causal: internvl2-1b's flow shape (4, 4608, 14 query heads over 2 kv
   heads: a GQA group of 7, the longest walk of query heads per key tile
   in the dK/dV pass yet) and musicgen-large's (4, 4608, 32 over 32), and
   the LM train step's (8, 4096 + 256, 14 / 2: phase 34's batch and
   length), forward (o and LSE) and backward, each in bf16 on the
   tensor-core kernels and in f32 on the FMA kernels: every row (query
   row of o and dq, key row of dk and dv) within ``ROW_BAND`` of its own
   max |plain|, the backward also against torch.autograd on one batch
   row; then the kernel, FMA, plain and SDPA (``enable_gqa``, fused
   backends) times and the operation bounds.  (The prefill's shape is
   checked and timed in phase 35, at the batch the prefill runs.)
33. The frontend archs' flow path: ``repro_torch.launch.serve.main``
   serving 4 requests of internvl2-1b at all 24 layers and of
   musicgen-large at all 48 (bf16, random weights from a seed) over 511 +
   1 + 4096 tokens, 4 steps (``flash_attention`` n_layers a velocity on
   the tensor cores, ``sde_step`` 4 a batch), s per step, req/s, peak
   memory; the velocity at depth 2 against the plain versions at the
   bf16 band (wq/wk drawn at 1/sqrt(d_model); the gap at the
   repository's init printed); and ``launch.train`` flow_grpo for 2 steps
   at all layers (musicgen-large under ``perf.remat=block``: its 3.23 B
   params with bf16 grads and f32 moments are ≈ 38.8 GB), AdamW at lr
   1e-3 with weight decay 4 (lr * wd past half a bf16 ulp, so the decay
   shows in bf16 params): launch counts, finite metrics, params that move, and
   ``frontend_proj`` (which the velocity never reads) with a zero
   gradient, moved by the decay alone.
34. The LM task path's train step (``tasks.make_train_step``) on
   internvl2-1b at full width and all 24 layers: ``train_4k``'s 4096
   tokens after the 256-token vision prefix, batch 8 of ``TokenStream``
   (the global batch of 256 cut to one card), 3 steps: launch counts
   (attention forward 2 x 24 a step under the per-block remat, backward
   24), s a step, tokens/s, peak memory, CE and a profile of one step;
   the step's MFU and hardware FLOP share from the cost model
   (``launch.costs``, both below 100 %), and ``launch.dryrun`` of the same
   step on meta tensors (one-rank layout), its predicted peak within 10 %
   of the measured one (``max_memory_allocated`` over what was allocated
   before the params); then at depth 2 the loss,
   ce, gradient norm and every leaf's gradient through the kernels
   against the plain versions.
35. Prefill and decode.  For every arch the reference registers (all 11)
   at full width and depth 2 (zamba2-2.7b one group of 6 SSM blocks and
   the shared block; deepseek-v2-236b its dense layer and one MoE layer),
   f32: prefill through the kernels, one-token decodes, against the
   forward through the kernels (attention archs 511 + 1 against 512;
   mamba2-370m 128 + 128 decodes against 256; zamba2-2.7b 127 + 1 against
   128) and against prefill + decode through the plain versions, MoE
   capacity raised so nothing is dropped (``ample_capacity``).  Then
   internvl2-1b at all 24 layers in bf16: prefill at ``prefill_32k``'s
   length (32768 + 256) at the largest batch <= 32 the card holds, 16
   decode steps from its caches; the attention forward at that prefill's
   shape (B, 32768 + 256, 14 / 2) in bf16 and f32 against the reference's
   chunked jnp path (one sequence and a query chunk at a time) row by row,
   with its times as phase 32's; and ``decode_32k``: batch 128 over zero
   caches of 32768 entries (a 51.5 GB KV cache): tokens/s, ms a step,
   peak memory, and a profile of one decode_32k step.
36. The sweep: ``python -m repro_torch.launch.sweep`` in train
   mode over ``flow.trainer_type=flow_grpo,awm``, a base config of
   smollm-360m at full width and 8 of its 32 layers, 2 steps a combo, each
   combo its own ``launch.train`` process on the card; its kernel counts
   (written at its exit, ``REPRO_KERNEL_COUNTS``) against the path, 2
   finite history rows an artifact, and a rerun that skips both.
37. ``main_path``, ``train_path``, ``ssm_path``, ``dense_path``,
   ``ssm_train_path``, ``perf_path``, ``distributed_path``,
   ``engine_path``, ``hybrid_path``, ``moe_path``, ``frontend_path``,
   ``lm_path``, ``sweep_path``, ``phase_times`` and ``kernels`` JSON
   lines, the card's name and power limit, and the last line ``{"ok":
   true, "device": {...}}``.

Each phase prints its seconds as it ends (``[N] took ... s``), and the
script the total.  ``--only N,...`` runs just the device and build phases
and phases N (3 and 8-36) and prints no result lines: a development aid.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

T_START = time.perf_counter()

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# deepseek-v2-236b's training (phase 30) fits one card only with the
# caching allocator's expandable segments (scripts/moe_train_memory.py):
# set for the whole process before CUDA starts, as a user's launch of that
# cell sets it; an explicit setting is kept
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402

from repro_torch import configs, registry  # noqa: E402
from repro_torch.api import Experiment  # noqa: E402
from repro_torch.api import loop as loop_lib  # noqa: E402
from repro_torch import optim as optim_lib  # noqa: E402
from repro_torch.config import (INPUT_SHAPES, FlowRLConfig,  # noqa: E402
                                InputShape, OptimConfig, PerfConfig,
                                RewardSpec, replace)
from repro_torch.core.rollout import (  # noqa: E402
    request_draws, request_seeds, rollout_keyed)
from repro_torch.data import TokenStream, synthetic_prompts  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import counts as counts_lib  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import grpo_loss as grpo_mod  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bwd)
from repro_torch.kernels.grpo_loss import grpo_loss, grpo_loss_bwd  # noqa: E402
from repro_torch.kernels.sde_step import sde_step  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd  # noqa: E402
from repro_torch.launch import costs as costs_lib  # noqa: E402
from repro_torch.launch import dryrun, serve, train  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import frontends, tasks  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import params as params_lib  # noqa: E402
from repro_torch.models.backbone import Backbone  # noqa: E402
from repro_torch.models.flow import FlowAdapter  # noqa: E402
from repro_torch.models.layers import attention_chunked  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): device memory and bf16 tensor
# cores; f32 outside the tensor cores for the elementwise kernel
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

# path shapes
B_SERVE, LAT_TOKENS, LAT_DIM = 4, 4096, 64
COND_LEN, COND_DIM = 512, 4096
SEQ, HEADS, HEAD_DIM = COND_LEN + LAT_TOKENS, 24, 128
NUM_STEPS, N_LAYERS = 4, 38
# the dense LM path: smollm-360m at its published width (32 layers, 15
# query heads over 5 kv heads of 64) over [512 cond; 1 time; 4096 latent]
# tokens, causal: a ragged 4609 = 36 x 128 + 1, the last query tile one row
DENSE_ARCH, DENSE_LAYERS = "smollm-360m", 32
DENSE_SEQ = COND_LEN + 1 + LAT_TOKENS
DENSE_HEADS, DENSE_KV_HEADS, DENSE_HEAD_DIM = 15, 5, 64
BF16_BAND = 3e-2        # max |kernel - plain| / max |plain| through bf16 blocks
# bf16 attention at S=4608: outputs are ~sqrt(e/S) ~ 0.024 in std, so the
# short cases' absolute 2e-2 would pass a wrong kernel; the limit scales
# with max |plain| (0.19 there: 3.8e-3, four bf16 ulps at the top)
PATH_ATTN_BAND = 2e-2


def log(msg: str) -> None:
    print(msg, flush=True)


# the running phase and the seconds each phase took, from ``begin`` to the
# next ``begin`` or ``end_phase``
_PHASE = {"n": None, "t0": 0.0, "secs": {}}


def end_phase() -> None:
    """Close the running phase: print and keep its seconds."""
    n = _PHASE["n"]
    if n is not None:
        secs = time.perf_counter() - _PHASE["t0"]
        _PHASE["secs"][str(n)] = round(secs, 1)
        log(f"    [{n}] took {secs:.1f} s")
        _PHASE["n"] = None


def begin(n: int, msg: str) -> None:
    """Close the running phase and start phase ``n``."""
    end_phase()
    log(f"[{n}] {msg}")
    _PHASE["n"], _PHASE["t0"] = n, time.perf_counter()


def phase_times() -> dict:
    """The per-phase seconds so far and the total since the script
    started."""
    end_phase()
    total = time.perf_counter() - T_START
    log(f"[time] phases {json.dumps(_PHASE['secs'])}; total {total:.1f} s")
    return {"phase_s": dict(_PHASE["secs"]), "total_s": round(total, 1)}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events, warmed up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def graph_ms(fn, calls: int, replays: int = 5) -> float:
    """Mean device milliseconds of one ``fn`` call: ``calls`` calls captured
    in a CUDA graph and replayed, so the host's launch cost (Python, ctypes,
    allocation) drops out of the kernel's time."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(replays):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / (replays * calls)
    del graph
    return ms


def _plain_flash(q, k, v, *, causal=True, window=0, return_lse=False):
    o, lse = ref.flash_attention_fwd_ref(q, k, v, causal=causal,
                                         window=window)
    return (o, lse) if return_lse else o


def _plain_flash_bwd(q, k, v, o, lse, do, *, causal=True, window=0):
    return ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window)


def _plain_grpo(lpn, lpo, adv, ratio_mean=None, *, clip=0.2, guard=False):
    return ref.grpo_loss_ref(lpn, lpo, adv, clip=clip, guard=guard,
                             ratio_mean=ratio_mean)


@contextlib.contextmanager
def plain_dispatch():
    """Route every kernel call to its plain version on CUDA tensors too —
    ``ops``' wrappers and the autograd Functions' forwards and backwards —
    for the comparison runs of this script (the port itself has no such
    switch)."""
    saved = (ops._flash, ops._sde, ops._grpo, ops._ssd,
             fa_mod.flash_attention, fa_mod.flash_attention_bwd,
             grpo_mod.grpo_loss, grpo_mod.grpo_loss_bwd, ssd_mod.ssd_scan,
             ssd_mod.ssd_scan_bwd)
    ops._flash = ref.flash_attention_ref
    ops._ssd = lambda x, dt, a, bm, cm, chunk: ref.ssd_chunked_ref(
        x, dt, a, bm, cm, chunk)
    ops._sde = lambda v, x, eps, t, t_next, eta: ref.sde_step_ref(
        v, x, t, t_next, eps, eta=eta)
    ops._grpo = _plain_grpo
    fa_mod.flash_attention = _plain_flash
    fa_mod.flash_attention_bwd = _plain_flash_bwd
    grpo_mod.grpo_loss = _plain_grpo
    grpo_mod.grpo_loss_bwd = ref.grpo_loss_bwd_ref
    ssd_mod.ssd_scan = ops._ssd
    ssd_mod.ssd_scan_bwd = lambda x, dt, a, bm, cm, dy, dhT, *, chunk: \
        ref.ssd_scan_bwd_ref(x, dt, a, bm, cm, dy, dhT, chunk)
    try:
        yield
    finally:
        (ops._flash, ops._sde, ops._grpo, ops._ssd, fa_mod.flash_attention,
         fa_mod.flash_attention_bwd, grpo_mod.grpo_loss,
         grpo_mod.grpo_loss_bwd, ssd_mod.ssd_scan,
         ssd_mod.ssd_scan_bwd) = saved


COUNTED = counts_lib.COUNTED
COUNTED_BY_NAME = {fn.__name__: fn for fn in COUNTED}


def reset_counts() -> None:
    for fn in COUNTED:
        fn.launches = 0
        for variant in getattr(fn, "variant_launches", {}):
            fn.variant_launches[variant] = 0
        for pair in getattr(fn, "pair_launches", {}):
            fn.pair_launches[pair] = 0


def counts() -> dict:
    return {fn.__name__: fn.launches for fn in COUNTED}


def all_variants() -> dict:
    """Each counted kernel's launches by variant (the attention and scan
    wrappers: ``wgmma`` / ``fma``)."""
    return {fn.__name__: dict(fn.variant_launches) for fn in COUNTED
            if hasattr(fn, "variant_launches")}


def pair_counts() -> dict:
    """The attention wrappers' launches by (query/key, value) dim pair
    (``pair_launches``, keyed ``"192x128"``)."""
    return {fn.__name__: dict(fn.pair_launches) for fn in COUNTED
            if hasattr(fn, "pair_launches")}


def routed(n: int, variant: str) -> dict:
    """The variant counts of ``n`` launches all on ``variant``."""
    return {"wgmma": n if variant == "wgmma" else 0,
            "fma": n if variant == "fma" else 0}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


SASS_OPS = ("HGMMA", "UTMALDG", "HMMA")


def sass_counts(name: str):
    """Counts of warpgroup products (HGMMA), TMA tile loads (UTMALDG) and
    warp-level products (HMMA) in the built library of ``csrc/<name>.cu``,
    from ``cuobjdump -sass``; "not found" when the toolkit has no
    cuobjdump."""
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    tool = str(tool) if tool.exists() else shutil.which("cuobjdump")
    if tool is None:
        return "not found"
    sass = subprocess.run([tool, "-sass", str(_build._lib_path(name))],
                          capture_output=True, text=True, check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in SASS_OPS}


# ------------------------------------------------------------------ phase 3
def check_sde(dev) -> dict:
    g = torch.Generator(device=dev).manual_seed(0)
    shapes = [((B_SERVE, LAT_TOKENS, LAT_DIM), torch.float32),
              ((2, 8, 4), torch.float32), ((3, 7, 13), torch.bfloat16),
              ((1, 100003), torch.float32), ((5, 2049), torch.bfloat16)]
    path_err = None
    for shape, dt in shapes:
        v, x, e = (torch.randn(shape, generator=g, device=dev).to(dt)
                   for _ in range(3))
        for t, tn in [(0.9999, 0.75), (0.5, 0.4), (0.25, 1e-4)]:
            xn, lp = sde_step(v, x, e, t, tn, eta=0.7)
            xn2, lp2 = sde_step(v, x, e, t, tn, eta=0.7)
            xr, lr = ref.sde_step_ref(v, x, t, tn, e, eta=0.7)
            torch.cuda.synchronize()
            xerr = float((xn - xr).abs().max())
            lerr = float(((lp - lr).abs() / lr.abs()).max())
            log(f"  sde_step {shape} {dt} t={t}: x_next max|err| {xerr:.3e}"
                f", logp max rel err {lerr:.3e}")
            if not torch.allclose(xn, xr, atol=1e-5, rtol=1e-5):
                fail(f"sde_step x_next off at {shape} {dt} t={t}")
            if lerr > 1e-5:
                fail(f"sde_step logp off at {shape} {dt} t={t}")
            if not (torch.equal(lp, lp2) and torch.equal(xn, xn2)):
                fail(f"sde_step not deterministic at {shape} {dt}")
            if shape[0] == B_SERVE and dt == torch.float32:
                path_err = max(path_err or 0.0, xerr)
    # times at the path shape over 4 input sets (67 MB, more than the 50 MB
    # L2), as the rollout meets v fresh from the velocity each step
    shape = (B_SERVE, LAT_TOKENS, LAT_DIM)
    sets = [[torch.randn(shape, generator=g, device=dev) for _ in range(3)]
            for _ in range(4)]
    it = [0]

    def run(fn):
        def call():
            v, x, e = sets[it[0] % 4]
            it[0] += 1
            fn(v, x, e)
        return call

    call_ms = cuda_ms(run(lambda v, x, e: sde_step(v, x, e, 0.5, 0.25)),
                      200)
    ms = graph_ms(run(lambda v, x, e: sde_step(v, x, e, 0.5, 0.25)), 40)
    plain_ms = cuda_ms(run(lambda v, x, e: ref.sde_step_ref(
        v, x, 0.5, 0.25, e, eta=0.7)), 50)
    n = B_SERVE * LAT_TOKENS * LAT_DIM
    nbytes = 3 * n * 4 + n * 4 + B_SERVE * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 12 * n / F32_FLOPS * 1e3
    bound = max(t_bytes, t_ops)
    log(f"  sde_step path {shape} f32: kernel {ms:.4f} ms on the device "
        f"({call_ms:.4f} ms a call with the host's launch), plain "
        f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB)")
    return {"name": "sde_step", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sde_step.cu",
            "replaces": "src/repro/kernels/sde_step.py:50",
            "max_abs_err": path_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def check_attention(dev) -> dict:
    g = torch.Generator(device=dev).manual_seed(1)
    cases = [  # B, Sq, Sk, H, K, D, causal, window, dtype
        (1, SEQ, SEQ, HEADS, HEADS, HEAD_DIM, False, 0, torch.bfloat16),
        (2, 128, 128, 4, 2, 64, True, 0, torch.float32),
        (2, 128, 128, 4, 2, 64, False, 0, torch.bfloat16),
        (1, 76, 76, 2, 1, 32, False, 0, torch.float32),
        (2, 76, 76, 4, 4, 128, True, 16, torch.bfloat16),
        (1, 200, 130, 8, 2, 64, False, 0, torch.bfloat16),
        (1, 512, 512, 8, 2, 64, True, 64, torch.float32),
        (1, 100, 37, 4, 1, 64, True, 64, torch.bfloat16),
        (1, 300, 300, 4, 2, 128, False, 0, torch.float32),
        # several ring stages with skipped tiles and ragged tails at D = 128,
        # and the 64-byte swizzle of D = 32 under a window
        (1, 1000, 1000, 8, 2, 128, True, 0, torch.bfloat16),
        (1, 300, 300, 4, 2, 32, True, 128, torch.bfloat16),
        # a window of 256 over 1000 keys: rows of the second consumer
        # whose first key tile lies wholly outside their window
        (1, 1000, 1000, 8, 2, 128, True, 256, torch.bfloat16),
        # the dense path: a GQA group of 3, causal, ragged last tile
        (B_SERVE, DENSE_SEQ, DENSE_SEQ, DENSE_HEADS, DENSE_KV_HEADS,
         DENSE_HEAD_DIM, True, 0, torch.bfloat16),
    ]
    path_err = dense_err = None
    for (B, Sq, Sk, H, K, D, causal, window, dt) in cases:
        q = torch.randn(B, Sq, H, D, generator=g, device=dev).to(dt)
        k = torch.randn(B, Sk, K, D, generator=g, device=dev).to(dt)
        v = torch.randn(B, Sk, K, D, generator=g, device=dev).to(dt)
        o = flash_attention(q, k, v, causal=causal, window=window)
        r = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err = float((o.float() - r.float()).abs().max())
        log(f"  flash_attention B={B} Sq={Sq} Sk={Sk} H={H} K={K} D={D} "
            f"causal={causal} window={window} {dt}: max|err| {err:.3e}")
        if Sq in (SEQ, DENSE_SEQ):
            limit = PATH_ATTN_BAND * float(r.float().abs().max())
            log(f"    path shape: limit {limit:.3e} "
                f"({PATH_ATTN_BAND} of max|plain|)")
            ok = err <= limit
            if Sq == SEQ:
                path_err = err
            else:
                dense_err = err
        else:
            tol = 2e-5 if dt == torch.float32 else 2e-2
            ok = torch.allclose(o.float(), r.float(), atol=tol, rtol=tol)
        if not ok:
            fail(f"flash_attention off at {(B, Sq, Sk, H, K, D)}")
        del q, k, v, o, r
    # bf16 rows that are no multiple of 16 bytes apart take the f32-FMA
    # kernel instead of the tensor-core one
    q, k, v = (torch.randn(2, 76, 4, 34, generator=g, device=dev).to(
        torch.bfloat16)[..., :32] for _ in range(3))
    o = flash_attention(q, k, v, causal=True)
    r = ref.flash_attention_ref(q, k, v, causal=True)
    err = float((o.float() - r.float()).abs().max())
    log(f"  flash_attention strided bf16 (head stride 34): max|err| "
        f"{err:.3e}")
    if not torch.allclose(o.float(), r.float(), atol=2e-2, rtol=2e-2):
        fail("flash_attention off on strided bf16 inputs")
    torch.cuda.empty_cache()
    # times at the serving shape: B=4, S=4608, 24 heads of 128, bf16
    shp = (B_SERVE, SEQ, HEADS, HEAD_DIM)
    q, k, v = (torch.randn(shp, generator=g, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    ms = graph_ms(lambda: flash_attention(q, k, v, causal=False), 3)
    plain_ms = cuda_ms(lambda: ref.flash_attention_ref(q, k, v,
                                                       causal=False), 2, 1)
    torch.cuda.empty_cache()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    library_ms = cuda_ms(lambda: sdpa(qt, kt, vt), 10)
    flops = 4 * B_SERVE * HEADS * SEQ * SEQ * HEAD_DIM
    nbytes = 4 * q.numel() * 2
    t_ops = flops / BF16_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound = max(t_ops, t_bytes)
    log(f"  flash_attention path {shp} bf16: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, SDPA {library_ms:.3f} ms, bound {bound:.3f} ms "
        f"({flops / 1e12:.3f} TFLOP)")
    del q, k, v
    torch.cuda.empty_cache()
    dense = _dense_attention_times(dev, g, dense_err)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:81",
            "max_abs_err": path_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms, "dense_shape": dense}


def _dense_qkv(g, dev, *extra):
    """bf16 q (B, S, 15, 64) and k, v (B, S, 5, 64) at the dense path's
    shape, plus one more q-shaped tensor per ``extra`` name."""
    B, S = B_SERVE, DENSE_SEQ
    q = torch.randn(B, S, DENSE_HEADS, DENSE_HEAD_DIM, generator=g,
                    device=dev, dtype=torch.bfloat16)
    k, v = (torch.randn(B, S, DENSE_KV_HEADS, DENSE_HEAD_DIM, generator=g,
                        device=dev, dtype=torch.bfloat16) for _ in range(2))
    return (q, k, v) + tuple(torch.randn_like(q) for _ in extra)


def _causal_flops() -> float:
    """Operations of the causal forward at the dense path's shape: the two
    products over the half of the score matrix the mask keeps."""
    return 4 * B_SERVE * DENSE_HEADS * DENSE_SEQ ** 2 * DENSE_HEAD_DIM / 2


def _dense_attention_times(dev, g, err) -> dict:
    """The causal GQA forward at the dense path's shape (4, 4609, 15 q / 5
    kv heads, 64, bf16): kernel, plain, SDPA (``enable_gqa``, causal) and
    the bound, operations 4 B H S^2 D / 2."""
    q, k, v = _dense_qkv(g, dev)
    ms = graph_ms(lambda: flash_attention(q, k, v, causal=True), 3)
    plain_ms = cuda_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True),
                       2, 1)
    torch.cuda.empty_cache()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    library_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                      enable_gqa=True), 10)
    flops = _causal_flops()
    t_ops = flops / BF16_FLOPS * 1e3
    t_bytes = 4 * q.numel() * 2 / HBM_BYTES_PER_S * 1e3
    bound = max(t_ops, t_bytes)
    log(f"  flash_attention dense path {tuple(q.shape)} q / {tuple(k.shape)}"
        f" kv, causal, bf16: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"SDPA {library_ms:.3f} ms, bound {bound:.3f} ms "
        f"({flops / 1e12:.3f} TFLOP)")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


ATTN_BWD_CASES = [  # B, Sq, Sk, H, K, D, causal, window, dtype
    (2, 128, 128, 4, 2, 64, True, 0, torch.float32),
    (2, 128, 128, 4, 2, 64, False, 0, torch.bfloat16),
    (1, 76, 76, 2, 1, 32, False, 0, torch.float32),
    (2, 76, 76, 4, 4, 128, True, 16, torch.bfloat16),
    (1, 200, 130, 8, 2, 64, False, 0, torch.bfloat16),
    (1, 512, 512, 8, 2, 64, True, 64, torch.float32),
    (1, 100, 37, 4, 1, 64, True, 64, torch.bfloat16),
    (1, 300, 300, 4, 2, 128, False, 0, torch.float32),
    (1, 300, 300, 4, 2, 128, True, 0, torch.bfloat16),
    (1, 1000, 1000, 8, 2, 128, True, 0, torch.bfloat16),
    (1, 300, 300, 4, 2, 32, True, 128, torch.bfloat16),
    (1, 1000, 1000, 8, 2, 128, True, 256, torch.bfloat16),
    (1, SEQ, SEQ, HEADS, HEADS, HEAD_DIM, False, 0, torch.bfloat16),
    # query counts that are no multiple of 4: the LSE and delta rows are
    # padded to a 16-byte pitch for the kernels' TMA loads
    (1, 129, 129, 3, 1, 64, True, 0, torch.bfloat16),
    (1, 130, 77, 4, 2, 128, False, 0, torch.bfloat16),
    (B_SERVE, DENSE_SEQ, DENSE_SEQ, DENSE_HEADS, DENSE_KV_HEADS,
     DENSE_HEAD_DIM, True, 0, torch.bfloat16),
]
# max |kernel - plain| / max |plain| of each of dq, dk, dv: f32 sums in
# another order; bf16 rounds P and dS for the second products and the
# outputs once (one bf16 ulp is 2^-8 of the top binade)
ATTN_BWD_BAND = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the (192, 128) path shape, each row against its own max |plain|
# (``_row_errs``): in bf16 four roundings (2^-8 each) of the row's largest
# value, from P, dS and the output; in f32 the FMA kernels' exp and online
# rescaling leave ~1e-5 of a row in o, which dq's rows amplify ~10x where
# dP - delta nearly cancels (1.1e-4 measured on an H100)
ROW_BAND = {torch.float32: 5e-4, torch.bfloat16: 1.6e-2}
ROW_FLOOR = 0.1
LSE_BAND = 1e-5          # max |lse - plain| / max(1, max |plain lse|)


def _grad_errs(got, want) -> list:
    return [float((a.float() - b.float()).abs().max())
            / max(float(b.float().abs().max()), 1e-30)
            for a, b in zip(got, want)]


def check_attention_bwd(dev) -> dict:
    """The forward's LSE output and the backward kernel against their plain
    versions, and against torch.autograd through the plain forward."""
    g = torch.Generator(device=dev).manual_seed(3)
    path_err = dense_err = None
    for (B, Sq, Sk, H, K, D, causal, window, dt) in ATTN_BWD_CASES:
        q = torch.randn(B, Sq, H, D, generator=g, device=dev).to(dt)
        k = torch.randn(B, Sk, K, D, generator=g, device=dev).to(dt)
        v = torch.randn(B, Sk, K, D, generator=g, device=dev).to(dt)
        do = torch.randn(B, Sq, H, D, generator=g, device=dev).to(dt)
        o0 = flash_attention(q, k, v, causal=causal, window=window)
        o, lse = flash_attention(q, k, v, causal=causal, window=window,
                                 return_lse=True)
        if not torch.equal(o0, o):
            fail(f"flash_attention: o with the LSE output differs from o "
                 f"without it at {(B, Sq, Sk, H, K, D)} {dt}")
        _, lse_ref = ref.flash_attention_fwd_ref(q, k, v, causal=causal,
                                                 window=window)
        lse_err = float((lse - lse_ref).abs().max()) / max(
            1.0, float(lse_ref.abs().max()))
        got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                  window=window)
        again = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                    window=window)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"flash_attention_bwd not deterministic at "
                 f"{(B, Sq, Sk, H, K, D)} {dt}")
        # the plain backward on the same (q, k, v, o, lse, do), one batch
        # row at a time (at the path shape a whole (B, S, H, S) f32 score
        # tensor is 8 GB)
        want = [torch.cat(t) for t in zip(*(
            ref.flash_attention_bwd_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                        o[i:i + 1], lse[i:i + 1],
                                        do[i:i + 1], causal=causal,
                                        window=window) for i in range(B)))]
        errs = _grad_errs(got, want)
        # torch.autograd through the plain forward, in f32, batch row 0
        leaves = [a[:1].float().requires_grad_() for a in (q, k, v)]
        ref.flash_attention_ref(*leaves, causal=causal,
                                window=window).backward(do[:1].float())
        auto = _grad_errs([a[:1] for a in got], [a.grad for a in leaves])
        torch.cuda.synchronize()
        band = ATTN_BWD_BAND[dt]
        log(f"  flash_attention_bwd B={B} Sq={Sq} Sk={Sk} H={H} K={K} D={D} "
            f"causal={causal} window={window} {dt}: dq/dk/dv vs plain "
            f"{errs[0]:.2e}/{errs[1]:.2e}/{errs[2]:.2e}, vs autograd "
            f"{auto[0]:.2e}/{auto[1]:.2e}/{auto[2]:.2e} of max|plain| "
            f"(band {band}); lse {lse_err:.2e}")
        if lse_err > LSE_BAND:
            fail(f"flash_attention lse off at {(B, Sq, Sk, H, K, D)} {dt}")
        if max(errs + auto) > band:
            fail(f"flash_attention_bwd off at {(B, Sq, Sk, H, K, D)} {dt}")
        if Sq in (SEQ, DENSE_SEQ):
            e = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(got, want))
            if Sq == SEQ:
                path_err = e
            else:
                dense_err = e
        del q, k, v, do, o, o0, lse, lse_ref, got, again, want, leaves
        torch.cuda.empty_cache()
    # times at the training path's shape: B=4, S=4608, 24 heads of 128
    shp = (4, SEQ, HEADS, HEAD_DIM)
    q, k, v, do = (torch.randn(shp, generator=g, device=dev,
                               dtype=torch.bfloat16) for _ in range(4))
    o, lse = flash_attention(q, k, v, causal=False, return_lse=True)
    # the forward's LSE variant, the one the training loss runs
    lse_fwd_ms = graph_ms(lambda: flash_attention(
        q, k, v, causal=False, return_lse=True), 2)
    ms = graph_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                              causal=False), 2)
    plain_ms = cuda_ms(lambda: ref.flash_attention_bwd_ref(
        q, k, v, o, lse, do, causal=False), 1, 1)
    torch.cuda.empty_cache()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (a.transpose(1, 2).detach().requires_grad_()
                  for a in (q, k, v))
    out = sdpa(qt, kt, vt)
    dot = do.transpose(1, 2)
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), 5)
    flops = 10 * shp[0] * HEADS * SEQ * SEQ * HEAD_DIM
    nbytes = (4 + 3) * q.numel() * 2 + 4 * lse.numel()
    t_ops = flops / BF16_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound = max(t_ops, t_bytes)
    log(f"  flash_attention_bwd path {shp} bf16: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, SDPA backward {library_ms:.3f} ms, bound "
        f"{bound:.3f} ms ({flops / 1e12:.3f} TFLOP); the forward with its "
        f"LSE output {lse_fwd_ms:.3f} ms")
    del q, k, v, do, o, lse, qt, kt, vt, out, dot
    torch.cuda.empty_cache()
    dense = _dense_attention_bwd_times(dev, g, dense_err)
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "none (JAX autodiff of src/repro/models/"
                        "attention.py:71, attention_chunked)",
            "max_abs_err": path_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms, "forward_with_lse_ms": lse_fwd_ms,
            "dense_shape": dense}


def _dense_attention_bwd_times(dev, g, err) -> dict:
    """The causal GQA backward at the dense path's shape: kernel, plain,
    SDPA backward (``enable_gqa``, causal) and the bound, 2.5x the causal
    forward's operations."""
    q, k, v, do = _dense_qkv(g, dev, "do")
    o, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    lse_fwd_ms = graph_ms(lambda: flash_attention(
        q, k, v, causal=True, return_lse=True), 3)
    ms = graph_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                              causal=True), 3)
    plain_ms = cuda_ms(lambda: ref.flash_attention_bwd_ref(
        q, k, v, o, lse, do, causal=True), 1, 1)
    torch.cuda.empty_cache()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (a.transpose(1, 2).detach().requires_grad_()
                  for a in (q, k, v))
    out = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2)
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), 5)
    flops = 2.5 * _causal_flops()
    nbytes = (4 * q.numel() + 3 * 2 * k.numel()) * 2 + 4 * lse.numel()
    t_ops = flops / BF16_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound = max(t_ops, t_bytes)
    log(f"  flash_attention_bwd dense path {tuple(q.shape)} q / "
        f"{tuple(k.shape)} kv, causal, bf16: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, SDPA backward {library_ms:.3f} ms, bound "
        f"{bound:.3f} ms ({flops / 1e12:.3f} TFLOP); the forward with its "
        f"LSE output {lse_fwd_ms:.3f} ms")
    del q, k, v, do, o, lse, qt, kt, vt, out, dot
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "forward_with_lse_ms": lse_fwd_ms}


GRPO_BATCHES = (7, 64, 1031, 4)
GRPO_BAND = 1e-6         # max |kernel - plain| / max(1, max |plain|)


def check_grpo(dev) -> list:
    """grpo_loss forward (loss, frac; guard on and off) and its backward
    kernel against the plain versions over the reference's sweep, then
    their times at the training path's batch (B = 4)."""
    g = torch.Generator(device=dev).manual_seed(4)
    err_f = err_b = 0.0
    for B in GRPO_BATCHES:
        lpn = torch.randn(B, generator=g, device=dev) * 0.05
        lpo = torch.randn(B, generator=g, device=dev) * 0.05
        adv = torch.randn(B, generator=g, device=dev)
        gl = torch.randn(B, generator=g, device=dev)
        rm = torch.exp(torch.clamp(lpn - lpo, -20, 20)).mean().reshape(1)
        for clip in (0.1, 0.3):
            for guard in (False, True):
                loss, frac = grpo_loss(lpn, lpo, adv, rm, clip=clip,
                                       guard=guard)
                lr, fr = ref.grpo_loss_ref(lpn, lpo, adv, clip=clip,
                                           guard=guard, ratio_mean=rm)
                e = float((loss - lr).abs().max()) / max(
                    1.0, float(lr.abs().max()))
                if e > GRPO_BAND or not torch.equal(frac, fr):
                    fail(f"grpo_loss off at B={B} clip={clip} "
                         f"guard={guard}: {e:.3e}")
                err_f = max(err_f, e)
            got = grpo_loss_bwd(lpn, lpo, adv, gl, clip=clip)
            want = ref.grpo_loss_bwd_ref(lpn, lpo, adv, gl, clip=clip)
            e = max(float((a - b).abs().max()) / max(1.0, float(
                b.abs().max())) for a, b in zip(got, want))
            if e > GRPO_BAND:
                fail(f"grpo_loss_bwd off at B={B} clip={clip}: {e:.3e}")
            err_b = max(err_b, e)
            # the autograd Function on CUDA tensors launches both kernels
            x = lpn.clone().requires_grad_()
            n0 = (grpo_loss.launches, grpo_loss_bwd.launches)
            loss, _ = ops.grpo_loss_trainable(x, lpo, adv, clip=clip)
            loss.backward(gl)
            if (grpo_loss.launches - n0[0], grpo_loss_bwd.launches - n0[1]) \
                    != (1, 1) or not torch.equal(x.grad, got[0]):
                fail("GRPOLossFn did not run the kernels forward and back")
    torch.cuda.synchronize()
    log(f"  grpo_loss over B {GRPO_BATCHES}, clip 0.1/0.3, guard off/on: "
        f"forward max rel err {err_f:.3e}, backward {err_b:.3e} "
        f"(band {GRPO_BAND}); frac equal")
    B = 4
    lpn, lpo, adv, gl = (torch.randn(B, generator=g, device=dev)
                         for _ in range(4))
    # the launch floor: the device time of an empty kernel (a zero-cycle
    # spin, torch.cuda._sleep(0)) measured as the kernels are
    floor_ms = graph_ms(lambda: torch.cuda._sleep(0), 40)
    log(f"  an empty kernel launch: {floor_ms:.4f} ms on the device (replayed "
        f"graph), the floor under any kernel of a few bytes")
    rows = []
    for name, kern, plain, n_in, n_out in (
            ("grpo_loss",
             lambda: grpo_loss(lpn, lpo, adv, clip=1e-4),
             lambda: ref.grpo_loss_ref(lpn, lpo, adv, clip=1e-4), 3, 2),
            ("grpo_loss_bwd",
             lambda: grpo_loss_bwd(lpn, lpo, adv, gl, clip=1e-4),
             lambda: ref.grpo_loss_bwd_ref(lpn, lpo, adv, gl, clip=1e-4),
             4, 3)):
        ms = graph_ms(kern, 40)
        call_ms = cuda_ms(kern, 200)
        plain_ms = cuda_ms(plain, 200)
        nbytes = (n_in + n_out) * B * 4
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"  {name} B={B}: kernel {ms:.4f} ms on the device ({call_ms:.4f}"
            f" ms a call with the host's launch), plain {plain_ms:.4f} ms, "
            f"bound {bound:.2e} ms ({nbytes} bytes)")
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/grpo_loss.cu",
                     "replaces": ("src/repro/kernels/grpo_loss.py:36"
                                  if name == "grpo_loss" else
                                  "src/repro/kernels/grpo_loss.py:80"),
                     "max_abs_err": err_f if name == "grpo_loss" else err_b,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": "bytes", "library_ms": None,
                     "launch_floor_ms": floor_ms})
    return rows


def draw_modulation(p: dict, d_model: int, seed: int) -> None:
    """adaLN-zero starts every block as the identity; draw the modulation
    (one layer at a time, in place) so that attention and MLP really shape
    the output."""
    ada = p["backbone"]["blocks"]["ada"]
    gen = torch.Generator(device=ada.device).manual_seed(seed)
    for layer in ada:
        layer.copy_(torch.randn(layer.shape, generator=gen,
                                device=ada.device) * (0.5 / d_model ** 0.5))


# ------------------------------------------------------------------ phase 4
def _velocity_gap(adapter, p, x, t, cond) -> tuple:
    """(max |kernel - plain|, max |plain|) of one velocity; fails unless
    the kernel route ran the attention kernel once per block."""
    with torch.no_grad():
        n0 = flash_attention.launches
        vk = adapter.velocity(p, x, t, cond)
        if flash_attention.launches - n0 != adapter.cfg.n_layers:
            fail(f"the {adapter.cfg.name} velocity did not run the attention "
                 "kernel once per block")
        with plain_dispatch():
            vp = adapter.velocity(p, x, t, cond)
    torch.cuda.synchronize()
    if not torch.isfinite(vk).all():
        fail(f"the {adapter.cfg.name} velocity is not finite")
    return float((vk - vp).abs().max()), float(vp.abs().max())


def check_velocity(dev) -> None:
    cfg = replace(configs.get("flux_dit"), n_layers=2)
    adapter = FlowAdapter(cfg, FlowRLConfig(latent_tokens=LAT_TOKENS,
                                            latent_dim=LAT_DIM), COND_DIM)
    gen = torch.Generator(device=dev).manual_seed(0)
    p = params_lib.init(adapter.spec(), gen, torch.bfloat16, dev)
    draw_modulation(p, cfg.d_model, seed=1)
    x = torch.randn(1, LAT_TOKENS, LAT_DIM, generator=gen, device=dev)
    cond = torch.randn(1, COND_LEN, COND_DIM, generator=gen, device=dev)
    t = torch.tensor([0.7], device=dev)
    err, scale = _velocity_gap(adapter, p, x, t, cond)
    log(f"  velocity flux_dit depth 2 (1, {SEQ} tokens) bf16: max|kernel - "
        f"plain| {err:.3e} of max|v| {scale:.3e}")
    if err > BF16_BAND * scale:
        fail("velocity through the kernels is off the bf16 band")


# ------------------------------------------------------------------ phase 5
def main_path() -> dict:
    argv = ["--arch", "flux_dit", "--sde", "flow_sde", "--device", "cuda",
            "--requests", str(B_SERVE), "--max-batch", str(B_SERVE),
            "--bucket", str(B_SERVE),
            "--set", f"flow.num_steps={NUM_STEPS}",
            "--set", f"flow.latent_tokens={LAT_TOKENS}",
            "--set", f"flow.latent_dim={LAT_DIM}",
            "--set", "param_dtype=bfloat16",
            "--set", "data.encoder=" + json.dumps(
                {"cond_dim": COND_DIM, "cond_len": COND_LEN})]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = serve.main(argv)
    launches = counts()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    stats, lat = out["stats"], out["latents"]
    batches = len(out["warmup"]) + sum(stats["dispatches"].values())
    serve_batches = sum(stats["dispatches"].values())
    log(f"  launches {launches} over {batches} batches (warmup + serve)")
    if tuple(lat.shape) != (B_SERVE, LAT_TOKENS, LAT_DIM):
        fail(f"latents have shape {tuple(lat.shape)}")
    if not torch.isfinite(lat).all():
        fail("served latents are not finite")
    if launches["sde_step"] != NUM_STEPS * batches:
        fail(f"sde_step launched {launches['sde_step']} times, expected "
             f"{NUM_STEPS * batches}")
    if launches["flash_attention"] != N_LAYERS * NUM_STEPS * batches:
        fail(f"flash_attention launched {launches['flash_attention']} "
             f"times, expected {N_LAYERS * NUM_STEPS * batches}")
    serve_s = out["serve_s"]
    res = {"engine": out["engine"], "latents": lat,
           "launches": launches, "batches": batches,
           "req_per_s": B_SERVE / serve_s,
           "s_per_step": serve_s / (serve_batches * NUM_STEPS),
           "serve_s": serve_s, "warmup_s": out["warmup_s"],
           "peak_bytes": peak}
    log(f"  main path: {res['req_per_s']:.4f} req/s, {res['s_per_step']:.4f}"
        f" s per denoising step (batch {B_SERVE}), max_memory_allocated "
        f"{peak / 2**30:.2f} GiB")
    return res


# ------------------------------------------------------------------ phase 6
PROFILE_GROUPS = (
    # every kernel of csrc/ssd_scan_bwd.cu and csrc/ssd_scan_bwd_wgmma.cu
    # lives in namespace ssd_bwd, the forward's FMA passes that the first
    # reruns too
    ("ssd_scan_bwd kernels", ("ssd_bwd",)),
    ("ssd_scan kernel", ("ssd_chunk_", "ssd_state_pass", "ssd_scan_wgmma")),
    ("flash_attention kernel", ("attn_fwd",)),
    ("flash_attention_bwd kernel", ("bwd_delta", "bwd_dkdv", "bwd_dq")),
    ("sde_step kernel", ("sde_step_chunks", "sde_logp_rows")),
    ("grpo_loss kernels", ("grpo_fwd", "grpo_bwd")),
    ("matmul (cuBLAS)", ("gemm", "xmma", "nvjet", "cutlass", "sm90_")))


def _profile_group(name: str) -> str:
    low = name.lower()
    for group, keys in PROFILE_GROUPS:
        if any(k in low for k in keys):
            return group
    return "other (elementwise, norms, copies)"


def profile(fn, what: str) -> dict:
    """Trace one call of ``fn`` (warmed up) with ``torch.profiler``: device
    time by kernel group and the device's idle share over the call.  The
    cached blocks are released before the warm-up call: a train step of
    54-layer zamba2-2.7b after the script's earlier phases found too few
    contiguous ones for its largest tensors."""
    gc.collect()
    torch.cuda.empty_cache()
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = {}          # kernel name -> [device ms, launches]
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            row = rows.setdefault(e.name, [0.0, 0])
            row[0] += e.time_range.elapsed_us() / 1e3
            row[1] += 1
    busy = sum(ms for ms, _ in rows.values())
    if busy == 0:
        fail(f"the profile of {what} holds no device time")
    groups = {}
    for name, (ms, n) in rows.items():
        g = groups.setdefault(_profile_group(name), [0.0, 0])
        g[0] += ms
        g[1] += n
    log(f"  {what}: traced wall {wall_ms:.3f} ms, device busy {busy:.3f} ms, "
        f"idle share {max(0.0, 1 - busy / wall_ms):.4f}")
    for g, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"    {g:36s} {ms:10.3f} ms  {100 * ms / busy:6.2f} %  "
            f"{n} launches")
    log("  top kernels by device time:")
    for name, (ms, n) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"    {ms:10.3f} ms  {n:5d}x  {name[:100]}")
    return {"traced_wall_ms": wall_ms, "device_busy_ms": busy,
            "groups_ms": {g: v[0] for g, v in groups.items()},
            "groups_launches": {g: v[1] for g, v in groups.items()}}


def profile_step(eng, seq: int) -> dict:
    """Trace one denoising step of the serving engine (the body of
    ``rollout_keyed``: velocity, then ``step_with_eps``) at batch 4 over
    ``seq`` tokens."""
    prompts = synthetic_prompts(B_SERVE)
    cond = torch.from_numpy(eng.encode(prompts)).to(eng.device)
    draws = [request_draws(eng.adapter, s, NUM_STEPS, eng.device)
             for s in request_seeds(0, B_SERVE)]
    x = torch.stack([d[0] for d in draws])
    eps = torch.stack([d[1][0] for d in draws])
    ts = eng.scheduler.timesteps(NUM_STEPS)
    t, t_next = float(ts[0]), float(ts[1])
    tb = torch.full((B_SERVE,), t, device=eng.device)

    @torch.no_grad()
    def step():
        v = eng.adapter.velocity(eng.params, x, tb, cond).float()
        return eng.scheduler.step_with_eps(v, x, t, t_next, eps)

    return profile(step, f"one denoising step, batch {B_SERVE}, {seq} tokens")


# ------------------------------------------------------------------ phase 7
def check_modulated(eng, lat_zero: torch.Tensor) -> dict:
    """Serve the main path's requests again with the modulation drawn,
    through the engine and the kernels, and replay them through
    ``rollout_keyed`` on the plain versions."""
    draw_modulation(eng.params, eng.adapter.cfg.d_model, seed=2)
    prompts = synthetic_prompts(B_SERVE)
    lat = eng.serve(prompts, 0)          # the seed serve.main used
    cond = torch.from_numpy(eng.encode(prompts)).to(eng.device)
    with torch.no_grad(), plain_dispatch():
        ref_lat = rollout_keyed(eng.adapter, eng.params, cond,
                                request_seeds(0, B_SERVE), eng.scheduler,
                                NUM_STEPS).x0.cpu()
    err = float((lat - ref_lat).abs().max())
    scale = float(ref_lat.abs().max())
    moved = float((lat - lat_zero).abs().max())
    log(f"  {B_SERVE} requests served through the kernels vs rollout_keyed "
        f"through the plain versions: max|diff| {err:.3e} of max|x| "
        f"{scale:.3e}; the drawn modulation moved the latents by "
        f"{moved:.3e}")
    if not torch.isfinite(lat).all():
        fail("latents served with the drawn modulation are not finite")
    if err > BF16_BAND * scale:
        fail("served latents disagree with the plain replay")
    if moved <= 10 * err:
        fail("the drawn modulation hardly moved the latents; the replay "
             "check cannot see the blocks")
    return {"max_abs_err": err, "max_abs": scale, "moved": moved}


# ------------------------------------------------------------------ phase 8
TRAIN_LAYERS, TRAIN_STEPS, PROMPTS, GROUP = 4, 2, 2, 2
TRAIN_REWARDS = [{"reward_type": "text_render", "weight": 1.0},
                 {"reward_type": "pickscore", "weight": 0.25},
                 {"reward_type": "latent_norm", "weight": 0.1}]


def _layer_abs_max(g: torch.Tensor, stack_dims: int) -> torch.Tensor:
    """Each layer's max |g| (f32, NaN if the layer has one) of a leaf
    stacked over its first ``stack_dims`` dims, from ``aminmax``: no
    copy of the leaf (a deepseek expert table's f32 copy is 4.7 GiB)."""
    lo, hi = torch.aminmax(g.flatten(0, stack_dims - 1).flatten(1), dim=1)
    return torch.maximum(-lo, hi).float()


class _TrainWatch(loop_lib.Callback):
    """At train start: sets the launch counts to 0, redraws leaves with
    ``draw(params, cfg)`` if given,
    keeps a copy of the leaves ``keys`` of the blocks' ``block`` (so the run
    can show that the params moved), and wraps the trainer's
    ``apply_grads``, which clears the gradients, to keep each layer's max
    |grad| of ``grad_keys`` at the first update (the leaves are stacked
    over their first ``stack_dims`` dims: 2 for the hybrid's (groups,
    attn_every))."""

    def __init__(self, block: str, keys: tuple, grad_keys: tuple = (),
                 draw=None, stack_dims: int = 1):
        self.block, self.keys, self.grad_keys = block, keys, grad_keys
        self.draw, self.stack_dims = draw, stack_dims

    def on_train_start(self, loop):
        # the counts cover the train loop, not ``perf.log_memory``'s
        # ``memory_stats`` run before it
        reset_counts()
        tr = loop.trainer
        if self.draw is not None:
            self.draw(tr.state.params, tr.adapter.cfg)
        leaves = tr.state.params["backbone"]["blocks"][self.block]
        self.before = {k: leaves[k].clone() for k in self.keys}
        self.first_grads = None
        inner = tr.apply_grads

        def apply_grads():
            if self.first_grads is None:
                self.first_grads = {
                    k: _layer_abs_max(leaves[k].grad, self.stack_dims)
                    for k in self.grad_keys}
            return inner()

        tr.apply_grads = apply_grads

    def moved(self, trainer) -> dict:
        leaves = trainer.state.params["backbone"]["blocks"][self.block]
        return {k: float((leaves[k].float() - self.before[k].float()
                          ).abs().max()) for k in self.keys}


def train_path(tmp: str) -> dict:
    """``repro_torch.launch.train.main`` on the card: full-width flux_dit
    at 4 blocks, bf16, FLUX.1-dev geometry, flow_sde, T=4, 2 prompts x
    group 2, three rewards under gdpo, 2 steps."""
    argv = ["--arch", "flux_dit", "--sde", "flow_sde", "--device", "cuda",
            "--trainer", "flow_grpo", "--steps", str(TRAIN_STEPS),
            "--set", "arch_overrides=" + json.dumps(
                {"n_layers": TRAIN_LAYERS}),
            "--set", "param_dtype=bfloat16",
            "--set", f"flow.num_steps={NUM_STEPS}",
            "--set", f"flow.group_size={GROUP}",
            "--set", f"flow.latent_tokens={LAT_TOKENS}",
            "--set", f"flow.latent_dim={LAT_DIM}",
            "--set", "flow.advantage_agg=gdpo",
            "--set", "flow.rewards=" + json.dumps(TRAIN_REWARDS),
            "--set", f"flow.cache_dir={tmp}/cache",
            "--set", "data.encoder=" + json.dumps(
                {"cond_dim": COND_DIM, "cond_len": COND_LEN}),
            "--set", f"data.batch_prompts={PROMPTS}",
            "--set", f"data.n_prompts={PROMPTS * TRAIN_STEPS}",
            "--set", "loop.save_every=0", "--set", "loop.log_every=1",
            "--set", f"loop.ckpt_dir={tmp}/ckpt"]
    watch = _TrainWatch("attn", ("wq", "wk", "wv"))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = train.main(argv, callbacks=[watch])
    launches = counts()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    hist = out["history"]
    trainer = out["experiment"].build_trainer()
    n = TRAIN_STEPS
    want = {"sde_step": NUM_STEPS * n,
            "flash_attention": 2 * TRAIN_LAYERS * NUM_STEPS * n,
            "flash_attention_bwd": TRAIN_LAYERS * NUM_STEPS * n,
            "grpo_loss": NUM_STEPS * n, "grpo_loss_bwd": NUM_STEPS * n,
            "ssd_scan": 0, "ssd_scan_bwd": 0}
    log(f"  launches {launches} over {n} train steps (expected {want})")
    if launches != want:
        fail("the train path's kernel launches do not match the path")
    if len(hist) != n:
        fail(f"{len(hist)} train steps ran, expected {n}")
    for r in hist:
        vals = [r["loss"], r["grad_norm"], r["reward"]] + [
            v for k, v in r.items() if k.startswith("reward/")]
        if not all(math.isfinite(v) for v in vals):
            fail(f"train step {r['step']}: non-finite metrics {r}")
    moved = watch.moved(trainer)
    if int(trainer.state.opt.step) != n or not all(moved.values()):
        fail(f"the params did not move: step {int(trainer.state.opt.step)}, "
             f"max |change| {moved}")
    for r in hist:
        log(f"  step {r['step']}: {r['dt']:.4f} s (trainer.step through the "
            f"metrics fetch), loss {r['loss']:+.4e}, grad_norm "
            f"{r['grad_norm']:.4e}, reward {r['reward']:+.4e}, clip_frac "
            f"{r['clip_frac']:.3f}, max|logp_new - logp_old| "
            f"{r['logp_gap']:.4e} (clip_range {trainer.flow.clip_range})")
    log(f"  max_memory_allocated {peak / 2**30:.2f} GiB ({peak} bytes); "
        f"params moved by up to {moved}")
    res = {"launches": launches, "s_per_step": [r["dt"] for r in hist],
           "peak_bytes": peak,
           "clip_frac": [r["clip_frac"] for r in hist],
           "logp_gap": [r["logp_gap"] for r in hist],
           "loss": [r["loss"] for r in hist],
           "grad_norm": [r["grad_norm"] for r in hist],
           "reward": [r["reward"] for r in hist]}
    # one more train step of the same trainer, traced
    cond = torch.randn(PROMPTS, COND_LEN, COND_DIM, device=trainer.device)
    it = [n]

    def one_step():
        m = trainer.step(cond, 0, it=it[0])
        it[0] += 1
        return float(m["loss"])

    res["profile"] = profile(
        one_step, f"one train step, {PROMPTS} x {GROUP} samples, "
                  f"{TRAIN_LAYERS} blocks, {NUM_STEPS} timesteps")
    return res


# ------------------------------------------------------------------ phase 9
UPDATE_LAYERS, UPDATE_CLIP = 2, 0.2
TRAINERS = ("flow_grpo", "mix_grpo", "grpo_guard", "nft", "awm")
GRPO_FAMILY = ("flow_grpo", "mix_grpo", "grpo_guard")
# max |kernel - plain| / max |plain| of the attention weights' grads and the
# relative gap of grad_norm: two bf16 runs of the same step, each with its
# own rollout (latents 4e-3 apart after 4 steps, phase 7) and bf16 P and
# dS in the attention backward
GRAD_BAND = 5e-2
# of the weights that the plain route's AdamW step moved, the share that
# differ between the routes: they differ only where the two gradients'
# signs do (both within their gap of zero) or their rounding lands one ulp
# apart; a step in the wrong direction would make about all of them differ
PARAM_DIFF_SHARE = 0.25


def _loss_band(name: str, k: dict, p: dict) -> float:
    """How far the two routes' losses may lie apart.  GRPO family: inside
    the clip band each loss is -mean(ratio A) with |ratio - 1| <= w, so the
    two differ by at most 2 w mean|A|, with w the clip range (GRPO-Guard's
    RatioNorm divides by a batch mean that is itself within the clip band:
    w = (1 + c) / (1 - c) - 1).  NFT and AWM: squared velocity errors on
    two bf16 rollouts' x0 at the same (t, eps), GRAD_BAND relative to the
    size of the loss's terms: NFT's are positive, so the loss itself; AWM
    weights them by advantages of both signs, so mean|A| times the mean
    squared error (vel_err squared)."""
    adv = max(k["adv_abs"], p["adv_abs"])
    if name == "grpo_guard":
        return 2 * ((1 + UPDATE_CLIP) / (1 - UPDATE_CLIP) - 1) * adv
    if name in GRPO_FAMILY:
        return 2 * UPDATE_CLIP * adv
    if name == "awm":
        se = max(k["aux"]["vel_err"], p["aux"]["vel_err"]) ** 2
        return GRAD_BAND * adv * se
    return GRAD_BAND * abs(p["loss"])


def _param_gap(got, want, start, lr: float) -> dict:
    """The params after one AdamW step of two routes from ``start``.
    AdamW's first step moves each weight by lr * g / (|g| + eps), ~lr
    times the gradient's sign: where the two routes' gradients share it
    the weights agree to their rounding; elsewhere they differ by 2 lr.
    So each leaf is held to 2 lr plus one bf16 ulp of its own max |p|
    (``param_band_share`` <= 1), and the share of the weights the step
    moved that differ is counted."""
    p_err, p_ratio, p_band, p_leaf = 0.0, 0.0, 0.0, ""
    n_diff, n_moved, n_all = 0, 0, 0
    for (path, a), (_, b), (_, b0) in zip(params_lib.leaves(got),
                                          params_lib.leaves(want),
                                          params_lib.leaves(start)):
        d = (a.float() - b.float()).abs()
        b_max = float(b.float().abs().max())
        ulp = 2.0 ** (math.floor(math.log2(b_max)) - 7) if b_max > 0 else 0.0
        band = 2 * lr + ulp
        d_max = float(d.max())
        p_err = max(p_err, d_max)
        if d_max / band >= p_ratio:
            p_ratio, p_band, p_leaf = d_max / band, band, "/".join(path)
        n_diff += int((d > 0).sum())
        n_moved += int((b != b0).sum())
        n_all += d.numel()
    return {"param_max_diff": p_err, "param_leaf": p_leaf,
            "param_band": p_band, "param_band_share": p_ratio,
            "params_differing": n_diff, "params_moved": n_moved,
            "params_total": n_all}


def check_update(dev, name: str, arch: str = "flux_dit") -> dict:
    """One update of trainer ``name`` (rollout, rewards, loss and its
    gradient, clip, AdamW) of ``arch`` at full width, depth 2, batch 2,
    through the kernels and, on the same injected draws (x_init, the
    rollout's eps, and for NFT/AWM the update's t and noise), through the
    plain versions.  ``flux_dit`` draws the modulation and holds the
    attention weights' grads; ``mamba2-370m`` draws the SSM leaves and holds
    the grads of in_proj, conv_w, a_log and dt_bias; ``zamba2-2.7b`` (2
    groups of one SSM block, ``depth_cfg``) draws the SSM leaves and the
    shared wq/wk and holds those SSM grads and the shared block's wq, wk
    and wv (the sum over its two sites).  The clip range is
    widened to 0.2 so that every sample's ratio lies inside the band on
    both routes (the kernel rollout's log-density differs from the loss's
    by the gap phase 8 prints)."""
    hybrid = arch == HY_ARCH
    ssm = arch == SSM_ARCH or hybrid
    cond_len = SSM_COND_LEN if ssm else COND_LEN
    paths = ([("blocks", "ssm", k) for k in SSM_GRAD_KEYS] if ssm
             else [("blocks", "attn", k) for k in ("wq", "wk", "wv")])
    if hybrid:
        paths += [("shared_attn", "attn", k) for k in ("wq", "wk", "wv")]
    keys = ["/".join(p[1:]) for p in paths]
    cfg = depth_cfg(arch, UPDATE_LAYERS)
    flow = FlowRLConfig(num_steps=NUM_STEPS, group_size=2,
                        clip_range=UPDATE_CLIP, latent_tokens=LAT_TOKENS,
                        latent_dim=LAT_DIM, advantage_agg="gdpo",
                        rewards=(RewardSpec("pickscore", 1.0, args={
                            "latent_dim": LAT_DIM, "cond_dim": COND_DIM}),
                                 RewardSpec("latent_norm", 0.1)))
    opt = OptimConfig(lr=1e-4, warmup_steps=1, total_steps=1000)
    gen = torch.Generator(device=dev).manual_seed(5)
    cond = torch.randn(1, cond_len, COND_DIM, generator=gen, device=dev)
    x_init = torch.randn(2, LAT_TOKENS, LAT_DIM, generator=gen, device=dev)
    eps = torch.randn(NUM_STEPS, 2, LAT_TOKENS, LAT_DIM, generator=gen,
                      device=dev)
    t_u = 0.02 + 0.96 * torch.rand(2, generator=gen, device=dev)
    eps_u = torch.randn(2, LAT_TOKENS, LAT_DIM, generator=gen, device=dev)
    runs = {}
    params = None
    for route in ("kernel", "plain"):
        tr = registry.build("trainer", name, cfg, flow, opt, seed=0,
                            cond_dim=COND_DIM, device=dev, params=params)
        if params is None:
            if ssm:
                draw_ssm(tr.state.params, seed=6)
                if hybrid:
                    draw_shared_attention(tr.state.params, cfg.d_model,
                                          seed=6)
            else:
                draw_modulation(tr.state.params, cfg.d_model, seed=6)
            params = _clone(tr.state.params)
            start = _clone(params)
        ctx = plain_dispatch() if route == "plain" else contextlib.nullcontext()
        reset_counts()
        with ctx:
            traj = tr.sample(tr.state.params, cond, None, x_init=x_init,
                             eps=eps)
            _, adv, stats = tr._rewards(traj.x0, {"cond": traj.cond})
            loss, aux = tr.backward(traj, adv, t=t_u, eps=eps_u)
            bb = tr.state.params["backbone"]
            grads = {k: bb[p[0]][p[1]][p[2]].grad.clone()
                     for k, p in zip(keys, paths)}
            tr._begin_update()
            gnorm, lr = tr.apply_grads()
            tr._end_update()
            lr = float(lr)
        torch.cuda.synchronize()
        # mamba2-370m's scan backward on the tensor cores; zamba2-2.7b's
        # (state 64) on the FMA passes, its attention backward on the
        # tensor cores
        want_routes = ({"ssd_scan_bwd": "fma", "flash_attention_bwd": "wgmma"}
                       if hybrid else {"ssd_scan_bwd": "wgmma"} if ssm
                       else {})
        ran = all_variants()
        if route == "kernel" and any(
                ran[kn] != routed(COUNTED_BY_NAME[kn].launches, v)
                or COUNTED_BY_NAME[kn].launches == 0
                for kn, v in want_routes.items()):
            fail(f"{name}: the {arch} update's backward kernels did not run "
                 f"on their routes {want_routes}: variants {ran}")
        runs[route] = {"loss": float(loss), "grad_norm": float(gnorm),
                       "lr": lr, "grads": grads,
                       "aux": {a: float(v) for a, v in aux.items()},
                       "reward": float(stats["reward_mean"]),
                       "adv_abs": float(adv.abs().mean()),
                       "params": tr.state.params}
        del tr, traj
        torch.cuda.empty_cache()
    k, p = runs["kernel"], runs["plain"]
    grad_err = {n: float((k["grads"][n].float() - p["grads"][n].float()
                          ).abs().max()) / float(p["grads"][n].float().abs(
                              ).max()) for n in k["grads"]}
    zero = [n for n, g in k["grads"].items() if not g.abs().max() > 0]
    gn_err = abs(k["grad_norm"] - p["grad_norm"]) / p["grad_norm"]
    gap = _param_gap(k["params"], p["params"], start, k["lr"])
    p_err, p_ratio, p_band, p_leaf = (gap["param_max_diff"],
                                      gap["param_band_share"],
                                      gap["param_band"], gap["param_leaf"])
    n_diff, n_moved, n_all = (gap["params_differing"], gap["params_moved"],
                              gap["params_total"])
    del start
    diff_share = n_diff / max(n_moved, 1)
    aux = ", ".join(f"{a} {k['aux'][a]:.4e} / {p['aux'][a]:.4e}"
                    for a in k["aux"])
    log(f"  one {name} update, {arch} depth {UPDATE_LAYERS}, batch 2, "
        f"kernels vs plain: loss {k['loss']:+.4e} / {p['loss']:+.4e}, "
        f"grad_norm {k['grad_norm']:.4e} / {p['grad_norm']:.4e} "
        f"({gn_err:.2e}), reward {k['reward']:+.4e} / {p['reward']:+.4e}, "
        f"{aux}")
    log(f"  grads of {', '.join(keys)}: max|kernel - plain| / max|plain| "
        + ", ".join(f"{grad_err[n]:.3e}" for n in keys)
        + f" (band {GRAD_BAND}); params after AdamW: max|diff| {p_err:.3e}, "
        f"nearest its leaf's band (2 lr + one bf16 ulp of the leaf's max|p|) "
        f"{p_leaf} at {p_ratio:.3f} of {p_band:.3e}; {n_diff} of the "
        f"{n_moved} weights the step moved differ ({diff_share:.4f}, band "
        f"{PARAM_DIFF_SHARE}), of {n_all}")
    if zero:
        fail(f"{name}: the gradients of {zero} are zero: the check cannot "
             f"see their backward")
    if max(grad_err.values()) > GRAD_BAND or gn_err > GRAD_BAND:
        fail(f"{name}: the update's gradients through the kernels disagree "
             "with the plain versions")
    loss_band = _loss_band(name, k, p)
    if abs(k["loss"] - p["loss"]) > loss_band:
        fail(f"{name}: the update's loss through the kernels disagrees with "
             f"the plain versions beyond {loss_band:.3e}")
    if p_ratio > 1:
        fail(f"{name}: the params of {p_leaf} after AdamW disagree between "
             "the routes")
    if n_moved == 0 or diff_share > PARAM_DIFF_SHARE:
        fail(f"{name}: the AdamW step moved {n_moved} weights, of which "
             f"{diff_share:.4f} differ between the routes")
    return {"grad_err": grad_err, "grad_norm_err": gn_err,
            "loss": [k["loss"], p["loss"]], "loss_band": loss_band,
            "aux": [k["aux"], p["aux"]], **gap}


def check_updates(dev, arch: str = "flux_dit") -> dict:
    """Phase 9 (``flux_dit``) or 18 (``mamba2-370m``) for each of the five
    trainers."""
    out = {}
    for name in TRAINERS:
        out[name] = check_update(dev, name, arch)
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------- phase 10
# the Mamba-2 serving path: mamba2-370m at its published width, one time
# token between a 511-token condition and 4096 latent tokens, so that the
# sequence (4608 = 36 x 128) is a multiple of the scan's chunk
SSM_ARCH, SSM_LAYERS, SSM_COND_LEN = "mamba2-370m", 48, 511
SSM_SEQ = SSM_COND_LEN + 1 + LAT_TOKENS
SSM_HEADS, SSM_HEAD_DIM, SSM_STATE, SSM_CHUNK = 32, 64, 128, 128
# max |kernel - plain| / max |plain|: f32 sums in another order; in bf16 y
# is rounded once from f32 by both (a tie lands one bf16 ulp, 2^-8, apart)
SSD_Y_BAND = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
SSD_H_BAND = 1e-4        # the final state is f32 on both routes


def _ssd_inputs(g, dev, B, L, H, P, N, kind, dtype):
    """x, dt, a, bm, cm of one scan.  ``sweep``: the reference's sweep
    (tests/test_kernels.py); ``mamba2``: Mamba-2's init, dt log-uniform in
    [1e-3, 1e-1] and A in [-16, -1] (arXiv:2405.21060); ``slow``: |dA| near
    1e-3, where the state carried across chunks dominates y."""
    x = torch.randn(B, L, H, P, generator=g, device=dev).to(dtype)
    bm = (torch.randn(B, L, N, generator=g, device=dev) * 0.5).to(dtype)
    cm = (torch.randn(B, L, N, generator=g, device=dev) * 0.5).to(dtype)
    u = torch.rand(B, L, H, generator=g, device=dev)
    if kind == "sweep":
        dt = torch.nn.functional.softplus(
            torch.randn(B, L, H, generator=g, device=dev)) * 0.5
        a = -torch.exp(torch.randn(H, generator=g, device=dev) * 0.3)
    elif kind == "mamba2":
        dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
        a = -(1 + 15 * torch.rand(H, generator=g, device=dev))
    else:
        dt = 1e-3 * (0.5 + u)
        a = -(0.5 + torch.rand(H, generator=g, device=dev))
    return x, dt.contiguous(), a, bm, cm


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


@contextlib.contextmanager
def fma_route():
    """Send every ``ssd_scan`` call to the f32 FMA passes, to time them
    beside the tensor-core kernel on the same inputs (the port itself has
    no such switch)."""
    saved = ssd_mod.tensor_core_route
    ssd_mod.tensor_core_route = lambda *args: False
    try:
        yield
    finally:
        ssd_mod.tensor_core_route = saved


def _ssd_variant(call):
    """(result of ``call()``, the ssd_scan variant that it launched)."""
    before = dict(ssd_scan.variant_launches)
    out = call()
    ran = [k for k, n in ssd_scan.variant_launches.items() if n != before[k]]
    if len(ran) != 1:
        fail(f"one ssd_scan call launched variants {ran}")
    return out, ran[0]


def _ssd_fwd_bound(B, L, H, P, N, Q) -> tuple:
    """(bound ms, "bytes" or "operations", bytes, flops) of one bf16 scan:
    x, bm, cm, dt and a read once, y and the f32 final state written once;
    per chunk C B^T (shared by the heads) and per head L' x, C h_prev and
    the state update at the bf16 tensor-core rate."""
    nc = L // Q
    nbytes = (2 * B * L * H * P * 2 + B * L * H * 4 + H * 4
              + 2 * B * L * N * 2 + B * H * P * N * 4)
    flops = 2 * B * nc * Q * (Q * N + H * Q * P + 2 * H * P * N)
    return _bound(nbytes, flops) + (nbytes, flops)


def _ssd_bwd_bound(B, L, H, P, N, Q) -> tuple:
    """The same for the scan's backward (``_ssd_bwd_times`` counts)."""
    nc = L // Q
    nbytes = (3 * B * L * H * P * 2 + 4 * B * L * N * 2 + 2 * B * L * H * 4
              + 2 * H * 4)
    flops = 2 * B * nc * (3 * Q * Q * N + H * (2 * Q * Q * P + 5 * Q * P * N))
    return _bound(nbytes, flops) + (nbytes, flops)


def _bound(nbytes: float, flops: float) -> tuple:
    """(ms, what bounds it): the larger of the bytes over the memory rate
    and the operations over the bf16 tensor-core rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _ssd_times(dev, g, B) -> dict:
    """Device ms of the tensor-core kernel and of the FMA passes on the same
    bf16 inputs (replayed graphs), of the plain version, and the bound, at
    the path shape with batch ``B``."""
    L, H, P, N, Q = SSM_SEQ, SSM_HEADS, SSM_HEAD_DIM, SSM_STATE, SSM_CHUNK
    x, dt, a, bm, cm = _ssd_inputs(g, dev, B, L, H, P, N, "mamba2",
                                   torch.bfloat16)
    with fma_route():
        fma_ms = graph_ms(lambda: ssd_scan(x, dt, a, bm, cm, chunk=Q), 5)
    ms = graph_ms(lambda: ssd_scan(x, dt, a, bm, cm, chunk=Q), 5)
    call_ms = cuda_ms(lambda: ssd_scan(x, dt, a, bm, cm, chunk=Q), 20)
    plain_ms = cuda_ms(lambda: ref.ssd_chunked_ref(x, dt, a, bm, cm, Q), 3, 1)
    bound, by, nbytes, flops = _ssd_fwd_bound(B, L, H, P, N, Q)
    log(f"  ssd_scan path (B={B}, L={L}, H={H}, P={P}, N={N}, Q={Q}) bf16: "
        f"kernel {ms:.4f} ms on the device ({call_ms:.4f} ms a call with "
        f"the host's launch), the f32 FMA passes {fma_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.2f} GFLOP)")
    del x, dt, a, bm, cm
    torch.cuda.empty_cache()
    return {"ms": ms, "call_ms": call_ms, "fma_ms": fma_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}


def check_ssd(dev) -> dict:
    """ssd_scan against the plain chunked version (and the sequential
    recurrence at small lengths) over the reference's sweep, odd shapes,
    the slow-decay cases and the path shape, f32 and bf16, bitwise on
    rerun, each case on the variant its dtype and shape call for (bf16 at
    head dim 64, state 128, chunk 128 on the tensor cores, the rest on the
    FMA passes); then its times at the path shape at batch 4 and 1."""
    g = torch.Generator(device=dev).manual_seed(7)
    P_, N_, Q_ = SSM_HEAD_DIM, SSM_STATE, SSM_CHUNK
    cases = [  # B, L, H, P, N, chunk, kind
        (2, 128, 2, 32, 64, 32, "sweep"), (1, 256, 4, 64, 128, 128, "sweep"),
        (3, 64, 1, 16, 32, 64, "sweep"),
        (2, 384, 1, P_, N_, Q_, "sweep"), (2, 128, 4, P_, N_, Q_, "sweep"),
        (1, 21, 3, 8, 16, 32, "sweep"), (2, 96, 16, 32, 32, 32, "sweep"),
        (2, 1024, 8, P_, N_, Q_, "mamba2"), (2, 1024, 4, P_, N_, Q_, "slow"),
        (B_SERVE, SSM_SEQ, SSM_HEADS, P_, N_, Q_, "mamba2"),
        (B_SERVE, SSM_SEQ, SSM_HEADS, P_, N_, Q_, "slow"),
    ]
    path_err = 0.0
    for (B, L, H, P, N, Q, kind) in cases:
        for dt_ in (torch.float32, torch.bfloat16):
            x, dt, a, bm, cm = _ssd_inputs(g, dev, B, L, H, P, N, kind, dt_)
            (y, hT), variant = _ssd_variant(
                lambda: ssd_scan(x, dt, a, bm, cm, chunk=Q))
            want = ("wgmma" if dt_ == torch.bfloat16
                    and (P, N, min(Q, L)) == (P_, N_, Q_) else "fma")
            if variant != want:
                fail(f"ssd_scan at {(B, L, H, P, N, Q)} {dt_} ran the "
                     f"{variant} variant, not {want}")
            y2, h2 = ssd_scan(x, dt, a, bm, cm, chunk=Q)
            if not (torch.equal(y, y2) and torch.equal(hT, h2)):
                fail(f"ssd_scan not bitwise equal on rerun at "
                     f"{(B, L, H, P, N, Q)} {kind} {dt_}")
            yp, hp = ref.ssd_chunked_ref(x, dt, a, bm, cm, Q)
            errs = [_rel(y, yp), _rel(hT, hp)]
            if L <= 384:
                ys, hs = ref.ssd_scan_ref(x, dt, a, bm, cm)
                errs += [_rel(y, ys), _rel(hT, hs)]
            # how much of y the state carried across chunks makes: the
            # same scan with every chunk started from zero
            q = min(Q, L)
            loc, _ = ref.ssd_chunked_ref(
                *(t.reshape(B * (L // q), q, *t.shape[2:])
                  for t in (x, dt)), a,
                *(t.reshape(B * (L // q), q, -1) for t in (bm, cm)), q)
            carried = _rel(loc.reshape(y.shape), yp)
            # the tensor-core kernel against its own rounding, written out
            emu = ""
            if variant == "wgmma":
                ye, he = ref.ssd_tensor_core_ref(x, dt, a, bm, cm, Q)
                emu = (f"; vs its rounding written out: y {_rel(y, ye):.2e},"
                       f" hT {_rel(hT, he):.2e}")
                del ye, he
            torch.cuda.synchronize()
            y_err, h_err = max(errs[0::2]), max(errs[1::2])
            log(f"  ssd_scan B={B} L={L} H={H} P={P} N={N} Q={q} {kind} "
                f"{dt_} [{variant}]: y {y_err:.2e} (band {SSD_Y_BAND[dt_]}),"
                f" hT {h_err:.2e} (band {SSD_H_BAND}) of max|plain|"
                f"{' vs chunked and sequential' if len(errs) > 2 else ''}; "
                f"carried state {carried:.3f} of max|y|{emu}")
            if y_err > SSD_Y_BAND[dt_] or h_err > SSD_H_BAND:
                fail(f"ssd_scan off at {(B, L, H, P, N, Q)} {kind} {dt_}")
            if kind == "slow" and L > Q and carried < 0.5:
                fail("the slow-decay case does not make the carried state "
                     "dominate y; it cannot check the inter-chunk decay")
            if L == SSM_SEQ and dt_ == torch.bfloat16:
                path_err = max(path_err, float(
                    (y.float() - yp.float()).abs().max()))
            del x, dt, a, bm, cm, y, hT, y2, h2, yp, hp, loc
            torch.cuda.empty_cache()
    # times at the path shape, bf16, as the serving path calls it (batch
    # 4), and at batch 1 (phase 11's), where 32 blocks hold 32 SMs
    times = {B: _ssd_times(dev, g, B) for B in (B_SERVE, 1)}
    t4 = times[B_SERVE]
    return {"name": "ssd_scan", "route": "cuda", "variant": "wgmma",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:77",
            "max_abs_err": path_err, "ms": t4["ms"],
            "plain_ms": t4["plain_ms"], "bound_ms": t4["bound_ms"],
            "bound_by": t4["bound_by"], "library_ms": None,
            "times_by_batch": times}


def draw_ssm(p: dict, seed: int) -> None:
    """Draw the SSM leaves from Mamba-2's own init (conv taps uniform in
    +-1/sqrt(4), A in [-16, -1], dt log-uniform in [1e-3, 1e-1] through
    the bias) and zero the skip D, in place.  At the repository's init
    (conv taps at 0.02) the scan moves the velocity by under 1 %, and the
    skip hides it further, so a check could not see it."""
    s = p["backbone"]["blocks"]["ssm"]
    gen = torch.Generator(device=s["conv_w"].device).manual_seed(seed)

    def draw(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device=gen.device)

    s["conv_w"].copy_(draw(s["conv_w"].shape, -0.5, 0.5))
    s["a_log"].copy_(torch.log(draw(s["a_log"].shape, 1.0, 16.0)))
    dt = torch.exp(draw(s["dt_bias"].shape, math.log(1e-3), math.log(1e-1)))
    s["dt_bias"].copy_(dt + torch.log(-torch.expm1(-dt)))
    s["d_skip"].zero_()


def _zero_scan(x, dt, a, bm, cm, *, chunk=128):
    B, L, H, P = x.shape
    return (torch.zeros(x.shape, dtype=x.dtype, device=x.device),
            torch.zeros((B, H, P, bm.shape[-1]), device=x.device))


# ----------------------------------------------------------------- phase 11
def check_ssm_velocity(dev) -> dict:
    """``FlowAdapter.velocity`` of mamba2-370m at full width, depth 2, on
    the path geometry, through the kernels and the plain versions; then
    with ``ops.ssd_scan`` stubbed to zeros, to show the scan moves it."""
    cfg = replace(configs.get(SSM_ARCH), n_layers=2)
    adapter = FlowAdapter(cfg, FlowRLConfig(latent_tokens=LAT_TOKENS,
                                            latent_dim=LAT_DIM), COND_DIM)
    gen = torch.Generator(device=dev).manual_seed(8)
    p = params_lib.init(adapter.spec(), gen, torch.bfloat16, dev)
    draw_ssm(p, seed=9)
    x = torch.randn(1, LAT_TOKENS, LAT_DIM, generator=gen, device=dev)
    cond = torch.randn(1, SSM_COND_LEN, COND_DIM, generator=gen, device=dev)
    t = torch.tensor([0.7], device=dev)
    with torch.no_grad():
        n0 = ssd_scan.launches
        w0 = ssd_scan.variant_launches["wgmma"]
        vk = adapter.velocity(p, x, t, cond)
        if ssd_scan.launches - n0 != cfg.n_layers:
            fail("velocity did not run the ssd_scan kernel once per block")
        if ssd_scan.variant_launches["wgmma"] - w0 != cfg.n_layers:
            fail("the bf16 velocity did not run the tensor-core scan")
        with plain_dispatch():
            vp = adapter.velocity(p, x, t, cond)
        real = ops.ssd_scan
        ops.ssd_scan = _zero_scan
        try:
            v0 = adapter.velocity(p, x, t, cond)
        finally:
            ops.ssd_scan = real
    torch.cuda.synchronize()
    err = float((vk - vp).abs().max())
    scale = float(vp.abs().max())
    moved = float((v0 - vk).abs().max())
    band = BF16_BAND * scale
    log(f"  velocity {SSM_ARCH} depth 2 (1, {SSM_SEQ} tokens) bf16: "
        f"max|kernel - plain| {err:.3e} of max|v| {scale:.3e} (band "
        f"{band:.3e}); the scan stubbed to zeros moves it by {moved:.3e}")
    if not (torch.isfinite(vk).all() and err <= band):
        fail("the mamba2 velocity through the kernels is off the bf16 band")
    if moved < 10 * band:
        fail("stubbing the scan hardly moves the velocity: the check "
             "cannot see the scan")
    return {"max_abs_err": err, "max_abs": scale, "band": band,
            "moved_by_zero_scan": moved}


# ----------------------------------------------------------------- phase 12
def _ssm_argv(dtype: str) -> list:
    return ["--arch", SSM_ARCH, "--sde", "flow_sde", "--device", "cuda",
            "--requests", str(B_SERVE), "--max-batch", str(B_SERVE),
            "--bucket", str(B_SERVE),
            "--set", f"flow.num_steps={NUM_STEPS}",
            "--set", f"flow.latent_tokens={LAT_TOKENS}",
            "--set", f"flow.latent_dim={LAT_DIM}",
            "--set", f"param_dtype={dtype}",
            "--set", "data.encoder=" + json.dumps(
                {"cond_dim": COND_DIM, "cond_len": SSM_COND_LEN})]


def ssm_path() -> dict:
    """``repro_torch.launch.serve.main`` serving 4 requests of mamba2-370m
    (48 layers, bf16, random weights from a seed) at 511 + 1 + 4096 tokens
    under flow_sde, 4 steps: launch counts, s per step, req/s, peak memory
    and a profile of one step."""
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = serve.main(_ssm_argv("bfloat16"))
    launches = counts()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    stats, lat = out["stats"], out["latents"]
    eng = out["engine"]
    batches = len(out["warmup"]) + sum(stats["dispatches"].values())
    serve_batches = sum(stats["dispatches"].values())
    want = {name: 0 for name in launches}
    want["sde_step"] = NUM_STEPS * batches
    want["ssd_scan"] = SSM_LAYERS * NUM_STEPS * batches
    log(f"  launches {launches} over {batches} batches (warmup + serve; "
        f"expected {want})")
    if eng.adapter.cfg.n_layers != SSM_LAYERS:
        fail(f"served {eng.adapter.cfg.n_layers} layers, not {SSM_LAYERS}")
    if tuple(lat.shape) != (B_SERVE, LAT_TOKENS, LAT_DIM) or not \
            torch.isfinite(lat).all():
        fail(f"ssm latents: shape {tuple(lat.shape)} or not finite")
    if launches != want:
        fail("the ssm serving path's kernel launches do not match the path")
    variants = dict(ssd_scan.variant_launches)
    log(f"  ssd_scan launches by variant: {variants}")
    if variants != {"wgmma": want["ssd_scan"], "fma": 0}:
        fail("not every ssd_scan launch of the bf16 serving path ran the "
             "tensor-core kernel")
    serve_s = out["serve_s"]
    res = {"launches": launches, "ssd_scan_variants": variants,
           "batches": batches,
           "req_per_s": B_SERVE / serve_s,
           "s_per_step": serve_s / (serve_batches * NUM_STEPS),
           "serve_s": serve_s, "warmup_s": out["warmup_s"],
           "peak_bytes": peak,
           "n_params": params_lib.n_params(eng.adapter.spec())}
    log(f"  ssm path: {res['req_per_s']:.4f} req/s, {res['s_per_step']:.4f}"
        f" s per denoising step (batch {B_SERVE}), max_memory_allocated "
        f"{peak / 2**30:.2f} GiB ({peak} bytes), {res['n_params']} params")
    res["profile"] = profile_step(eng, SSM_SEQ)
    return res


# the served trajectory against the plain versions, step by step, in f32.
# With the SSM leaves drawn the 48 layers amplify any rounding difference
# (``chunking_gaps`` measures it: two chunkings of the plain scan itself
# give velocities 1e-4 of max |v| apart in f32 and a quarter in bf16), and
# 4 denoising steps amplify it again.  So each step is replayed from the
# kernels' own state, in f32: 2e-3 of max |x| per step
SSM_REPLAY_BAND = 2e-3


def chunking_gaps(adapter, params, x, t, cond) -> dict:
    """max |difference| / max |v| of one velocity between the kernels and
    the plain versions, and between the plain scan at chunk 64 and at 128
    (the same function in another rounding), in f32 and in bf16."""
    out = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        p = params if dtype == torch.float32 else _cast(params, dtype)
        with torch.no_grad():
            vk = adapter.velocity(p, x, t, cond)
            with plain_dispatch():
                v128 = adapter.velocity(p, x, t, cond)
                ops._ssd = lambda x_, dt, a, bm, cm, chunk: \
                    ref.ssd_chunked_ref(x_, dt, a, bm, cm, 64)
                v64 = adapter.velocity(p, x, t, cond)
        scale = float(v128.abs().max())
        out[name] = {"kernel_vs_plain": float((vk - v128).abs().max()) / scale,
                     "chunk64_vs_chunk128":
                         float((v64 - v128).abs().max()) / scale}
        del p
    return out


def check_ssm_replay() -> dict:
    """Serve the same 4 requests of 48-layer mamba2-370m in f32 through
    ``serve.main``, draw the SSM leaves, serve them again through the
    engine; hold the served latents bitwise against ``rollout_keyed``
    through the kernels, and each of its steps against the same step
    through the plain versions from the same state and noise."""
    out = serve.main(_ssm_argv("float32"))
    eng, lat0 = out["engine"], out["latents"]
    draw_ssm(eng.params, seed=10)
    prompts = synthetic_prompts(B_SERVE)
    n0 = ssd_scan.launches
    lat = eng.serve(prompts, 0)          # the seed serve.main used
    if ssd_scan.launches - n0 != SSM_LAYERS * NUM_STEPS:
        fail("the f32 serve did not run the ssd_scan kernel per layer")
    cond = torch.from_numpy(eng.encode(prompts)).to(eng.device)
    seeds = request_seeds(0, B_SERVE)
    with torch.no_grad():
        traj = rollout_keyed(eng.adapter, eng.params, cond, seeds,
                             eng.scheduler, NUM_STEPS)
    if not torch.equal(traj.x0.cpu(), lat):
        fail("the engine's latents differ from rollout_keyed's")
    eps = torch.stack([request_draws(eng.adapter, sd, NUM_STEPS,
                                     eng.device)[1] for sd in seeds], dim=1)
    ts = eng.scheduler.timesteps(NUM_STEPS)
    scale = float(traj.xs.abs().max())
    errs = []
    with torch.no_grad(), plain_dispatch():
        for i in range(NUM_STEPS):
            t, t_next = float(ts[i]), float(ts[i + 1])
            tb = torch.full((B_SERVE,), t, device=eng.device)
            v = eng.adapter.velocity(eng.params, traj.xs[i], tb, cond)
            x_next, _ = eng.scheduler.step_with_eps(v, traj.xs[i], t,
                                                    t_next, eps[i])
            errs.append(float((x_next - traj.xs[i + 1]).abs().max()))
        free = rollout_keyed(eng.adapter, eng.params, cond, seeds,
                             eng.scheduler, NUM_STEPS).x0.cpu()
    free_err = float((free - lat).abs().max())
    moved = float((lat - lat0).abs().max())
    band = SSM_REPLAY_BAND * scale
    gaps = chunking_gaps(eng.adapter, eng.params, traj.xs[0][:1],
                         torch.full((1,), float(ts[0]), device=eng.device),
                         cond[:1])
    for name, g in gaps.items():
        log(f"  one velocity, 48 layers, SSM leaves drawn, {name}: kernels vs "
            f"plain {g['kernel_vs_plain']:.3e}, plain at chunk 64 vs 128 "
            f"{g['chunk64_vs_chunk128']:.3e} of max|v|")
    log(f"  {B_SERVE} requests in f32, SSM leaves drawn: each step through "
        f"the kernels vs the same step through the plain versions, max|diff|"
        f" {', '.join(f'{e:.3e}' for e in errs)} of max|x| {scale:.3e} "
        f"(band {band:.3e}); the whole plain replay ends {free_err:.3e} "
        f"away; the draw moved the latents by {moved:.3e}")
    if not torch.isfinite(lat).all() or max(errs) > band:
        fail("a step of the ssm served path disagrees with the plain "
             "versions")
    if moved <= 10 * band:
        fail("the drawn SSM leaves hardly moved the latents")
    del eng, out, traj
    return {"step_errs": errs, "max_abs": scale, "band": band,
            "free_running_err": free_err, "moved": moved,
            "velocity_gaps": gaps}

# ----------------------------------------------------------------- phase 14
# max |kernel - plain| / max |plain| of each gradient: f32 sums in another
# order; in bf16 dx, dbm and dcm are rounded once from f32 by both (a tie
# lands one bf16 ulp, 2^-8 of the value, apart), ddt and da stay f32
SSD_BWD_BAND = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
SSD_BWD_F32_BAND = 1e-4
SSD_GRADS = ("dx", "ddt", "da", "dbm", "dcm")


def _ssd_conv_slices(x, bm, cm):
    """x, bm and cm as column slices of one (B, L, H P + 2 N) buffer, as
    the model passes them (the conv output's token stride, 2304 at the
    path shape)."""
    B, L, H, P = x.shape
    buf = torch.cat([x.reshape(B, L, H * P), bm, cm], dim=-1)
    N = bm.shape[-1]
    return (buf[..., :H * P].unflatten(-1, (H, P)),
            buf[..., H * P:H * P + N], buf[..., H * P + N:])


def _ssd_bwd_times(dev, g, B) -> dict:
    """Device ms of the tensor-core backward and of the FMA passes on the
    same inputs (replayed graphs), of the plain version, and the bound, at
    the path shape with batch ``B`` (bf16, dhT absent as in training).
    Bound: each input and output once (x, dy, dx, bm, cm, dbm, dcm in
    bf16; dt, ddt, a, da in f32) over the memory rate, and the products'
    operations over the bf16 tensor-core rate: per chunk
    S = C B^T, dS B and dS^T C (3 Q Q N, shared by the heads); per head
    dy x^T and (S M)^T dy (2 Q Q P) and five Q P N products, h_prev,
    dh_prev, dh B^T, dy h_prev (dC's carried term) and dh^T x (dB's).  The
    kernel also forms h_prev C^T for ddt's carried term; that is
    sum_n C[q,n] (dy[q] h_prev)[n], O(Q N) more once dy h_prev is there, so
    the bound does not count it."""
    L, H, P, N, Q = SSM_SEQ, SSM_HEADS, SSM_HEAD_DIM, SSM_STATE, SSM_CHUNK
    x, dt, a, bm, cm = _ssd_inputs(g, dev, B, L, H, P, N, "mamba2",
                                   torch.bfloat16)
    x, bm, cm = _ssd_conv_slices(x, bm, cm)
    dy = torch.randn(x.shape, generator=g, device=dev).to(x.dtype)
    with fma_route():
        fma_ms = graph_ms(lambda: ssd_scan_bwd(x, dt, a, bm, cm, dy, None,
                                               chunk=Q), 3)
    ms = graph_ms(lambda: ssd_scan_bwd(x, dt, a, bm, cm, dy, None, chunk=Q),
                  3)
    call_ms = cuda_ms(lambda: ssd_scan_bwd(x, dt, a, bm, cm, dy, None,
                                           chunk=Q), 5)
    plain_ms = cuda_ms(lambda: ref.ssd_scan_bwd_ref(x, dt, a, bm, cm, dy,
                                                    None, Q), 2, 1)
    bound, by, nbytes, flops = _ssd_bwd_bound(B, L, H, P, N, Q)
    log(f"  ssd_scan_bwd path (B={B}, L={L}, H={H}, P={P}, N={N}, Q={Q}) "
        f"bf16: tensor-core kernels {ms:.4f} ms on the device ({call_ms:.4f}"
        f" ms a call with the host's launch), the f32 FMA passes "
        f"{fma_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
        f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
    del x, dt, a, bm, cm, dy
    torch.cuda.empty_cache()
    return {"ms": ms, "call_ms": call_ms, "fma_ms": fma_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}


def check_ssd_bwd(dev) -> dict:
    """The ssd_scan backward kernel against its plain closed form
    (``ref.ssd_scan_bwd_ref``) and torch.autograd through the plain
    chunked forward, on phase 10's cases and the path shape at batch 4 and
    1, x, bm and cm as column slices of one buffer as the model passes
    them, f32 and bf16, dhT zero (None) and drawn, bitwise on rerun; the
    slow-decay cases must make the gradient carried across chunks most of
    dx.  Then ``ops.ssd_scan`` with an input requiring grad runs
    ``SSDScanFn`` (one forward and one backward launch, both on the tensor
    cores); then times at the path shape.  Each case must run the variant
    its dtype and shape call for: bf16 at head dim 64, state 128, chunk 128
    (``tensor_core_bwd_route``) the tensor-core backward (held also against
    its own rounding written out, ``ref.ssd_tensor_core_bwd_ref``, as a
    diagnostic up to L = 1024), the rest the f32 FMA passes."""
    g = torch.Generator(device=dev).manual_seed(13)
    P_, N_, Q_ = SSM_HEAD_DIM, SSM_STATE, SSM_CHUNK
    cases = [  # B, L, H, P, N, chunk, kind
        (2, 128, 2, 32, 64, 32, "sweep"), (1, 256, 4, 64, 128, 128, "sweep"),
        (3, 64, 1, 16, 32, 64, "sweep"),
        (2, 384, 1, P_, N_, Q_, "sweep"), (2, 128, 4, P_, N_, Q_, "sweep"),
        (1, 21, 3, 8, 16, 32, "sweep"), (2, 96, 16, 32, 32, 32, "sweep"),
        (2, 1024, 8, P_, N_, Q_, "mamba2"), (2, 1024, 4, P_, N_, Q_, "slow"),
        (B_SERVE, SSM_SEQ, SSM_HEADS, P_, N_, Q_, "mamba2"),
        (1, SSM_SEQ, SSM_HEADS, P_, N_, Q_, "mamba2"),
        (B_SERVE, SSM_SEQ, SSM_HEADS, P_, N_, Q_, "slow"),
    ]
    path_err = 0.0
    worst, worst_tc = {}, {}
    for (B, L, H, P, N, Q, kind) in cases:
        for dt_ in (torch.float32, torch.bfloat16):
            x, dt, a, bm, cm = _ssd_inputs(g, dev, B, L, H, P, N, kind, dt_)
            x, bm, cm = _ssd_conv_slices(x, bm, cm)
            dy = torch.randn(x.shape, generator=g, device=dev).to(dt_)
            want_v = ("wgmma" if dt_ == torch.bfloat16
                      and (P, N, min(Q, L)) == (P_, N_, Q_) else "fma")
            if ssd_mod.tensor_core_bwd_route(x, bm, cm, dy, Q) != (
                    want_v == "wgmma"):
                fail(f"tensor_core_bwd_route disagrees with the shape rule at "
                     f"{(B, L, H, P, N, Q)} {dt_}")
            for dh in (None, torch.randn((B, H, P, N), generator=g,
                                         device=dev)):
                before = dict(ssd_scan_bwd.variant_launches)
                got = ssd_scan_bwd(x, dt, a, bm, cm, dy, dh, chunk=Q)
                ran = [k for k, n in ssd_scan_bwd.variant_launches.items()
                       if n != before[k]]
                if ran != [want_v]:
                    fail(f"ssd_scan_bwd at {(B, L, H, P, N, Q)} {dt_} ran "
                         f"{ran}, not {want_v}")
                again = ssd_scan_bwd(x, dt, a, bm, cm, dy, dh, chunk=Q)
                if not all(torch.equal(u, v) for u, v in zip(got, again)):
                    fail(f"ssd_scan_bwd not bitwise equal on rerun at "
                         f"{(B, L, H, P, N, Q)} {kind} {dt_}")
                want = ref.ssd_scan_bwd_ref(x, dt, a, bm, cm, dy, dh, Q)
                errs = [_rel(u, v) for u, v in zip(got, want)]
                leaves = [t.detach().clone().requires_grad_()
                          for t in (x, dt, a, bm, cm)]
                y, hT = ref.ssd_chunked_ref(*leaves, Q)
                outs, cots = [y], [dy]
                if dh is not None:
                    outs.append(hT)
                    cots.append(dh)
                auto = torch.autograd.grad(outs, leaves, cots)
                aerrs = [_rel(u, v) for u, v in zip(got, auto)]
                del leaves, y, hT, outs, cots, auto
                # how much of dx the gradient carried across chunks makes:
                # the plain backward with every chunk on its own
                q = min(Q, L)
                loc = ref.ssd_scan_bwd_ref(
                    *(t.reshape(B * (L // q), q, *t.shape[2:])
                      for t in (x, dt)), a,
                    *(t.reshape(B * (L // q), q, -1) for t in (bm, cm)),
                    dy.reshape(B * (L // q), q, H, P), None, q)[0]
                carried = _rel(loc.reshape(x.shape), want[0])
                # the tensor-core backward against its rounding written out
                emu = ""
                if want_v == "wgmma" and L <= 1024:
                    e = ref.ssd_tensor_core_bwd_ref(x, dt, a, bm, cm, dy, dh,
                                                    Q)
                    emu = "; vs its rounding written out " + "/".join(
                        f"{_rel(u, v):.1e}" for u, v in zip(got, e))
                    del e
                torch.cuda.synchronize()
                f32_out = (False, True, True, False, False)
                bands = [SSD_BWD_F32_BAND if f else SSD_BWD_BAND[dt_]
                         for f in f32_out]
                log(f"  ssd_scan_bwd B={B} L={L} H={H} P={P} N={N} Q={q} "
                    f"{kind} {dt_} dhT {'drawn' if dh is not None else 'None'}"
                    f" [{want_v}]: vs plain "
                    + "/".join(f"{e:.1e}" for e in errs)
                    + ", vs autograd " + "/".join(f"{e:.1e}" for e in aerrs)
                    + f" ({'/'.join(SSD_GRADS)}; bands "
                    + "/".join(str(b) for b in bands)
                    + f"); carried {carried:.3f} of max|dx|{emu}")
                for n, e, ae, band in zip(SSD_GRADS, errs, aerrs, bands):
                    worst[n] = max(worst.get(n, 0.0), e, ae)
                    if not (e <= band and ae <= band):
                        fail(f"ssd_scan_bwd {n} off at {(B, L, H, P, N, Q)} "
                             f"{kind} {dt_}")
                if kind == "slow" and L > Q and carried < 0.5:
                    fail("the slow-decay case does not make the carried "
                         "gradient most of dx")
                if want_v == "wgmma":
                    for n, e, ae in zip(SSD_GRADS, errs, aerrs):
                        worst_tc[n] = max(worst_tc.get(n, 0.0), e, ae)
                if L == SSM_SEQ and dt_ == torch.bfloat16:
                    path_err = max(path_err, max(
                        float((u.float() - v.float()).abs().max())
                        for u, v in zip(got, want)))
                del got, again, want, loc
            del x, dt, a, bm, cm, dy
            torch.cuda.empty_cache()
    # ops.ssd_scan with an input requiring grad: SSDScanFn, through the
    # tensor-core forward and the backward kernel
    x, dt, a, bm, cm = _ssd_inputs(g, dev, 1, 256, 4, P_, N_, "mamba2",
                                   torch.bfloat16)
    x.requires_grad_()
    reset_counts()
    y, _ = ops.ssd_scan(x, dt, a, bm, cm, chunk=Q_)
    y.float().sum().backward()
    seen = (counts(), dict(ssd_scan.variant_launches), type(y.grad_fn),
            dict(ssd_scan_bwd.variant_launches))
    log(f"  ops.ssd_scan with x requiring grad: {seen[2].__name__}, "
        f"launches {seen[0]}, forward variants {seen[1]}, backward "
        f"variants {seen[3]}")
    if seen[0]["ssd_scan"] != 1 or seen[0]["ssd_scan_bwd"] != 1 or \
            seen[1]["wgmma"] != 1 or seen[3]["wgmma"] != 1 or \
            "SSDScanFn" not in seen[2].__name__:
        fail("ops.ssd_scan with an input requiring grad did not run "
             "SSDScanFn through the kernels")
    del x, dt, a, bm, cm, y
    times = {B: _ssd_bwd_times(dev, g, B) for B in (B_SERVE, 1)}
    t4 = times[B_SERVE]
    log(f"  ssd_scan_bwd worst of max|kernel - plain or autograd| / "
        f"max|plain| over the tensor-core cases: {json.dumps(worst_tc)}")
    return {"name": "ssd_scan_bwd", "route": "cuda", "variant": "wgmma",
            "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd_wgmma.cu",
            "replaces": "none (JAX autodiff of src/repro/models/ssm.py:84, "
                        "ssd_chunked)",
            "max_abs_err": path_err, "max_rel_err": worst,
            "max_rel_err_wgmma": worst_tc, "ms": t4["ms"],
            "fma_ms": t4["fma_ms"], "plain_ms": t4["plain_ms"],
            "bound_ms": t4["bound_ms"], "bound_by": t4["bound_by"],
            "library_ms": None, "times_by_batch": times}


# ----------------------------------------------------------------- phase 15
def draw_attention(p: dict, d_model: int, seed: int) -> None:
    """Redraw wq and wk at std 1/sqrt(d_model), one layer at a time, in
    place.  The repository's init takes a 3-D projection's fan-in from its
    head axis: at smollm-360m's width q and k have std 8 and the attention
    logits std ~64, the softmax is nearly one-hot, and the 32-layer stack
    amplifies any rounding (on the CPU, bf16 rounding of the attention
    inputs alone moves the reduced velocity by a fifth of max |v| in either
    package), so no replay could tell a kernel fault from chaos; and its
    gradients grow ~5x a layer in either package, so that 32 layers
    overflow to an infinite gradient norm (tests/test_torch_dense.py).
    Drawn so, the logits are of order one."""
    attn = p["backbone"]["blocks"]["attn"]
    gen = torch.Generator(device=attn["wq"].device).manual_seed(seed)
    for key in ("wq", "wk"):
        for layer in attn[key]:
            layer.copy_(torch.randn(layer.shape, generator=gen,
                                    device=layer.device) / d_model ** 0.5)


def check_dense_velocity(dev, arch: str, draw_qk: bool,
                         cond_len: int = COND_LEN) -> dict:
    """``FlowAdapter.velocity`` of ``arch`` at full width, depth 2, over
    ``cond_len`` + 1 + 4096 tokens (512 + 1 + 4096 by default), through
    the kernels (one attention launch per block) and through the plain
    versions, at the bf16 band.  With ``draw_qk`` the gap at the
    repository's init is printed (no band: the logits are near one-hot
    there, ``draw_attention``) and the band holds with wq/wk drawn."""
    cfg = replace(configs.get(arch), n_layers=2)
    adapter = FlowAdapter(cfg, FlowRLConfig(latent_tokens=LAT_TOKENS,
                                            latent_dim=LAT_DIM), COND_DIM)
    gen = torch.Generator(device=dev).manual_seed(12)
    p = params_lib.init(adapter.spec(), gen, torch.bfloat16, dev)
    x = torch.randn(1, LAT_TOKENS, LAT_DIM, generator=gen, device=dev)
    cond = torch.randn(1, cond_len, COND_DIM, generator=gen, device=dev)
    t = torch.tensor([0.7], device=dev)
    hd = cfg.resolved_head_dim
    seq = cond_len + 1 + LAT_TOKENS
    shape = (f"{arch} depth 2 (1, {seq} tokens, {cfg.n_heads} q / "
             f"{cfg.n_kv_heads} kv heads of {hd}, qk_norm {cfg.qk_norm})")
    res = {"heads": [cfg.n_heads, cfg.n_kv_heads, hd]}
    if draw_qk:
        err0, scale0 = _velocity_gap(adapter, p, x, t, cond)
        log(f"  velocity {shape} bf16 at the repository's init: max|kernel -"
            f" plain| {err0:.3e} of max|v| {scale0:.3e} (no band)")
        res["repository_init"] = {"max_abs_err": err0, "max_abs": scale0}
        draw_attention(p, cfg.d_model, seed=13)
    err, scale = _velocity_gap(adapter, p, x, t, cond)
    log(f"  velocity {shape}{', wq/wk drawn' if draw_qk else ''} bf16: "
        f"max|kernel - plain| {err:.3e} of max|v| {scale:.3e} (band "
        f"{BF16_BAND * scale:.3e})")
    if err > BF16_BAND * scale:
        fail(f"the {arch} velocity through the kernels is off the bf16 band")
    del p
    res.update(max_abs_err=err, max_abs=scale, band=BF16_BAND * scale)
    return res


def check_dense_velocities(dev) -> dict:
    """Phase 15: smollm-360m (D 64, a GQA group of 3) and qwen3-32b
    (qk_norm, D 128, 64 q / 8 kv heads); wq/wk drawn where no qk_norm
    keeps the logits small."""
    out = {}
    for arch in (DENSE_ARCH, "qwen3-32b"):
        out[arch] = check_dense_velocity(
            dev, arch, draw_qk=not configs.get(arch).qk_norm)
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------- phase 16
def _dense_argv() -> list:
    return ["--arch", DENSE_ARCH, "--sde", "flow_sde", "--device", "cuda",
            "--requests", str(B_SERVE), "--max-batch", str(B_SERVE),
            "--bucket", str(B_SERVE),
            "--set", f"flow.num_steps={NUM_STEPS}",
            "--set", f"flow.latent_tokens={LAT_TOKENS}",
            "--set", f"flow.latent_dim={LAT_DIM}",
            "--set", "param_dtype=bfloat16",
            "--set", "data.encoder=" + json.dumps(
                {"cond_dim": COND_DIM, "cond_len": COND_LEN})]


def dense_serve_path() -> dict:
    """``repro_torch.launch.serve.main`` serving 4 requests of smollm-360m
    (32 layers, bf16, random weights from a seed) over 512 + 1 + 4096
    tokens under flow_sde, 4 steps: launch counts, s per step, req/s, peak
    memory and a profile of one step; then, with wq/wk drawn, the same
    requests served again through the engine and held against
    ``rollout_keyed`` through the plain versions."""
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = serve.main(_dense_argv())
    launches = counts()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    stats, lat = out["stats"], out["latents"]
    eng = out["engine"]
    batches = len(out["warmup"]) + sum(stats["dispatches"].values())
    serve_batches = sum(stats["dispatches"].values())
    want = {name: 0 for name in launches}
    want["sde_step"] = NUM_STEPS * batches
    want["flash_attention"] = DENSE_LAYERS * NUM_STEPS * batches
    log(f"  launches {launches} over {batches} batches (warmup + serve; "
        f"expected {want})")
    if eng.adapter.cfg.n_layers != DENSE_LAYERS:
        fail(f"served {eng.adapter.cfg.n_layers} layers, not {DENSE_LAYERS}")
    if tuple(lat.shape) != (B_SERVE, LAT_TOKENS, LAT_DIM) or not \
            torch.isfinite(lat).all():
        fail(f"dense latents: shape {tuple(lat.shape)} or not finite")
    if launches != want:
        fail("the dense serving path's kernel launches do not match the path")
    serve_s = out["serve_s"]
    res = {"launches": launches, "batches": batches,
           "req_per_s": B_SERVE / serve_s,
           "s_per_step": serve_s / (serve_batches * NUM_STEPS),
           "serve_s": serve_s, "warmup_s": out["warmup_s"],
           "peak_bytes": peak,
           "n_params": params_lib.n_params(eng.adapter.spec())}
    log(f"  dense path: {res['req_per_s']:.4f} req/s, "
        f"{res['s_per_step']:.4f} s per denoising step (batch {B_SERVE}), "
        f"max_memory_allocated {peak / 2**30:.2f} GiB ({peak} bytes), "
        f"{res['n_params']} params")
    res["profile"] = profile_step(eng, DENSE_SEQ)
    # the replay: served through the engine and the kernels with wq/wk
    # drawn, against rollout_keyed through the plain versions
    draw_attention(eng.params, eng.adapter.cfg.d_model, seed=14)
    prompts = synthetic_prompts(B_SERVE)
    lat2 = eng.serve(prompts, 0)         # the seed serve.main used
    cond = torch.from_numpy(eng.encode(prompts)).to(eng.device)
    with torch.no_grad(), plain_dispatch():
        ref_lat = rollout_keyed(eng.adapter, eng.params, cond,
                                request_seeds(0, B_SERVE), eng.scheduler,
                                NUM_STEPS).x0.cpu()
    err = float((lat2 - ref_lat).abs().max())
    scale = float(ref_lat.abs().max())
    moved = float((lat2 - lat).abs().max())
    log(f"  {B_SERVE} requests, wq/wk drawn, served through the kernels vs "
        f"rollout_keyed through the plain versions: max|diff| {err:.3e} of "
        f"max|x| {scale:.3e} (band {BF16_BAND * scale:.3e}); the draw moved "
        f"the latents by {moved:.3e}")
    if not torch.isfinite(lat2).all() or err > BF16_BAND * scale:
        fail("the dense served latents disagree with the plain replay")
    if moved <= 10 * err:
        fail("the drawn attention hardly moved the latents; the replay "
             "cannot see the blocks")
    res["replay"] = {"max_abs_err": err, "max_abs": scale,
                     "band": BF16_BAND * scale, "moved": moved}
    del eng, out
    return res


# ----------------------------------------------------------------- phase 17
def _train_want(name: str, steps: int, layers: int, fwd: str, bwd: str,
                remat: str = "none", microbatch: int = 1,
                rollout_chunks: int = 1) -> dict:
    """Kernel launches of ``steps`` train steps of trainer ``name`` at
    T = 4 over ``layers`` blocks that each run kernel ``fwd`` forward and
    ``bwd`` backward (or, as dicts, each kernel's launches a velocity and
    a loss backward: the hybrid's scan and shared attention): the
    rollout's forward per layer and step and its
    sde_step per SDE step, once per chunk of an attached engine's rollout
    (``rollout_chunks``); the loss's forward and backward per layer at
    each SDE step (GRPO family) or once (NFT/AWM), the forward twice under
    ``remat="block"`` (once more in the backward), and the grpo_loss
    kernels only where the reference's kernel condition holds; each loss
    pass once per chunk under ``dist.microbatch``."""
    sde = {"mix_grpo": 2}.get(name, NUM_STEPS)   # MixGRPO: window 2
    passes = (sde if name in GRPO_FAMILY else 1) * microbatch
    want = {fn.__name__: 0 for fn in COUNTED}
    fwd = fwd if isinstance(fwd, dict) else {fwd: layers}
    bwd = bwd if isinstance(bwd, dict) else {bwd: layers}
    for k, n in fwd.items():
        want[k] = n * (NUM_STEPS * rollout_chunks
                       + (2 if remat == "block" else 1) * passes)
    for k, n in bwd.items():
        want[k] = n * passes
    if name in GRPO_FAMILY:
        want["sde_step"] = sde * rollout_chunks
        if name != "grpo_guard":
            want["grpo_loss"] = want["grpo_loss_bwd"] = sde * microbatch
    return {k: v * steps for k, v in want.items()}


def _train_argv(tmp: str, arch: str, layers: int, cond_len: int, name: str,
                n: int, tag: str, extra=()) -> list:
    return ["--arch", arch, "--sde", "flow_sde", "--device", "cuda",
            "--trainer", name, "--steps", str(n),
            "--set", "arch_overrides=" + json.dumps({"n_layers": layers}),
            "--set", "param_dtype=bfloat16",
            "--set", f"flow.num_steps={NUM_STEPS}",
            "--set", f"flow.group_size={GROUP}",
            "--set", f"flow.latent_tokens={LAT_TOKENS}",
            "--set", f"flow.latent_dim={LAT_DIM}",
            "--set", "flow.advantage_agg=gdpo",
            "--set", "flow.rewards=" + json.dumps(TRAIN_REWARDS),
            "--set", f"flow.cache_dir={tmp}/cache_{arch}",
            "--set", "data.encoder=" + json.dumps(
                {"cond_dim": COND_DIM, "cond_len": cond_len}),
            "--set", f"data.batch_prompts={PROMPTS}",
            "--set", f"data.n_prompts={PROMPTS * n}",
            "--set", "loop.save_every=0", "--set", "loop.log_every=1",
            "--set", f"loop.ckpt_dir={tmp}/ckpt_{arch}_{name}_{tag}",
            *extra]


def train_one(tmp: str, arch: str, layers: int, cond_len: int, kernels: tuple,
              watch, name: str, n: int, *, extra=(), tag: str = "",
              remat: str = "none", captured: bool = False,
              profile_what: str = "", mesh=None, microbatch: int = 1,
              engine_batch: int = 0, routes=None) -> dict:
    """``repro_torch.launch.train.main`` on the card: trainer ``name`` for
    ``n`` steps at ``arch``'s full width and ``layers`` layers, bf16,
    ``cond_len`` condition tokens, one time token and phase 8's latents,
    T = 4, 2 prompts x group 2, phase 8's rewards under gdpo, the
    ``--set`` switches ``extra``, under ``watch`` (a ``_TrainWatch``).
    Launch counts that match the path (``kernels``: the block's forward
    and backward kernel; every ``ssd_scan`` on the tensor-core kernel;
    ``captured``: the first step ran eagerly and was captured once, and
    the counters count each replay's kernels, ``kernels.counts``), finite
    metrics, every layer's gradient of the watch's ``grad_keys`` at the
    first update finite and nonzero, params that move, s per step, peak
    memory, and with ``profile_what`` a profile of one more step.
    ``mesh`` is injected into the trainer; ``microbatch`` is the
    ``dist.microbatch`` that ``extra`` sets.  With ``engine_batch`` the
    run goes through the Experiment API instead, with a serving engine of
    that ``max_batch`` attached: ``Experiment.build_trainer()``,
    ``trainer.attach_engine(ServingEngine.for_trainer(trainer,
    max_batch=engine_batch))``, ``Experiment.train()``; its rollouts then
    run in chunks of ``engine_batch`` rows.  ``routes`` (kernel -> variant)
    replaces the default variant check (every ``ssd_scan`` launch and its
    backward's on the tensor cores) with one for each kernel it names.
    Returns the row and the trainer."""
    argv = _train_argv(tmp, arch, layers, cond_len, name, n, tag, extra)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    engine, chunks = None, 1
    if engine_batch:
        exp = Experiment.from_args(Experiment.cli_parser().parse_args(argv))
        engine = ServingEngine.for_trainer(exp.build_trainer(),
                                           max_batch=engine_batch,
                                           cond_len=exp.cond_len)
        exp.build_trainer().attach_engine(engine)
        chunks = -(-PROMPTS * GROUP // engine_batch)
        res = exp.train([watch])
        res.update(experiment=exp, memory_stats=None)
    else:
        res = train.main(argv, callbacks=[watch], mesh=mesh)
    launches = counts()
    pairs = pair_counts()
    variants = dict(ssd_scan.variant_launches)
    bwd_variants = dict(ssd_scan_bwd.variant_launches)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    peak_reserved = torch.cuda.max_memory_reserved()
    hist = res["history"]
    trainer = res["experiment"].build_trainer()
    want = _train_want(name, n, layers, *kernels, remat=remat,
                       microbatch=microbatch, rollout_chunks=chunks)
    label = f"{name}{' ' + tag if tag else ''}"
    log(f"  {label}: launches {launches} over {n} train steps (expected "
        f"{want}); ssd_scan variants {variants}, ssd_scan_bwd variants "
        f"{bwd_variants}")
    if trainer.adapter.cfg.n_layers != layers:
        fail(f"{label} trained {trainer.adapter.cfg.n_layers} layers")
    routes = routes or {"ssd_scan": "wgmma", "ssd_scan_bwd": "wgmma"}
    ran = all_variants()
    if launches != want or any(ran[k] != routed(want[k], v)
                               for k, v in routes.items()):
        fail(f"{label}: the {arch} train path's kernel launches do not "
             f"match the path (variants {ran}, routes {routes})")
    if len(hist) != n:
        fail(f"{label}: {len(hist)} train steps ran, expected {n}")
    for r in hist:
        vals = [v for k, v in r.items()
                if isinstance(v, float) and k != "steps_per_s"]
        if not all(math.isfinite(v) for v in vals):
            fail(f"{label} step {r['step']}: non-finite metrics {r}")
    grads = watch.first_grads
    layer_min = {k: float(g.min()) for k, g in grads.items()}
    if not (all(torch.isfinite(g).all() for g in grads.values())
            and all(m > 0 for m in layer_min.values())):
        fail(f"{label}: a layer's gradient of {list(grads)} at the first "
             f"update is zero or not finite (smallest per-layer max "
             f"|grad| {layer_min})")
    moved = watch.moved(trainer)
    if int(trainer.state.opt.step) != n or not all(moved.values()):
        fail(f"{label}: the params did not move: step "
             f"{int(trainer.state.opt.step)}, max |change| {moved}")
    for r in hist:
        grpo = (f", clip_frac {r['clip_frac']:.3f}, max|logp_new - "
                f"logp_old| {r['logp_gap']:.4e}" if name in GRPO_FAMILY
                else "".join(f", {k} {r[k]:.4e}" for k in
                             ("r_mean", "vel_err", "adv_clip_frac")
                             if k in r))
        log(f"  {label} step {r['step']}: {r['dt']:.4f} s, loss "
            f"{r['loss']:+.4e}, grad_norm {r['grad_norm']:.4e}, reward "
            f"{r['reward']:+.4e}{grpo}")
    sps = hist[-1]["steps_per_s"]
    log(f"  {label}: max_memory_allocated {peak / 2**30:.2f} GiB "
        f"({peak} bytes; reserved {peak_reserved}); {sps:.4f} steps/s from "
        f"the second dispatch; "
        f"first update's smallest per-layer max |grad| {layer_min}; params "
        f"moved by up to {moved}")
    row = {"launches": launches, "pair_launches": pairs,
           "s_per_step": [r["dt"] for r in hist],
           "steps_per_s": sps, "peak_bytes": peak,
           "peak_reserved_bytes": peak_reserved,
           "memory_stats": res["memory_stats"],
           "loss": [r["loss"] for r in hist],
           "grad_norm": [r["grad_norm"] for r in hist],
           "reward": [r["reward"] for r in hist],
           "first_grad_layer_min": layer_min}
    if name in GRPO_FAMILY:
        row["clip_frac"] = [r["clip_frac"] for r in hist]
        row["logp_gap"] = [r["logp_gap"] for r in hist]
    if engine is not None:
        row["engine"] = {k: engine.stats[k] for k in
                         ("dispatches", "padded_lanes", "buckets")}
        log(f"  {label}: engine {row['engine']}")
    if captured:
        row["fused"] = trainer._fused.report()
        log(f"  {label}: fused step {row['fused']}")
        if (row["fused"]["captures"], row["fused"]["replays"]) != (1, n - 1):
            fail(f"{label}: expected 1 capture and {n - 1} replays")
    if profile_what:
        cond = torch.randn(PROMPTS, cond_len, COND_DIM, device=trainer.device)
        it = [n]

        def one_step():
            m = trainer.step(cond, 0, it=it[0])
            it[0] += 1
            return float(m["loss"])

        row["profile"] = profile(one_step, profile_what)
    return row, trainer


def train_trainers(tmp: str, arch: str, layers: int, cond_len: int,
                   kernels: tuple, make_watch) -> dict:
    """``train_one`` for flow_grpo (2 steps and a traced third), then
    mix_grpo, grpo_guard, nft and awm (1 step each), each under a fresh
    ``make_watch()``."""
    out = {}
    for name in TRAINERS:
        n = TRAIN_STEPS if name == "flow_grpo" else 1
        what = (f"one {arch} train step, {PROMPTS} x {GROUP} samples, "
                f"{layers} layers, {NUM_STEPS} timesteps"
                if name == "flow_grpo" else "")
        out[name], trainer = train_one(tmp, arch, layers, cond_len, kernels,
                                       make_watch(), name, n,
                                       profile_what=what)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    return out


def dense_train_path(tmp: str) -> dict:
    """``train_trainers`` at smollm-360m's full width and all 32 layers,
    phase 8's geometry, with wq/wk drawn at train start
    (``draw_attention``: at the repository's init the gradients grow ~5x a
    layer and the gradient norm overflows); the first update's wq/wk
    gradients are held."""
    return train_trainers(
        tmp, DENSE_ARCH, DENSE_LAYERS, COND_LEN,
        ("flash_attention", "flash_attention_bwd"),
        lambda: _TrainWatch("attn", ("wq", "wk", "wv"), ("wq", "wk"),
                            lambda p, cfg: draw_attention(p, cfg.d_model,
                                                          seed=15)))


# ----------------------------------------------------------------- phase 18
# the leaves whose gradients phase 18 holds: in_proj and conv_w feed the
# scan's x, B, C and dt; a_log reaches the output only through the scan, so
# a zero there would mean the scan's gradient was lost
SSM_GRAD_KEYS = ("in_proj", "conv_w", "a_log", "dt_bias")


# ----------------------------------------------------------------- phase 19
SSM_TRAIN_LAYERS = 48


def ssm_train_path(tmp: str) -> dict:
    """``train_trainers`` at mamba2-370m's full width and all 48 layers,
    the serving cell's geometry (511 + 1 + 4096 = 36 x 128 tokens), with
    the SSM leaves drawn at train start (``draw_ssm``: at the repository's
    init the carried state reaches only the first tokens of a chunk, so a
    wrong inter-chunk gradient would hardly show).  Every layer's a_log
    and dt_bias gradient at the first update is held (a_log reaches the
    output only through the scan).  The leaves watched for movement are
    ones whose AdamW steps (~lr) exceed their bf16 spacing: dt_bias
    (|dt_bias| 2-7, a spacing of 2^-6 to 2^-5) does not move in bf16 at lr
    1e-4."""
    return train_trainers(
        tmp, SSM_ARCH, SSM_TRAIN_LAYERS, SSM_COND_LEN,
        ("ssd_scan", "ssd_scan_bwd"),
        lambda: _TrainWatch("ssm", ("conv_w", "conv_b", "a_log"),
                            ("a_log", "dt_bias"),
                            lambda p, cfg: draw_ssm(p, seed=19)))


# ----------------------------------------------------------------- phase 20
SSM_KERNELS = ("ssd_scan", "ssd_scan_bwd")
BLOCK = ("--set", "perf.remat=block")
# the reference's fuse_step / remat="block" bands (tests/test_perf.py):
# loss rtol 1e-5 / atol 1e-6; params rtol 1e-5 / atol 1e-6 (fused); the
# block params are held to check_update's per-leaf band (``_param_gap``),
# much tighter at lr 1e-4 than the reference's bf16 atol 2e-2
REF_RTOL, REF_ATOL = 1e-5, 1e-6


def _ssm_watch():
    return _TrainWatch("ssm", ("conv_w", "conv_b", "a_log"),
                       ("a_log", "dt_bias"),
                       lambda p, cfg: draw_ssm(p, seed=19))


def ssm_block_path(tmp: str, none_row=None) -> dict:
    """mamba2-370m at 48 layers through ``launch.train`` under
    ``perf.remat=block`` (with ``perf.log_memory``): flow_grpo for 2 steps
    and a traced third, every scan forward twice per layer and SDE step of
    the loss.  Then 1 step under ``scan`` + ``remat_offload`` on phase
    19's prompts, against phase 19's first flow_grpo step (``none_row``;
    run here for 1 step when the phase runs alone): the same loss, grad
    norm and reward, bitwise (on the port both are the program of
    ``none``), and the peaks beside each other."""
    out = {}
    out["block"], trainer = train_one(
        tmp, SSM_ARCH, SSM_TRAIN_LAYERS, SSM_COND_LEN, SSM_KERNELS,
        _ssm_watch(), "flow_grpo", TRAIN_STEPS,
        extra=BLOCK + ("--set", "perf.log_memory=true"), tag="block",
        remat="block",
        profile_what=f"one {SSM_ARCH} train step under remat=block, "
                     f"{SSM_TRAIN_LAYERS} layers")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    # phase 19's dataset: the prompt order depends on its size
    prompts = ("--set", f"data.n_prompts={PROMPTS * TRAIN_STEPS}")
    modes = {"none": prompts,
             "scan_offload": prompts + ("--set", "perf.remat=scan", "--set",
                                        "perf.remat_offload=true")}
    if none_row is not None:
        out["none"] = none_row
        del modes["none"]
    for mode, extra in modes.items():
        out[mode], trainer = train_one(
            tmp, SSM_ARCH, SSM_TRAIN_LAYERS, SSM_COND_LEN, SSM_KERNELS,
            _ssm_watch(), "flow_grpo", 1, extra=extra, tag=mode)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    a, b = out["none"], out["scan_offload"]
    same = all(a[k][0] == b[k][0] for k in ("loss", "grad_norm", "reward"))
    log(f"  none{' (phase 19)' if none_row is not None else ''} / scan + "
        f"remat_offload, first step: loss {a['loss'][0]!r} / "
        f"{b['loss'][0]!r}, grad_norm {a['grad_norm'][0]!r} / "
        f"{b['grad_norm'][0]!r}, reward {a['reward'][0]!r} / "
        f"{b['reward'][0]!r}; bitwise {same}; peak {a['peak_bytes']} / "
        f"{b['peak_bytes']} bytes")
    if not same:
        fail("remat=scan with remat_offload changed the step")
    out["scan_offload"]["bitwise_none"] = same
    if none_row is not None:
        del out["none"]
    return out


def check_block_update(dev, arch: str) -> dict:
    """One flow_grpo step of ``arch`` at full width, depth 2 (mamba2-370m
    with its SSM leaves drawn, flux_dit with its modulation drawn), under
    remat="none" and "block" from one state on one set of injected draws:
    block runs each forward kernel once more per layer and SDE step (the
    recompute), and the step is held to the reference's band of none:
    loss and grad norm within rtol 1e-5 (loss atol 1e-6), each param leaf
    within 2 lr + one bf16 ulp of its max |p| (``_param_gap``), and at
    most PARAM_DIFF_SHARE of the moved weights differing.  Says whether
    the two are bitwise equal."""
    ssm = arch == SSM_ARCH
    kernel = "ssd_scan" if ssm else "flash_attention"
    cfg = replace(configs.get(arch), n_layers=UPDATE_LAYERS)
    flow = FlowRLConfig(num_steps=NUM_STEPS, group_size=2,
                        clip_range=UPDATE_CLIP, latent_tokens=LAT_TOKENS,
                        latent_dim=LAT_DIM, advantage_agg="gdpo",
                        rewards=(RewardSpec("pickscore", 1.0, args={
                            "latent_dim": LAT_DIM, "cond_dim": COND_DIM}),
                                 RewardSpec("latent_norm", 0.1)))
    opt = OptimConfig(lr=1e-4, warmup_steps=1, total_steps=1000)
    gen = torch.Generator(device=dev).manual_seed(20)
    cond = torch.randn(1, SSM_COND_LEN if ssm else COND_LEN, COND_DIM,
                       generator=gen, device=dev)
    draws = {"x_init": torch.randn(2, LAT_TOKENS, LAT_DIM, generator=gen,
                                   device=dev),
             "eps": torch.randn(NUM_STEPS, 2, LAT_TOKENS, LAT_DIM,
                                generator=gen, device=dev)}
    runs, params, start = {}, None, None
    for mode in ("none", "block"):
        tr = registry.build("trainer", "flow_grpo", cfg, flow, opt, seed=0,
                            cond_dim=COND_DIM, device=dev, params=params,
                            perf=PerfConfig(remat=mode))
        if params is None:
            if ssm:
                draw_ssm(tr.state.params, seed=21)
            else:
                draw_modulation(tr.state.params, cfg.d_model, seed=21)
            params = _clone(tr.state.params)
            start = _clone(params)
        reset_counts()
        m = tr.step(cond, 0, it=0, **draws)
        runs[mode] = {"metrics": {k: float(v) for k, v in m.items()},
                      "launches": counts(), "params": tr.state.params}
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    a, b = runs["none"], runs["block"]
    want = {"none": UPDATE_LAYERS * 2 * NUM_STEPS,    # rollout, loss
            "block": UPDATE_LAYERS * 3 * NUM_STEPS}   # and the recompute
    ran = {m: runs[m]["launches"][kernel] for m in want}
    if ran != want:
        fail(f"{arch}: {kernel} ran {ran} forwards under none / block, "
             f"expected {want}")
    gap = _param_gap(b["params"], a["params"], start, opt.lr)
    del start
    share = gap["params_differing"] / max(gap["params_moved"], 1)
    bitwise = a["metrics"] == b["metrics"] and gap["param_max_diff"] == 0.0
    la, lb = a["metrics"]["loss"], b["metrics"]["loss"]
    ga, gb = a["metrics"]["grad_norm"], b["metrics"]["grad_norm"]
    log(f"  one flow_grpo step, {arch} depth {UPDATE_LAYERS}, none / block: "
        f"loss {la!r} / {lb!r}, grad_norm {ga!r} / {gb!r}; params max|diff| "
        f"{gap['param_max_diff']:.3e}, nearest its leaf's band "
        f"{gap['param_leaf']} at {gap['param_band_share']:.3f} of "
        f"{gap['param_band']:.3e}; {gap['params_differing']} of the "
        f"{gap['params_moved']} weights the step moved differ; bitwise "
        f"{bitwise}; {kernel} forwards {ran}")
    if (abs(lb - la) > REF_ATOL + REF_RTOL * abs(la)
            or abs(gb - ga) > REF_RTOL * abs(ga)):
        fail(f"{arch}: remat=block's loss or grad norm is off the "
             "reference's band of remat=none")
    if (gap["param_band_share"] > 1 or gap["params_moved"] == 0
            or share > PARAM_DIFF_SHARE):
        fail(f"{arch}: remat=block's params after AdamW are off the band of "
             f"remat=none ({gap})")
    return {"loss": [la, lb], "grad_norm": [ga, gb], "bitwise": bitwise,
            "forward_launches": ran, **gap}


# ----------------------------------------------------------------- phase 21
FUSED_STEPS = 4
FUSED = ("--set", "perf.fuse_step=true", "--set", "perf.remat=block",
         "--set", "perf.offload_rewards=true",
         "--set", "perf.policy_dtype=bfloat16", "--set", "loop.pipeline=2",
         "--set", "perf.log_memory=true")
# f32 activations through two layers on the kernels' f32 variants against
# the plain versions: f32 sums in another order
F32_VEL_BAND = 1e-3


def fused_path(tmp: str) -> dict:
    """mamba2-370m at 48 layers through ``launch.train`` with the fused
    step (captured once, then replayed), block remat, the reward towers
    offloaded to host memory, an explicit bf16 policy and a pipeline of 2,
    for 4 steps, and a profile of one more replay.  The launch counts are
    those of the kernels that ran: the eager first step and each replay.
    The towers' bytes are computed from their shapes; what is checked is
    that their store is in pinned host memory."""
    row, trainer = train_one(
        tmp, SSM_ARCH, SSM_TRAIN_LAYERS, SSM_COND_LEN, SSM_KERNELS,
        _ssm_watch(), "flow_grpo", FUSED_STEPS, extra=FUSED, tag="fused",
        remat="block", captured=True,
        profile_what=f"one replayed fused {SSM_ARCH} train step, "
                     f"{SSM_TRAIN_LAYERS} layers")
    from repro_torch.perf import reward_tower_report
    row["reward_towers"] = reward_tower_report(trainer)
    store = [t for _, t in params_lib.leaves(trainer.loader.param_store())
             if t is not None]
    pinned = bool(store) and all(t.device.type == "cpu" and t.is_pinned()
                                 for t in store)
    log(f"  fused: reward towers {row['reward_towers']} (bytes from their "
        f"shapes); their {len(store)} leaves in pinned host memory: "
        f"{pinned}")
    if not pinned:
        fail("offload_rewards left a reward tower leaf off pinned host "
             "memory")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return row


def check_fused_update(dev) -> dict:
    """At full width, depth 2, SSM leaves drawn, block remat, towers
    offloaded, bf16 policy: the fused step (its step 0 eager and
    captured, step 1 replayed) against the eager step from one state on
    one set of injected draws, to the reference's fuse_step band (params
    rtol 1e-5 / atol 1e-6, loss rtol 1e-5 / atol 1e-5), and whether
    bitwise; then one eager step under set_sync_debug_mode("error")."""
    cfg = replace(configs.get(SSM_ARCH), n_layers=UPDATE_LAYERS)
    flow = FlowRLConfig(num_steps=NUM_STEPS, group_size=2,
                        clip_range=UPDATE_CLIP, latent_tokens=LAT_TOKENS,
                        latent_dim=LAT_DIM, advantage_agg="gdpo",
                        rewards=(
                            RewardSpec("text_render", 1.0, args={
                                "latent_dim": LAT_DIM,
                                "latent_tokens": LAT_TOKENS,
                                "cond_dim": COND_DIM}),
                            RewardSpec("pickscore", 0.25, args={
                                "latent_dim": LAT_DIM, "cond_dim": COND_DIM}),
                            RewardSpec("latent_norm", 0.1)))
    opt = OptimConfig(lr=1e-4, warmup_steps=1, total_steps=1000)
    perf = dict(remat="block", offload_rewards=True, policy_dtype="bfloat16")
    gen = torch.Generator(device=dev).manual_seed(21)
    cond = torch.randn(1, SSM_COND_LEN, COND_DIM, generator=gen, device=dev)
    draws = [{"x_init": torch.randn(2, LAT_TOKENS, LAT_DIM, generator=gen,
                                    device=dev),
              "eps": torch.randn(NUM_STEPS, 2, LAT_TOKENS, LAT_DIM,
                                 generator=gen, device=dev)}
             for _ in range(2)]
    eager = registry.build("trainer", "flow_grpo", cfg, flow, opt, seed=0,
                           cond_dim=COND_DIM, device=dev,
                           perf=PerfConfig(**perf))
    draw_ssm(eager.state.params, seed=22)
    fused = registry.build("trainer", "flow_grpo", cfg, flow, opt, seed=0,
                           cond_dim=COND_DIM, device=dev,
                           params=_clone(eager.state.params),
                           perf=PerfConfig(fuse_step=True, **perf))
    me, mf, ran = [], [], []
    for it in range(2):
        reset_counts()
        me.append({k: float(v) for k, v in eager.step(
            cond, 0, it=it, **draws[it]).items()})
        ran_eager = counts()
        reset_counts()
        mf.append({k: float(v) for k, v in fused.step(
            cond, 0, it=it, **draws[it]).items()})
        ran.append((ran_eager, counts()))
    rep = fused._fused.report()
    if (rep["captures"], rep["replays"]) != (1, 1):
        fail(f"the fused step did not capture once and replay once: {rep}")
    # the counters count what ran: the eager step and its capture (taken
    # back out) at step 0, the replay at step 1, each the eager step's
    log(f"  launches per step, eager / fused: {ran}")
    if not all(e == f and e["ssd_scan"] > 0 for e, f in ran):
        fail("the fused step's launch counts are not the eager step's")
    p_err, bitwise = 0.0, me == mf
    for (_, a), (_, b) in zip(params_lib.leaves(eager.state.params),
                              params_lib.leaves(fused.state.params)):
        d = (a.float() - b.float()).abs()
        p_err = max(p_err, float((d - REF_RTOL * b.float().abs()).max()))
        bitwise = bitwise and bool((d == 0).all())
    le, lf = me[1]["loss"], mf[1]["loss"]
    log(f"  depth {UPDATE_LAYERS}, step 1 eager vs replayed: loss {le!r} / "
        f"{lf!r}, grad_norm {me[1]['grad_norm']!r} / {mf[1]['grad_norm']!r},"
        f" reward {me[1]['reward_mean']!r} / {mf[1]['reward_mean']!r}; "
        f"params max(|diff| - rtol |p|) {p_err:.3e} (atol {REF_ATOL}); "
        f"bitwise {bitwise}; {rep}")
    if abs(lf - le) > 1e-5 + REF_RTOL * abs(le) or p_err > REF_ATOL:
        fail("the replayed fused step is off the reference's band of the "
             "eager step")
    del fused
    gc.collect()
    eager.prefetch_reward_params()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m = eager.step(cond, 0, it=2)
        eager.prefetch_reward_params()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    loss = float(m["loss"])
    log(f"  an eager step under set_sync_debug_mode('error'): no host "
        f"synchronisation raised; loss {loss!r}")
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    return {"loss": [le, lf], "param_excess": p_err, "bitwise": bitwise,
            "fused": rep, "launches_eager_fused": ran,
            "sync_free_loss": loss}


def check_f32_policy_velocity(dev) -> dict:
    """``FlowAdapter(policy_dtype=float32)`` on bf16 parameters at full
    width, depth 2, batch 1, on the path geometry, for mamba2-370m (SSM
    leaves drawn) and flux_dit (modulation drawn): through the kernels'
    f32 variants (the scan's FMA passes, the attention's f32 kernel)
    against the plain versions, within F32_VEL_BAND of max |v|."""
    out = {}
    for arch, cond_len in ((SSM_ARCH, SSM_COND_LEN), ("flux_dit", COND_LEN)):
        cfg = replace(configs.get(arch), n_layers=2)
        adapter = FlowAdapter(cfg, FlowRLConfig(latent_tokens=LAT_TOKENS,
                                                latent_dim=LAT_DIM),
                              COND_DIM, policy_dtype=torch.float32)
        gen = torch.Generator(device=dev).manual_seed(23)
        p = params_lib.init(adapter.spec(), gen, torch.bfloat16, dev)
        if arch == SSM_ARCH:
            draw_ssm(p, seed=24)
        else:
            draw_modulation(p, cfg.d_model, seed=24)
        x = torch.randn(1, LAT_TOKENS, LAT_DIM, generator=gen, device=dev)
        cond = torch.randn(1, cond_len, COND_DIM, generator=gen, device=dev)
        t = torch.full((1,), 0.7, device=dev)
        reset_counts()
        with torch.no_grad():
            vk = adapter.velocity(p, x, t, cond)
            ran = counts()
            variants = dict(ssd_scan.variant_launches)
            with plain_dispatch():
                vp = adapter.velocity(p, x, t, cond)
        torch.cuda.synchronize()
        err, scale = float((vk - vp).abs().max()), float(vp.abs().max())
        log(f"  f32 policy on bf16 params, {arch} depth 2: max|kernel - "
            f"plain| {err:.3e} of max|v| {scale:.3e} (band "
            f"{F32_VEL_BAND * scale:.3e}); launches {ran}, ssd_scan "
            f"variants {variants}")
        kernel = "ssd_scan" if arch == SSM_ARCH else "flash_attention"
        if ran[kernel] != 2 or (arch == SSM_ARCH and variants != {
                "wgmma": 0, "fma": 2}):
            fail(f"the f32 {arch} velocity did not run the f32 kernels")
        if not (torch.isfinite(vk).all() and err <= F32_VEL_BAND * scale):
            fail(f"the f32-policy {arch} velocity is off its band")
        out[arch] = {"max_abs_err": err, "max_abs": scale}
        del p
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------- phase 22
FLUX_BLOCK_LAYERS = 16


def flux_block_path(tmp: str) -> dict:
    """flux_dit at full width and 16 of its 38 blocks under
    ``perf.remat=block`` through ``launch.train``: flow_grpo for 2 steps,
    phase 8's geometry, batch and rewards; then smollm-360m at all 32
    layers under block for 1 step (wq/wk drawn, as phase 17)."""
    out = {}
    out["flux_dit"], trainer = train_one(
        tmp, "flux_dit", FLUX_BLOCK_LAYERS, COND_LEN,
        ("flash_attention", "flash_attention_bwd"),
        _TrainWatch("attn", ("wq", "wk", "wv")), "flow_grpo", TRAIN_STEPS,
        extra=BLOCK + ("--set", "perf.log_memory=true"), tag="block",
        remat="block")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    out[DENSE_ARCH], trainer = train_one(
        tmp, DENSE_ARCH, DENSE_LAYERS, COND_LEN,
        ("flash_attention", "flash_attention_bwd"),
        _TrainWatch("attn", ("wq", "wk", "wv"), ("wq", "wk"),
                    lambda p, cfg: draw_attention(p, cfg.d_model, seed=15)),
        "flow_grpo", 1, extra=BLOCK, tag="block", remat="block")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------- phase 23
MB2 = ("--set", "dist.microbatch=2")
# the reference's microbatch band (tests/test_distributed.py::
# test_microbatch_grads_match_full_batch): loss atol 1e-7, grads rtol 1e-4 /
# atol 1e-6, printed beside the gaps.  A chunk's velocity rounds otherwise
# than the full batch's (another batch size), and the GRPO loss carries
# that through its ratio of two full-width log-densities (sums over
# 262,144 latent elements; PERF.md: 3.3e-3 to 6.8e-3 of a leaf's max
# |grad| measured over two trajectories), so flow_grpo is held to
# MB_GRPO_BAND of each leaf's max |grad| and of the loss; AWM's loss, with
# no ratio, on injected draws, to MB_AWM_BAND (measured 2.4e-6 and 7.2e-6).
# A wrong accumulation (a chunk lost, no division by k) is off by O(1).
MB_LOSS_ATOL, MB_RTOL, MB_ATOL = 1e-7, 1e-4, 1e-6
MB_GRPO_BAND, MB_AWM_BAND = 2e-2, 1e-3


def one_rank_group(tmp: str, store: str = "nccl_store"):
    """(a) A one-rank NCCL group (``file://`` store ``tmp/store``) and its
    (1, 1) ("data", "model") mesh through ``distributed.build_mesh``; the
    gather's all-gather and reduce-scatter on NCCL over a block leaf's
    shape (bitwise the identity on one rank) and their times."""
    import torch.distributed as dist
    from repro_torch import distributed, sharding as shlib
    dev = torch.device("cuda", 0)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/{store}",
                            rank=0, world_size=1, device_id=dev)
    mesh = distributed.build_mesh(1, 1, "cuda")
    backend = dist.get_backend(mesh.get_group("data"))
    x = torch.randn(3072, 12288, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    y = shlib.GatherParam.apply(x, 1, mesh.get_group("model"), 1)
    g = torch.randn_like(y)
    y.backward(g)
    ok = bool(torch.equal(y.detach(), x.detach()) and torch.equal(x.grad, g))
    group = mesh.get_group("model")
    ag = cuda_ms(lambda: shlib.gather_dim(x.detach(), 1, group, 1), 5)
    rs = cuda_ms(lambda: shlib.scatter_mean_dim(g, 1, group, 1), 5)
    log(f"  one-rank group: backend {backend}, mesh {tuple(mesh.shape)} "
        f"{mesh.mesh_dim_names}; GatherParam on (3072, 12288) bf16 bitwise "
        f"the identity forward and backward: {ok}; all-gather {ag:.4f} ms, "
        f"reduce-scatter (f32) {rs:.4f} ms")
    if backend != "nccl" or not ok:
        fail("the one-rank NCCL group or its gather is wrong")
    return mesh, {"backend": backend, "gather_identity": ok,
                  "all_gather_ms": ag, "reduce_scatter_ms": rs}


def _mesh_setup(dev, arch: str, seed: int):
    ssm = arch == SSM_ARCH
    cfg = replace(configs.get(arch), n_layers=UPDATE_LAYERS)
    flow = FlowRLConfig(num_steps=NUM_STEPS, group_size=2,
                        clip_range=UPDATE_CLIP, latent_tokens=LAT_TOKENS,
                        latent_dim=LAT_DIM, advantage_agg="gdpo",
                        rewards=(RewardSpec("pickscore", 1.0, args={
                            "latent_dim": LAT_DIM, "cond_dim": COND_DIM}),
                                 RewardSpec("latent_norm", 0.1)))
    opt = OptimConfig(lr=1e-4, warmup_steps=1, total_steps=1000)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cond = torch.randn(1, SSM_COND_LEN if ssm else COND_LEN, COND_DIM,
                       generator=gen, device=dev)
    return cfg, flow, opt, cond


def _draw(tr, arch: str, seed: int) -> None:
    if arch == SSM_ARCH:
        draw_ssm(tr.state.params, seed=seed)
    else:
        draw_modulation(tr.state.params, tr.adapter.cfg.d_model, seed=seed)


def check_mesh_update(dev, arch: str, mesh, tmp: str) -> dict:
    """(b) One flow_grpo step of ``arch`` at full width, depth 2, through
    the mesh path (the one-rank mesh injected: reward gather, gradient
    all-reduce, loss and metric reductions on NCCL) and without a mesh,
    from one state and seed: loss, grad norm and every param bitwise.
    (d) for mamba2-370m: the mesh trainer's checkpoint (its canonical
    state, saved) restored into a trainer without a mesh, bitwise."""
    from repro_torch import checkpoint
    cfg, flow, opt, cond = _mesh_setup(dev, arch, 23)
    runs, params = {}, None
    for name, m in (("none", None), ("mesh", mesh)):
        tr = registry.build("trainer", "flow_grpo", cfg, flow, opt, seed=0,
                            cond_dim=COND_DIM, device=dev, params=params,
                            mesh=m)
        if params is None:
            _draw(tr, arch, 24)
            params = _clone(tr.state.params)
        reset_counts()
        met = tr.step(cond, 5, it=0)
        runs[name] = ({k: float(v) for k, v in met.items()}, counts(), tr)
    (ma, la, a), (mb, lb, b) = runs["none"], runs["mesh"]
    same = all(torch.equal(x, y) for (_, x), (_, y) in zip(
        params_lib.leaves(a.state.params), params_lib.leaves(b.state.params)))
    bitwise = ma == mb and same and la == lb
    log(f"  {arch} depth {UPDATE_LAYERS}, no mesh / one-rank mesh: loss "
        f"{ma['loss']!r} / {mb['loss']!r}, grad_norm {ma['grad_norm']!r} / "
        f"{mb['grad_norm']!r}, reward {ma['reward_mean']!r} / "
        f"{mb['reward_mean']!r}; every param equal {same}; launches equal "
        f"{la == lb}; bitwise {bitwise}")
    if not bitwise:
        fail(f"{arch}: the one-rank mesh path is not bitwise the no-mesh "
             "path")
    out = {"loss": [ma["loss"], mb["loss"]], "bitwise": bitwise}
    del a
    runs.pop("none")
    if arch == SSM_ARCH:
        ckpt = f"{tmp}/ckpt_mesh"
        state = b.canonical_state()
        checkpoint.save_checkpoint(ckpt, 1, state)
        fresh = registry.build("trainer", "flow_grpo", cfg, flow, opt,
                               seed=1, cond_dim=COND_DIM, device=dev)
        step, got = checkpoint.restore_latest(ckpt, fresh.state,
                                              fresh.state_slicer())
        rt = step == 1 and all(
            torch.equal(x, y) for x, y in zip(_leaves(got), _leaves(state)))
        log(f"  (d) checkpoint saved under the mesh, restored without one: "
            f"step {step}, every leaf (params, moments, step) bitwise {rt}")
        if not rt:
            fail("the mesh checkpoint did not restore bitwise without a "
                 "mesh")
        out["checkpoint_roundtrip"] = rt
        del fresh, got, state
    del b, runs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _leaves(state):
    from repro_torch.checkpoint.io import _flatten
    return [t for _, t in _flatten(state)]


def check_mesh_microbatch(dev, arch: str, mesh) -> dict:
    """(b) ``dist.microbatch=2`` against 0 on the mesh, f32 params and
    ``perf.policy_dtype=float32``, at full width, depth 2: one loss and
    backward of ``flow_grpo`` on one rollout's trajectory and advantages,
    and of ``awm`` on the same trajectory with injected timesteps and
    noise; the loss and every gradient leaf against the reference's band
    (printed: the share of elements outside it) and held to MB_GRPO_BAND
    and MB_AWM_BAND of the loss and of each leaf's max |grad|."""
    from repro_torch.config import DistConfig
    cfg, flow, opt, cond = _mesh_setup(dev, arch, 25)
    f32 = PerfConfig(policy_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(27)
    draws = {"t": torch.rand(2, generator=gen, device=dev) * 0.96 + 0.02,
             "eps": torch.randn(2, LAT_TOKENS, LAT_DIM, generator=gen,
                                device=dev)}
    params, traj, adv, out = None, None, None, {}
    for tname, band in (("flow_grpo", MB_GRPO_BAND), ("awm", MB_AWM_BAND)):
        grads, losses, ran = {}, {}, {}
        for k in (0, 2):
            tr = registry.build("trainer", tname, cfg, flow, opt, seed=0,
                                cond_dim=COND_DIM, device=dev,
                                dtype=torch.float32, params=params, perf=f32,
                                dist=DistConfig(microbatch=k), mesh=mesh)
            if params is None:
                _draw(tr, arch, 26)
                params = tr.state.params
                traj = tr.sample(params, cond, gen)
                _, adv, _ = tr._rewards(traj.x0, {"cond": traj.cond})
            kw = draws if tname == "awm" else {}
            reset_counts()
            loss, _ = tr.backward(traj, adv, None, **kw)
            ran[k] = counts()
            losses[k] = float(loss)
            grads[k] = [p.grad.clone() for _, p in params_lib.leaves(params)]
            for _, p in params_lib.leaves(params):
                p.grad = None
            del tr
        worst, outside, total = 0.0, 0, 0
        for g0, g2 in zip(grads[0], grads[2]):
            d = (g2 - g0).abs()
            worst = max(worst, float(d.max()) / max(float(g0.abs().max()),
                                                    1e-30))
            outside += int((d > MB_ATOL + MB_RTOL * g0.abs()).sum())
            total += d.numel()
        dl = abs(losses[2] - losses[0])
        log(f"  {arch} depth {UPDATE_LAYERS}, f32, {tname}, microbatch 2 / 0:"
            f" loss {losses[2]!r} / {losses[0]!r} (|diff| {dl:.3e}; "
            f"reference atol {MB_LOSS_ATOL}); worst leaf max|diff| / "
            f"max|grad| {worst:.3e} (held to {band}); {outside} of {total} "
            f"gradient elements outside the reference's rtol {MB_RTOL} / "
            f"atol {MB_ATOL}; loss-side launches {ran}")
        if (not math.isfinite(losses[2]) or worst > band
                or dl > band * max(abs(losses[0]), 1.0)):
            fail(f"{arch}: {tname} with microbatch=2 is off its band of the "
                 "full batch")
        out[tname] = {"loss": [losses[0], losses[2]], "loss_gap": dl,
                      "worst_leaf_share": worst, "band": band,
                      "outside_reference_band": outside, "elements": total,
                      "launches": {str(k): v for k, v in ran.items()}}
        del grads
    del traj, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_mesh_fused(dev, mesh) -> dict:
    """(b) The fused step with ``dist.microbatch=2`` on the mesh,
    mamba2-370m at full width, depth 2, bf16: step 0 eager and captured
    (the graph holds the NCCL collectives), step 1 replayed, against the
    eager mesh step on the same draws: bitwise, 1 capture and 1 replay."""
    from repro_torch.config import DistConfig
    cfg, flow, opt, cond = _mesh_setup(dev, SSM_ARCH, 28)
    gen = torch.Generator(device=dev).manual_seed(29)
    draws = [{"x_init": torch.randn(2, LAT_TOKENS, LAT_DIM, generator=gen,
                                    device=dev),
              "eps": torch.randn(NUM_STEPS, 2, LAT_TOKENS, LAT_DIM,
                                 generator=gen, device=dev)}
             for _ in range(2)]
    mb = DistConfig(microbatch=2)
    eager = registry.build("trainer", "flow_grpo", cfg, flow, opt, seed=0,
                           cond_dim=COND_DIM, device=dev, dist=mb, mesh=mesh)
    _draw(eager, SSM_ARCH, 30)
    fused = registry.build("trainer", "flow_grpo", cfg, flow, opt, seed=0,
                           cond_dim=COND_DIM, device=dev, dist=mb, mesh=mesh,
                           params=_clone(eager.state.params),
                           perf=PerfConfig(fuse_step=True))
    me, mf, ran = [], [], []
    for it in range(2):
        reset_counts()
        me.append({k: float(v) for k, v in eager.step(
            cond, 0, it=it, **draws[it]).items()})
        ran_e = counts()
        reset_counts()
        mf.append({k: float(v) for k, v in fused.step(
            cond, 0, it=it, **draws[it]).items()})
        ran.append((ran_e, counts()))
    rep = fused._fused.report()
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        params_lib.leaves(eager.state.params),
        params_lib.leaves(fused.state.params)))
    bitwise = me == mf and same
    log(f"  fused + microbatch 2 on the mesh, {SSM_ARCH} depth "
        f"{UPDATE_LAYERS}: {rep['captures']} capture(s), {rep['replays']} "
        f"replay(s); step 1 eager / replayed loss {me[1]['loss']!r} / "
        f"{mf[1]['loss']!r}, grad_norm {me[1]['grad_norm']!r} / "
        f"{mf[1]['grad_norm']!r}; params equal {same}; bitwise {bitwise}; "
        f"launches per step eager / fused {ran}")
    if (rep["captures"], rep["replays"]) != (1, 1) or not bitwise or not all(
            e == f for e, f in ran):
        fail("the fused microbatched step on the mesh is not bitwise the "
             "eager one")
    del eager, fused
    gc.collect()
    torch.cuda.empty_cache()
    return {"bitwise": bitwise, "fused": rep, "launches": ran}


def mesh_train_path(tmp: str, mesh) -> dict:
    """(c) Full width and depth through ``launch.train`` on the mesh with
    ``dist.microbatch=2``, flow_grpo, 2 steps, phase 19's and phase 22's
    geometry, batch and rewards: mamba2-370m at 48 layers under
    ``remat=none`` (SSM leaves drawn), then flux_dit at 16 blocks under
    ``block``.  Launch counts (each loss pass once per chunk), s a step,
    steps/s, peak allocated and reserved memory; and the device time of
    the step's gradient all-reduce over the one-rank "data" group (every
    leaf, f32), against the step."""
    out = {}
    out[SSM_ARCH], trainer = train_one(
        tmp, SSM_ARCH, SSM_TRAIN_LAYERS, SSM_COND_LEN, SSM_KERNELS,
        _ssm_watch(), "flow_grpo", TRAIN_STEPS, extra=MB2, tag="mb2",
        mesh=mesh, microbatch=2)
    for _, p in params_lib.leaves(trainer.state.params):
        p.grad = torch.zeros_like(p)
    sync = cuda_ms(trainer._sync_grads, 3)
    for _, p in params_lib.leaves(trainer.state.params):
        p.grad = None
    step_ms = 1e3 / out[SSM_ARCH]["steps_per_s"]
    out[SSM_ARCH]["grad_allreduce_ms"] = sync
    out[SSM_ARCH]["grad_allreduce_share"] = sync / step_ms
    log(f"  {SSM_ARCH}: the gradient all-reduce over the one-rank group "
        f"{sync:.3f} ms a step, {100 * sync / step_ms:.3f} % of "
        f"{step_ms:.1f} ms")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    out["flux_dit"], trainer = train_one(
        tmp, "flux_dit", FLUX_BLOCK_LAYERS, COND_LEN,
        ("flash_attention", "flash_attention_bwd"),
        _TrainWatch("attn", ("wq", "wk", "wv")), "flow_grpo", TRAIN_STEPS,
        extra=BLOCK + MB2, tag="block_mb2", remat="block", mesh=mesh,
        microbatch=2)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_mesh_serving(dev, mesh) -> dict:
    """(e) mamba2-370m at 48 layers, SSM leaves drawn, 4 requests in one
    bucket of 4, 4 steps of flow_sde: the engine on the one-rank mesh
    (its keyed executor: the bucket split over "data", the latents
    all-gathered) against the engine without one, per request bitwise."""
    from repro_torch.core import schedulers
    from repro_torch.serving import ServingEngine
    cfg = configs.get(SSM_ARCH)
    flow = FlowRLConfig(num_steps=NUM_STEPS, latent_tokens=LAT_TOKENS,
                        latent_dim=LAT_DIM, sde_type="flow_sde")
    adapter = FlowAdapter(cfg, flow, COND_DIM)
    gen = torch.Generator(device=dev).manual_seed(31)
    params = params_lib.init(adapter.spec(), gen, torch.bfloat16, dev)
    draw_ssm(params, seed=32)
    sched = schedulers.build("flow_sde", flow.eta)
    cond = torch.randn(4, SSM_COND_LEN, COND_DIM, generator=gen,
                       device=dev).cpu().numpy()
    lat, stats = {}, {}
    for name, m in (("none", None), ("mesh", mesh)):
        eng = ServingEngine(adapter, sched, params, num_steps=NUM_STEPS,
                            device=dev, max_batch=4, buckets=[4],
                            cond_len=SSM_COND_LEN, mesh=m)
        reset_counts()
        lat[name] = eng.serve(cond, seed=33)
        stats[name] = {"launches": counts(),
                       "dispatches": eng.stats["dispatches"],
                       "data_parallel": eng.stats["data_parallel"]}
        del eng
    same = bool(torch.equal(lat["none"], lat["mesh"]))
    log(f"  served {SSM_ARCH} on the mesh / without: {stats}; per-request "
        f"latents bitwise {same}")
    if not same or not torch.isfinite(lat["mesh"]).all():
        fail("sharded serving on the mesh is not bitwise the engine without "
             "one")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"bitwise": same, **stats["mesh"]}


def distributed_phase(dev, tmp: str) -> dict:
    """Phase 23: (a) the one-rank NCCL group and mesh, (b) the mesh path
    bitwise the no-mesh path (flux_dit, mamba2-370m), microbatch 2 against
    0, the fused microbatched step on the mesh, (c) full-width, full-depth
    microbatched training on the mesh, (d) the checkpoint round trip, (e)
    sharded serving.  Destroys the group at the end."""
    import torch.distributed as dist
    mesh, out = one_rank_group(tmp)
    try:
        out["update"] = {a: check_mesh_update(dev, a, mesh, tmp)
                         for a in ("flux_dit", SSM_ARCH)}
        out["microbatch"] = {a: check_mesh_microbatch(dev, a, mesh)
                             for a in ("flux_dit", SSM_ARCH)}
        out["fused"] = check_mesh_fused(dev, mesh)
        out["train"] = mesh_train_path(tmp, mesh)
        out["serve"] = check_mesh_serving(dev, mesh)
    finally:
        dist.destroy_process_group()
    return out


# ----------------------------------------------------------------- phase 24
# training through the serving engine: its rollouts of 2 prompts x group 2
# run in chunks of ENGINE_BATCH rows (2 chunks a step)
ENGINE_BATCH = 2
# phase 19's engine-free flow_grpo on the same cell, for comparison when
# phase 19 did not run in this call (as recorded in PERF.md §5, NVIDIA
# H100 80GB HBM3, 700 W: the second step's seconds, max_memory_allocated)
PHASE19_S_PER_STEP, PHASE19_PEAK_GIB = 3.2484, 67.33
# one flow_grpo / awm step at depth 2 in f32 on injected draws, the
# engine's rollout in one chunk (max_batch 4) against two (max_batch 2):
# the two chunkings' latents differ by f32 rounding (a chunk's velocity at
# another batch size), held to ENGINE_XS_BAND of max |xs|; the GRPO loss
# carries that through its ratio, so flow_grpo's loss and each leaf's
# max |grad| are held to phase 23's MB_GRPO_BAND, awm's to MB_AWM_BAND
ENGINE_XS_BAND = 1e-4


def _engine_step(dev, tname: str, params, cond, draws, engine_batch: int,
                 mesh=None) -> dict:
    """One ``tname`` step of mamba2-370m at full width, depth 2, f32 (the
    ``_mesh_setup`` cell), from ``params`` on injected ``draws``, through
    an attached engine of ``max_batch`` ``engine_batch`` (none if 0):
    metrics, launch counts, the trajectory, the gradients before the
    optimizer step, the params after it and the engine's dispatches."""
    cfg, flow, opt, _ = _mesh_setup(dev, SSM_ARCH, 30)
    tr = registry.build("trainer", tname, cfg, flow, opt, seed=0,
                        cond_dim=COND_DIM, device=dev, dtype=torch.float32,
                        params=_clone(params), mesh=mesh,
                        perf=PerfConfig(policy_dtype="float32"))
    eng = None
    if engine_batch:
        eng = ServingEngine.for_trainer(tr, max_batch=engine_batch,
                                        cond_len=SSM_COND_LEN)
        tr.attach_engine(eng)
    seen = {}
    inner_sample, inner_apply = tr._sample, tr.apply_grads

    def sample(*a, **kw):
        seen["traj"] = inner_sample(*a, **kw)
        return seen["traj"]

    def apply_grads():
        seen["grads"] = [p.grad.clone()
                         for _, p in params_lib.leaves(tr.state.params)]
        return inner_apply()

    tr._sample, tr.apply_grads = sample, apply_grads
    reset_counts()
    met = tr.step(cond, 5, it=0, **draws)
    seen.update(metrics={k: float(v) for k, v in met.items()},
                launches=counts(),
                params=[p.clone() for _, p in
                        params_lib.leaves(tr.state.params)],
                dispatches=None if eng is None else eng.stats["dispatches"])
    del tr, eng
    return seen


def _grad_share(a: list, b: list) -> float:
    """The largest per-leaf max |a - b| / max |b|."""
    return max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
               for x, y in zip(a, b))


def check_engine_updates(dev, tmp: str) -> dict:
    """At depth 2 in f32 on injected draws (x_init, the rollout's eps, and
    for awm the update's t and noise), 2 prompts x group 2: flow_grpo and
    awm without an engine, through an engine in one chunk (max_batch 4)
    and in two (max_batch 2).  flow_grpo in one chunk is bitwise the
    engine-free step (metrics, every param after AdamW, launches); in two
    chunks its trajectory is within ENGINE_XS_BAND of max |xs| and its
    loss and every leaf's gradient within MB_GRPO_BAND; awm's (engine in
    one chunk against none: its ODE through ``step_with_eps`` against
    ``step_ode``, and two chunks against one) within MB_AWM_BAND.  Then on
    a one-rank NCCL group and mesh: the two-chunk engine step on the mesh
    bitwise the no-mesh one."""
    import torch.distributed as dist
    cfg, flow, opt, _ = _mesh_setup(dev, SSM_ARCH, 30)
    gen = torch.Generator(device=dev).manual_seed(31)
    B = 2 * flow.group_size
    cond = torch.randn(2, SSM_COND_LEN, COND_DIM, generator=gen, device=dev)
    draws = {"x_init": torch.randn(B, LAT_TOKENS, LAT_DIM, generator=gen,
                                   device=dev),
             "eps": torch.randn(NUM_STEPS, B, LAT_TOKENS, LAT_DIM,
                                generator=gen, device=dev)}
    awm_draws = dict(draws, update_t=torch.rand(B, generator=gen, device=dev)
                     * 0.96 + 0.02,
                     update_eps=torch.randn(B, LAT_TOKENS, LAT_DIM,
                                            generator=gen, device=dev))
    tr = registry.build("trainer", "flow_grpo", cfg, flow, opt, seed=0,
                        cond_dim=COND_DIM, device=dev, dtype=torch.float32)
    draw_ssm(tr.state.params, seed=32)
    params = _clone(tr.state.params)
    del tr
    out = {}
    for tname, band, kw in (("flow_grpo", MB_GRPO_BAND, draws),
                            ("awm", MB_AWM_BAND, awm_draws)):
        runs = {k: _engine_step(dev, tname, params, cond, kw, k)
                for k in (0, 4, 2)}
        free, one, two = runs[0], runs[4], runs[2]
        scale = float(one["traj"].xs.abs().max())
        xs_gap = float((two["traj"].xs - one["traj"].xs).abs().max()) / scale
        free_gap = float((one["traj"].xs - free["traj"].xs).abs().max()
                         ) / scale
        bitwise = (one["metrics"] == free["metrics"]
                   and one["launches"] == free["launches"]
                   and all(torch.equal(a, b) for a, b in
                           zip(one["params"], free["params"])))
        loss = {k: r["metrics"]["loss"] for k, r in runs.items()}
        two_share = _grad_share(two["grads"], one["grads"])
        one_share = _grad_share(one["grads"], free["grads"])
        log(f"  {tname} depth {UPDATE_LAYERS}, f32: loss no engine / "
            f"max_batch 4 / max_batch 2 {loss[0]!r} / {loss[4]!r} / "
            f"{loss[2]!r}; max_batch 4 bitwise the engine-free step "
            f"{bitwise} (xs gap {free_gap:.3e}, worst leaf grad gap "
            f"{one_share:.3e} of max |grad|); max_batch 2 against 4: xs gap "
            f"{xs_gap:.3e} of max |xs| (band {ENGINE_XS_BAND}), worst leaf "
            f"grad gap {two_share:.3e} (band {band}); dispatches "
            f"{one['dispatches']} / {two['dispatches']}; launches "
            f"{free['launches']} / {one['launches']} / {two['launches']}")
        if (one["dispatches"], two["dispatches"]) != (
                {f"b4/s{NUM_STEPS}": 1}, {f"b2/s{NUM_STEPS}": 2}):
            fail(f"{tname}: the engine's rollout did not run in the "
                 "expected chunks")
        if not all(math.isfinite(v) for v in loss.values()):
            fail(f"{tname}: a non-finite loss through the engine")
        if tname == "flow_grpo" and not bitwise:
            fail("flow_grpo through the engine in one chunk is not bitwise "
                 "the engine-free step")
        if tname == "awm" and (
                one_share > band or abs(loss[4] - loss[0]) > band * max(
                    abs(loss[0]), 1.0)):
            fail("awm through the engine is off its band of the "
                 "engine-free step")
        if (xs_gap > ENGINE_XS_BAND or two_share > band
                or abs(loss[2] - loss[4]) > band * max(abs(loss[4]), 1.0)):
            fail(f"{tname}: the engine's two chunks are off their band of "
                 "one")
        out[tname] = {"loss": [loss[0], loss[4], loss[2]],
                      "one_chunk_bitwise": bitwise,
                      "one_chunk_xs_gap": free_gap,
                      "one_chunk_grad_share": one_share,
                      "two_chunk_xs_gap": xs_gap,
                      "two_chunk_grad_share": two_share, "band": band,
                      "launches": [free["launches"], one["launches"],
                                   two["launches"]]}
        del runs, free, one, two
        gc.collect()
    mesh, grp = one_rank_group(tmp, "nccl_store_24")
    try:
        none = _engine_step(dev, "flow_grpo", params, cond, draws, 2)
        on = _engine_step(dev, "flow_grpo", params, cond, draws, 2,
                          mesh=mesh)
    finally:
        dist.destroy_process_group()
    parts = {
        "metrics": [k for k in none["metrics"]
                    if on["metrics"].get(k) != none["metrics"][k]],
        "launches": on["launches"] == none["launches"],
        "xs": torch.equal(on["traj"].xs, none["traj"].xs),
        "logps": torch.equal(on["traj"].logps, none["traj"].logps),
        "grads": sum(not torch.equal(a, b)
                     for a, b in zip(on["grads"], none["grads"])),
        "params": sum(not torch.equal(a, b)
                      for a, b in zip(on["params"], none["params"]))}
    same = (not parts["metrics"] and parts["launches"] and parts["xs"]
            and parts["logps"] and not parts["grads"]
            and not parts["params"])
    log(f"  flow_grpo depth {UPDATE_LAYERS}, engine max_batch 2, one-rank "
        f"{grp['backend']} mesh / no mesh: loss {on['metrics']['loss']!r} / "
        f"{none['metrics']['loss']!r}; bitwise {same} (metrics that differ "
        f"{parts['metrics']}, launches equal {parts['launches']}, xs equal "
        f"{parts['xs']}, logps equal {parts['logps']}, leaves whose grad / "
        f"param differ {parts['grads']} / {parts['params']} of "
        f"{len(none['params'])})")
    if not same:
        fail("the engine path on the one-rank mesh is not bitwise the "
             "no-mesh engine path")
    out["mesh_bitwise"] = same
    del none, on, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def engine_phase(dev, tmp: str, phase19=None) -> dict:
    """Phase 24: flow_grpo on mamba2-370m at its published width and all
    48 layers, bf16, trained 2 steps through an attached engine whose
    rollouts run in chunks of ENGINE_BATCH (``train_one`` with
    ``engine_batch``: launch counts, finite metrics, first-update
    gradients, params that move), its engine's dispatches, s a step and
    memory beside phase 19's engine-free run (``phase19``, its row, when
    it ran in this call); then ``check_engine_updates``."""
    row, trainer = train_one(
        tmp, SSM_ARCH, SSM_TRAIN_LAYERS, SSM_COND_LEN, SSM_KERNELS,
        _TrainWatch("ssm", ("conv_w", "conv_b", "a_log"),
                    ("a_log", "dt_bias"),
                    lambda p, cfg: draw_ssm(p, seed=19)),
        "flow_grpo", TRAIN_STEPS, tag="engine", engine_batch=ENGINE_BATCH)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    want = {f"b{ENGINE_BATCH}/s{NUM_STEPS}":
            TRAIN_STEPS * PROMPTS * GROUP // ENGINE_BATCH}
    if row["engine"]["dispatches"] != want or row["engine"]["padded_lanes"]:
        fail(f"the engine dispatched {row['engine']}, expected {want} and "
             "no padded lane")
    if phase19 is not None:
        ref_s = phase19["s_per_step"][-1]
        ref_gib = phase19["peak_bytes"] / 2**30
        src = "phase 19 in this run"
    else:
        ref_s, ref_gib = PHASE19_S_PER_STEP, PHASE19_PEAK_GIB
        src = "phase 19 as recorded in PERF.md"
    log(f"  through the engine: {row['s_per_step'][-1]:.4f} s a step, "
        f"max_memory_allocated {row['peak_bytes'] / 2**30:.2f} GiB, reserved "
        f"{row['peak_reserved_bytes'] / 2**30:.2f} GiB; engine-free "
        f"({src}): {ref_s:.4f} s, {ref_gib:.2f} GiB")
    row["engine_free"] = {"s_per_step": ref_s, "peak_gib": ref_gib,
                          "source": src}
    return {"train": row, "update": check_engine_updates(dev, tmp)}


# ----------------------------------------------------------------- phase 25
# the hybrid's path: zamba2-2.7b at its published width (arXiv:2411.15242:
# 54 Mamba-2 layers in 9 groups of 6, each group followed by one shared
# attention + SwiGLU block, causal GQA with 32 heads of 80; SSD heads 80 of
# 64, state 64, chunk 128) over 511 + 1 + 4096 = 36 x 128 tokens
HY_ARCH, HY_LAYERS, HY_COND_LEN = "zamba2-2.7b", 54, 511
HY_SEQ = HY_COND_LEN + 1 + LAT_TOKENS
HY_SITES, HY_HEADS, HY_HEAD_DIM = 9, 32, 80
HY_SSD_HEADS, HY_STATE = 80, 64
HY_KERNELS = ({"ssd_scan": HY_LAYERS, "flash_attention": HY_SITES},
              {"ssd_scan_bwd": HY_LAYERS, "flash_attention_bwd": HY_SITES})
# state 64 is no shape of the tensor-core scan: the FMA passes run it, and
# the shared attention's bf16 D = 80 runs on the tensor cores
HY_ROUTES = {"ssd_scan": "fma", "ssd_scan_bwd": "fma",
             "flash_attention": "wgmma", "flash_attention_bwd": "wgmma"}


def depth_cfg(arch: str, layers: int):
    """``arch``'s full-width config cut to ``layers`` layers; the hybrid
    below one group of ``attn_every`` keeps whole groups of one SSM block
    each, so that every cut still runs its shared block at every group."""
    cfg = configs.get(arch)
    if cfg.family == "hybrid" and layers < cfg.hybrid.attn_every:
        return replace(cfg, n_layers=layers,
                       hybrid=replace(cfg.hybrid, attn_every=1))
    return replace(cfg, n_layers=layers)


def draw_shared_attention(p: dict, d_model: int, seed: int) -> None:
    """The hybrid's shared wq and wk redrawn at std 1/sqrt(d_model), in
    place, for ``draw_attention``'s reason (at the repository's init the
    logits have std ~ d_model / n_heads, 80 at zamba2-2.7b's width, and the
    softmax is one-hot: tests/test_torch_hybrid.py)."""
    attn = p["backbone"]["shared_attn"]["attn"]
    gen = torch.Generator(device=attn["wq"].device).manual_seed(seed)
    for key in ("wq", "wk"):
        attn[key].copy_(torch.randn(attn[key].shape, generator=gen,
                                    device=attn[key].device) / d_model ** 0.5)


def draw_hybrid(p: dict, cfg, seed: int) -> None:
    draw_ssm(p, seed=seed)
    draw_shared_attention(p, cfg.d_model, seed=seed + 1)


D80_CASES = [  # B, Sq, H, K, causal, window, dtype
    (B_SERVE, HY_SEQ, HY_HEADS, HY_HEADS, True, 0, torch.bfloat16),
    (B_SERVE, HY_SEQ, HY_HEADS, HY_HEADS, True, 0, torch.float32),
    (1, 129, 2, 1, True, 0, torch.bfloat16),
    (1, 129, 2, 1, True, 0, torch.float32),
    (2, 77, 4, 2, True, 0, torch.bfloat16),
    (2, 77, 4, 2, True, 0, torch.float32),
    (1, 1000, 4, 2, True, 256, torch.bfloat16),
    (1, 300, 4, 2, False, 0, torch.bfloat16),
]


def _causal_flops_d80() -> float:
    """Operations of the causal forward at the hybrid path's attention
    shape: the two products over the half of the score matrix the mask
    keeps, 4 B H S^2 D / 2."""
    return 4 * B_SERVE * HY_HEADS * HY_SEQ ** 2 * HY_HEAD_DIM / 2


def check_attention_d80(dev) -> list:
    """The attention forward (o and its LSE) and backward at head dim 80
    against their plain versions and torch.autograd through the plain
    forward, with phase 3's bands: the path shape (4, 4608, 32 / 32 heads
    of 80, causal) in bf16 on the tensor-core kernels and in f32 on the FMA
    kernels, ragged (1, 129, 2 / 1) and (2, 77, 4 / 2), a window of 256
    over 1000 and a bidirectional case.  Each call must run the variant its
    dtype calls for (``variant_launches``).  Then kernel (replayed graph),
    plain and SDPA times and the bound at the path shape, forward and
    backward.  Returns the two kernel rows."""
    g = torch.Generator(device=dev).manual_seed(25)
    errs = {}
    for (B, S, H, K, causal, window, dt) in D80_CASES:
        D = HY_HEAD_DIM
        q = torch.randn(B, S, H, D, generator=g, device=dev).to(dt)
        k = torch.randn(B, S, K, D, generator=g, device=dev).to(dt)
        v = torch.randn(B, S, K, D, generator=g, device=dev).to(dt)
        do = torch.randn(B, S, H, D, generator=g, device=dev).to(dt)
        variant = "wgmma" if dt == torch.bfloat16 else "fma"
        if fa_mod.tensor_core_route(q, k, v) != (variant == "wgmma"):
            fail(f"tensor_core_route disagrees with the dtype rule at "
                 f"{(B, S, H, K, D)} {dt}")
        before = all_variants()
        o, lse = flash_attention(q, k, v, causal=causal, window=window,
                                 return_lse=True)
        got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                  window=window)
        ran = all_variants()
        for name in ("flash_attention", "flash_attention_bwd"):
            if ran[name][variant] - before[name][variant] != 1:
                fail(f"{name} at D = 80 {dt} did not run its {variant} "
                     f"kernel: {before[name]} -> {ran[name]}")
        # the plain versions one batch row at a time (a whole (4, 4608,
        # 32, 4608) f32 score tensor is 10.9 GB)
        rows = [ref.flash_attention_fwd_ref(q[i:i + 1], k[i:i + 1],
                                            v[i:i + 1], causal=causal,
                                            window=window) for i in range(B)]
        r = torch.cat([a for a, _ in rows])
        lse_ref = torch.cat([b for _, b in rows])
        want = [torch.cat(t) for t in zip(*(
            ref.flash_attention_bwd_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                        o[i:i + 1], lse[i:i + 1],
                                        do[i:i + 1], causal=causal,
                                        window=window) for i in range(B)))]
        leaves = [a[:1].float().requires_grad_() for a in (q, k, v)]
        ref.flash_attention_ref(*leaves, causal=causal,
                                window=window).backward(do[:1].float())
        torch.cuda.synchronize()
        err = float((o.float() - r.float()).abs().max())
        lse_err = float((lse - lse_ref).abs().max()) / max(
            1.0, float(lse_ref.abs().max()))
        gerr = _grad_errs(got, want)
        auto = _grad_errs([a[:1] for a in got], [a.grad for a in leaves])
        path = S == HY_SEQ
        if path:
            limit = PATH_ATTN_BAND * float(r.float().abs().max())
            ok = err <= limit
        else:
            tol = 2e-5 if dt == torch.float32 else 2e-2
            limit = tol
            ok = torch.allclose(o.float(), r.float(), atol=tol, rtol=tol)
        band = ATTN_BWD_BAND[dt]
        log(f"  D=80 B={B} S={S} H={H} K={K} causal={causal} window={window} "
            f"{dt} ({variant}): o max|err| {err:.3e} (limit {limit:.3e}), "
            f"lse {lse_err:.2e}; dq/dk/dv vs plain {gerr[0]:.2e}/"
            f"{gerr[1]:.2e}/{gerr[2]:.2e}, vs autograd {auto[0]:.2e}/"
            f"{auto[1]:.2e}/{auto[2]:.2e} of max|plain| (band {band})")
        if not ok or lse_err > LSE_BAND:
            fail(f"flash_attention off at D = 80, {(B, S, H, K)} {dt}")
        if max(gerr + auto) > band:
            fail(f"flash_attention_bwd off at D = 80, {(B, S, H, K)} {dt}")
        if path:
            errs[dt] = (err, max(float((a.float() - b.float()).abs().max())
                                 for a, b in zip(got, want)))
        del q, k, v, do, o, lse, got, want, rows, r, lse_ref, leaves
        torch.cuda.empty_cache()
    return _attention_d80_times(dev, g, errs)


def _attention_d80_times(dev, g, errs) -> list:
    """Forward and backward at the path shape (4, 4608, 32 heads of 80,
    causal): the bf16 kernels and the f32 FMA kernels from replayed
    graphs, the plain versions and SDPA (and its backward) with CUDA
    events, and the bounds: 4 B H S^2 D / 2 operations forward, 2.5 x that
    backward, at the bf16 tensor-core rate."""
    shp = (B_SERVE, HY_SEQ, HY_HEADS, HY_HEAD_DIM)
    q, k, v, do = (torch.randn(shp, generator=g, device=dev,
                               dtype=torch.bfloat16) for _ in range(4))
    o, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    ms = graph_ms(lambda: flash_attention(q, k, v, causal=True), 3)
    lse_ms = graph_ms(lambda: flash_attention(q, k, v, causal=True,
                                              return_lse=True), 3)
    bwd_ms = graph_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                                  causal=True), 3)
    q32, k32, v32, do32 = (a.float() for a in (q, k, v, do))
    o32, lse32 = flash_attention(q32, k32, v32, causal=True, return_lse=True)
    fma_ms = graph_ms(lambda: flash_attention(q32, k32, v32, causal=True), 1)
    fma_bwd_ms = graph_ms(lambda: flash_attention_bwd(
        q32, k32, v32, o32, lse32, do32, causal=True), 1)
    del q32, k32, v32, do32, o32, lse32
    torch.cuda.empty_cache()
    # the plain versions one batch row at a time, as the checks run them
    # (a whole batch's f32 scores and probabilities would take ~50 GB)
    rows_b = range(B_SERVE)
    plain_ms = cuda_ms(lambda: [ref.flash_attention_ref(
        q[i:i + 1], k[i:i + 1], v[i:i + 1], causal=True) for i in rows_b],
        1, 1)
    torch.cuda.empty_cache()
    plain_bwd_ms = cuda_ms(lambda: [ref.flash_attention_bwd_ref(
        q[i:i + 1], k[i:i + 1], v[i:i + 1], o[i:i + 1], lse[i:i + 1],
        do[i:i + 1], causal=True) for i in rows_b], 1, 1)
    torch.cuda.empty_cache()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (a.transpose(1, 2).detach().requires_grad_()
                  for a in (q, k, v))
    with torch.no_grad():
        sdpa_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True), 10)
    out = sdpa(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), 5)
    flops = _causal_flops_d80()
    rows = []
    for name, kms, fms, pms, lms, f, nbytes, src, rep_ in (
            ("flash_attention_d80", ms, fma_ms, plain_ms, sdpa_ms, flops,
             4 * q.numel() * 2, "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:81"),
            ("flash_attention_bwd_d80", bwd_ms, fma_bwd_ms, plain_bwd_ms,
             sdpa_bwd_ms, 2.5 * flops, 7 * q.numel() * 2 + 4 * lse.numel(),
             "flash_attention_bwd.cu",
             "none (JAX autodiff of src/repro/models/attention.py:71, "
             "attention_chunked)")):
        bound, by = _bound(nbytes, f)
        log(f"  {name} path {shp} causal bf16: kernel {kms:.4f} ms "
            f"(wgmma), the f32 FMA kernel {fms:.4f} ms, plain {pms:.3f} ms "
            f"(a batch row at a time), "
            f"SDPA{' backward' if 'bwd' in name else ''} {lms:.4f} ms, "
            f"bound {bound:.4f} ms ({f / 1e12:.4f} TFLOP, "
            f"{nbytes / 1e6:.1f} MB)")
        rows.append({
            "name": name, "route": "cuda", "variant": "wgmma",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": rep_,
            "max_abs_err": errs[torch.bfloat16][0 if "bwd" not in name
                                                else 1],
            "max_abs_err_f32": errs[torch.float32][0 if "bwd" not in name
                                                   else 1],
            "ms": kms, "fma_ms": fms, "plain_ms": pms, "bound_ms": bound,
            "bound_by": by, "library_ms": lms})
    rows[0]["forward_with_lse_ms"] = lse_ms
    del q, k, v, do, o, lse, qt, kt, vt, out, dot
    torch.cuda.empty_cache()
    return rows


def check_ssd_zamba(dev) -> list:
    """The scan forward and backward at the hybrid path's shape (4, 4608,
    80 heads of 64, state 64, chunk 128, bf16, x, bm and cm as column
    slices of one buffer as the model passes them), which take the f32 FMA
    passes (state 64 is no shape of the tensor-core kernels): against the
    plain versions at phase 10's and 14's bf16 bands, on the FMA variant,
    then their times (replayed graphs), the plain versions' and the byte
    bounds.  Returns the two kernel rows."""
    g = torch.Generator(device=dev).manual_seed(26)
    B, L, H, P, N, Q = (B_SERVE, HY_SEQ, HY_SSD_HEADS, SSM_HEAD_DIM,
                        HY_STATE, SSM_CHUNK)
    x, dt, a, bm, cm = _ssd_inputs(g, dev, B, L, H, P, N, "mamba2",
                                   torch.bfloat16)
    x, bm, cm = _ssd_conv_slices(x, bm, cm)
    dy = torch.randn(x.shape, generator=g, device=dev).to(x.dtype)
    before = all_variants()
    y, hT = ssd_scan(x, dt, a, bm, cm, chunk=Q)
    grads = ssd_scan_bwd(x, dt, a, bm, cm, dy, None, chunk=Q)
    ran = all_variants()
    for name in ("ssd_scan", "ssd_scan_bwd"):
        if ran[name]["fma"] - before[name]["fma"] != 1:
            fail(f"{name} at the zamba2 shape did not run the FMA passes")
    y_ref, h_ref = ref.ssd_chunked_ref(x, dt, a, bm, cm, Q)
    want = ref.ssd_scan_bwd_ref(x, dt, a, bm, cm, dy, None, Q)
    torch.cuda.synchronize()
    y_err, h_err = _rel(y, y_ref), _rel(hT, h_ref)
    g_err = [_rel(a_, b_) for a_, b_ in zip(grads, want)]
    log(f"  ssd_scan zamba2 shape (B={B}, L={L}, H={H}, P={P}, N={N}, Q={Q}) "
        f"bf16 (fma): y {y_err:.2e}, final state {h_err:.2e} of max|plain| "
        f"(bands {SSD_Y_BAND[torch.bfloat16]}, {SSD_H_BAND}); backward "
        + ", ".join(f"{n} {e:.2e}" for n, e in zip(SSD_GRADS, g_err))
        + f" (band {SSD_BWD_BAND[torch.bfloat16]})")
    if y_err > SSD_Y_BAND[torch.bfloat16] or h_err > SSD_H_BAND:
        fail("ssd_scan off at the zamba2 shape")
    if max(g_err) > SSD_BWD_BAND[torch.bfloat16]:
        fail("ssd_scan_bwd off at the zamba2 shape")
    del y, hT, grads, y_ref, h_ref, want
    torch.cuda.empty_cache()
    ms = graph_ms(lambda: ssd_scan(x, dt, a, bm, cm, chunk=Q), 5)
    bwd_ms = graph_ms(lambda: ssd_scan_bwd(x, dt, a, bm, cm, dy, None,
                                           chunk=Q), 3)
    plain_ms = cuda_ms(lambda: ref.ssd_chunked_ref(x, dt, a, bm, cm, Q), 2, 1)
    plain_bwd_ms = cuda_ms(lambda: ref.ssd_scan_bwd_ref(
        x, dt, a, bm, cm, dy, None, Q), 1, 1)
    rows = []
    for name, kms, pms, bound_fn, rep_ in (
            ("ssd_scan_zamba2", ms, plain_ms, _ssd_fwd_bound,
             "src/repro/kernels/ssd_scan.py:77"),
            ("ssd_scan_bwd_zamba2", bwd_ms, plain_bwd_ms, _ssd_bwd_bound,
             "none (JAX autodiff of src/repro/models/ssm.py:84)")):
        bound, by, nbytes, flops = bound_fn(B, L, H, P, N, Q)
        log(f"  {name} (B={B}, L={L}, H={H}, P={P}, N={N}, Q={Q}) bf16 on "
            f"the FMA passes: {kms:.4f} ms on the device, plain {pms:.3f} "
            f"ms, bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP)")
        src = "ssd_scan.cu" if "bwd" not in name else "ssd_scan_bwd.cu"
        rows.append({
            "name": name, "route": "cuda", "variant": "fma",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": rep_,
            "max_abs_err": y_err if "bwd" not in name else max(g_err),
            "max_rel_err": y_err if "bwd" not in name else max(g_err),
            "ms": kms, "plain_ms": pms, "bound_ms": bound, "bound_by": by,
            "library_ms": None})
    del x, dt, a, bm, cm, dy
    torch.cuda.empty_cache()
    return rows


def kernels_d80(dev) -> list:
    """Phase 25: the D = 80 attention rows and the zamba2-shape scan
    rows."""
    return check_attention_d80(dev) + check_ssd_zamba(dev)


# ----------------------------------------------------------------- phase 26
def _hy_argv(dtype: str) -> list:
    return ["--arch", HY_ARCH, "--sde", "flow_sde", "--device", "cuda",
            "--requests", str(B_SERVE), "--max-batch", str(B_SERVE),
            "--bucket", str(B_SERVE),
            "--set", f"flow.num_steps={NUM_STEPS}",
            "--set", f"flow.latent_tokens={LAT_TOKENS}",
            "--set", f"flow.latent_dim={LAT_DIM}",
            "--set", f"param_dtype={dtype}",
            "--set", "data.encoder=" + json.dumps(
                {"cond_dim": COND_DIM, "cond_len": HY_COND_LEN})]


def hybrid_serve_path(dev) -> dict:
    """``repro_torch.launch.serve.main`` serving 4 requests of zamba2-2.7b
    (54 layers, bf16, random weights from a seed) over 511 + 1 + 4096
    tokens under flow_sde, 4 steps: launch counts (a velocity: ``ssd_scan``
    54, all on the FMA passes, ``flash_attention`` 9, all on the tensor
    cores), the latents bitwise ``rollout_keyed``'s through the kernels,
    s per step, req/s, peak memory and a profile of one step; then the
    velocity at depth 2 (``depth_cfg``) with the SSM leaves and the shared
    wq/wk drawn, through the kernels against the plain versions, in f32
    (the FMA kernels) and in bf16 (the tensor-core attention)."""
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = serve.main(_hy_argv("bfloat16"))
    launches = counts()
    ran = all_variants()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    stats, lat, eng = out["stats"], out["latents"], out["engine"]
    batches = len(out["warmup"]) + sum(stats["dispatches"].values())
    serve_batches = sum(stats["dispatches"].values())
    want = {name: 0 for name in launches}
    want["sde_step"] = NUM_STEPS * batches
    want["ssd_scan"] = HY_LAYERS * NUM_STEPS * batches
    want["flash_attention"] = HY_SITES * NUM_STEPS * batches
    log(f"  launches {launches} over {batches} batches (warmup + serve; "
        f"expected {want}); variants {ran}")
    if eng.adapter.cfg.n_layers != HY_LAYERS:
        fail(f"served {eng.adapter.cfg.n_layers} layers, not {HY_LAYERS}")
    if tuple(lat.shape) != (B_SERVE, LAT_TOKENS, LAT_DIM) or not \
            torch.isfinite(lat).all():
        fail(f"hybrid latents: shape {tuple(lat.shape)} or not finite")
    if launches != want or any(
            ran[k] != routed(want[k], HY_ROUTES[k])
            for k in ("ssd_scan", "flash_attention")):
        fail("the hybrid serving path's kernel launches do not match the "
             "path")
    prompts = synthetic_prompts(B_SERVE)
    cond = torch.from_numpy(eng.encode(prompts)).to(eng.device)
    with torch.no_grad():
        traj = rollout_keyed(eng.adapter, eng.params, cond,
                             request_seeds(0, B_SERVE), eng.scheduler,
                             NUM_STEPS)
    if not torch.equal(traj.x0.cpu(), lat):
        fail("the hybrid engine's latents differ from rollout_keyed's")
    del traj
    serve_s = out["serve_s"]
    res = {"launches": launches, "variants": ran, "batches": batches,
           "req_per_s": B_SERVE / serve_s,
           "s_per_step": serve_s / (serve_batches * NUM_STEPS),
           "serve_s": serve_s, "warmup_s": out["warmup_s"],
           "peak_bytes": peak,
           "n_params": params_lib.n_params(eng.adapter.spec()),
           "latents_equal_rollout_keyed": True}
    log(f"  hybrid path: {res['req_per_s']:.4f} req/s, "
        f"{res['s_per_step']:.4f} s per denoising step (batch {B_SERVE}), "
        f"max_memory_allocated {peak / 2**30:.2f} GiB ({peak} bytes), "
        f"{res['n_params']} params; latents bitwise rollout_keyed's")
    res["profile"] = profile_step(eng, HY_SEQ)
    del eng, out
    gc.collect()
    torch.cuda.empty_cache()
    res["velocity_checks"] = check_hybrid_velocity(dev)
    return res


def check_hybrid_velocity(dev) -> dict:
    """``FlowAdapter.velocity`` of zamba2-2.7b at full width and depth 2
    (two groups of one SSM block and the shared block: ``depth_cfg``) over
    511 + 1 + 4096 tokens, SSM leaves and shared wq/wk drawn, through the
    kernels against the plain versions: in f32 (every kernel's f32 FMA
    variant) within F32_VEL_BAND of max |v|, and in bf16 (the attention
    on the tensor cores at D = 80) within BF16_BAND."""
    cfg = depth_cfg(HY_ARCH, UPDATE_LAYERS)
    adapter = FlowAdapter(cfg, FlowRLConfig(latent_tokens=LAT_TOKENS,
                                            latent_dim=LAT_DIM), COND_DIM)
    out = {}
    for name, dtype, band in (("f32", torch.float32, F32_VEL_BAND),
                              ("bf16", torch.bfloat16, BF16_BAND)):
        gen = torch.Generator(device=dev).manual_seed(27)
        p = params_lib.init(adapter.spec(), gen, dtype, dev)
        draw_hybrid(p, cfg, seed=28)
        x = torch.randn(1, LAT_TOKENS, LAT_DIM, generator=gen, device=dev)
        cond = torch.randn(1, HY_COND_LEN, COND_DIM, generator=gen,
                           device=dev)
        t = torch.full((1,), 0.7, device=dev)
        reset_counts()
        with torch.no_grad():
            vk = adapter.velocity(p, x, t, cond)
            ran, variants = counts(), all_variants()
            with plain_dispatch():
                vp = adapter.velocity(p, x, t, cond)
        torch.cuda.synchronize()
        err, scale = float((vk - vp).abs().max()), float(vp.abs().max())
        attn = "wgmma" if dtype == torch.bfloat16 else "fma"
        log(f"  velocity {HY_ARCH} depth {UPDATE_LAYERS} (2 groups), {name}: "
            f"max|kernel - plain| {err:.3e} of max|v| {scale:.3e} (band "
            f"{band * scale:.3e}); launches {ran}, variants {variants}")
        if (ran["ssd_scan"], ran["flash_attention"]) != (2, 2) or \
                variants["ssd_scan"] != routed(2, "fma") or \
                variants["flash_attention"] != routed(2, attn):
            fail(f"the {name} hybrid velocity did not run its kernels")
        if not (torch.isfinite(vk).all() and err <= band * scale):
            fail(f"the {name} hybrid velocity is off its band")
        out[name] = {"max_abs_err": err, "max_abs": scale,
                     "band": band * scale}
        del p
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------- phase 27
HY_TRAIN_LAYERS = 54


def _hy_watch():
    return _TrainWatch("ssm", ("conv_w", "conv_b", "a_log"),
                       ("a_log", "dt_bias"),
                       lambda p, cfg: draw_hybrid(p, cfg, seed=29),
                       stack_dims=2)


def hybrid_train_path(dev, tmp: str) -> dict:
    """zamba2-2.7b at full width and all 54 layers through ``launch.train``
    under ``perf.remat=block`` (each group checkpointed) with
    ``perf.log_memory``, flow_grpo, phase 19's geometry, batch and rewards,
    SSM leaves and shared wq/wk drawn at train start, 2 steps and a traced
    third: launch counts (a velocity 54 scans and 9 attentions, the loss
    each forward twice, the backward once, per SDE step), every layer's
    a_log and dt_bias gradient at the first update, s per step, peak
    memory; then one update of each of the five trainers at depth 2
    against the plain versions (``check_updates``)."""
    row, trainer = train_one(
        tmp, HY_ARCH, HY_TRAIN_LAYERS, HY_COND_LEN, HY_KERNELS, _hy_watch(),
        "flow_grpo", TRAIN_STEPS,
        extra=BLOCK + ("--set", "perf.log_memory=true"), tag="block",
        remat="block", routes=HY_ROUTES,
        profile_what=f"one {HY_ARCH} train step under remat=block, "
                     f"{HY_TRAIN_LAYERS} layers")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return {"block": row, "update_check": check_updates(dev, HY_ARCH)}


# ----------------------------------------------------------------- phase 28
DS_ARCH, GROK_ARCH = "deepseek-v2-236b", "grok-1-314b"
MLA_HEADS, MLA_QK, MLA_V = 128, 192, 128
MLA_CASES = [  # B, Sq, Sk, H, K, causal, window, dtype
    (B_SERVE, HY_SEQ, HY_SEQ, MLA_HEADS, MLA_HEADS, True, 0, torch.bfloat16),
    (B_SERVE, HY_SEQ, HY_SEQ, MLA_HEADS, MLA_HEADS, True, 0, torch.float32),
    (1, 129, 129, 2, 1, True, 0, torch.bfloat16),
    (1, 129, 129, 2, 1, True, 0, torch.float32),
    (2, 77, 130, 4, 2, True, 0, torch.bfloat16),
    (2, 77, 130, 4, 2, True, 0, torch.float32),
    (1, 1000, 1000, 4, 2, True, 256, torch.bfloat16),
    (1, 300, 300, 4, 2, False, 0, torch.bfloat16),
]
# heads of one plain call at the path shape: (1, 4608, 32, 4608) f32
# scores are 2.7 GB (all 128 heads would be 10.9 GB, and the backward
# holds several such tensors)
MLA_PLAIN_HEADS = 32


def _mla_plain(fn, q, k, v, *rest, causal=True, window=0):
    """``fn`` (a plain attention forward or backward) one batch row and
    ``MLA_PLAIN_HEADS`` kv heads (with their query heads) at a time,
    concatenated back: the same function, within the card's memory."""
    B, H, K = q.shape[0], q.shape[2], k.shape[2]
    G, step = H // K, max(1, MLA_PLAIN_HEADS // (H // K))
    outs = []
    for i in range(B):
        parts = []
        for k0 in range(0, K, step):
            qs = slice(k0 * G, (k0 + step) * G)
            ks = slice(k0, k0 + step)
            args = [q[i:i + 1, :, qs], k[i:i + 1, :, ks], v[i:i + 1, :, ks]]
            for t in rest:   # o, lse (B, H, Sq), do: query-head tensors
                args.append(t[i:i + 1, qs] if t.dim() == 3
                            else t[i:i + 1, :, qs])
            parts.append(fn(*args, causal=causal, window=window))
        outs.append(parts)
    def join(pieces):   # heads are dim 1 of lse (B, H, Sq), else dim 2
        return torch.cat(pieces, dim=1 if pieces[0].dim() == 3 else 2)

    if isinstance(outs[0][0], torch.Tensor):
        return torch.cat([join(parts) for parts in outs])
    return tuple(torch.cat([join([p[j] for p in parts]) for parts in outs])
                 for j in range(len(outs[0][0])))


def _mla_flops(backward: bool = False) -> float:
    """Operations of the causal attention at the MLA path's shape: each
    product over the half of the score matrix the mask keeps (S (S + 1) /
    2 pairs), 2 flops a multiply-add; forward QK^T at 192 and PV at 128,
    backward QK^T and dO V^T recomputed, dV at 128, dQ and dK at 192."""
    pairs = B_SERVE * MLA_HEADS * HY_SEQ * (HY_SEQ + 1) / 2
    dims = (MLA_QK + MLA_V + MLA_V + MLA_QK + MLA_QK if backward
            else MLA_QK + MLA_V)
    return 2 * pairs * dims


def _row_errs(got, want) -> list:
    """For each pair: the largest over rows (every index but the last dim)
    of max |got - want| in the row over the row's scale, its max |want|
    but at least ``ROW_FLOOR`` of the median row's.  The floor is for a row
    whose plain result vanishes by cancellation: under a causal mask dq's
    first query row sees one key, where dS = P (dP - delta) is 0."""
    out = []
    for a, b in zip(got, want):
        b = b.float()
        scale = b.abs().amax(-1)
        scale = scale.clamp_min(ROW_FLOOR * float(scale.median()))
        err = (a.float() - b).abs().amax(-1)
        out.append(float((err / scale).max()))
        del b, scale, err
    return out


def _mla_row_check_power(q, k, v, o, lse, do, r, got, want, band) -> None:
    """The per-row check against two wrong kernels at the path shape: o
    whose later half of the query rows read each value row one key late
    (v rolled by one key), and dv whose later half of the key rows took
    each upstream gradient one query late (do rolled by one query).  Both
    must fail the row band; printed beside what the whole-tensor limit of
    phases 3 and 25 (``PATH_ATTN_BAND`` x max |plain|) would say."""
    half = q.shape[1] // 2
    wrong = o.clone()
    wrong[:, half:] = flash_attention(q, k, v.roll(1, 1))[:, half:]
    wrong_dv = got[2].clone()
    wrong_dv[:, half:] = flash_attention_bwd(q, k, v, o, lse,
                                             do.roll(1, 1))[2][:, half:]
    for name, bad, plain in (("o", wrong, r), ("dv", wrong_dv, want[2])):
        (row,) = _row_errs([bad], [plain])
        whole = float((bad.float() - plain.float()).abs().max())
        old = PATH_ATTN_BAND * float(plain.float().abs().max())
        log(f"  (192, 128) a wrong {name} (later half one row late): per-row "
            f"{row:.3e} (band {band}); max|err| {whole:.3e} against the "
            f"whole-tensor limit {old:.3e}: "
            f"{'passes' if whole <= old else 'fails'} there")
        if row <= band:
            fail(f"the per-row check passes a wrong {name} at (192, 128)")
    del wrong, wrong_dv
    torch.cuda.empty_cache()


def check_attention_mla(dev) -> list:
    """The attention forward (o and its LSE) and backward at a query/key
    dim of 192 and a value dim of 128 (DeepSeek-V2's latent attention)
    against their plain versions and torch.autograd through the plain
    forward, with phase 3's bands: the path shape (4, 4608, 128 / 128
    heads, causal) in bf16 on the tensor-core kernels and in f32 on the FMA
    kernels, ragged (1, 129, 2 / 1) and (2, 77 queries over 130 keys, 4 /
    2), a window of 256 over 1000 and a bidirectional case.  At the path
    shape every row is also held to ``ROW_BAND`` of its own max |plain|
    (``_row_errs``), and that check must reject two wrong kernels
    (``_mla_row_check_power``).  Each call must
    run the variant its dtype calls for (``variant_launches``), and the
    wrapper must refuse a pair it has no kernel for.  Then the times and
    bounds at the path shape (``_attention_mla_times``).  Returns the two
    kernel rows."""
    g = torch.Generator(device=dev).manual_seed(28)
    errs = {}
    try:
        z = torch.zeros(1, 8, 1, MLA_QK, device=dev, dtype=torch.bfloat16)
        flash_attention(z, z, z[..., :64])
        fail("flash_attention accepted (192, 64) head dims")
    except ValueError as e:
        log(f"  (192, 64) refused: {e}")
    for (B, Sq, Sk, H, K, causal, window, dt) in MLA_CASES:
        q = torch.randn(B, Sq, H, MLA_QK, generator=g, device=dev).to(dt)
        k = torch.randn(B, Sk, K, MLA_QK, generator=g, device=dev).to(dt)
        v = torch.randn(B, Sk, K, MLA_V, generator=g, device=dev).to(dt)
        do = torch.randn(B, Sq, H, MLA_V, generator=g, device=dev).to(dt)
        variant = "wgmma" if dt == torch.bfloat16 else "fma"
        if fa_mod.tensor_core_route(q, k, v) != (variant == "wgmma"):
            fail(f"tensor_core_route disagrees with the dtype rule at "
                 f"{(B, Sq, Sk, H, K)} {dt}")
        before = all_variants()
        o, lse = flash_attention(q, k, v, causal=causal, window=window,
                                 return_lse=True)
        o2 = flash_attention(q, k, v, causal=causal, window=window)
        got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                  window=window)
        ran = all_variants()
        if ran["flash_attention"][variant] - before[
                "flash_attention"][variant] != 2 or ran[
                "flash_attention_bwd"][variant] - before[
                "flash_attention_bwd"][variant] != 1:
            fail(f"the (192, 128) attention {dt} did not run its {variant} "
                 f"kernels: {before} -> {ran}")
        if tuple(o.shape) != (B, Sq, H, MLA_V) or not torch.equal(o, o2):
            fail("the (192, 128) forward's o has the wrong shape or moves "
                 "with return_lse")
        r, lse_ref = _mla_plain(ref.flash_attention_fwd_ref, q, k, v,
                                causal=causal, window=window)
        want = _mla_plain(ref.flash_attention_bwd_ref, q, k, v, o, lse, do,
                          causal=causal, window=window)
        hs = min(H, MLA_PLAIN_HEADS)
        ks = max(1, hs * K // H)
        leaves = [q[:1, :, :hs].float().requires_grad_(),
                  k[:1, :, :ks].float().requires_grad_(),
                  v[:1, :, :ks].float().requires_grad_()]
        ref.flash_attention_ref(*leaves, causal=causal, window=window
                                ).backward(do[:1, :, :hs].float())
        torch.cuda.synchronize()
        err = float((o.float() - r.float()).abs().max())
        lse_err = float((lse - lse_ref).abs().max()) / max(
            1.0, float(lse_ref.abs().max()))
        gerr = _grad_errs(got, want)
        got0 = [got[0][:1, :, :hs], got[1][:1, :, :ks], got[2][:1, :, :ks]]
        autos = [a.grad for a in leaves]
        auto = _grad_errs(got0, autos)
        path = Sq == HY_SEQ
        band = ATTN_BWD_BAND[dt]
        if path:
            # each row (query row of o and dq, key row of dk and dv) at its
            # own scale: max |plain| over the whole tensor is set by the
            # first rows (o's row 0 is v_0), 3-4 times a late row's.  The
            # backward is held so against the plain backward, which takes
            # the kernel's o and lse; autograd recomputes o in f32, and
            # where a row's dq or dk nearly cancels, the forward's bf16
            # rounding of o (through delta = rowsum(dO o)) is most of the
            # row, so autograd keeps the whole-tensor band (its per-row
            # reading is printed)
            row_band = ROW_BAND[dt]
            (row_o,), rows_g = _row_errs([o], [r]), _row_errs(got, want)
            rows_a = _row_errs(got0, autos)
            limit = row_band
            ok = row_o <= row_band
            log(f"  (192, 128) path {dt}: per-row max|err| / max|plain| of "
                f"the row: o {row_o:.3e}; dq/dk/dv vs plain "
                f"{rows_g[0]:.3e}/{rows_g[1]:.3e}/{rows_g[2]:.3e} (band "
                f"{row_band} a row); vs autograd {rows_a[0]:.3e}/"
                f"{rows_a[1]:.3e}/{rows_a[2]:.3e}")
            if max(rows_g) > row_band:
                fail(f"flash_attention_bwd off at (192, 128), a row past "
                     f"its band at {(B, Sq, Sk, H, K)} {dt}")
            if dt == torch.bfloat16:
                _mla_row_check_power(q, k, v, o, lse, do, r, got, want,
                                     row_band)
        else:
            tol = 2e-5 if dt == torch.float32 else 2e-2
            limit = tol
            ok = torch.allclose(o.float(), r.float(), atol=tol, rtol=tol)
        log(f"  (192, 128) B={B} Sq={Sq} Sk={Sk} H={H} K={K} causal={causal}"
            f" window={window} {dt} ({variant}): o max|err| {err:.3e} "
            f"(limit {limit:.3e}{' a row' if path else ''}), lse "
            f"{lse_err:.2e}; dq/dk/dv vs plain {gerr[0]:.2e}/{gerr[1]:.2e}/"
            f"{gerr[2]:.2e}, vs autograd {auto[0]:.2e}/{auto[1]:.2e}/"
            f"{auto[2]:.2e} of max|plain| (band {band})")
        if not ok or lse_err > LSE_BAND:
            fail(f"flash_attention off at (192, 128), "
                 f"{(B, Sq, Sk, H, K)} {dt}")
        if max(gerr + auto) > band:
            fail(f"flash_attention_bwd off at (192, 128), "
                 f"{(B, Sq, Sk, H, K)} {dt}")
        if path:
            errs[dt] = (err, max(float((a.float() - b.float()).abs().max())
                                 for a, b in zip(got, want)))
        del q, k, v, do, o, o2, lse, got, want, r, lse_ref, leaves
        torch.cuda.empty_cache()
    return _attention_mla_times(dev, g, errs)


def _sdpa_mla_ms(q, k, v, do) -> tuple:
    """SDPA's forward and backward ms at (192, 128) on its fused backends
    (flash, memory-efficient, cuDNN; the math backend would hold the whole
    score matrix), or (None, None, reason) where none of them takes the
    pair."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (a.transpose(1, 2).detach().requires_grad_()
                  for a in (q, k, v))
    try:
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                          SDPBackend.EFFICIENT_ATTENTION,
                          SDPBackend.CUDNN_ATTENTION]):
            with torch.no_grad():
                fwd = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True), 5)
            out = sdpa(qt, kt, vt, is_causal=True)
            dot = do.transpose(1, 2)
            bwd = cuda_ms(lambda: torch.autograd.grad(
                out, (qt, kt, vt), dot, retain_graph=True), 3)
        return fwd, bwd, "fused SDPA backend"
    except RuntimeError as e:
        return None, None, f"no fused SDPA backend takes it: {e}"[:300]


def _attention_mla_times(dev, g, errs) -> list:
    """Forward and backward at the MLA path shape (4, 4608, 128 heads,
    192 / 128, causal): the bf16 kernels and the f32 FMA kernels from
    replayed graphs, the plain versions (``_mla_plain``) and SDPA with CUDA
    events, and the bounds (``_mla_flops`` at the bf16 tensor-core rate;
    each input read once, each output written once)."""
    B, S, H = B_SERVE, HY_SEQ, MLA_HEADS
    q, k = (torch.randn(B, S, H, MLA_QK, generator=g, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    v, do = (torch.randn(B, S, H, MLA_V, generator=g, device=dev,
                         dtype=torch.bfloat16) for _ in range(2))
    o, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    ms = graph_ms(lambda: flash_attention(q, k, v, causal=True), 3)
    lse_ms = graph_ms(lambda: flash_attention(q, k, v, causal=True,
                                              return_lse=True), 3)
    bwd_ms = graph_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                                  causal=True), 2)
    q32, k32, v32, do32 = (a.float() for a in (q, k, v, do))
    o32, lse32 = flash_attention(q32, k32, v32, causal=True, return_lse=True)
    fma_ms = graph_ms(lambda: flash_attention(q32, k32, v32, causal=True), 1,
                      2)
    fma_bwd_ms = graph_ms(lambda: flash_attention_bwd(
        q32, k32, v32, o32, lse32, do32, causal=True), 1, 2)
    del q32, k32, v32, do32, o32, lse32
    torch.cuda.empty_cache()
    plain_ms = cuda_ms(lambda: _mla_plain(ref.flash_attention_ref, q, k, v),
                       1, 0)
    torch.cuda.empty_cache()
    plain_bwd_ms = cuda_ms(lambda: _mla_plain(
        ref.flash_attention_bwd_ref, q, k, v, o, lse, do), 1, 0)
    torch.cuda.empty_cache()
    sdpa_ms, sdpa_bwd_ms, sdpa_note = _sdpa_mla_ms(q, k, v, do)
    torch.cuda.empty_cache()
    el = 2   # bf16 bytes
    fwd_bytes = (q.numel() + k.numel() + v.numel() + o.numel()) * el
    bwd_bytes = (2 * q.numel() + 2 * k.numel() + 2 * v.numel()
                 + o.numel() + do.numel()) * el + 4 * lse.numel()
    rows = []
    for name, kms, fms, pms, lms, flops, nbytes, src, rep_ in (
            ("flash_attention_mla", ms, fma_ms, plain_ms, sdpa_ms,
             _mla_flops(), fwd_bytes, "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:81"),
            ("flash_attention_bwd_mla", bwd_ms, fma_bwd_ms, plain_bwd_ms,
             sdpa_bwd_ms, _mla_flops(True), bwd_bytes,
             "flash_attention_bwd.cu",
             "none (JAX autodiff of src/repro/models/layers.py "
             "attention_chunked, called at src/repro/models/mla.py:108)")):
        bound, by = _bound(nbytes, flops)
        lib = "none" if lms is None else f"{lms:.4f} ms"
        log(f"  {name} path ({B}, {S}, {H} / {H} heads, 192 / 128) causal "
            f"bf16: kernel {kms:.4f} ms (wgmma), the f32 FMA kernel "
            f"{fms:.4f} ms, plain {pms:.3f} ms (32 heads of a batch row "
            f"at a time), SDPA{' backward' if 'bwd' in name else ''} {lib} "
            f"({sdpa_note}), bound {bound:.4f} ms ({flops / 1e12:.4f} TFLOP,"
            f" {nbytes / 1e6:.1f} MB)")
        rows.append({
            "name": name, "route": "cuda", "variant": "wgmma",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": rep_,
            "max_abs_err": errs[torch.bfloat16][0 if "bwd" not in name
                                                else 1],
            "max_abs_err_f32": errs[torch.float32][0 if "bwd" not in name
                                                   else 1],
            "ms": kms, "fma_ms": fms, "plain_ms": pms, "bound_ms": bound,
            "bound_by": by, "library_ms": lms, "library_note": sdpa_note})
    rows[0]["forward_with_lse_ms"] = lse_ms
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------ phases 29-31
# the MoE family at published width over the hybrid's geometry (511 + 1 +
# 4096 tokens): deepseek-v2-236b served at 6 layers (the dense one and 5
# MoE layers of 160 routed experts top-6 and 2 shared: ~21.3 B params) and
# trained at 2 (the dense one and 1 MoE), grok-1-314b served at 4 (8
# experts top-2 of width 32768): 236 B and 314 B params do not fit one card
DS_SERVE_LAYERS, DS_TRAIN_LAYERS, GROK_SERVE_LAYERS = 6, 2, 4
MOE_ROUTES = {"flash_attention": "wgmma", "flash_attention_bwd": "wgmma"}
# the trainers' comparison at depth 2: 511 + 1 + 512 tokens (the plain
# attention's (2, 1024, 128, 1024) f32 scores) and 32 routed experts (two
# trainers' params, grads and AdamW moments at 160 experts take ~86 GB)
MOE_UPDATE_LAT, MOE_UPDATE_EXPERTS = 512, 32


def draw_qk_proj(p: dict, cfg, seed: int) -> None:
    """The attention's query and key projections redrawn in place: GQA's
    wq/wk at std 1/sqrt(d_model) (``draw_attention``'s reason), MLA's
    w_uq/w_uk at 1/sqrt(their latent rank) (the repository's init takes
    their fan-in from the head axis: tests/test_torch_moe.py)."""
    bb = p["backbone"]
    gen = torch.Generator(device=bb["final_norm"].device).manual_seed(seed)
    for stack in ("dense_blocks", "blocks"):
        if stack not in bb:
            continue
        attn = bb[stack]["attn"]
        for key in ("wq", "wk", "w_uq", "w_uk"):
            if key in attn:
                w = attn[key]
                fan_in = cfg.d_model if key in ("wq", "wk") else w.shape[-3]
                w.copy_(torch.randn(w.shape, generator=gen, device=w.device)
                        / fan_in ** 0.5)


@contextlib.contextmanager
def routing(record=None, replay=None):
    """Each MoE call's expert assignments appended to ``record``, or
    replaced by the next of ``replay`` (the gates then taken from the
    call's own probabilities at those experts, renormalised as the router
    does): a comparison aid of this script, so that a plain pass can take
    the kernel pass's routing where the two differ by a near-tie."""
    saved = moe_mod.route

    def route(p, cfg, xg):
        logits, probs, gates, idx = saved(p, cfg, xg)
        if record is not None:
            record.append(idx.clone())
        if replay is not None:
            idx = replay.pop(0)
            gates = probs.gather(-1, idx)
            gates = gates / torch.clamp(gates.sum(-1, keepdim=True),
                                        min=1e-9)
        return logits, probs, gates, idx

    moe_mod.route = route
    try:
        yield
    finally:
        moe_mod.route = saved


def _assign_diff(a: list, b: list) -> int:
    """Token-expert assignments of two recorded routings that differ."""
    return sum(int((x.sort(-1).values != y.sort(-1).values).sum())
               for x, y in zip(a, b))


def _moe_argv(arch: str, layers: int) -> list:
    return ["--arch", arch, "--sde", "flow_sde", "--device", "cuda",
            "--requests", str(B_SERVE), "--max-batch", str(B_SERVE),
            "--bucket", str(B_SERVE),
            "--set", "arch_overrides=" + json.dumps({"n_layers": layers}),
            "--set", f"flow.num_steps={NUM_STEPS}",
            "--set", f"flow.latent_tokens={LAT_TOKENS}",
            "--set", f"flow.latent_dim={LAT_DIM}",
            "--set", "param_dtype=bfloat16",
            "--set", "data.encoder=" + json.dumps(
                {"cond_dim": COND_DIM, "cond_len": HY_COND_LEN})]


def moe_serve_path(arch: str, layers: int) -> dict:
    """``repro_torch.launch.serve.main`` serving 4 requests of ``arch`` at
    full width and ``layers`` layers (bf16, random weights from a seed)
    over 511 + 1 + 4096 tokens under flow_sde, 4 steps: launch counts (a
    velocity: ``flash_attention`` once a layer, all on the tensor cores;
    ``sde_step`` 4 per batch), the latents bitwise ``rollout_keyed``'s
    through the kernels, the share of routed assignments dropped at
    capacity in each MoE layer over that rollout, s per step, req/s, peak
    memory and a profile of one step."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = serve.main(_moe_argv(arch, layers))
    launches = counts()
    ran = all_variants()
    pairs = pair_counts()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    stats, lat, eng = out["stats"], out["latents"], out["engine"]
    batches = len(out["warmup"]) + sum(stats["dispatches"].values())
    serve_batches = sum(stats["dispatches"].values())
    want = {name: 0 for name in launches}
    want["sde_step"] = NUM_STEPS * batches
    want["flash_attention"] = layers * NUM_STEPS * batches
    log(f"  launches {launches} over {batches} batches (warmup + serve; "
        f"expected {want}); variants {ran}")
    cfg = eng.adapter.cfg
    if cfg.n_layers != layers or cfg.d_model != configs.get(arch).d_model:
        fail(f"served {cfg.n_layers} layers of width {cfg.d_model}")
    if tuple(lat.shape) != (B_SERVE, LAT_TOKENS, LAT_DIM) or not \
            torch.isfinite(lat).all():
        fail(f"{arch} latents: shape {tuple(lat.shape)} or not finite")
    # every attention of the path at the arch's one dim pair
    hd = cfg.resolved_head_dim
    pair = f"{MLA_QK}x{MLA_V}" if cfg.mla else f"{hd}x{hd}"
    log(f"  launches by dim pair {pairs}")
    if launches != want or ran["flash_attention"] != routed(
            want["flash_attention"], "wgmma") or pairs[
            "flash_attention"][pair] != want["flash_attention"]:
        fail(f"the {arch} serving path's kernel launches do not match the "
             "path")
    prompts = synthetic_prompts(B_SERVE)
    cond = torch.from_numpy(eng.encode(prompts)).to(eng.device)
    assigned = []
    with torch.no_grad(), routing(record=assigned):
        traj = rollout_keyed(eng.adapter, eng.params, cond,
                             request_seeds(0, B_SERVE), eng.scheduler,
                             NUM_STEPS)
    # each MoE call's share of routed assignments past its experts'
    # capacity (the router's assignments through the dispatch's own slots)
    cap = moe_mod.capacity(HY_SEQ, cfg)
    n_moe = layers - cfg.moe.first_k_dense
    drops = torch.stack([
        1.0 - moe_mod._slots(idx, cfg.moe.n_experts, cap)[1].float().mean()
        for idx in assigned]).view(NUM_STEPS, n_moe)
    if not torch.equal(traj.x0.cpu(), lat):
        fail(f"the {arch} engine's latents differ from rollout_keyed's")
    del traj
    per_layer = [float(v) for v in drops.mean(0)]
    serve_s = out["serve_s"]
    res = {"layers": layers, "launches": launches, "variants": ran,
           "pair_launches": pairs,
           "batches": batches, "req_per_s": B_SERVE / serve_s,
           "s_per_step": serve_s / (serve_batches * NUM_STEPS),
           "serve_s": serve_s, "warmup_s": out["warmup_s"],
           "peak_bytes": peak,
           "n_params": params_lib.n_params(eng.adapter.spec()),
           "capacity": cap,
           "dropped_share_per_moe_layer": per_layer,
           "dropped_share_per_step": [float(v) for v in drops.mean(1)],
           "latents_equal_rollout_keyed": True}
    log(f"  {arch} path ({layers} layers): {res['req_per_s']:.4f} req/s, "
        f"{res['s_per_step']:.4f} s per denoising step (batch {B_SERVE}), "
        f"max_memory_allocated {peak / 2**30:.2f} GiB ({peak} bytes), "
        f"{res['n_params']} params; latents bitwise rollout_keyed's; "
        f"capacity {res['capacity']} slots an expert, routed assignments "
        f"dropped per MoE layer {[f'{v:.4f}' for v in per_layer]}")
    res["profile"] = profile_step(eng, HY_SEQ)
    del eng, out
    gc.collect()
    torch.cuda.empty_cache()
    return res


def check_moe_velocity(dev, arch: str) -> dict:
    """``FlowAdapter.velocity`` of ``arch`` at full width and depth 2 (for
    deepseek the dense layer and one MoE layer of 160 experts) over 511 +
    1 + 4096 tokens, batch 1, the attention's query and key projections
    drawn (``draw_qk_proj``), through the kernels and through the plain
    versions, in bf16 and f32.  The router makes the comparison
    discontinuous: a near-tie among the experts flips on the attention's
    rounding.  So the plain pass takes the kernel pass's expert
    assignments (``routing``) and is held to the band (BF16_BAND, or
    F32_VEL_BAND in f32); the unforced plain pass's gap and its count of
    differing assignments are printed beside it without a band, and so is
    the forced gap at the repository's init (no draw)."""
    cfg = depth_cfg(arch, UPDATE_LAYERS)
    adapter = FlowAdapter(cfg, FlowRLConfig(latent_tokens=LAT_TOKENS,
                                            latent_dim=LAT_DIM), COND_DIM)
    out = {}
    for name, dtype, band, draw in (
            ("bf16", torch.bfloat16, BF16_BAND, True),
            ("f32", torch.float32, F32_VEL_BAND, True),
            ("bf16_repository_init", torch.bfloat16, None, False)):
        gen = torch.Generator(device=dev).manual_seed(31)
        p = params_lib.init(adapter.spec(), gen, dtype, dev)
        if draw:
            draw_qk_proj(p, cfg, seed=32)
        x = torch.randn(1, LAT_TOKENS, LAT_DIM, generator=gen, device=dev)
        cond = torch.randn(1, HY_COND_LEN, COND_DIM, generator=gen,
                           device=dev)
        t = torch.full((1,), 0.7, device=dev)
        rec_k, rec_p = [], []
        reset_counts()
        with torch.no_grad():
            with routing(record=rec_k):
                vk = adapter.velocity(p, x, t, cond)
            ran, variants = counts(), all_variants()
            with plain_dispatch():
                with routing(record=rec_p):
                    vu = adapter.velocity(p, x, t, cond)
                with routing(replay=list(rec_k)):
                    vp = adapter.velocity(p, x, t, cond)
        torch.cuda.synchronize()
        scale = float(vp.abs().max())
        err = float((vk - vp).abs().max())
        unforced = float((vk - vu).abs().max())
        n_diff = _assign_diff(rec_k, rec_p)
        n_all = sum(r.numel() for r in rec_k)
        attn = "wgmma" if dtype == torch.bfloat16 else "fma"
        bs = "no band" if band is None else f"band {band * scale:.3e}"
        log(f"  velocity {arch} depth {UPDATE_LAYERS}, {name}: max|kernel - "
            f"plain| {err:.3e} of max|v| {scale:.3e} ({bs}) with the plain "
            f"pass on the kernel pass's routing; unforced {unforced:.3e}, "
            f"{n_diff} of {n_all} assignments differ; launches {ran}, "
            f"variants {variants['flash_attention']}")
        if ran["flash_attention"] != UPDATE_LAYERS or \
                variants["flash_attention"] != routed(UPDATE_LAYERS, attn):
            fail(f"the {name} {arch} velocity did not run its kernels")
        if not torch.isfinite(vk).all() or (band is not None
                                            and err > band * scale):
            fail(f"the {name} {arch} velocity is off its band")
        out[name] = {"max_abs_err": err, "max_abs": scale,
                     "band": None if band is None else band * scale,
                     "unforced_max_abs_err": unforced,
                     "assignments_differing": n_diff,
                     "assignments": n_all}
        del p, vk, vp, vu
        gc.collect()
        torch.cuda.empty_cache()
    return out


def deepseek_serve_phase(dev) -> dict:
    """Phase 29."""
    res = {"serve": moe_serve_path(DS_ARCH, DS_SERVE_LAYERS)}
    res["velocity_checks"] = check_moe_velocity(dev, DS_ARCH)
    return res


def _ds_watch():
    # the moves are watched on the router (a copy of an expert table would
    # take 2.3 GiB beside the state); the first update's gradients on the
    # router and all three tables
    return _TrainWatch("ffn", ("router",),
                       ("router", "w_gate", "w_up", "w_down"),
                       lambda p, cfg: draw_qk_proj(p, cfg, seed=33))


def deepseek_train_phase(dev, tmp: str) -> dict:
    """Phase 30: deepseek-v2-236b at full width and 2 layers (the dense one
    and one MoE layer of 160 routed experts) through ``launch.train`` under
    ``perf.remat=block`` with ``perf.log_memory`` and
    ``perf.offload_rewards`` (the reward towers, 4.0 GiB at this geometry,
    wait on the host between uses: beside 50 GiB of state and one MoE
    layer's backward they do not fit) under the allocator's expandable
    segments, which the script sets for itself (without either, or AdamW's
    flat chunks, the cell runs out of memory:
    ``scripts/moe_train_memory.py``), flow_grpo, phase 19's
    batch, T and rewards over 511 + 1 + 4096 tokens, w_uq/w_uk drawn at
    train start, 2 steps and a traced third: launch counts (the attention
    forward once a layer a velocity, twice in the loss; its backward once
    a layer a loss backward; ``grpo_loss`` and its backward T each), the
    router's and expert tables' gradients at the first update, s per
    step, peak memory and ``memory_stats``; then one update of each of the
    five trainers at depth 2 against the plain versions
    (``check_moe_update``)."""
    kernels = ({"flash_attention": DS_TRAIN_LAYERS},
               {"flash_attention_bwd": DS_TRAIN_LAYERS})
    row, trainer = train_one(
        tmp, DS_ARCH, DS_TRAIN_LAYERS, HY_COND_LEN, kernels, _ds_watch(),
        "flow_grpo", TRAIN_STEPS,
        extra=BLOCK + ("--set", "perf.log_memory=true",
                       "--set", "perf.offload_rewards=true"),
        tag="block", remat="block", routes=MOE_ROUTES,
        profile_what=f"one {DS_ARCH} train step under remat=block, "
                     f"{DS_TRAIN_LAYERS} layers")
    del trainer
    gc.collect()   # the trainer's 50 GiB of state sit in reference cycles
    torch.cuda.empty_cache()
    pair = f"{MLA_QK}x{MLA_V}"
    if any(row["pair_launches"][k][pair] != row["launches"][k]
           for k in ("flash_attention", "flash_attention_bwd")):
        fail(f"the {DS_ARCH} train path ran an attention at another dim "
             f"pair than {pair}: {row['pair_launches']}")
    updates = {}
    for name in TRAINERS:
        updates[name] = check_moe_update(dev, name)
        gc.collect()
        torch.cuda.empty_cache()
    return {"block": row, "update_check": updates}


def check_moe_update(dev, name: str) -> dict:
    """One update of trainer ``name`` on deepseek-v2-236b at full width,
    depth 2 (the dense layer and one MoE layer cut to 32 routed experts,
    top-6, 2 shared), over 511 + 1 + 512 tokens, batch 2, w_uq/w_uk drawn,
    through the kernels and, on the same injected draws, through the plain
    versions with the kernel pass's expert assignments (``routing``):
    loss, grad norm, the grads of both layers' w_uq, w_uk, w_uv and the
    MoE layer's router and expert tables, and the params after AdamW, at
    ``check_update``'s bands."""
    base = depth_cfg(DS_ARCH, UPDATE_LAYERS)
    cfg = replace(base, moe=replace(base.moe,
                                    n_experts=MOE_UPDATE_EXPERTS))
    paths = ([(s, "attn", k) for s in ("dense_blocks", "blocks")
              for k in ("w_uq", "w_uk", "w_uv")]
             + [("blocks", "ffn", k) for k in ("router", "w_gate", "w_up",
                                               "w_down")])
    keys = ["/".join(p) for p in paths]
    flow = FlowRLConfig(num_steps=NUM_STEPS, group_size=2,
                        clip_range=UPDATE_CLIP, latent_tokens=MOE_UPDATE_LAT,
                        latent_dim=LAT_DIM, advantage_agg="gdpo",
                        rewards=(RewardSpec("pickscore", 1.0, args={
                            "latent_dim": LAT_DIM, "cond_dim": COND_DIM}),
                                 RewardSpec("latent_norm", 0.1)))
    opt = OptimConfig(lr=1e-4, warmup_steps=1, total_steps=1000)
    gen = torch.Generator(device=dev).manual_seed(5)
    cond = torch.randn(1, HY_COND_LEN, COND_DIM, generator=gen, device=dev)
    x_init = torch.randn(2, MOE_UPDATE_LAT, LAT_DIM, generator=gen,
                         device=dev)
    eps = torch.randn(NUM_STEPS, 2, MOE_UPDATE_LAT, LAT_DIM, generator=gen,
                      device=dev)
    t_u = 0.02 + 0.96 * torch.rand(2, generator=gen, device=dev)
    eps_u = torch.randn(2, MOE_UPDATE_LAT, LAT_DIM, generator=gen,
                        device=dev)
    runs, params, recorded = {}, None, []
    for route in ("kernel", "plain"):
        tr = registry.build("trainer", name, cfg, flow, opt, seed=0,
                            cond_dim=COND_DIM, device=dev, params=params)
        if params is None:
            draw_qk_proj(tr.state.params, cfg, seed=6)
            params = _clone(tr.state.params)
            start = _clone(params)
        ctx = plain_dispatch() if route == "plain" else contextlib.nullcontext()
        rctx = (routing(record=recorded) if route == "kernel"
                else routing(replay=list(recorded)))
        reset_counts()
        with ctx, rctx:
            traj = tr.sample(tr.state.params, cond, None, x_init=x_init,
                             eps=eps)
            _, adv, stats = tr._rewards(traj.x0, {"cond": traj.cond})
            loss, aux = tr.backward(traj, adv, t=t_u, eps=eps_u)
            bb = tr.state.params["backbone"]
            grads = {k: bb[p[0]][p[1]][p[2]].grad.clone()
                     for k, p in zip(keys, paths)}
            tr._begin_update()
            gnorm, lr = tr.apply_grads()
            tr._end_update()
            lr = float(lr)
        torch.cuda.synchronize()
        ran = all_variants()
        if route == "kernel" and (
                ran["flash_attention_bwd"] != routed(
                    flash_attention_bwd.launches, "wgmma")
                or flash_attention_bwd.launches == 0):
            fail(f"{name}: the {DS_ARCH} update's attention backward did not "
                 f"run on the tensor cores: {ran}")
        runs[route] = {"loss": float(loss), "grad_norm": float(gnorm),
                       "lr": lr, "grads": grads,
                       "aux": {a: float(v) for a, v in aux.items()},
                       "reward": float(stats["reward_mean"]),
                       "adv_abs": float(adv.abs().mean()),
                       "params": tr.state.params}
        del tr, traj
        torch.cuda.empty_cache()
    k, p = runs["kernel"], runs["plain"]
    grad_err = {n: float((k["grads"][n].float() - p["grads"][n].float()
                          ).abs().max()) / float(p["grads"][n].float().abs(
                              ).max()) for n in k["grads"]}
    zero = [n for n, g in k["grads"].items() if not g.abs().max() > 0]
    gn_err = abs(k["grad_norm"] - p["grad_norm"]) / p["grad_norm"]
    gap = _param_gap(k["params"], p["params"], start, k["lr"])
    del start
    diff_share = gap["params_differing"] / max(gap["params_moved"], 1)
    log(f"  one {name} update, {DS_ARCH} depth {UPDATE_LAYERS} "
        f"({MOE_UPDATE_EXPERTS} routed experts, {MOE_UPDATE_LAT} latent "
        f"tokens), batch 2, kernels vs plain on the kernel's routing: loss "
        f"{k['loss']:+.4e} / {p['loss']:+.4e}, grad_norm "
        f"{k['grad_norm']:.4e} / {p['grad_norm']:.4e} ({gn_err:.2e}), "
        f"reward {k['reward']:+.4e} / {p['reward']:+.4e}")
    log(f"  grads max|kernel - plain| / max|plain|: "
        + ", ".join(f"{n} {grad_err[n]:.3e}" for n in keys)
        + f" (band {GRAD_BAND}); params after AdamW: nearest its band "
        f"{gap['param_leaf']} at {gap['param_band_share']:.3f}; "
        f"{gap['params_differing']} of the {gap['params_moved']} weights "
        f"the step moved differ ({diff_share:.4f}, band {PARAM_DIFF_SHARE})")
    if zero:
        fail(f"{name}: the gradients of {zero} are zero")
    if max(grad_err.values()) > GRAD_BAND or gn_err > GRAD_BAND:
        fail(f"{name}: the {DS_ARCH} update's gradients through the kernels "
             "disagree with the plain versions")
    loss_band = _loss_band(name, k, p)
    if abs(k["loss"] - p["loss"]) > loss_band:
        fail(f"{name}: the {DS_ARCH} update's loss disagrees beyond "
             f"{loss_band:.3e}")
    if gap["param_band_share"] > 1 or gap["params_moved"] == 0 or \
            diff_share > PARAM_DIFF_SHARE:
        fail(f"{name}: the {DS_ARCH} params after AdamW disagree between "
             "the routes")
    return {"grad_err": grad_err, "grad_norm_err": gn_err,
            "loss": [k["loss"], p["loss"]], "loss_band": loss_band, **gap}


def grok_serve_phase(dev) -> dict:
    """Phase 31."""
    res = {"serve": moe_serve_path(GROK_ARCH, GROK_SERVE_LAYERS)}
    res["velocity_checks"] = check_moe_velocity(dev, GROK_ARCH)
    return res


# ------------------------------------------------------------ phases 32-35
# the frontend families at published width over the hybrid's geometry (511
# + 1 + 4096 = 4608 tokens, causal, head dim 64): internvl2-1b (24 layers,
# 14 query heads over 2 kv heads: a GQA group of 7) and musicgen-large (48
# layers, 32 heads over 32: a group of 1); the LM task path on internvl2-1b
# at the reference's input shapes
FE_ARCHS = {"internvl2-1b": 24, "musicgen-large": 48}
FE_HEAD_DIM = 64
# AdamW in the frontend archs' flow training: the velocity never reads
# frontend_proj, so its gradient is zero and it moves by the decay alone.
# The default OptimConfig decays nothing, and a bf16 param moves only when
# lr * wd passes half its ulp (2^-9 to 2^-8 of the value): at lr 1e-3 from
# the first step (warmup 1) and wd 4, lr * wd = 4e-3 a step
FE_LR, FE_WD = 1e-3, 4.0
LM_ARCH = "internvl2-1b"
# train_4k: 4096 tokens after the 256-token vision prefix; its global batch
# of 256 is cut to 8 sequences, what one card trains in one step
LM_SEQ, LM_BATCH, LM_STEPS = INPUT_SHAPES["train_4k"].seq_len, 8, 3
PREFILL_SEQ = INPUT_SHAPES["prefill_32k"].seq_len
PREFILL_BATCHES = (32, 16, 8, 4, 2, 1)   # prefill_32k's 32, then halved
LM_DECODES = 16
DECODE_SHAPE = INPUT_SHAPES["decode_32k"]
DECODE_STEPS = 4
# decode against the forward at depth 2 in f32: the attention kernels' FMA
# route against plain decode math, f32 sums in another order
DECODE_BAND = 1e-3       # max |decode - forward| / max |forward logits|
# the LM train step at depth 2 through the kernels against the plain
# versions, bf16: the loss to 1e-3 of itself, the gradient norm to 2e-2,
# each leaf's gradient to GRAD_BAND of its max |plain|
LM_LOSS_BAND, LM_GNORM_BAND = 1e-3, 2e-2
# phase 34's step as the cost model and the dry run see it
LM_SHAPE = InputShape("train_4k_b8", LM_SEQ, LM_BATCH, "train")
# the dry run's predicted peak against the card's, relative
DRYRUN_BAND = 0.10


def _fe_attention_cases() -> list:
    """(name, what, B, S, H, K, backward) of the attention at phase 32's
    shapes, forward and backward: both archs' flow shapes and
    internvl2-1b's LM train step (``LM_BATCH`` x (``LM_SEQ`` + its
    256-token prefix))."""
    iv, mg = configs.get("internvl2-1b"), configs.get("musicgen-large")
    return [("g7", "internvl2-1b flow", B_SERVE, HY_SEQ, iv.n_heads,
             iv.n_kv_heads, True),
            ("g1", "musicgen-large flow", B_SERVE, HY_SEQ, mg.n_heads,
             mg.n_kv_heads, True),
            ("lm", "internvl2-1b LM train", LM_BATCH,
             LM_SEQ + iv.frontend.n_tokens, iv.n_heads, iv.n_kv_heads, True)]


def _prefill_plain(q, k, v):
    """The plain attention at the prefill shape, one sequence and a query
    chunk of 1024 at a time (``layers.attention_chunked``, the reference's
    jnp path: the kernels' plain version would hold the (33024, 33024) f32
    scores of 14 heads, 61 GB a sequence)."""
    return torch.cat([attention_chunked(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                        causal=True, chunk_q=1024)
                      for i in range(q.shape[0])])


def _fe_qkv(g, dev, B, S, H, K, dt, with_do):
    q = torch.randn(B, S, H, FE_HEAD_DIM, generator=g, device=dev).to(dt)
    k, v = (torch.randn(B, S, K, FE_HEAD_DIM, generator=g, device=dev).to(dt)
            for _ in range(2))
    do = torch.randn_like(q) if with_do else None
    return q, k, v, do


def _fe_attention_case(dev, g, name, what, B, S, H, K, bwd, dt) -> dict:
    """One shape and dtype: o and LSE, and with ``bwd`` dq, dk, dv, held
    row by row against the plain versions (``_row_errs`` at
    ``ROW_BAND``), the LSE at ``LSE_BAND``, the backward also against
    torch.autograd through the plain forward (one batch row, at
    ``ATTN_BWD_BAND`` of the whole tensor, phase 28's reason), each call
    on the variant its dtype calls for."""
    q, k, v, do = _fe_qkv(g, dev, B, S, H, K, dt, bwd)
    variant = "wgmma" if dt == torch.bfloat16 else "fma"
    before = all_variants()
    o, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=True) if bwd \
        else None
    ran = all_variants()
    if ran["flash_attention"][variant] - before["flash_attention"][
            variant] != 1 or (bwd and ran["flash_attention_bwd"][variant]
                              - before["flash_attention_bwd"][variant]
                              != 1):
        fail(f"the attention at the {what} shape {dt} did not run its "
             f"{variant} kernels: {before} -> {ran}")
    out = {"max_abs_err_bwd": None, "grad_rows": None}
    if bwd:
        r, lse_ref = _mla_plain(ref.flash_attention_fwd_ref, q, k, v)
        want = _mla_plain(ref.flash_attention_bwd_ref, q, k, v, o, lse, do)
        lse_err = float((lse - lse_ref).abs().max()) / max(
            1.0, float(lse_ref.abs().max()))
        leaves = [t[:1].float().requires_grad_() for t in (q, k, v)]
        ref.flash_attention_ref(*leaves, causal=True).backward(
            do[:1].float())
        auto = _grad_errs([t[:1] for t in got], [t.grad for t in leaves])
        rows_g = _row_errs(got, want)
        out.update(grad_rows=rows_g, max_abs_err_bwd=max(
            float((a.float() - b.float()).abs().max())
            for a, b in zip(got, want)), autograd=auto, lse_err=lse_err)
        del want, leaves, lse_ref
    else:
        r = _prefill_plain(q, k, v)
        lse_err, auto, rows_g = 0.0, [0.0], [0.0]
    torch.cuda.synchronize()
    (row_o,) = _row_errs([o], [r])
    err = float((o.float() - r.float()).abs().max())
    band = ROW_BAND[dt]
    log(f"  {what} ({B}, {S}, {H} / {K} heads of {FE_HEAD_DIM}) causal {dt} "
        f"({variant}): per-row max|err| / max|plain| of the row: o "
        f"{row_o:.3e}" + (f", dq/dk/dv {rows_g[0]:.3e}/{rows_g[1]:.3e}/"
                          f"{rows_g[2]:.3e}; vs autograd {auto[0]:.2e}/"
                          f"{auto[1]:.2e}/{auto[2]:.2e} of max|plain| (band "
                          f"{ATTN_BWD_BAND[dt]}); lse {lse_err:.2e}"
                          if bwd else "") +
        f" (band {band} a row); o max|err| {err:.3e}")
    if row_o > band or max(rows_g) > band or lse_err > LSE_BAND or \
            max(auto) > ATTN_BWD_BAND[dt]:
        fail(f"the attention at the {what} shape is off its band ({dt})")
    out.update(o_row=row_o, max_abs_err=err)
    del q, k, v, do, o, lse, got, r
    torch.cuda.empty_cache()
    return out


def _sdpa_gqa_ms(q, k, v, do) -> tuple:
    """SDPA's forward (and with ``do`` backward) ms on its fused backends
    with ``enable_gqa``; where none takes the GQA call, on k and v
    expanded to every query head (the expansion untimed).  Returns (fwd,
    bwd or None, note)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION]
    G = q.shape[2] // k.shape[2]
    for gqa in (True, False):
        qt, kt, vt = (a.transpose(1, 2).detach() for a in (q, k, v))
        if not gqa:
            kt, vt = (a.repeat_interleave(G, dim=1) for a in (kt, vt))
        qt, kt, vt = (a.requires_grad_(do is not None) for a in (qt, kt, vt))
        try:
            with sdpa_kernel(fused):
                with torch.no_grad():
                    fwd = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                               enable_gqa=gqa), 3)
                bwd = None
                if do is not None:
                    out = sdpa(qt, kt, vt, is_causal=True, enable_gqa=gqa)
                    dot = do.transpose(1, 2)
                    bwd = cuda_ms(lambda: torch.autograd.grad(
                        out, (qt, kt, vt), dot, retain_graph=True), 3)
            return fwd, bwd, ("fused SDPA backend, enable_gqa" if gqa else
                              "fused SDPA backend on k, v expanded to "
                              "every query head (no fused backend takes "
                              "enable_gqa here)")
        except RuntimeError as e:
            note = f"no fused SDPA backend takes it: {e}"[:300]
    return None, None, note


def _fe_attention_times(dev, g, name, what, B, S, H, K, bwd, errs) -> list:
    """bf16 kernel and f32 FMA kernel ms from replayed graphs, the plain
    versions' and SDPA's ms with CUDA events, and the operation bounds
    (each product over the S (S + 1) / 2 pairs the causal mask keeps at
    the bf16 tensor-core rate: forward 4 D a pair, backward 10 D; bytes:
    each input read once, each output written once).  The rows of the
    ``kernels`` line."""
    q, k, v, do = _fe_qkv(g, dev, B, S, H, K, torch.bfloat16, bwd)
    pairs = B * H * S * (S + 1) / 2
    o, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    ms = graph_ms(lambda: flash_attention(q, k, v, causal=True), 2)
    plain = (lambda: _mla_plain(ref.flash_attention_ref, q, k, v)) if bwd \
        else (lambda: _prefill_plain(q, k, v))
    plain_ms = cuda_ms(plain, 1, 0)
    torch.cuda.empty_cache()
    q32, k32, v32 = (a.float() for a in (q, k, v))
    fma_ms = graph_ms(lambda: flash_attention(q32, k32, v32, causal=True),
                      1, 2)
    sdpa_ms, sdpa_bwd_ms, note = _sdpa_gqa_ms(q, k, v, do)
    torch.cuda.empty_cache()
    el = 2
    rows = []
    fwd_bound = _bound((2 * q.numel() + 2 * k.numel()) * el,
                       4 * pairs * FE_HEAD_DIM)
    rows.append({"name": f"flash_attention_{name}", "kms": ms,
                 "fma": fma_ms, "plain": plain_ms, "lib": sdpa_ms,
                 "bound": fwd_bound, "err": errs[torch.bfloat16][0],
                 "err32": errs[torch.float32][0], "src": "flash_attention.cu",
                 "replaces": "src/repro/kernels/flash_attention.py:81"})
    if bwd:
        do32 = do.float()
        o32, lse32 = flash_attention(q32, k32, v32, causal=True,
                                     return_lse=True)
        bwd_ms = graph_ms(lambda: flash_attention_bwd(
            q, k, v, o, lse, do, causal=True), 2)
        fma_bwd_ms = graph_ms(lambda: flash_attention_bwd(
            q32, k32, v32, o32, lse32, do32, causal=True), 1, 2)
        del do32, o32, lse32
        torch.cuda.empty_cache()
        plain_bwd_ms = cuda_ms(lambda: _mla_plain(
            ref.flash_attention_bwd_ref, q, k, v, o, lse, do), 1, 0)
        torch.cuda.empty_cache()
        nbytes = (4 * q.numel() + 4 * k.numel()) * el + 4 * lse.numel()
        rows.append({"name": f"flash_attention_bwd_{name}", "kms": bwd_ms,
                     "fma": fma_bwd_ms, "plain": plain_bwd_ms,
                     "lib": sdpa_bwd_ms,
                     "bound": _bound(nbytes, 10 * pairs * FE_HEAD_DIM),
                     "err": errs[torch.bfloat16][1],
                     "err32": errs[torch.float32][1],
                     "src": "flash_attention_bwd.cu",
                     "replaces": "none (JAX autodiff of src/repro/models/"
                                 "attention.py:71)"})
    out = []
    for r in rows:
        bound, by = r["bound"]
        lib = "none" if r["lib"] is None else f"{r['lib']:.4f} ms"
        log(f"  {r['name']} {what} ({B}, {S}, {H} / {K} heads of "
            f"{FE_HEAD_DIM}) causal bf16: kernel {r['kms']:.4f} ms (wgmma), "
            f"the f32 FMA kernel {r['fma']:.4f} ms, plain {r['plain']:.3f} "
            f"ms, SDPA{' backward' if 'bwd' in r['name'] else ''} {lib} "
            f"({note}), bound {bound:.4f} ms ({by})")
        out.append({
            "name": r["name"], "route": "cuda", "variant": "wgmma",
            "source": f"src/repro_torch/kernels/csrc/{r['src']}",
            "replaces": r["replaces"], "max_abs_err": r["err"],
            "max_abs_err_f32": r["err32"], "ms": r["kms"],
            "fma_ms": r["fma"], "plain_ms": r["plain"], "bound_ms": bound,
            "bound_by": by, "library_ms": r["lib"], "library_note": note,
            "shape": [B, S, H, K, FE_HEAD_DIM]})
    del q, k, v, do, o, lse, q32, k32, v32
    torch.cuda.empty_cache()
    return out


def _fe_attention_rows(dev, g, name, what, B, S, H, K, bwd) -> list:
    """One shape: the bf16 and f32 checks, then the times; its kernel
    rows."""
    errs = {}
    for dt in (torch.bfloat16, torch.float32):
        r = _fe_attention_case(dev, g, name, what, B, S, H, K, bwd, dt)
        errs[dt] = (r["max_abs_err"], r["max_abs_err_bwd"])
    rows = _fe_attention_times(dev, g, name, what, B, S, H, K, bwd, errs)
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def check_attention_frontends(dev) -> list:
    """Phase 32: the attention kernels at the new shapes (a GQA group of 7
    and of 1 at head dim 64, and the LM train step's batch and length) in
    bf16 on the tensor cores and f32 on the FMA kernels against their
    plain versions, then their times beside SDPA and the bounds.  Returns
    the kernel rows."""
    g = torch.Generator(device=dev).manual_seed(32)
    rows = []
    for case in _fe_attention_cases():
        rows += _fe_attention_rows(dev, g, *case)
    return rows


# ----------------------------------------------------------------- phase 33
def _fe_argv(arch: str) -> list:
    return ["--arch", arch, "--sde", "flow_sde", "--device", "cuda",
            "--requests", str(B_SERVE), "--max-batch", str(B_SERVE),
            "--bucket", str(B_SERVE),
            "--set", f"flow.num_steps={NUM_STEPS}",
            "--set", f"flow.latent_tokens={LAT_TOKENS}",
            "--set", f"flow.latent_dim={LAT_DIM}",
            "--set", "param_dtype=bfloat16",
            "--set", "data.encoder=" + json.dumps(
                {"cond_dim": COND_DIM, "cond_len": HY_COND_LEN})]


def frontend_serve_path(arch: str, layers: int) -> dict:
    """``repro_torch.launch.serve.main`` serving 4 requests of ``arch`` at
    full width and depth (bf16, random weights from a seed) over 511 + 1 +
    4096 tokens under flow_sde, 4 steps: launch counts (``flash_attention``
    ``layers`` a velocity, all on the tensor cores; ``sde_step`` 4 a
    batch), s per step, req/s and peak memory."""
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = serve.main(_fe_argv(arch))
    launches = counts()
    ran = all_variants()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    stats, lat, eng = out["stats"], out["latents"], out["engine"]
    batches = len(out["warmup"]) + sum(stats["dispatches"].values())
    serve_batches = sum(stats["dispatches"].values())
    want = {name: 0 for name in launches}
    want["sde_step"] = NUM_STEPS * batches
    want["flash_attention"] = layers * NUM_STEPS * batches
    log(f"  {arch}: launches {launches} over {batches} batches (warmup + "
        f"serve; expected {want}), attention variants "
        f"{ran['flash_attention']}")
    if eng.adapter.cfg.n_layers != layers:
        fail(f"served {eng.adapter.cfg.n_layers} layers of {arch}")
    if tuple(lat.shape) != (B_SERVE, LAT_TOKENS, LAT_DIM) or not \
            torch.isfinite(lat).all():
        fail(f"{arch} latents: shape {tuple(lat.shape)} or not finite")
    if launches != want or ran["flash_attention"] != routed(
            want["flash_attention"], "wgmma"):
        fail(f"the {arch} serving path's kernel launches do not match")
    serve_s = out["serve_s"]
    res = {"launches": launches, "batches": batches,
           "req_per_s": B_SERVE / serve_s,
           "s_per_step": serve_s / (serve_batches * NUM_STEPS),
           "serve_s": serve_s, "warmup_s": out["warmup_s"],
           "peak_bytes": peak,
           "n_params": params_lib.n_params(eng.adapter.spec())}
    log(f"  {arch} serving: {res['req_per_s']:.4f} req/s, "
        f"{res['s_per_step']:.4f} s per denoising step (batch {B_SERVE}), "
        f"max_memory_allocated {peak / 2**30:.2f} GiB ({peak} bytes), "
        f"{res['n_params']} params")
    del eng, out
    return res


class _FrontendWatch(_TrainWatch):
    """``_TrainWatch`` over the attention leaves (wq/wk drawn at train
    start, ``draw_attention``), which also keeps ``frontend_proj`` at
    train start and its largest |gradient| at the first update."""

    def __init__(self, seed: int):
        super().__init__("attn", ("wq", "wk", "wv"), ("wq", "wk"),
                         lambda p, cfg: draw_attention(p, cfg.d_model,
                                                       seed=seed))

    def on_train_start(self, loop):
        super().on_train_start(loop)
        tr = loop.trainer
        fp = tr.state.params["backbone"]["frontend_proj"]
        self.fp_before, self.fp_grad = fp.clone(), None
        inner = tr.apply_grads

        def apply_grads():
            if self.fp_grad is None:
                self.fp_grad = float(fp.grad.abs().max())
            return inner()

        tr.apply_grads = apply_grads


def frontend_train_path(tmp: str, arch: str, layers: int) -> dict:
    """``repro_torch.launch.train.main``: flow_grpo for 2 steps at
    ``arch``'s full width and all its layers, phase 19's batch, T and
    rewards over 511 + 1 + 4096 tokens, AdamW at ``FE_LR`` with weight
    decay ``FE_WD``, wq/wk drawn at train start; musicgen-large under
    ``perf.remat=block`` (its 3.23 B params with bf16 grads and f32
    moments are ≈ 38.8 GB before activations; 48 layers of saved
    activations do not fit beside them), internvl2-1b under ``none``.
    ``train_one``'s checks, and ``frontend_proj``: a zero gradient at the
    first update, and after the two steps each element its start times
    (1 - lr * wd) per step, as AdamW's f32 update with no moment writes
    it (within one bf16 rounding a step)."""
    block = arch == "musicgen-large"
    watch = _FrontendWatch(seed=33)
    extra = (BLOCK if block else ()) + (
        "--set", f"optim.lr={FE_LR}", "--set", "optim.warmup_steps=1",
        "--set", f"optim.weight_decay={FE_WD}")
    row, trainer = train_one(
        tmp, arch, layers, HY_COND_LEN,
        ("flash_attention", "flash_attention_bwd"), watch, "flow_grpo",
        TRAIN_STEPS, extra=extra, remat="block" if block else "none",
        routes={"flash_attention": "wgmma", "flash_attention_bwd": "wgmma"})
    fp = trainer.state.params["backbone"]["frontend_proj"]
    want = watch.fp_before
    for i in range(TRAIN_STEPS):
        lr = torch.tensor(trainer._lr(i), dtype=torch.float32,
                          device=fp.device)
        w32 = want.float()
        want = (w32 - lr * (FE_WD * w32)).to(want.dtype)
    gap = float((fp.float() - want.float()).abs().max())
    ulp = float(want.float().abs().max()) * 2.0 ** -8 * TRAIN_STEPS
    moved = float((fp.float() - watch.fp_before.float()).abs().max())
    log(f"  {arch}: frontend_proj's gradient at the first update max "
        f"{watch.fp_grad}; after {TRAIN_STEPS} steps max|p - p0 (1 - lr "
        f"wd)^n| {gap:.3e} (bitwise: {torch.equal(fp, want)}; band "
        f"{ulp:.3e}), moved by {moved:.3e}; remat "
        f"{'block' if block else 'none'}")
    if watch.fp_grad != 0.0 or gap > ulp or moved == 0.0:
        fail(f"{arch}'s frontend_proj did not move by AdamW's decay alone")
    row.update(frontend_proj={"grad_max": watch.fp_grad, "decay_gap": gap,
                              "bitwise": torch.equal(fp, want),
                              "moved": moved},
               remat="block" if block else "none")
    del trainer
    return row


def frontend_phase(dev, tmp: str) -> dict:
    """Phase 33: each frontend arch served at all its layers, its
    velocity at depth 2 against the plain versions (wq/wk drawn; the gap
    at the repository's init printed), and trained at all its layers."""
    out = {}
    for arch, layers in FE_ARCHS.items():
        res = {"serve": frontend_serve_path(arch, layers)}
        gc.collect()
        torch.cuda.empty_cache()
        res["velocity_check"] = check_dense_velocity(dev, arch, True,
                                                     cond_len=HY_COND_LEN)
        gc.collect()
        torch.cuda.empty_cache()
        res["train"] = frontend_train_path(tmp, arch, layers)
        gc.collect()
        torch.cuda.empty_cache()
        out[arch] = res
    return out


# ----------------------------------------------------------------- phase 34
def _lm_batch(cfg, stream, gen, batch: int) -> dict:
    """One ``TokenStream`` batch on the card with the stub frontend's
    prefix embeddings drawn from ``gen``."""
    nb = next(stream)
    dev = gen.device
    return {"tokens": torch.from_numpy(nb["tokens"]).to(dev),
            "labels": torch.from_numpy(nb["labels"]).to(dev),
            "prefix_embed": frontends.build(cfg.frontend).embeddings(
                gen, batch)}


def lm_train_path(dev) -> dict:
    """``tasks.make_train_step`` on internvl2-1b at full width and all 24
    layers (bf16, random weights from a seed, wq/wk drawn at
    1/sqrt(d_model)), ``train_4k``'s 4096 tokens after the 256-token
    vision prefix, batch ``LM_BATCH`` of ``TokenStream``, the default
    ``OptimConfig``, ``LM_STEPS`` steps: launch counts (attention forward
    2 x 24 a step under the per-block remat, backward 24, all on the
    tensor cores), finite metrics, params that move, s a step, tokens/s
    (CE tokens, after the prefix), peak memory and CE, and a profile of
    one more step."""
    cfg = configs.get(LM_ARCH)
    L = cfg.n_layers
    # the step's own peak: everything allocated from here on (the params,
    # the moments, the batches, the steps), over what earlier phases hold
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev).manual_seed(34)
    p = tasks.init_params(cfg, gen, torch.bfloat16, dev)
    draw_attention({"backbone": p}, cfg.d_model, seed=35)
    step = tasks.make_train_step(cfg, OptimConfig())
    state = tasks.TrainState(p, optim_lib.adamw_init(p))
    stream = TokenStream(cfg.vocab_size, LM_BATCH, LM_SEQ, seed=0).batches()
    # kept on the host, so the device peak is the step's alone
    before = {k: p["blocks"]["attn"][k].to("cpu", copy=True)
              for k in ("wq", "wk")}
    reset_counts()
    hist = []
    for i in range(LM_STEPS):
        batch = _lm_batch(cfg, stream, gen, LM_BATCH)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        m = {k: float(v) for k, v in m.items()}
        dt = time.perf_counter() - t0
        m["dt"] = dt
        hist.append(m)
        log(f"  LM step {i}: {dt:.4f} s, loss {m['loss']:.4f}, ce "
            f"{m['ce']:.4f}, grad_norm {m['grad_norm']:.4e}, lr "
            f"{m['lr']:.3e}")
    launches = counts()
    ran = all_variants()
    peak = torch.cuda.max_memory_allocated()
    measured = peak - base
    want = {name: 0 for name in launches}
    want["flash_attention"] = 2 * L * LM_STEPS
    want["flash_attention_bwd"] = L * LM_STEPS
    log(f"  LM train: launches {launches} (expected {want}); variants "
        f"{ran['flash_attention']}, {ran['flash_attention_bwd']}")
    if launches != want or ran["flash_attention"] != routed(
            want["flash_attention"], "wgmma") or ran[
            "flash_attention_bwd"] != routed(want["flash_attention_bwd"],
                                             "wgmma"):
        fail("the LM train step's kernel launches do not match the path")
    if not all(math.isfinite(v) for m in hist for v in m.values()):
        fail(f"the LM train step's metrics are not finite: {hist}")
    moved = {k: float((p["blocks"]["attn"][k].cpu().float() - v.float())
                      .abs().max()) for k, v in before.items()}
    if int(state.opt.step) != LM_STEPS or not all(moved.values()):
        fail(f"the LM train step did not move the params: {moved}")
    steady = [m["dt"] for m in hist[1:]]
    s_step = sum(steady) / len(steady)
    extra = [_lm_batch(cfg, stream, gen, LM_BATCH) for _ in range(2)]
    held = [state]

    def one_step():
        held[0], _ = step(held[0], extra.pop())

    prof = profile(one_step, f"one LM train step, {LM_ARCH} {L} layers, "
                   f"batch {LM_BATCH}")
    shares = lm_step_shares(cfg, s_step)
    dry = lm_dryrun_peak(cfg, measured)
    res = {"launches": launches, "s_per_step": [m["dt"] for m in hist],
           "tokens_per_s": LM_BATCH * LM_SEQ / s_step,
           "peak_bytes": peak, "step_peak_bytes": measured,
           "cost_model": shares, "dryrun": dry,
           "ce": [m["ce"] for m in hist],
           "loss": [m["loss"] for m in hist],
           "grad_norm": [m["grad_norm"] for m in hist],
           "batch": LM_BATCH, "seq": LM_SEQ,
           "prefix": cfg.frontend.n_tokens, "layers": L, "profile": prof}
    log(f"  LM train {LM_ARCH}, {L} layers, batch {LM_BATCH} x ({LM_SEQ} + "
        f"{cfg.frontend.n_tokens}) tokens: {s_step:.4f} s a step (steps "
        f"2-{LM_STEPS}), {res['tokens_per_s']:.1f} tokens/s, "
        f"max_memory_allocated {peak / 2**30:.2f} GiB ({peak} bytes), CE "
        f"{res['ce']}")
    del p, state, step, held, extra
    return res


def lm_step_shares(cfg, s_step: float) -> dict:
    """The LM train step's shares of the card's bf16 peak from the cost
    model (``launch.costs``) at the step's shape (``LM_BATCH`` x 4096 text
    tokens; the model counts no prefix token): MFU = model FLOPs (6 N_active
    a token) / s a step / peak, and the hardware share = the FLOPs the
    kernel path runs (4 forwards under the per-block remat, causal
    attention halved) / s a step / peak.  Both must be below 1."""
    c = costs_lib.step_costs(cfg, LM_SHAPE)
    peak = mesh_lib.PEAK_FLOPS_BF16
    out = {"model_flops": c.model_flops, "flops_kernel": c.flops_kernel,
           "s_per_step": s_step, "mfu": c.model_flops / s_step / peak,
           "hw_flops_share": c.flops_kernel / s_step / peak,
           "peak_flops_bf16": peak}
    log(f"  LM train step cost model: {c.model_flops:.4e} model FLOPs, "
        f"{c.flops_kernel:.4e} kernel-path FLOPs a step; at {s_step:.4f} s "
        f"a step MFU {100 * out['mfu']:.2f} %, hardware FLOP share "
        f"{100 * out['hw_flops_share']:.2f} % of {peak:.3e} FLOP/s "
        f"({mesh_lib.CARD} datasheet peak)")
    if not (0 < out["mfu"] < 1 and 0 < out["hw_flops_share"] < 1):
        fail(f"the LM step's FLOP shares are not below 100 %: {out}")
    return out


def lm_dryrun_peak(cfg, measured: int) -> dict:
    """``launch.dryrun`` of phase 34's step on meta tensors (the same arch
    and depth, ``LM_BATCH``, per-block remat, ``OptimConfig()``; the
    one-rank layout): its predicted peak bytes against the measured one
    (``max_memory_allocated`` over what was allocated before the params),
    to ``DRYRUN_BAND``."""
    with tempfile.TemporaryDirectory() as tmp:
        rec = dryrun.run_one(LM_ARCH, LM_SHAPE, one_rank=True, out_dir=tmp,
                             cfg=cfg)
    pred = rec["memory"]["peak_bytes"]
    ratio = pred / measured
    out = {"predicted_peak_bytes": pred, "measured_peak_bytes": measured,
           "ratio": ratio, "argument_bytes": rec["memory"]["argument_bytes"],
           "temp_bytes": rec["memory"]["temp_bytes"], "run_s": rec["run_s"],
           "collectives": rec["collectives"]["_total"]["count"]}
    log(f"  dry run of the LM step (meta, one rank, {rec['run_s']} s): "
        f"predicted peak {pred} bytes (arguments {out['argument_bytes']}, "
        f"temporaries {out['temp_bytes']}), measured {measured} bytes, "
        f"ratio {ratio:.4f} (band {DRYRUN_BAND})")
    if abs(ratio - 1) > DRYRUN_BAND or out["collectives"]:
        fail(f"the dry run's peak is off the measured one: {out}")
    return out


def _lm_grads(step, p, batch) -> tuple:
    """(loss, ce, grad norm, grads) of the LM loss at ``p`` (f32 sums)."""
    leaves = [t for _, t in params_lib.leaves(p)]
    for t in leaves:
        t.requires_grad_(True)
    try:
        total, ce, _ = step.loss_fn(p, batch)
        gs = torch.autograd.grad(total, leaves, allow_unused=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    gs = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, gs)]
    gnorm = math.sqrt(sum(float((g.float() ** 2).sum()) for g in gs))
    return float(total.detach()), float(ce.detach()), gnorm, gs


def check_lm_update(dev) -> dict:
    """The LM loss and its gradient at internvl2-1b's full width, depth 2,
    batch 2 of ``TokenStream`` at ``train_4k``'s length with the vision
    prefix, wq/wk drawn: through the kernels (attention forward 2 x 2,
    backward 2) against the plain versions, loss and ce to
    ``LM_LOSS_BAND`` of themselves, the gradient norm to
    ``LM_GNORM_BAND``, every leaf's gradient to ``GRAD_BAND`` of its max
    |plain|."""
    cfg = replace(configs.get(LM_ARCH), n_layers=UPDATE_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(36)
    p = tasks.init_params(cfg, gen, torch.bfloat16, dev)
    draw_attention({"backbone": p}, cfg.d_model, seed=37)
    step = tasks.make_train_step(cfg, OptimConfig())
    stream = TokenStream(cfg.vocab_size, 2, LM_SEQ, seed=1).batches()
    batch = _lm_batch(cfg, stream, gen, 2)
    n0, b0 = flash_attention.launches, flash_attention_bwd.launches
    k = _lm_grads(step, p, batch)
    nk = (flash_attention.launches - n0, flash_attention_bwd.launches - b0)
    if nk != (2 * UPDATE_LAYERS, UPDATE_LAYERS):
        fail(f"the depth-2 LM gradient launched {nk} attention kernels")
    with plain_dispatch():
        pl = _lm_grads(step, p, batch)
    loss_gap = abs(k[0] - pl[0]) / abs(pl[0])
    ce_gap = abs(k[1] - pl[1]) / abs(pl[1])
    gn_gap = abs(k[2] - pl[2]) / pl[2]
    leaf_gap = max(_rel(a, b) for a, b in zip(k[3], pl[3]))
    log(f"  LM loss at depth {UPDATE_LAYERS}, bf16, kernels vs plain: loss "
        f"{k[0]:.6f} / {pl[0]:.6f} ({loss_gap:.2e}), ce {ce_gap:.2e} (band "
        f"{LM_LOSS_BAND}); grad norm {k[2]:.4e} / {pl[2]:.4e} "
        f"({gn_gap:.2e}, band {LM_GNORM_BAND}); largest leaf gradient gap "
        f"{leaf_gap:.3e} of its max (band {GRAD_BAND})")
    if loss_gap > LM_LOSS_BAND or ce_gap > LM_LOSS_BAND or \
            gn_gap > LM_GNORM_BAND or leaf_gap > GRAD_BAND:
        fail("the LM loss or its gradient through the kernels is off the "
             "plain versions")
    return {"loss": [k[0], pl[0]], "ce": [k[1], pl[1]],
            "grad_norm": [k[2], pl[2]], "leaf_gap": leaf_gap}


# ----------------------------------------------------------------- phase 35
def _decode_cfg(arch: str):
    """Depth 2 (the hybrid: one group of its 6 SSM blocks and the shared
    block; deepseek: its dense first layer and one MoE layer)."""
    cfg = configs.get(arch)
    if cfg.family == "hybrid":
        return replace(cfg, n_layers=cfg.hybrid.attn_every)
    return replace(cfg, n_layers=2)


@contextlib.contextmanager
def ample_capacity():
    """Every MoE group's expert capacity raised to its token count, so no
    assignment is dropped: a forward over S tokens drops assignments at
    capacity that a one-token decode keeps, by design, so the two agree
    only where nothing is dropped (the reference's test runs reduced
    sizes, where capacity is ample).  A comparison aid of this script."""
    saved = moe_mod.capacity
    moe_mod.capacity = lambda tokens, cfg: max(4, -(-tokens // 4) * 4)
    try:
        yield
    finally:
        moe_mod.capacity = saved


def check_decode_vs_forward(dev, arch: str) -> dict:
    """prefill + decode against the forward at ``arch``'s full width and
    depth 2 (``_decode_cfg``), f32 (the MoE router's near-ties do not flip
    between the passes), batch 2, random weights from a seed with the
    attention's query/key projections and the SSM leaves drawn: attention
    families prefill 511 tokens (after any frontend prefix) and decode one
    against the forward over 512; mamba2-370m prefills 128 and decodes 128
    one at a time against the forward over 256 (every decoded position);
    zamba2-2.7b prefills 127 and decodes 1 against the forward over 128
    (the scan takes whole chunks of 128).  The prefill and the forward run
    the kernels (their launches counted), the decode none; the decode
    logits are also held against a prefill + decode through the plain
    versions.  Both at ``DECODE_BAND`` of max |logits|."""
    cfg = _decode_cfg(arch)
    Q = cfg.ssm.chunk if cfg.ssm else 0
    S, n_pre = {"ssm": (2 * Q, Q), "hybrid": (Q, Q - 1)}.get(
        cfg.family, (512, 511))
    gen = torch.Generator(device=dev).manual_seed(350)
    p = tasks.init_params(cfg, gen, torch.float32, dev)
    bb = {"backbone": p}
    if cfg.family in ("ssm", "hybrid"):
        draw_ssm(bb, seed=351)
    if cfg.family == "hybrid":
        draw_shared_attention(bb, cfg.d_model, seed=352)
    elif cfg.family != "ssm":
        draw_qk_proj(bb, cfg, seed=352)
    toks = torch.randint(0, cfg.vocab_size, (2, S), generator=gen,
                         device=dev)
    pe = frontends.build(cfg.frontend).embeddings(gen, 2)
    n_prefix = cfg.frontend.n_tokens
    prefill, dec = tasks.make_prefill_step(cfg), tasks.make_decode_step(cfg)
    model = Backbone(cfg)

    def run():
        batch = {"tokens": toks[:, :n_pre]}
        if pe is not None:
            batch["prefix_embed"] = pe
        _, caches = prefill(p, batch)
        outs = []
        for i in range(n_pre, S):
            lg, caches = dec(p, caches, toks[:, i:i + 1], n_prefix + i)
            outs.append(lg)
        return torch.stack(outs, 1)

    with ample_capacity():
        reset_counts()
        dec_k = run()
        pre_launches = counts()
        with torch.no_grad():
            hidden = model.forward_embeds(p, model.embed_inputs(p, toks, pe))
            full = model.logits(p, hidden[:, n_prefix + n_pre:])
        fwd_launches = counts()
        with plain_dispatch():
            dec_p = run()
    torch.cuda.synchronize()
    n_attn = (0 if cfg.family == "ssm" else 1 if cfg.family == "hybrid"
              else cfg.n_layers)
    n_scan = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    want = {name: 0 for name in pre_launches}
    want.update(flash_attention=n_attn, ssd_scan=n_scan)
    want2 = {k: 2 * v for k, v in want.items()}
    scale = float(full.abs().max())
    err_fwd = float((dec_k - full).abs().max()) / scale
    err_plain = float((dec_k - dec_p).abs().max()) / float(
        dec_p.abs().max())
    log(f"  {arch} depth {cfg.n_layers} f32 ({cfg.family}): prefill "
        f"{n_pre}{f' + {n_prefix} prefix' if n_prefix else ''}, decode "
        f"{S - n_pre}: |decode - forward| {err_fwd:.3e}, |decode - plain "
        f"decode| {err_plain:.3e} of max|logits| (band {DECODE_BAND}); "
        f"launches prefill {pre_launches}, + forward {fwd_launches}")
    if pre_launches != want or fwd_launches != want2:
        fail(f"{arch}: the prefill / forward kernel launches do not match "
             f"(expected {want}, then {want2})")
    if not torch.isfinite(dec_k).all() or err_fwd > DECODE_BAND or \
            err_plain > DECODE_BAND:
        fail(f"{arch}: decode disagrees with the forward or the plain "
             "versions")
    del p, bb, dec_k, dec_p, full, hidden
    return {"err_forward": err_fwd, "err_plain": err_plain,
            "layers": cfg.n_layers, "decoded": S - n_pre}


def lm_prefill_decode(dev) -> dict:
    """internvl2-1b at full width and all 24 layers, bf16, wq/wk drawn:
    prefill at ``prefill_32k``'s length (32768 tokens after the 256-token
    prefix) at the largest batch of ``PREFILL_BATCHES`` the card holds
    (each larger one printed with its out-of-memory), 24 attention
    launches; then ``LM_DECODES`` decode steps from its caches (no kernel
    launches); prefill tokens/s, decode ms a step, peak memory; the
    attention's check and times at that prefill's shape, its batch
    included (``kernel_rows``, phase 32's).  Then ``decode_32k``: batch
    128 over ``init_caches`` of 32768 entries, ``DECODE_STEPS`` steps, ms
    a step (from the second), peak memory and a profile of one more
    step."""
    cfg = configs.get(LM_ARCH)
    L, n_pre = cfg.n_layers, cfg.frontend.n_tokens
    gen = torch.Generator(device=dev).manual_seed(38)
    p = tasks.init_params(cfg, gen, torch.bfloat16, dev)
    draw_attention({"backbone": p}, cfg.d_model, seed=39)
    prefill, dec = tasks.make_prefill_step(cfg), tasks.make_decode_step(cfg)
    fe = frontends.build(cfg.frontend)
    res, refused = {}, {}
    for B in PREFILL_BATCHES:
        toks = torch.randint(0, cfg.vocab_size, (B, PREFILL_SEQ),
                             generator=gen, device=dev)
        batch = {"tokens": toks, "prefix_embed": fe.embeddings(gen, B)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        try:
            t0 = time.perf_counter()
            logits, caches = prefill(p, batch)
            torch.cuda.synchronize()
            pre_s = time.perf_counter() - t0
        except torch.cuda.OutOfMemoryError as e:
            refused[B] = str(e).splitlines()[0][:200]
            log(f"  prefill at batch {B}: out of memory ({refused[B]})")
        else:
            break
        del batch, toks
        gc.collect()
        torch.cuda.empty_cache()
    else:
        fail("prefill_32k fits at no batch")
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    want = {name: 0 for name in launches}
    want["flash_attention"] = L
    if launches != want or all_variants()["flash_attention"] != routed(
            L, "wgmma") or not torch.isfinite(logits).all():
        fail(f"the prefill's launches {launches} do not match, or its "
             "logits are not finite")
    tokens = B * (PREFILL_SEQ + n_pre)
    log(f"  prefill_32k {LM_ARCH} {L} layers at batch {B}: {pre_s:.4f} s, "
        f"{tokens / pre_s:.1f} tokens/s, max_memory_allocated "
        f"{peak / 2**30:.2f} GiB ({peak} bytes); launches {launches}")
    res["prefill"] = {"batch": B, "s": pre_s, "tokens_per_s": tokens / pre_s,
                      "peak_bytes": peak, "launches": launches,
                      "refused": refused}
    tok = logits.argmax(-1)[:, None]
    reset_counts()
    times = []
    for i in range(LM_DECODES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = dec(p, caches, tok, PREFILL_SEQ + n_pre + i)
        tok = logits.argmax(-1)[:, None]
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if any(counts().values()) or not torch.isfinite(logits).all():
        fail(f"the decode launched kernels {counts()} or its logits are "
             "not finite")
    peak = torch.cuda.max_memory_allocated()
    dec_ms = 1e3 * sum(times[1:]) / (len(times) - 1)
    log(f"  {LM_DECODES} decode steps at batch {B} from {PREFILL_SEQ + n_pre}"
        f" cached entries: {dec_ms:.3f} ms a step (steps 2-{LM_DECODES}), "
        f"max_memory_allocated {peak / 2**30:.2f} GiB")
    res["decode"] = {"batch": B, "ms_per_step": dec_ms,
                     "s_per_step": times, "peak_bytes": peak}
    del caches, logits, batch, toks
    gc.collect()
    torch.cuda.empty_cache()
    # the attention at the prefill's own shape, its batch included
    res["kernel_rows"] = _fe_attention_rows(
        dev, torch.Generator(device=dev).manual_seed(320), "prefill",
        f"{LM_ARCH} prefill_32k", B, PREFILL_SEQ + n_pre, cfg.n_heads,
        cfg.n_kv_heads, False)
    # decode_32k: batch 128 over zero caches of 32768 entries
    Bd, T = DECODE_SHAPE.global_batch, DECODE_SHAPE.seq_len
    torch.cuda.reset_peak_memory_stats()
    caches = tasks.init_caches(cfg, Bd, T, torch.bfloat16, dev)
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in (caches.k, caches.v))
    tok = torch.randint(0, cfg.vocab_size, (Bd, 1), generator=gen,
                        device=dev)
    times = []
    for i in range(DECODE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = dec(p, caches, tok, T + i)
        tok = logits.argmax(-1)[:, None]
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    if not torch.isfinite(logits).all():
        fail("decode_32k's logits are not finite")
    ms = 1e3 * sum(times[1:]) / (len(times) - 1)
    log(f"  decode_32k {LM_ARCH} {L} layers, batch {Bd} over {T} cached "
        f"entries (KV cache {cache_bytes / 1e9:.2f} GB): {ms:.3f} ms a step "
        f"(steps 2-{DECODE_STEPS}), {Bd / ms * 1e3:.1f} tokens/s, "
        f"max_memory_allocated {peak / 2**30:.2f} GiB ({peak} bytes)")
    res["decode_32k"] = {"batch": Bd, "cache_len": T,
                         "cache_bytes": cache_bytes, "ms_per_step": ms,
                         "s_per_step": times, "peak_bytes": peak,
                         "profile": profile(
                             lambda: dec(p, caches, tok, T + DECODE_STEPS),
                             f"one decode_32k step, {LM_ARCH} {L} layers, "
                             f"batch {Bd}")}
    del caches, logits, p
    return res


# ----------------------------------------------------------------- phase 36
SWEEP_LAYERS, SWEEP_STEPS = 8, 2
SWEEP_TRAINERS = ("flow_grpo", "awm")


def sweep_path(tmp: str) -> dict:
    """``python -m repro_torch.launch.sweep`` in train mode on the card: a
    base config of smollm-360m at full width and ``SWEEP_LAYERS`` of its 32
    layers (``arch_overrides``) in phase 17's geometry, ``--steps 2`` over
    ``--grid flow.trainer_type=flow_grpo,awm``.  Each combo is a fresh
    ``repro_torch.launch.train`` process on the card, whose kernel
    counters start at 0 and are written at its exit
    (``REPRO_KERNEL_COUNTS``): they must match the path
    (``_train_want``; the attention on the tensor cores); each artifact
    must hold 2 finite history rows; the same command again skips both."""
    work = os.path.join(tmp, "sweep")
    kdir = os.path.join(work, "kernel_counts")
    os.makedirs(kdir)
    base = os.path.join(work, "base.json")
    with open(base, "w") as f:
        json.dump({"arch": DENSE_ARCH, "param_dtype": "bfloat16",
                   "arch_overrides": {"n_layers": SWEEP_LAYERS},
                   "flow": {"sde_type": "flow_sde", "num_steps": NUM_STEPS,
                            "group_size": GROUP, "latent_tokens": LAT_TOKENS,
                            "latent_dim": LAT_DIM, "advantage_agg": "gdpo",
                            "rewards": TRAIN_REWARDS,
                            "cache_dir": os.path.join(work, "cache")},
                   "data": {"encoder": {"cond_dim": COND_DIM,
                                        "cond_len": COND_LEN},
                            "batch_prompts": PROMPTS,
                            "n_prompts": PROMPTS * SWEEP_STEPS},
                   "loop": {"save_every": 0, "log_every": 1}}, f)
    cmd = [sys.executable, "-m", "repro_torch.launch.sweep", "--config",
           base, "--steps", str(SWEEP_STEPS), "--device", "cuda", "--grid",
           "flow.trainer_type=" + ",".join(SWEEP_TRAINERS)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=work, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=dict(env, REPRO_KERNEL_COUNTS=kdir))
    out, err = proc.communicate(timeout=600)
    first_s = time.perf_counter() - t0
    log("  " + out.strip().replace("\n", "\n  "))
    if proc.returncode != 0 or out.count("[ok]") != len(SWEEP_TRAINERS):
        fail(f"the sweep failed (rc {proc.returncode}): {out}\n{err[-3000:]}")
    # the combos' counters in the order they ran, the sweep's own left out
    files = sorted((f for f in os.listdir(kdir)
                    if f != f"{proc.pid}.json"),
                   key=lambda f: os.path.getmtime(os.path.join(kdir, f)))
    if len(files) != len(SWEEP_TRAINERS):
        fail(f"the sweep's combos wrote {len(files)} kernel counts")
    res = {"combos": {}, "s_first": first_s}
    for name, fname in zip(SWEEP_TRAINERS, files):
        with open(os.path.join(kdir, fname)) as f:
            got = json.load(f)
        want = _train_want(name, SWEEP_STEPS, SWEEP_LAYERS,
                           "flash_attention", "flash_attention_bwd")
        launches = {k: got[k] for k in want}
        art = os.path.join(work, "experiments", "sweep",
                           f"flow_trainer_type={name}.json")
        with open(art) as f:
            hist = json.load(f)
        finite = all(math.isfinite(v) for r in hist for v in r.values()
                     if isinstance(v, float))
        log(f"  {name}: launches {launches} (expected {want}); "
            f"{len(hist)} history rows, loss "
            f"{[r['loss'] for r in hist]}")
        if launches != want or got["flash_attention/wgmma"] != want[
                "flash_attention"] or got["flash_attention_bwd/wgmma"] != \
                want["flash_attention_bwd"]:
            fail(f"the sweep's {name} combo's launches do not match the "
                 f"path: {got}")
        if len(hist) != SWEEP_STEPS or not finite:
            fail(f"the sweep's {name} artifact is not {SWEEP_STEPS} finite "
                 f"rows: {hist}")
        res["combos"][name] = {"launches": launches, "history": hist}
    t0 = time.perf_counter()
    again = subprocess.run(cmd, cwd=work, capture_output=True, text=True,
                           timeout=120, env=env)
    res["s_rerun"] = time.perf_counter() - t0
    if again.returncode != 0 or again.stdout.count("[skip]") != len(
            SWEEP_TRAINERS):
        fail(f"the sweep's rerun did not skip both combos: {again.stdout}")
    log(f"  sweep: {first_s:.1f} s for {len(SWEEP_TRAINERS)} combos, the "
        f"rerun {res['s_rerun']:.1f} s skipping both")
    return res


def lm_phase(dev) -> dict:
    """Phase 35: the decode-versus-forward checks for every arch, then the
    32k prefill, its decodes and decode_32k."""
    res = {"decode_checks": {}}
    for arch in configs.ARCH_IDS + configs.PAPER_ARCHS:
        res["decode_checks"][arch] = check_decode_vs_forward(dev, arch)
        gc.collect()
        torch.cuda.empty_cache()
    res.update(lm_prefill_decode(dev))
    return res


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="", metavar="N,N,...",
                    help="run only these of phases 3-36 after the device and "
                         "build phases, and print no result lines (a "
                         "development aid; the check runs every phase)")
    args = ap.parse_args(argv)
    only = {int(n) for n in args.only.split(",") if n}
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the H100",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cap = torch.cuda.get_device_capability(dev)
    card = card_line()
    begin(1, f"device: {torch.cuda.get_device_name(dev)} capability {cap}; "
        f"torch {torch.__version__} CUDA {torch.version.cuda}")
    log(card)
    if cap != (9, 0):
        fail(f"capability {cap}, the kernels are built for sm_90a")

    begin(2, "build: one nvcc per source in parallel")
    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"    build: {json.dumps(secs)} ({time.perf_counter() - t0:.2f} s "
        f"wall)")
    for name in _build.sources():
        _build.load(name)
    for name in ("flash_attention", "flash_attention_bwd", "ssd_scan",
                 "ssd_scan_bwd_wgmma"):
        sass = sass_counts(name)
        log(f"    {name} SASS: {json.dumps(sass)}")
        if isinstance(sass, dict) and not (sass["HGMMA"] and sass["UTMALDG"]):
            fail(f"the {name} library has no wgmma or no TMA load")

    if only:
        return run_only(dev, only)

    begin(3, "kernels against their plain versions")
    rows = [check_sde(dev), check_attention(dev), check_attention_bwd(dev),
            *check_grpo(dev)]

    begin(4, "velocity at full width, depth 2")
    check_velocity(dev)
    torch.cuda.empty_cache()

    begin(5, "main path: repro_torch.launch.serve, full flux_dit")
    res = main_path()
    eng, lat_zero = res.pop("engine"), res.pop("latents")

    begin(6, "profile of one denoising step of the engine")
    res["profile"] = profile_step(eng, SEQ)

    begin(7, "drawn modulation: served through the kernels vs plain replay")
    res["modulated"] = check_modulated(eng, lat_zero)
    del eng, lat_zero
    gc.collect()
    torch.cuda.empty_cache()

    begin(8, f"train path: repro_torch.launch.train, flux_dit at full width, "
        f"{TRAIN_LAYERS} blocks")
    with tempfile.TemporaryDirectory() as tmp:
        train_res = train_path(tmp)
    gc.collect()
    torch.cuda.empty_cache()

    begin(9, "one update of each trainer through the kernels vs the plain "
        "versions")
    update_res = check_updates(dev)
    gc.collect()
    torch.cuda.empty_cache()

    begin(10, "ssd_scan against its plain versions")
    ssd_row = check_ssd(dev)

    begin(11, f"velocity of {SSM_ARCH} at full width, depth 2")
    ssm_vel = check_ssm_velocity(dev)
    gc.collect()
    torch.cuda.empty_cache()

    begin(12, f"ssm path: repro_torch.launch.serve, {SSM_ARCH}, "
        f"{SSM_LAYERS} layers")
    ssm_res = ssm_path()
    ssm_res["velocity_check"] = ssm_vel
    gc.collect()
    torch.cuda.empty_cache()
    begin(13, f"{SSM_ARCH} in f32, SSM leaves drawn: served through the "
        f"kernels vs plain replay")
    ssm_res["replay_f32"] = check_ssm_replay()
    gc.collect()
    torch.cuda.empty_cache()

    begin(14, "ssd_scan backward against its plain versions")
    ssd_bwd_row = check_ssd_bwd(dev)
    gc.collect()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        begin(15, "dense velocity at full width, depth 2")
        dense_res = {"velocity_checks": check_dense_velocities(dev)}
        gc.collect()
        torch.cuda.empty_cache()

        begin(16, f"dense path: repro_torch.launch.serve, {DENSE_ARCH}, "
            f"{DENSE_LAYERS} layers")
        dense_res["serve"] = dense_serve_path()
        gc.collect()
        torch.cuda.empty_cache()

        begin(17, f"dense train path: repro_torch.launch.train, {DENSE_ARCH}"
            f", {DENSE_LAYERS} layers, the five trainers")
        dense_res["train"] = dense_train_path(tmp)
        gc.collect()
        torch.cuda.empty_cache()

        begin(18, f"one update of each trainer on {SSM_ARCH} through the "
            f"kernels vs the plain versions")
        ssm_update = check_updates(dev, SSM_ARCH)
        gc.collect()
        torch.cuda.empty_cache()

        begin(19, f"ssm train path: repro_torch.launch.train, {SSM_ARCH}, "
            f"{SSM_TRAIN_LAYERS} layers, the five trainers")
        ssm_train = ssm_train_path(tmp)
        gc.collect()
        torch.cuda.empty_cache()

        begin(20, f"{SSM_ARCH}, {SSM_TRAIN_LAYERS} layers, under "
            f"perf.remat=block; scan + remat_offload against phase 19's "
            f"none; one update at depth {UPDATE_LAYERS} under block against "
            f"none")
        perf_res = {"ssm_block": ssm_block_path(tmp,
                                                ssm_train["flow_grpo"]),
                    "block_update": check_block_update(dev, SSM_ARCH)}
        gc.collect()
        torch.cuda.empty_cache()

        begin(21, f"the fused, pipelined step: {SSM_ARCH}, "
            f"{SSM_TRAIN_LAYERS} layers, {FUSED_STEPS} steps; at depth "
            f"{UPDATE_LAYERS} replayed against eager, sync-free, f32 policy")
        perf_res["fused"] = fused_path(tmp)
        perf_res["fused_update"] = check_fused_update(dev)
        perf_res["f32_policy_velocity"] = check_f32_policy_velocity(dev)
        gc.collect()
        torch.cuda.empty_cache()

        begin(22, f"flux_dit at {FLUX_BLOCK_LAYERS} blocks and {DENSE_ARCH} "
            f"at {DENSE_LAYERS} layers under perf.remat=block; one flux_dit "
            f"update at depth {UPDATE_LAYERS} under block against none")
        perf_res["block_train"] = flux_block_path(tmp)
        perf_res["flux_block_update"] = check_block_update(dev, "flux_dit")
        gc.collect()
        torch.cuda.empty_cache()

        begin(23, "distributed/: a one-rank NCCL group and mesh; the mesh "
            "path against none, microbatch 2, the fused step on the mesh; "
            f"{SSM_ARCH} at {SSM_TRAIN_LAYERS} layers and flux_dit at "
            f"{FLUX_BLOCK_LAYERS} blocks with microbatch 2; checkpoint; "
            "sharded serving")
        dist_res = distributed_phase(dev, tmp)
        gc.collect()
        torch.cuda.empty_cache()

        begin(24, f"training through the serving engine: {SSM_ARCH}, "
            f"{SSM_TRAIN_LAYERS} layers, rollouts in chunks of "
            f"{ENGINE_BATCH}; at depth {UPDATE_LAYERS} against the "
            "engine-free step and on a one-rank mesh")
        engine_res = engine_phase(dev, tmp, ssm_train["flow_grpo"])
        gc.collect()
        torch.cuda.empty_cache()

        begin(25, "the attention kernels at head dim 80 and the scan at the "
            f"{HY_ARCH} shape against their plain versions; times")
        hy_rows = kernels_d80(dev)
        gc.collect()
        torch.cuda.empty_cache()

        begin(26, f"hybrid path: repro_torch.launch.serve, {HY_ARCH}, "
            f"{HY_LAYERS} layers; the velocity at depth {UPDATE_LAYERS} "
            "against the plain versions")
        hy_res = {"serve": hybrid_serve_path(dev)}
        gc.collect()
        torch.cuda.empty_cache()

        begin(27, f"hybrid train path: repro_torch.launch.train, {HY_ARCH}, "
            f"{HY_TRAIN_LAYERS} layers under perf.remat=block; one update "
            f"of each trainer at depth {UPDATE_LAYERS} against the plain "
            "versions")
        hy_res["train"] = hybrid_train_path(dev, tmp)
        gc.collect()
        torch.cuda.empty_cache()

        begin(28, "the attention kernels at a query/key dim of 192 and a "
            "value dim of 128 against their plain versions; times")
        mla_rows = check_attention_mla(dev)
        gc.collect()
        torch.cuda.empty_cache()

        begin(29, f"{DS_ARCH} served: repro_torch.launch.serve at "
            f"{DS_SERVE_LAYERS} layers; the velocity at depth "
            f"{UPDATE_LAYERS} against the plain versions")
        moe_res = {DS_ARCH: deepseek_serve_phase(dev)}
        gc.collect()
        torch.cuda.empty_cache()

        begin(30, f"{DS_ARCH} trained: repro_torch.launch.train at "
            f"{DS_TRAIN_LAYERS} layers under perf.remat=block; one update of "
            f"each trainer at depth {UPDATE_LAYERS} against the plain "
            "versions")
        moe_res[DS_ARCH]["train"] = deepseek_train_phase(dev, tmp)
        gc.collect()
        torch.cuda.empty_cache()

        begin(31, f"{GROK_ARCH} served: repro_torch.launch.serve at "
            f"{GROK_SERVE_LAYERS} layers; the velocity at depth "
            f"{UPDATE_LAYERS} against the plain versions")
        moe_res[GROK_ARCH] = grok_serve_phase(dev)
        gc.collect()
        torch.cuda.empty_cache()

        begin(32, "the attention kernels at the frontend archs' shapes (GQA "
            "groups of 7 and 1 at head dim 64) and the LM train step's, "
            "against their plain versions; times")
        fe_rows = check_attention_frontends(dev)
        gc.collect()
        torch.cuda.empty_cache()

        begin(33, "the frontend archs' flow path: " + ", ".join(
            f"{a} served and trained at {n} layers" for a, n in
            FE_ARCHS.items()) + f"; the velocity at depth {UPDATE_LAYERS} "
            "against the plain versions")
        fe_res = frontend_phase(dev, tmp)
        gc.collect()
        torch.cuda.empty_cache()

    begin(34, f"the LM train step: {LM_ARCH} at full width and depth, "
        f"train_4k's length, batch {LM_BATCH}; at depth {UPDATE_LAYERS} "
        "against the plain versions")
    lm_res = {"train": lm_train_path(dev)}
    gc.collect()
    torch.cuda.empty_cache()
    lm_res["update_check"] = check_lm_update(dev)
    gc.collect()
    torch.cuda.empty_cache()

    begin(35, "prefill and decode: decode against the forward for every "
        f"arch at depth 2; {LM_ARCH} prefill_32k, decodes and decode_32k")
    lm_res.update(lm_phase(dev))
    gc.collect()
    torch.cuda.empty_cache()

    begin(36, f"the sweep: repro_torch.launch.sweep, {DENSE_ARCH} at "
          f"{SWEEP_LAYERS} layers, {' and '.join(SWEEP_TRAINERS)}, "
          f"{SWEEP_STEPS} steps each in its own process; then rerun")
    with tempfile.TemporaryDirectory() as tmp:
        sweep_res = sweep_path(tmp)

    def by_path(name: str) -> dict:
        return {"serve": res["launches"][name],
                "train": train_res["launches"][name],
                "serve_ssm": ssm_res["launches"][name],
                "serve_dense": dense_res["serve"]["launches"][name],
                "train_dense": {t: r["launches"][name]
                                for t, r in dense_res["train"].items()},
                "train_ssm": {t: r["launches"][name]
                              for t, r in ssm_train.items()},
                "train_ssm_block": perf_res["ssm_block"]["block"][
                    "launches"][name],
                "train_ssm_fused": perf_res["fused"]["launches"][name],
                "train_flux16_block": perf_res["block_train"]["flux_dit"][
                    "launches"][name],
                "train_dense_block": perf_res["block_train"][DENSE_ARCH][
                    "launches"][name],
                "train_ssm_mb2_mesh": dist_res["train"][SSM_ARCH][
                    "launches"][name],
                "train_flux16_block_mb2_mesh": dist_res["train"]["flux_dit"][
                    "launches"][name],
                "serve_ssm_mesh": dist_res["serve"]["launches"][name],
                "train_ssm_engine": engine_res["train"]["launches"][name],
                "serve_hybrid": hy_res["serve"]["launches"][name],
                "train_hybrid_block": hy_res["train"]["block"]["launches"][
                    name],
                "serve_deepseek": moe_res[DS_ARCH]["serve"]["launches"][name],
                "train_deepseek_block": moe_res[DS_ARCH]["train"]["block"][
                    "launches"][name],
                "serve_grok": moe_res[GROK_ARCH]["serve"]["launches"][name],
                **{f"serve_{a}": fe_res[a]["serve"]["launches"][name]
                   for a in FE_ARCHS},
                **{f"train_{a}": fe_res[a]["train"]["launches"][name]
                   for a in FE_ARCHS},
                "lm_train_internvl2": lm_res["train"]["launches"][name],
                "lm_prefill_internvl2": lm_res["prefill"]["launches"][name],
                **{f"sweep_{t}": r["launches"][name]
                   for t, r in sweep_res["combos"].items()}}

    for row in rows:
        row["launches"] = train_res["launches"][row["name"]]
        row["launches_by_path"] = by_path(row["name"])
    ssd_row["launches"] = ssm_res["launches"]["ssd_scan"]
    ssd_row["launches_by_path"] = by_path("ssd_scan")
    ssd_bwd_row["launches"] = ssm_train["flow_grpo"]["launches"][
        "ssd_scan_bwd"]
    ssd_bwd_row["launches_by_path"] = by_path("ssd_scan_bwd")
    rows += [ssd_row, ssd_bwd_row]
    # the hybrid's rows: launches on its serving path (forwards) and its
    # train path (backwards)
    for row in hy_rows:
        base = row["name"].rsplit("_", 1)[0]
        path = "serve_hybrid" if "bwd" not in base else "train_hybrid_block"
        row["launches_by_path"] = by_path(base)
        row["launches"] = row["launches_by_path"][path]
    rows += hy_rows
    # the (192, 128) rows: the wrappers' launches at that dim pair on the
    # MoE paths (``pair_launches``; the earlier paths' archs have no
    # latent attention), on deepseek's serving path (forwards) and its
    # train path (backwards)
    ds = moe_res[DS_ARCH]
    for row in mla_rows:
        base = row["name"].rsplit("_", 1)[0]
        path = "serve_deepseek" if "bwd" not in base else \
            "train_deepseek_block"
        row["launches_by_path"] = {
            p: r["pair_launches"][base][f"{MLA_QK}x{MLA_V}"] for p, r in (
                ("serve_deepseek", ds["serve"]),
                ("train_deepseek_block", ds["train"]["block"]),
                ("serve_grok", moe_res[GROK_ARCH]["serve"]))}
        row["launches"] = row["launches_by_path"][path]
    rows += mla_rows
    # the new shapes' rows, each with the launches of the path that runs
    # it at that shape: internvl2-1b's (a group of 7) and musicgen-large's
    # (a group of 1) flow shapes on their own serving (forwards) and train
    # (backwards) paths, the LM train shape on the LM train step, the
    # prefill shape (at the prefill's batch) on the 32k prefill
    fe_rows += lm_res.pop("kernel_rows")
    for row in fe_rows:
        bwd = "_bwd_" in row["name"]
        row["launches_by_path"] = by_path("flash_attention_bwd" if bwd
                                          else "flash_attention")
        case = row["name"].rsplit("_", 1)[1]
        row["launches"] = row["launches_by_path"][{
            "g7": f"{'train' if bwd else 'serve'}_internvl2-1b",
            "g1": f"{'train' if bwd else 'serve'}_musicgen-large",
            "lm": "lm_train_internvl2",
            "prefill": "lm_prefill_internvl2"}[case]]
    rows += fe_rows
    keys = ("name", "route", "variant", "source", "replaces", "launches",
            "max_abs_err", "max_rel_err", "max_rel_err_wgmma", "ms", "fma_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms",
            "launches_by_path", "times_by_batch", "dense_shape",
            "launch_floor_ms", "max_abs_err_f32", "forward_with_lse_ms",
            "library_note", "shape")
    print(json.dumps({"main_path": {k: v for k, v in res.items()
                                    if k != "launches"}}))
    print(json.dumps({"train_path": {k: v for k, v in train_res.items()
                                     if k != "launches"},
                      "update_check": update_res}))
    print(json.dumps({"ssm_path": {k: v for k, v in ssm_res.items()
                                   if k != "launches"}}))
    print(json.dumps({"dense_path": dense_res}))
    print(json.dumps({"ssm_train_path": ssm_train,
                      "update_check": ssm_update}))
    print(json.dumps({"perf_path": perf_res}))
    print(json.dumps({"distributed_path": dist_res}))
    print(json.dumps({"engine_path": engine_res}))
    print(json.dumps({"hybrid_path": hy_res}))
    print(json.dumps({"moe_path": moe_res}))
    print(json.dumps({"frontend_path": fe_res}))
    print(json.dumps({"lm_path": lm_res}))
    print(json.dumps({"sweep_path": sweep_res}))
    print(json.dumps({"phase_times": phase_times()}))
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in rows]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _in_tmp(fn):
    def run():
        with tempfile.TemporaryDirectory() as tmp:
            return fn(tmp)
    return run


def run_only(dev, only: set) -> int:
    phases = {3: lambda: [check_sde(dev), check_attention(dev),
                          check_attention_bwd(dev), *check_grpo(dev)],
              8: _in_tmp(train_path), 9: lambda: check_updates(dev),
              10: lambda: check_ssd(dev), 11: lambda: check_ssm_velocity(dev),
              12: ssm_path, 13: check_ssm_replay,
              14: lambda: check_ssd_bwd(dev),
              15: lambda: check_dense_velocities(dev),
              16: dense_serve_path, 17: _in_tmp(dense_train_path),
              18: lambda: check_updates(dev, SSM_ARCH),
              19: _in_tmp(ssm_train_path),
              20: lambda: (_in_tmp(ssm_block_path)(),
                           check_block_update(dev, SSM_ARCH)),
              21: lambda: (_in_tmp(fused_path)(), check_fused_update(dev),
                           check_f32_policy_velocity(dev)),
              22: lambda: (_in_tmp(flux_block_path)(),
                           check_block_update(dev, "flux_dit")),
              23: _in_tmp(lambda tmp: distributed_phase(dev, tmp)),
              24: _in_tmp(lambda tmp: engine_phase(dev, tmp)),
              25: lambda: kernels_d80(dev),
              26: lambda: hybrid_serve_path(dev),
              27: _in_tmp(lambda tmp: hybrid_train_path(dev, tmp)),
              28: lambda: check_attention_mla(dev),
              29: lambda: deepseek_serve_phase(dev),
              30: _in_tmp(lambda tmp: deepseek_train_phase(dev, tmp)),
              31: lambda: grok_serve_phase(dev),
              32: lambda: check_attention_frontends(dev),
              33: _in_tmp(lambda tmp: frontend_phase(dev, tmp)),
              34: lambda: (lm_train_path(dev), check_lm_update(dev)),
              35: lambda: lm_phase(dev), 36: _in_tmp(sweep_path)}
    for n in sorted(only):
        if n not in phases:
            fail(f"--only: phase {n} cannot run alone")
        begin(n, "(--only)")
        phases[n]()
        gc.collect()
        torch.cuda.empty_cache()
    phase_times()
    return 0


if __name__ == "__main__":
    sys.exit(main())
