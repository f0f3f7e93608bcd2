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
   full-width ``flux_dit`` at 19 of its 38 blocks (cut from 38 when
   phase 46 came; bf16, random weights from a seed) at
   FLUX.1-dev's 1024x1024 geometry (4096 latent tokens of width 64, a
   512-token condition of width 4096) under ``flow_sde``, 4 steps.  The
   kernels' launch counts must match the path: ``sde_step`` 4 per batch and
   ``flash_attention`` 19 x 4 per batch.
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
   128); at state 64 Mamba-2's init, a slow decay and zamba2-2.7b's path
   shape (80 heads of 64, N 64) at batch 4 and 1; in f32 and bf16, bitwise
   on rerun.  Each case must run the variant its dtype and shape call for:
   bf16 at head dim 64, state 128 or 64 and chunk 128 the tensor-core
   kernel (held also against its own rounding written out,
   ``ref.ssd_tensor_core_ref``, as a diagnostic), the rest the f32 FMA
   passes.  Then the tensor-core kernel's, the FMA passes', the plain
   version's and the bound's times at the path shape, at batch 4 and 1.
11. ``FlowAdapter.velocity`` of ``mamba2-370m`` at full width, depth 2, over
   511 + 1 + 4096 tokens, with the SSM leaves drawn from Mamba-2's init,
   through the kernels (every scan on the tensor-core kernel) and through
   the plain versions at the bf16 band; then with ``ops.ssd_scan`` stubbed
   to zeros, which must move it by ten bands.
12. The Mamba-2 serving path: ``repro_torch.launch.serve.main`` serving 4
   requests of ``mamba2-370m`` (24 of its 48 layers, cut from 48 when
   phase 46 came; bf16, random weights from a seed) over a 511-token condition of width 4096, one time token and 4096
   latent tokens of width 64 (4608 = 36 x 128 tokens: the scan takes no
   ragged chunk) under ``flow_sde``, 4 steps.  Launch counts must match the
   path (``ssd_scan`` 24 x 4 and ``sde_step`` 4 per batch), every
   ``ssd_scan`` launch on the tensor-core kernel; prints s per step, req/s,
   peak memory and a profile of one step.
13. The same 4 requests served in f32 through ``serve.main``, then again
   with the SSM leaves drawn, through the engine and the kernels: the
   latents equal ``rollout_keyed``'s through the kernels bitwise, and each
   of its steps is held against the same step through the plain versions
   from the same state.  With the leaves drawn the 24 layers amplify any
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
   make the gradient carried across chunks most of dx; phase 10's state-64
   cases too.  Each case must run the variant its dtype and shape call for:
   bf16 at head dim 64, state 128 or 64, chunk 128
   (``tensor_core_bwd_route``) the tensor-core backward
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
   ``smollm-360m``'s full width and 8 of its 32 layers (cut from 32 to 16
   when phase 44 came, to 8 when phase 45 did; phase 22 trains all 32
   under ``block``), phase 8's
   geometry,
   batch and rewards: ``flow_grpo`` for 2 steps (and a traced third), then
   ``mix_grpo``, ``grpo_guard``, ``nft`` and ``awm`` for 1 step each, with
   wq/wk drawn at train start (at the repository's init the gradients grow
   ~5x a layer and overflow), each with launch counts that match its path
   (the attention backward 8 per loss backward, ``grpo_loss`` only for
   flow_grpo and mix_grpo, no ``sde_step`` in the NFT/AWM rollouts), finite
   metrics, params that move, s per step and peak memory.
18. One update of each of the five trainers on ``mamba2-370m`` at full
   width, depth 2, batch 2, with the SSM leaves drawn, through the kernels
   and through the plain versions on the same injected draws, as phase 9:
   loss, grad norm, the grads of ``in_proj``, ``conv_w``, ``a_log`` and
   ``dt_bias``, and the params after AdamW at stated bands; every scan
   backward through the kernels runs the tensor-core variant.
19. The SSM train path: ``repro_torch.launch.train.main`` at
   ``mamba2-370m``'s full width and 24 of its 48 layers (cut from 48 when
   phase 45 came), bf16, phase 12's
   geometry and phase 8's batch and rewards: ``flow_grpo`` for 2 steps
   (and a traced third), then ``mix_grpo``, ``grpo_guard``, ``nft`` and
   ``awm`` for 1 step each, with the SSM leaves drawn at train start, each
   with launch counts that match its path (the scan forward 24 x T in the
   rollout and 24 per loss forward, every one on the tensor-core kernel;
   the backward 24 per loss backward, every one on the tensor-core
   backward), finite metrics, every layer's
   ``a_log`` and ``dt_bias`` gradient at the first update finite and
   nonzero, params that move, s per step and peak memory.
20. ``mamba2-370m`` at 12 layers (cut from 48 to 24 when phase 44 came,
   to 12 when phase 45 did) through
   ``launch.train`` under
   ``--set perf.remat=block --set perf.log_memory=true``, phase 19's
   geometry, batch, T and rewards: ``flow_grpo`` for 2 steps and a traced
   third, with launch counts (every scan forward twice per layer and SDE
   step of the loss: once in the forward, once recomputed in the
   backward), s per step, peak memory and ``memory_stats``; then 1 step
   each at phase 19's 24 layers under ``none``, ``scan`` and ``scan`` +
   ``remat_offload``, whose
   loss, grad norm and reward must be bitwise equal; then one update at
   depth 2 under ``block`` against ``none`` on one set of injected draws,
   to the reference's band.
21. The fused, pipelined step on the same model at 6 layers (cut from
   48 to 24 to keep the script near 900 s when phase 44 came, to 12 when
   phase 45 did, to 6 when phase 46 did):
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
   step); (c) ``mamba2-370m`` at 6 layers under ``none`` and ``flux_dit``
   at 4 blocks under ``block`` (cut from 48 and 16 when phase 44 came,
   the SSM to 12 from 24 when phase 45 did, to 6 and 4 when phase 46
   did),
   each with
   ``microbatch=2`` on the mesh,
   through ``launch.train``, 2 steps: launch counts, s a step, steps/s,
   peak memory, and the gradient all-reduce's device time against the
   step; (d) the mesh trainer's checkpoint restored without a mesh,
   bitwise; (e) ``mamba2-370m`` at 6 layers (cut from 48 when phase 46
   came) served on the mesh against
   the engine without one, a bucket of 4, per request bitwise.
24. Training through the serving engine: ``flow_grpo`` on
   ``mamba2-370m`` at its published width and phase 19's 24 layers, bf16,
   phase
   19's geometry, batch and rewards, through ``Experiment.build_trainer()``,
   ``trainer.attach_engine(ServingEngine.for_trainer(trainer,
   max_batch=2))`` and ``Experiment.train()`` for 2 steps: each rollout of
   2 prompts x group 2 runs in 2 chunks of bucket 2 (the engine's
   dispatches ``{"b2/s4": 4}``, no padded lane); launch counts per step
   (``sde_step`` 8, the scan forward 24 x 4 x 2 in the rollout and 24 x 4
   in the loss, its backward 24 x 4, ``grpo_loss`` and its backward 4
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
   64, chunk 128, bf16), which run the tensor-core kernels at state 64,
   against the plain versions, with the kernels', the f32 FMA passes'
   (``fma_route``), the plain versions' and the bounds' times.
26. The hybrid serving path: ``repro_torch.launch.serve.main`` serving 4
   requests of ``zamba2-2.7b`` (54 layers in 9 groups of 6 Mamba-2 blocks
   and one shared attention block, bf16, random weights from a seed) over
   511 + 1 + 4096 tokens under ``flow_sde``, 4 steps: launch counts (a
   velocity: ``ssd_scan`` 54, ``flash_attention`` 9, all on the tensor
   cores; ``sde_step`` 4 per batch), the latents
   bitwise ``rollout_keyed``'s through the kernels, s per step, req/s,
   peak memory and a profile of one step; then the velocity at depth 2 (2
   groups of one SSM block) with the SSM leaves and the shared wq/wk
   drawn, through the kernels against the plain versions in f32 and bf16.
27. The hybrid train path: ``repro_torch.launch.train.main`` at
   ``zamba2-2.7b``'s full width and 6 of its 54 layers (1 of its 9
   groups, one shared-attention site; cut from 12 when phase 46 came)
   under
   ``perf.remat=block``, ``flow_grpo`` for 2 steps and a traced third at
   phase 19's geometry, batch and rewards, SSM leaves and shared wq/wk
   drawn at train start: launch counts on their variants (every scan
   forward and backward on the tensor cores), every layer's
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
   at all layers of internvl2-1b and 24 of musicgen-large's 48 (cut from
   48 when phase 46 came; under ``perf.remat=block``: at 48 layers its
   3.23 B params with bf16 grads and f32 moments are ≈ 38.8 GB), AdamW at lr
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
37. The linter: ``python -m repro_torch.analysis --format json
   src/repro_torch examples_torch`` in a subprocess with ``torch``,
   ``numpy``, ``jax`` and ``repro`` blocked (it is stdlib-only); it must
   exit 0 (every finding suppressed inline with a reason, or in
   ``.torchlint-baseline.json``).
   Prints the files linted, the new, suppressed and baselined counts and
   the seconds.  Launches no kernel.
38. The reference's production layout (``repro_torch.sharding``'s rule
   tables: attention, SwiGLU and the vocabulary tensor-parallel over
   "model", ZeRO-3 over "data", KV caches by head) on a one-rank NCCL
   group's (1, 1) mesh: internvl2-1b at full width and all 24 layers
   (bf16, wq/wk drawn), batch 8 of ``train_4k``'s length after the vision
   prefix, 2 LM train steps, then a prefill of 2 rows over 1024 tokens and
   4 greedy decodes, bitwise the no-mesh path (loss, grad norm, every
   param, every logit), attention launches 2 x 24 forwards and 24
   backwards a step on ``wgmma``, no collective but the one-rank data
   means (at (1, 1) the layout shards nothing: its traffic is tested on
   four gloo ranks, ``tests/test_torch_layout.py``); the one-rank dry run
   of that step, its predicted peak within 10 % of the measured one; and
   two 16 x 16 pairs (``qwen3-32b`` ``train_4k``,
   ``musicgen-large`` ``decode_32k``), each a ``launch.dryrun`` process
   started at the phase's start: predicted peak a rank and fit.
39. The MoE family tensor-parallel over "model" at the production
   layout's mp = 16, emulated on the card: one full-width
   ``deepseek-v2-236b`` MoE layer (MLA, 160 routed experts top-6, 2
   shared) and one ``grok-1-314b`` MoE layer (GQA, 8 experts top-2), bf16,
   random weights from a seed, their attention and mixture-of-experts
   regions from random normed inputs at the flow shape (4 x 4608) and
   random upstream gradients: whole, then as each of the 16 ranks in turn
   with its shard of every leaf (MLA's and GQA's heads, the experts' and
   shared experts' hidden dim) over a one-rank NCCL group standing in for
   the 16 (its *f* and *g* the identity, so each rank's outputs and input
   gradients are its partial sums).  The ranks' outputs and input
   gradients, summed, the shards' gradients, concatenated, and the
   gradients of the leaves every rank holds whole (MLA's latent
   projections and norms, the router, grok's kv projections), summed, are
   each held to 3e-2 of the whole layer's max; the ranks' attention runs
   16 forwards and 16 backwards on ``wgmma``, deepseek's at 8 heads of
   (192, 128).  Then that rank shape against its plain versions, and its
   kernel, plain, SDPA and bound times.
40. The Mamba-2 blocks tensor-parallel over "model" at mp = 16, emulated
   as in phase 39: one full-width ``zamba2-2.7b`` block (80 SSD heads of
   64, state 64) and one ``mamba2-370m`` block (32 heads, state 128),
   bf16, SSM leaves drawn from Mamba-2's init, from a random normed input
   at the flow shape (4 x 4608) and a random upstream gradient: whole,
   then as each of the 16 ranks with its shard of every leaf (in_proj's
   and the conv's components by rank, the heads' a_log, d_skip, dt_bias,
   norm rows and out_proj rows).  Two exchanges a one-rank group cannot
   carry are emulated: each rank is handed the gathered B and C columns
   of in_proj and the conv, and their gradients are summed over the
   ranks; the gated norm's sum of squares is summed over the ranks in a
   first pass, each rank's gradient of the total in a second, and the
   backward runs in a third with their sum.  Outputs and input gradients
   (summed), the shards' gradients (concatenated) and the B / C columns'
   (summed) are held to 3e-2 of the whole block's max; every scan, 48
   forwards and 16 backwards, runs on ``wgmma`` at a rank's heads,
   (4, 4608, 5, 64) at state 64 and (4, 4608, 2, 64) at state 128.  Then
   those two scan shapes against their plain versions, and their kernel,
   FMA-pass, plain and bound times.
41. The sequence-sharded decode (the reference's ``cache_seq`` rule under
   ``REPRO_CACHE_SEQ_SHARD=model``) at mp = 16, emulated on the card: one
   ``flux_dit`` attention layer (24 heads of 128, whole over "model"),
   one ``qwen3-32b`` layer (4 of 64 q heads a rank, 8 kv heads whole) and
   one ``deepseek-v2-236b`` MLA layer (8 of 128 heads a rank) at full
   width over a 32768-entry cache of ``decode_32k``'s 8 rows a data rank,
   4 decode steps: the 16 ranks run the port's own decode at once, one
   host thread each, over a group whose collectives meet at a barrier
   (``ThreadGroup``), each with its 2048-entry segment.  Each step's
   output within 2e-2 of one device's max (the port's decode on the same
   card), the rolled segments, concatenated, equal to one device's rolled
   cache bit for bit; then ms a step of the whole layer and of one rank
   on its segment, beside their bytes bounds at 3.35 TB/s.
42. Expert parallelism (``REPRO_MOE_MODE=ep_model``) at mp = 16, emulated
   on the card: one ``deepseek-v2-236b`` MoE layer at full width (MLA and
   the routed and shared experts) at 4 x 4608 in bf16, whole, then as the
   16 ranks at once on host threads over a ``ThreadGroup``, each with its
   8 of 128 MLA heads, its 10 of 160 routed experts at the whole hidden
   dim and its 1/16 of the shared experts: the forwards' *g* all-reduces
   meet across the ranks, the backwards run one rank after another and
   the script sums what *f*'s backward would.  Each output, the summed
   input gradients and every weight gradient within 3e-2 of the whole
   layer's max; the attention 16 forwards and 16 backwards on ``wgmma`` at
   8 heads of (192, 128), nothing else; every MoE call on 10 experts'
   tables; each *g* handed f32.  Again under ``REPRO_BF16_REDUCE=1``, each
   *g* handed bf16.  Then one rank's routed experts, forward and
   backward, tensor mode (160 experts at f 96) against ep_model (10 at f
   1536), CUDA events beside their bounds.
43. The activation-gathered route (``REPRO_NO_WEIGHT_GATHER``, and every
   decode) at dp = 16, emulated on the card: each rank holds 1/16 of
   every matrix's d dim, kept at use, and each product moves rows over
   "data" instead (``sharding.rows_in`` / ``rows_out``).  One full-width
   ``smollm-360m`` dense layer and one ``mamba2-370m`` block at 16 rows x
   1024 tokens in bf16, a row a rank: whole, then as the 16 ranks, their
   forwards at once on host threads over a ``ThreadGroup`` (its
   all-gathers, reduce-scatters and all-to-alls meeting at a barrier),
   their backwards in rounds (autograd runs every CUDA backward on one
   device thread, so each rank's backward reruns until every collective
   it reaches has all the ranks' inputs).  The outputs and input
   gradients (the ranks' rows), each matrix's shard gradient times 16 and
   the whole leaves' gradients summed within 3e-2 of the whole layer's
   max; the attention and the scan forward and backward on ``wgmma`` at a
   rank's row, nothing else.  Then one ``deepseek-v2-236b`` decode layer
   (MLA's absorbed decode and the MoE, capacity ample) at 128 rows over a
   4096-entry cache, 8 rows a rank, against one device.
44. ``long_500k`` (524288 positions, batch 1): a prefill of 524160 =
   4095 x 128 tokens (``prefill_512k``, built here; the scan takes whole
   chunks), then decodes at positions 524160-524287.  Over 65536 tokens
   the attention archs take their window (``tasks.effective_window``,
   8192) and decode over a cache of the window's length.  (a) The
   attention kernel at (1, 524160, 15 / 5 heads of 64) under windows 8192
   and 8193 and at zamba2-2.7b's (1, 524160, 32 / 32 of 80) under 8192,
   bf16 on wgmma: five blocks of 1024 query rows (the first, the one
   across row W, the middle, an odd offset, the last) each row within
   ``ROW_BAND`` of ``layers.attention_chunked`` over the block's band of
   keys, the LSE within ``LSE_BAND``; the scan at (1, 524160, 32 heads of
   64, state 128) and (1, 524160, 80 of 64, state 64: x 2.68e9 elements)
   on wgmma, y and the final state against the plain chunked scan (16
   heads a call) at phase 10's bands, the state's gap also after 36 and
   512 chunks; their ms, plain ms and bounds (library: none).  (b)
   ``smollm-360m`` at 8 layers, ``mamba2-370m`` at 12 and
   ``zamba2-2.7b`` at 6 (cut from 32, 48 and 12 when phase 46 came), bf16,
   through ``tasks.make_prefill_step`` at
   the window over 524160 tokens (attention and scan launches counted,
   all on wgmma), each attention cache cut to its last 8192 entries, 128
   greedy ``make_decode_step`` steps: finite logits, prefill tokens/s,
   decode ms a step, peak and reserved memory.  (c) At depth 2 (zamba2-
   2.7b one group) in f32: a prefill of L tokens at window W + 1, the
   caches cut to W, 128 teacher-forced decodes, against the forward over
   L + 128 at W + 1 at every decoded position within ``DECODE_BAND`` (a
   decode attends its W cached keys and itself; mamba2-370m at window
   0), L = 524160 where it fits, else the longest of
   ``LONG_EXACT_LENS`` that does; and ``apply_rope`` on the card at
   positions 524160-524287 against float64.
45. The serving engine's captured executables (run right after phase 7,
   while phase 5's engine is alive; ``--only 45`` builds it through phase
   5's path).  Every serving phase above (5, 12, 16, 23's mesh serve, 24,
   26, 29, 31, 33) already runs through them: each warmup shape is run
   once eagerly and captured as a CUDA graph, each later dispatch is a
   replay, and their launch counts hold unchanged.  Here: (a) that
   ``flux_dit`` engine at b4 (warmed) and b1 (captured here), the replayed
   latents bitwise the eager executor's on the same seeds, and for each
   route one synchronised call's s a step and req/s and one traced call's
   device busy ms and idle share; (b) ``smollm-360m`` (8 of its 32
   layers) and ``mamba2-370m`` (12 of 48; cut from 32 and 48 when phase 46
   came) at full width through ``serve.main`` at buckets
   (1, 4), one tier of 4 steps, serving 5 requests (one b4, one b1
   dispatch, no cold one), a cold engine on the same params serving them
   again (one cold dispatch a shape, its latents bitwise the replays'),
   and the same replayed / eager figures at b1 and b4; (c) the trainer
   path at phase 24's cell: after one ``flow_grpo`` step (AdamW updates
   the params in place), the engine's replayed rollout bitwise an eager
   rollout at the new params, and ``mix_grpo`` with its window moving
   every step, the captures per SDE-mask pattern; (d) each engine's
   eager-run and capture seconds per shape, launches per replay and
   pool bytes beside ``max_memory_allocated``.
46. The examples (``examples_torch/``, the ports of ``examples/``), in
   turn, each in a fresh working directory (their configs write
   ``cache/...`` relative to it).  (f) first: the attention forward and
   backward at the e2e shape (16 rows of 16 + 64 tokens, 12 heads of 64,
   non-causal) and at the learning signal's reduced one (64 rows of 4 +
   8, 8 heads of 32), the scan at serve_flow's reduced mamba2-370m (4 rows
   of 17 tokens, 16 heads of 32, state 32, chunk 32: the FMA passes),
   ``sde_step`` and ``grpo_loss`` at the e2e's sizes, each against its
   plain version at the bands of phases 3, 10 and 32, with its ms, bound
   and SDPA's ms.  (a) ``train_grpo_e2e.py`` at its full configuration
   (the ~100M DiT, 12 layers of 768, 12 heads of 64; flow_sde, T = 8; 4
   prompts x group 4; three rewards under gdpo; 64 prompts through the
   default frozen encoder) for 200 steps with checkpoints at 100 and 200
   and its reward log, through the example's ``run``: its first 4 steps
   eagerly (as the example runs by default), then the 200 steps under
   ``perf.fuse_step`` (each step a replayed CUDA graph of the same
   kernels; an eager step is host-bound), their first 4 rows and reward
   log bitwise the eager ones; then a second run resumed from a copy of
   the step-100 checkpoint to step 200: its params, AdamW moments and
   step, its rows 100-199 and its reward log bitwise the first run's,
   every metric finite, launch counts those of the 304 steps; s a step
   (eager and replayed), peak memory, launches a step, one traced eager
   and one traced replayed step's idle share, early -> late reward
   (recorded, not asserted, as the example does).  (b) The
   reference's test_reward_improves (tests/test_trainers.py:38-63) for
   flow_grpo, nft and awm: mean(last 10) > mean(first 5) + 0.02 over 45
   steps.  (c) ``multi_reward.py``: 3 unique frozen towers for 4 reward
   configs, weighted_sum and gdpo 15 steps each, finite.  (d)
   ``quickstart.py``: flow_grpo, then awm, finite.  (e) ``serve_flow.py``:
   flux_dit and mamba2-370m (reduced) under ode and dance_sde through the
   warmed engine: no cold dispatch, the condition cache hit, each
   engine's latents bitwise an eager ``rollout_keyed`` on the same
   injected draws; req/s and warmup seconds.
47. ``main_path``, ``train_path``, ``ssm_path``, ``dense_path``,
   ``ssm_train_path``, ``perf_path``, ``distributed_path``,
   ``engine_path``, ``hybrid_path``, ``moe_path``, ``frontend_path``,
   ``lm_path``, ``sweep_path``, ``lint``, ``layout_path``,
   ``moe_layer_path``, ``ssm_layer_path``, ``seq_decode_path``,
   ``ep_layer_path``, ``route_path``, ``long_path``, ``graphs_path``,
   ``examples_path``, ``phase_times`` and ``kernels`` JSON lines, the
   card's name and power limit, and the last line ``{"ok": true,
   "device": {...}}``.

Each phase prints its seconds as it ends (``[N] took ... s``), and the
script the total.  ``--only N,...`` runs just the device and build phases
and phases N (3, 8-46) and prints no result lines: a development aid.
"""
from __future__ import annotations

import argparse
import concurrent.futures
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
from repro_torch.api import Experiment, apply_overrides  # noqa: E402
from repro_torch.api import loop as loop_lib  # noqa: E402
from repro_torch import optim as optim_lib  # noqa: E402
from repro_torch.config import (INPUT_SHAPES, FlowRLConfig,  # noqa: E402
                                InputShape, OptimConfig, PerfConfig,
                                RewardSpec, replace)
from repro_torch.core.rollout import (  # noqa: E402
    group_repeat, request_draws, request_seeds, rollout_keyed)
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
from repro_torch.models import layers as layers_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import params as params_lib  # noqa: E402
from repro_torch.models.backbone import Backbone, map_cache_spec  # noqa: E402
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
# flux_dit's serving depth: 19 of its 38 blocks (cut from 38 when phase
# 46 came)
NUM_STEPS, N_LAYERS = 4, 19
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
        log(f"    [{n}] took {secs:.1f} s; memory_allocated after it "
            f"{torch.cuda.memory_allocated()} bytes")
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
def depth(layers: int) -> list:
    """The CLI override that cuts an arch to ``layers`` layers."""
    return ["--set", "arch_overrides=" + json.dumps({"n_layers": layers})]


def main_path() -> dict:
    argv = ["--arch", "flux_dit", "--sde", "flow_sde", "--device", "cuda",
            "--requests", str(B_SERVE), "--max-batch", str(B_SERVE),
            "--bucket", str(B_SERVE), *depth(N_LAYERS),
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
        # the scan backward on the tensor cores (mamba2-370m at state 128,
        # zamba2-2.7b at 64), and zamba2-2.7b's attention backward
        want_routes = ({"ssd_scan_bwd": "wgmma",
                        "flash_attention_bwd": "wgmma"}
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
# mamba2-370m's serving depth: 24 of its 48 layers (cut from 48 when
# phase 46 came)
SSM_ARCH, SSM_LAYERS, SSM_COND_LEN = "mamba2-370m", 24, 511
SSM_SEQ = SSM_COND_LEN + 1 + LAT_TOKENS
SSM_HEADS, SSM_HEAD_DIM, SSM_STATE, SSM_CHUNK = 32, 64, 128, 128
# max |kernel - plain| / max |plain|: f32 sums in another order; in bf16 y
# is rounded once from f32 by both (a tie lands one bf16 ulp, 2^-8, apart)
SSD_Y_BAND = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
SSD_H_BAND = 1e-4        # the final state is f32 on both routes
# the scan at state 64 (zamba2-2.7b's SSD heads: 80 of 64, N 64, chunk 128,
# over phase 12's 4608 tokens): Mamba-2's init and a slow decay at a mid
# size, and the hybrid path's shape at batch 4 and 1 (phases 10 and 14 run
# them beside Mamba-2's cases)
HY_SSD_HEADS, HY_STATE = 80, 64
SSD_STATE64_CASES = [  # B, L, H, P, N, chunk, kind
    (2, 1024, 8, SSM_HEAD_DIM, HY_STATE, SSM_CHUNK, "mamba2"),
    (2, 1024, 4, SSM_HEAD_DIM, HY_STATE, SSM_CHUNK, "slow"),
    (B_SERVE, SSM_SEQ, HY_SSD_HEADS, SSM_HEAD_DIM, HY_STATE, SSM_CHUNK,
     "mamba2"),
    (1, SSM_SEQ, HY_SSD_HEADS, SSM_HEAD_DIM, HY_STATE, SSM_CHUNK, "mamba2"),
]


def ssd_want(dtype, L, P, N, Q) -> str:
    """The scan variant a call must run (forward and backward): the
    tensor cores for bf16 at head dim 64, state 128 (Mamba-2) or 64
    (zamba2) and a chunk of 128; the f32 FMA passes for the rest."""
    return ("wgmma" if dtype == torch.bfloat16 and P == SSM_HEAD_DIM
            and N in (SSM_STATE, HY_STATE) and min(Q, L) == SSM_CHUNK
            else "fma")


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
    the slow-decay cases and the path shape, and the state-64 cases
    (``SSD_STATE64_CASES``), f32 and bf16, bitwise on rerun, each case on
    the variant its dtype and shape call for (``ssd_want``: bf16 at head
    dim 64, state 128 or 64, chunk 128 on the tensor cores, the rest on the
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
    ] + SSD_STATE64_CASES
    path_err = 0.0
    for (B, L, H, P, N, Q, kind) in cases:
        for dt_ in (torch.float32, torch.bfloat16):
            x, dt, a, bm, cm = _ssd_inputs(g, dev, B, L, H, P, N, kind, dt_)
            (y, hT), variant = _ssd_variant(
                lambda: ssd_scan(x, dt, a, bm, cm, chunk=Q))
            want = ssd_want(dt_, L, P, N, Q)
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
            if L == SSM_SEQ and N == N_ and dt_ == torch.bfloat16:
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
    draw_ssm_leaves(p["backbone"]["blocks"]["ssm"], seed)


def draw_ssm_leaves(s: dict, seed: int) -> None:
    """``draw_ssm`` on one SSM leaf tree (stacked or one block's)."""
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
def _ssm_argv(dtype: str, layers: int = SSM_LAYERS) -> list:
    return ["--arch", SSM_ARCH, "--sde", "flow_sde", "--device", "cuda",
            "--requests", str(B_SERVE), "--max-batch", str(B_SERVE),
            "--bucket", str(B_SERVE), *depth(layers),
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
    its dtype and shape call for (``ssd_want``): bf16 at head dim 64, state
    128 or 64, chunk 128 (``tensor_core_bwd_route``) the tensor-core
    backward (held also against
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
    ] + SSD_STATE64_CASES
    path_err = 0.0
    worst, worst_tc = {}, {}
    for (B, L, H, P, N, Q, kind) in cases:
        for dt_ in (torch.float32, torch.bfloat16):
            x, dt, a, bm, cm = _ssd_inputs(g, dev, B, L, H, P, N, kind, dt_)
            x, bm, cm = _ssd_conv_slices(x, bm, cm)
            dy = torch.randn(x.shape, generator=g, device=dev).to(dt_)
            want_v = ssd_want(dt_, L, P, N, Q)
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
                if L == SSM_SEQ and N == N_ and dt_ == torch.bfloat16:
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
def _dense_argv(layers: int = DENSE_LAYERS) -> list:
    return ["--arch", DENSE_ARCH, "--sde", "flow_sde", "--device", "cuda",
            "--requests", str(B_SERVE), "--max-batch", str(B_SERVE),
            "--bucket", str(B_SERVE), *depth(layers),
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


# phase 17's depth (cut from all 32 layers to 16 with phases 20, 21 and 23
# to keep the script near 900 s once phase 44 ran, to 8 once phase 45 did;
# phase 22 still trains all 32 under remat=block)
DENSE_TRAIN_LAYERS = 8


def dense_train_path(tmp: str) -> dict:
    """``train_trainers`` at smollm-360m's full width and
    ``DENSE_TRAIN_LAYERS`` layers,
    phase 8's geometry, with wq/wk drawn at train start
    (``draw_attention``: at the repository's init the gradients grow ~5x a
    layer and the gradient norm overflows); the first update's wq/wk
    gradients are held."""
    return train_trainers(
        tmp, DENSE_ARCH, DENSE_TRAIN_LAYERS, COND_LEN,
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
# cut from 48 layers (with phase 20's none and scan + remat_offload steps
# and phase 24's training, which share it) to keep the script near 1000 s
# once phase 45 ran
SSM_TRAIN_LAYERS = 24


def ssm_train_path(tmp: str) -> dict:
    """``train_trainers`` at mamba2-370m's full width and 24 of its 48
    layers,
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


# phase 20's block run's depth (cut from 48 to 24 with phases 17, 21 and
# 23 to keep the script near 900 s once phase 44 ran, and to 12 with phase
# 19 once phase 45 did); its none and scan + remat_offload steps run at
# phase 19's depth
BLOCK_LAYERS = 12


def ssm_block_path(tmp: str, none_row=None) -> dict:
    """mamba2-370m at ``BLOCK_LAYERS`` layers through ``launch.train`` under
    ``perf.remat=block`` (with ``perf.log_memory``): flow_grpo for 2 steps
    and a traced third, every scan forward twice per layer and SDE step of
    the loss.  Then 1 step under ``scan`` + ``remat_offload`` on phase
    19's prompts, against phase 19's first flow_grpo step (``none_row``;
    run here for 1 step when the phase runs alone): the same loss, grad
    norm and reward, bitwise (on the port both are the program of
    ``none``), and the peaks beside each other."""
    out = {}
    out["block"], trainer = train_one(
        tmp, SSM_ARCH, BLOCK_LAYERS, SSM_COND_LEN, SSM_KERNELS,
        _ssm_watch(), "flow_grpo", TRAIN_STEPS,
        extra=BLOCK + ("--set", "perf.log_memory=true"), tag="block",
        remat="block",
        profile_what=f"one {SSM_ARCH} train step under remat=block, "
                     f"{BLOCK_LAYERS} layers")
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
# the fused path's depth (cut from 48 to 24 with phases 17, 20 and 23 to
# keep the script near 900 s once phase 44 ran, to 12 once phase 45 did,
# to 6 once phase 46 did)
FUSED_LAYERS = 6
FUSED = ("--set", "perf.fuse_step=true", "--set", "perf.remat=block",
         "--set", "perf.offload_rewards=true",
         "--set", "perf.policy_dtype=bfloat16", "--set", "loop.pipeline=2",
         "--set", "perf.log_memory=true")
# f32 activations through two layers on the kernels' f32 variants against
# the plain versions: f32 sums in another order
F32_VEL_BAND = 1e-3


def fused_path(tmp: str) -> dict:
    """mamba2-370m at ``FUSED_LAYERS`` layers through ``launch.train`` with
    the fused
    step (captured once, then replayed), block remat, the reward towers
    offloaded to host memory, an explicit bf16 policy and a pipeline of 2,
    for 4 steps, and a profile of one more replay.  The launch counts are
    those of the kernels that ran: the eager first step and each replay.
    The towers' bytes are computed from their shapes; what is checked is
    that their store is in pinned host memory."""
    row, trainer = train_one(
        tmp, SSM_ARCH, FUSED_LAYERS, SSM_COND_LEN, SSM_KERNELS,
        _ssm_watch(), "flow_grpo", FUSED_STEPS, extra=FUSED, tag="fused",
        remat="block", captured=True,
        profile_what=f"one replayed fused {SSM_ARCH} train step, "
                     f"{FUSED_LAYERS} layers")
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


# (c)'s depths (cut from 48 layers and 16 blocks with phases 17, 20 and
# 21 to keep the script near 900 s once phase 44 ran; the SSM from 24 to
# 12 once phase 45 did)
# cut from 12 and 8 when phase 46 came
MESH_SSM_LAYERS, MESH_FLUX_BLOCKS = 6, 4


def mesh_train_path(tmp: str, mesh) -> dict:
    """(c) Full width and depth through ``launch.train`` on the mesh with
    ``dist.microbatch=2``, flow_grpo, 2 steps, phase 19's and phase 22's
    geometry, batch and rewards: mamba2-370m at ``MESH_SSM_LAYERS``
    layers under ``remat=none`` (SSM leaves drawn), then flux_dit at
    ``MESH_FLUX_BLOCKS`` blocks under
    ``block``.  Launch counts (each loss pass once per chunk), s a step,
    steps/s, peak allocated and reserved memory; and the device time of
    the step's gradient all-reduce over the one-rank "data" group (every
    leaf, f32), against the step."""
    out = {}
    out[SSM_ARCH], trainer = train_one(
        tmp, SSM_ARCH, MESH_SSM_LAYERS, SSM_COND_LEN, SSM_KERNELS,
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
        tmp, "flux_dit", MESH_FLUX_BLOCKS, COND_LEN,
        ("flash_attention", "flash_attention_bwd"),
        _TrainWatch("attn", ("wq", "wk", "wv")), "flow_grpo", TRAIN_STEPS,
        extra=BLOCK + MB2, tag="block_mb2", remat="block", mesh=mesh,
        microbatch=2)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_mesh_serving(dev, mesh) -> dict:
    """(e) mamba2-370m at ``MESH_SSM_LAYERS`` layers, SSM leaves drawn, 4
    requests in one bucket of 4, 4 steps of flow_sde: the engine on the
    one-rank mesh (its keyed executor: the bucket split over "data", the
    latents all-gathered) against the engine without one, per request
    bitwise."""
    from repro_torch.core import schedulers
    from repro_torch.serving import ServingEngine
    cfg = depth_cfg(SSM_ARCH, MESH_SSM_LAYERS)
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
# phase 19's engine-free flow_grpo on the same cell (24 layers), for
# comparison when phase 19 did not run in this call (as recorded in PERF.md
# §6, NVIDIA H100 80GB HBM3, 700 W: the second step's seconds,
# max_memory_allocated)
PHASE19_S_PER_STEP, PHASE19_PEAK_GIB = 1.6447, 36.82
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
    """Phase 24: flow_grpo on mamba2-370m at its published width and phase
    19's depth, bf16, trained 2 steps through an attached engine whose
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
HY_KERNELS = ({"ssd_scan": HY_LAYERS, "flash_attention": HY_SITES},
              {"ssd_scan_bwd": HY_LAYERS, "flash_attention_bwd": HY_SITES})
# every kernel of the bf16 hybrid runs on the tensor cores: the scan at
# state 64 and the shared attention at D = 80
HY_ROUTES = {"ssd_scan": "wgmma", "ssd_scan_bwd": "wgmma",
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
    80 heads of 64, state 64, chunk 128, bf16), which take the tensor-core
    kernels at state 64 (``ssd_shape_rows``)."""
    return ssd_shape_rows(dev, HY_SSD_HEADS, HY_STATE, "zamba2", 26)


def ssd_shape_rows(dev, H: int, N: int, tag: str, seed: int) -> list:
    """The scan forward and backward at (``B_SERVE``, ``HY_SEQ``, ``H``
    heads of 64, state ``N``, chunk 128, bf16, x, bm and cm as column
    slices of one buffer as the model passes them), on the tensor-core
    kernels: against the plain versions at phase 10's and 14's bf16
    bands, on the wgmma variant, then their times (replayed graphs), the
    f32 FMA passes' on the same inputs (``fma_route``), the plain
    versions' and the bounds.  Returns the two kernel rows, named
    ``ssd_scan_<tag>`` and ``ssd_scan_bwd_<tag>``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B, L, P, Q = B_SERVE, HY_SEQ, SSM_HEAD_DIM, SSM_CHUNK
    x, dt, a, bm, cm = _ssd_inputs(g, dev, B, L, H, P, N, "mamba2",
                                   torch.bfloat16)
    x, bm, cm = _ssd_conv_slices(x, bm, cm)
    dy = torch.randn(x.shape, generator=g, device=dev).to(x.dtype)
    before = all_variants()
    y, hT = ssd_scan(x, dt, a, bm, cm, chunk=Q)
    grads = ssd_scan_bwd(x, dt, a, bm, cm, dy, None, chunk=Q)
    ran = all_variants()
    for name in ("ssd_scan", "ssd_scan_bwd"):
        if ran[name]["wgmma"] - before[name]["wgmma"] != 1:
            fail(f"{name} at the {tag} shape did not run the tensor-core "
                 f"kernel")
    y_ref, h_ref = ref.ssd_chunked_ref(x, dt, a, bm, cm, Q)
    want = ref.ssd_scan_bwd_ref(x, dt, a, bm, cm, dy, None, Q)
    torch.cuda.synchronize()
    y_err, h_err = _rel(y, y_ref), _rel(hT, h_ref)
    g_err = [_rel(a_, b_) for a_, b_ in zip(grads, want)]
    abs_err = [float((y.float() - y_ref.float()).abs().max()), max(
        float((a_.float() - b_.float()).abs().max())
        for a_, b_ in zip(grads, want))]
    log(f"  ssd_scan {tag} shape (B={B}, L={L}, H={H}, P={P}, N={N}, Q={Q}) "
        f"bf16 (wgmma): y {y_err:.2e}, final state {h_err:.2e} of max|plain| "
        f"(bands {SSD_Y_BAND[torch.bfloat16]}, {SSD_H_BAND}); backward "
        + ", ".join(f"{n} {e:.2e}" for n, e in zip(SSD_GRADS, g_err))
        + " (bands " + "/".join(str(SSD_BWD_F32_BAND if f else
                                    SSD_BWD_BAND[torch.bfloat16])
                                for f in (False, True, True, False, False))
        + ")")
    if y_err > SSD_Y_BAND[torch.bfloat16] or h_err > SSD_H_BAND:
        fail(f"ssd_scan off at the {tag} shape")
    for n, e, f32_out in zip(SSD_GRADS, g_err,
                             (False, True, True, False, False)):
        if e > (SSD_BWD_F32_BAND if f32_out else SSD_BWD_BAND[torch.bfloat16]):
            fail(f"ssd_scan_bwd {n} off at the {tag} shape")
    del y, hT, grads, y_ref, h_ref, want
    torch.cuda.empty_cache()
    ms = graph_ms(lambda: ssd_scan(x, dt, a, bm, cm, chunk=Q), 5)
    bwd_ms = graph_ms(lambda: ssd_scan_bwd(x, dt, a, bm, cm, dy, None,
                                           chunk=Q), 3)
    with fma_route():
        fma_ms = graph_ms(lambda: ssd_scan(x, dt, a, bm, cm, chunk=Q), 5)
        fma_bwd_ms = graph_ms(lambda: ssd_scan_bwd(x, dt, a, bm, cm, dy,
                                                   None, chunk=Q), 3)
    plain_ms = cuda_ms(lambda: ref.ssd_chunked_ref(x, dt, a, bm, cm, Q), 2, 1)
    plain_bwd_ms = cuda_ms(lambda: ref.ssd_scan_bwd_ref(
        x, dt, a, bm, cm, dy, None, Q), 1, 1)
    rows = []
    for name, kms, fms, pms, bound_fn, src, rep_, err, aerr in (
            (f"ssd_scan_{tag}", ms, fma_ms, plain_ms, _ssd_fwd_bound,
             "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:77", y_err,
             abs_err[0]),
            (f"ssd_scan_bwd_{tag}", bwd_ms, fma_bwd_ms, plain_bwd_ms,
             _ssd_bwd_bound, "ssd_scan_bwd_wgmma.cu",
             "none (JAX autodiff of src/repro/models/ssm.py:84)",
             max(g_err), abs_err[1])):
        bound, by, nbytes, flops = bound_fn(B, L, H, P, N, Q)
        log(f"  {name} (B={B}, L={L}, H={H}, P={P}, N={N}, Q={Q}) bf16 on "
            f"the tensor cores: {kms:.4f} ms on the device, the f32 FMA "
            f"passes {fms:.4f} ms, plain {pms:.3f} ms, bound {bound:.4f} ms "
            f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        rows.append({
            "name": name, "route": "cuda", "variant": "wgmma",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": rep_, "max_abs_err": aerr, "max_rel_err": err,
            "ms": kms, "fma_ms": fms, "plain_ms": pms, "bound_ms": bound,
            "bound_by": by, "library_ms": None,
            "shape": [B, L, H, P, N, Q]})
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
    54 and ``flash_attention`` 9, all on the tensor cores), the latents
    bitwise ``rollout_keyed``'s through the kernels,
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
    on the tensor cores at D = 80, the scan at state 64) within
    BF16_BAND."""
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
        route = "wgmma" if dtype == torch.bfloat16 else "fma"
        log(f"  velocity {HY_ARCH} depth {UPDATE_LAYERS} (2 groups), {name}: "
            f"max|kernel - plain| {err:.3e} of max|v| {scale:.3e} (band "
            f"{band * scale:.3e}); launches {ran}, variants {variants}")
        if (ran["ssd_scan"], ran["flash_attention"]) != (2, 2) or \
                variants["ssd_scan"] != routed(2, route) or \
                variants["flash_attention"] != routed(2, route):
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
# 2 of the hybrid's 9 groups (12 layers, two shared-attention sites): cut
# from all 54 layers to 30 when the whole script reached ≈ 1050 s of its
# 1200 (the MoE layer phase, 39, came in), then to 12 to make room for the
# sequence-sharded decode (phase 41); the serving path (26) keeps all 54
# 6 of zamba2-2.7b's 54 layers: one group, one shared-attention site (cut
# from 12 when phase 46 came)
HY_TRAIN_LAYERS = 6
HY_TRAIN_KERNELS = (
    {"ssd_scan": HY_TRAIN_LAYERS, "flash_attention": HY_TRAIN_LAYERS // 6},
    {"ssd_scan_bwd": HY_TRAIN_LAYERS,
     "flash_attention_bwd": HY_TRAIN_LAYERS // 6})


def _hy_watch():
    return _TrainWatch("ssm", ("conv_w", "conv_b", "a_log"),
                       ("a_log", "dt_bias"),
                       lambda p, cfg: draw_hybrid(p, cfg, seed=29),
                       stack_dims=2)


def hybrid_train_path(dev, tmp: str) -> dict:
    """zamba2-2.7b at full width and ``HY_TRAIN_LAYERS`` layers through
    ``launch.train`` under ``perf.remat=block`` (each group checkpointed)
    with ``perf.log_memory``, flow_grpo, phase 19's geometry, batch and
    rewards, SSM leaves and shared wq/wk drawn at train start, 2 steps and
    a traced third: launch counts (a velocity 12 scans and 2 attentions,
    the loss each forward twice, the backward once, per SDE step), every
    layer's a_log and dt_bias gradient at the first update, s per step,
    peak memory; then one update of each of the five trainers at depth 2
    against the plain versions (``check_updates``)."""
    row, trainer = train_one(
        tmp, HY_ARCH, HY_TRAIN_LAYERS, HY_COND_LEN, HY_TRAIN_KERNELS,
        _hy_watch(),
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


def _mla_flops(backward: bool = False, heads: int = MLA_HEADS) -> float:
    """Operations of the causal attention at the MLA path's shape (at
    ``heads`` heads): each product over the half of the score matrix the
    mask keeps (S (S + 1) / 2 pairs), 2 flops a multiply-add; forward QK^T
    at 192 and PV at 128, backward QK^T and dO V^T recomputed, dV at 128,
    dQ and dK at 192."""
    pairs = B_SERVE * heads * HY_SEQ * (HY_SEQ + 1) / 2
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
        if stack in bb:
            _draw_qk(bb[stack]["attn"], cfg, gen)


def _draw_qk(attn: dict, cfg, gen) -> None:
    """``draw_qk_proj``'s draw of one attention's leaves (stacked or a
    layer's)."""
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
# the depths phase 33 trains them at: musicgen-large at 24 of its 48 layers
# (cut from 48 when phase 46 came)
FE_TRAIN_LAYERS = {"internvl2-1b": 24, "musicgen-large": 24}
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
    ``arch``'s full width and ``layers`` layers, phase 19's batch, T and
    rewards over 511 + 1 + 4096 tokens, AdamW at ``FE_LR`` with weight
    decay ``FE_WD``, wq/wk drawn at train start; musicgen-large under
    ``perf.remat=block`` (at all 48 layers its 3.23 B params with bf16
    grads and f32 moments are ≈ 38.8 GB before activations, and 48 layers
    of saved activations do not fit beside them), internvl2-1b under
    ``none``.
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
    at the repository's init printed), and trained at
    ``FE_TRAIN_LAYERS``."""
    out = {}
    for arch, layers in FE_ARCHS.items():
        res = {"serve": frontend_serve_path(arch, layers)}
        gc.collect()
        torch.cuda.empty_cache()
        res["velocity_check"] = check_dense_velocity(dev, arch, True,
                                                     cond_len=HY_COND_LEN)
        gc.collect()
        torch.cuda.empty_cache()
        res["train"] = frontend_train_path(tmp, arch,
                                           FE_TRAIN_LAYERS[arch])
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


# ----------------------------------------------------------------- phase 37
LINT_BLOCKED = ("torch", "numpy", "jax", "repro")


def lint_path() -> dict:
    """``python -m repro_torch.analysis --format json src/repro_torch
    examples_torch`` in a fresh interpreter with ``LINT_BLOCKED`` made
    unimportable, from the checkout's root (so the committed
    ``.torchlint-baseline.json`` is the baseline): it must exit 0 and
    import none of them."""
    code = ("import runpy, sys\n"
            f"for m in {LINT_BLOCKED!r}:\n"
            "    sys.modules[m] = None\n"
            "sys.argv = ['repro_torch.analysis', '--format', 'json', "
            "'src/repro_torch', 'examples_torch']\n"
            "runpy.run_module('repro_torch.analysis', run_name='__main__')\n")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"the linter exited {proc.returncode}: {proc.stdout[-3000:]}\n"
             f"{proc.stderr[-3000:]}")
    rep = json.loads(proc.stdout)
    res = {"files": rep["files"], "new": len(rep["new"]),
           "suppressed": len(rep["suppressed"]),
           "baselined": len(rep["baselined"]),
           "stale_baseline": len(rep["stale_baseline"]),
           "lint_s": rep["seconds"], "process_s": wall}
    log(f"  torchlint: {res['files']} files, {res['new']} new, "
        f"{res['suppressed']} suppressed, {res['baselined']} baselined; "
        f"{res['lint_s']} s linting, {wall:.3f} s with the interpreter's "
        "start")
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


# ----------------------------------------------------------------- phase 38
# the production layout's serving check: prefill over this many text
# tokens (after the prefix) of two of the step's rows, then decodes
LAYOUT_PREFILL_SEQ, LAYOUT_ROWS, LAYOUT_DECODES, LAYOUT_STEPS = 1024, 2, 4, 2
# the 16 x 16 pairs the phase dry-runs, each in its own process
LAYOUT_PAIRS = (("qwen3-32b", "train_4k"), ("musicgen-large", "decode_32k"))


def _layout_dryruns(tmp: str) -> dict:
    """Start the phase's dry runs on the host, each a process (the fake
    group is global to its process): the LM step of ``_layout_run`` on one
    rank (``one_rank``: at (1, 1) the production layout shards nothing,
    so its bytes are the no-mesh path's), and ``LAYOUT_PAIRS`` at 16 x 16
    through ``python -m repro_torch.launch.dryrun``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    out = os.path.join(tmp, "layout_dryrun")
    code = (
        "from repro_torch import configs\n"
        "from repro_torch.config import InputShape\n"
        "from repro_torch.launch import dryrun\n"
        f"dryrun.run_one({LM_ARCH!r}, InputShape({LM_SHAPE.name!r}, "
        f"{LM_SHAPE.seq_len}, {LM_SHAPE.global_batch}, 'train'), "
        f"out_dir={out!r}, one_rank=True)\n")
    procs = {"one_rank": subprocess.Popen(
        [sys.executable, "-c", code], cwd=str(ROOT), env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)}
    for arch, shape in LAYOUT_PAIRS:
        procs[f"{arch}__{shape}"] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--out-dir", out], cwd=str(ROOT),
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True)
    return {"dir": out, "procs": procs}


def _layout_records(runs: dict) -> dict:
    """Wait for ``_layout_dryruns``' processes and read their records."""
    out = {}
    for name, proc in runs["procs"].items():
        err = proc.communicate(timeout=300)[1]
        if proc.returncode:
            fail(f"the dry run {name} failed: {err[-2000:]}")
    for f in sorted(os.listdir(runs["dir"])):
        with open(os.path.join(runs["dir"], f)) as fh:
            rec = json.load(fh)
        out[f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"] = rec
    return out


def _layout_run(dev, cfg, batches, mesh=None) -> dict:
    """``LAYOUT_STEPS`` LM train steps of ``cfg`` from params drawn from a
    seed (wq/wk drawn), then the prefill of ``LAYOUT_ROWS`` rows over
    ``LAYOUT_PREFILL_SEQ`` tokens and ``LAYOUT_DECODES`` greedy decodes;
    on ``mesh`` under the production rules, else with no mesh.  Metrics,
    attention launches and variants of the train steps, the steps' peak
    over what was allocated before the params, the collectives issued
    (kind, group size), logits and params on the host."""
    from repro_torch.launch import hlo_stats
    from repro_torch import sharding as shlib
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev).manual_seed(380)
    p = tasks.init_params(cfg, gen, torch.bfloat16, dev)
    draw_attention({"backbone": p}, cfg.d_model, seed=381)
    step = tasks.make_train_step(cfg, OptimConfig())
    state = tasks.TrainState(p, optim_lib.adamw_init(p))
    ctx = (contextlib.nullcontext() if mesh is None else shlib.param_gather(
        mesh, shlib.production_rules(mesh)))
    with ctx, hlo_stats.record_collectives() as coll:
        reset_counts()
        hist = []
        for b in batches:
            state, m = step(state, b)
            hist.append({k: float(v) for k, v in m.items()})
        launches, variants = counts(), all_variants()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        b = batches[0]
        pre = {"tokens": b["tokens"][:LAYOUT_ROWS, :LAYOUT_PREFILL_SEQ],
               "prefix_embed": b["prefix_embed"][:LAYOUT_ROWS]}
        logits, caches = tasks.make_prefill_step(cfg)(p, pre)
        dec = tasks.make_decode_step(cfg)
        outs = [logits.cpu()]
        pos = LAYOUT_PREFILL_SEQ + cfg.frontend.n_tokens
        for i in range(LAYOUT_DECODES):
            logits, caches = dec(p, caches, logits.argmax(-1)[:, None],
                                 pos + i)
            outs.append(logits.cpu())
    out = {"metrics": hist, "launches": launches, "variants": variants,
           "step_peak_bytes": peak, "logits": outs,
           "collectives": sorted({(k, g) for k, _, g in coll}),
           "params": [t.cpu() for _, t in params_lib.leaves(p)]}
    del p, state, step, caches, logits
    gc.collect()
    torch.cuda.empty_cache()
    return out


def layout_phase(dev, tmp: str) -> dict:
    """Phase 38: the reference's production layout (``sharding``'s rule
    tables: tensor parallel over "model", ZeRO-3 over "data", KV caches by
    head) on a one-rank NCCL group.  internvl2-1b at full width and all 24
    layers, bf16, wq/wk drawn, ``LM_BATCH`` rows of ``train_4k``'s length
    after the vision prefix: ``LAYOUT_STEPS`` LM train steps, the prefill
    and ``LAYOUT_DECODES`` decode steps under the production rules on the
    (1, 1) mesh, bitwise the no-mesh path (loss, grad norm, every param,
    every logit), the attention launches (2 x 24 forwards and 24
    backwards a step, all on ``wgmma``); the dry run's predicted peak of
    that step (one rank) against the measured one, to ``DRYRUN_BAND``; and
    two 16 x 16 pairs' predicted peaks and fit.  At (1, 1) the layout
    shards nothing (an axis of one rank splits no leaf), so no gather, no
    tensor-parallel operator and no vocabulary-parallel CE runs: the only
    collectives are the one-rank data means, which the phase checks.  The
    layout's traffic is held against one device on four gloo ranks by
    ``tests/test_torch_layout.py``, not on the card."""
    import torch.distributed as dist
    runs = _layout_dryruns(tmp)
    cfg = configs.get(LM_ARCH)
    L = cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(382)
    stream = TokenStream(cfg.vocab_size, LM_BATCH, LM_SEQ, seed=38).batches()
    batches = [_lm_batch(cfg, stream, gen, LM_BATCH)
               for _ in range(LAYOUT_STEPS)]
    mesh, grp = one_rank_group(tmp, "nccl_store_38")
    try:
        on = _layout_run(dev, cfg, batches, mesh)
    finally:
        dist.destroy_process_group()
    off = _layout_run(dev, cfg, batches)
    n_fwd, n_bwd = 2 * L * LAYOUT_STEPS, L * LAYOUT_STEPS
    want = {name: 0 for name in on["launches"]}
    want.update(flash_attention=n_fwd, flash_attention_bwd=n_bwd)
    launches_ok = (on["launches"] == want == off["launches"]
                   and on["variants"]["flash_attention"] == routed(
                       n_fwd, "wgmma")
                   and on["variants"]["flash_attention_bwd"] == routed(
                       n_bwd, "wgmma"))
    diff = {"metrics": [k for a, b in zip(on["metrics"], off["metrics"])
                        for k in a if a[k] != b[k]],
            "params": sum(not torch.equal(a, b)
                          for a, b in zip(on["params"], off["params"])),
            "logits": sum(not torch.equal(a, b)
                          for a, b in zip(on["logits"], off["logits"]))}
    same = not diff["metrics"] and not diff["params"] and not diff["logits"]
    # the data means of the gradients, loss and CE: all-reduces of one rank
    coll_ok = on["collectives"] == [("all-reduce", 1)]
    finite = all(math.isfinite(v) for m in on["metrics"] for v in m.values())
    log(f"  {LM_ARCH} {L} layers, batch {LM_BATCH} x ({LM_SEQ} + "
        f"{cfg.frontend.n_tokens}), {LAYOUT_STEPS} LM steps, prefill "
        f"{LAYOUT_ROWS} x {LAYOUT_PREFILL_SEQ} and {LAYOUT_DECODES} decodes: "
        f"production rules on the one-rank {grp['backend']} mesh / no mesh: "
        f"loss {[m['loss'] for m in on['metrics']]} / "
        f"{[m['loss'] for m in off['metrics']]}, grad_norm "
        f"{[m['grad_norm'] for m in on['metrics']]}; bitwise {same} "
        f"(metrics that differ {diff['metrics']}, params that differ "
        f"{diff['params']} of {len(on['params'])}, logit steps that differ "
        f"{diff['logits']} of {len(on['logits'])}); launches "
        f"{on['launches']} (expected {want}), variants {on['variants']}; "
        f"collectives (kind, ranks) {on['collectives']} (only the one-rank "
        f"data means expected)")
    if not (same and launches_ok and finite and coll_ok):
        fail("the production layout on one rank is not the no-mesh path, or "
             "its launches or collectives do not match")
    recs = _layout_records(runs)
    one = next(r for k, r in recs.items() if k.endswith("__rank1"))
    pred, measured = one["memory"]["peak_bytes"], on["step_peak_bytes"]
    ratio = pred / measured
    card = card_line()
    log(f"  dry run of that step (meta, one rank, {one['run_s']} s): "
        f"predicted peak {pred} bytes (arguments "
        f"{one['memory']['argument_bytes']}, temporaries "
        f"{one['memory']['temp_bytes']}), measured {measured} bytes "
        f"(max_memory_allocated over the params' start), ratio {ratio:.4f} "
        f"(band {DRYRUN_BAND}); {card}")
    if abs(ratio - 1) > DRYRUN_BAND:
        fail(f"the dry run's peak {pred} is off the measured {measured}")
    pairs = {}
    for arch, shape in LAYOUT_PAIRS:
        r = recs[f"{arch}__{shape}__pod16x16"]
        m = r["memory"]
        pairs[f"{arch}__{shape}"] = {
            "state_bytes": m["state_bytes"], "argument_bytes":
            m["argument_bytes"], "temp_bytes": m["temp_bytes"],
            "peak_bytes": m["peak_bytes"], "fits_80gb": r["fits_80gb"],
            "run_s": r["run_s"], "layout": r["layout"],
            "collectives": r["collectives"]["_total"]}
        log(f"  16 x 16 dry run {arch} {shape} (rank 0 of 256, meta, the "
            f"host's CPU, {r['run_s']} s): state {m['state_bytes'] / 1e9:.2f}"
            f" GB, arguments {m['argument_bytes'] / 1e9:.2f} GB, temporaries "
            f"{m['temp_bytes'] / 1e9:.2f} GB, peak {m['peak_bytes'] / 1e9:.2f}"
            f" GB a rank, fits 80 GB: {r['fits_80gb']}; a prediction for "
            f"{mesh_lib.CARD} ranks, measured beside {card}")
    return {"bitwise": same, "diff": diff, "launches": on["launches"],
            "collectives": on["collectives"],
            "variants": on["variants"], "metrics": on["metrics"],
            "dryrun": {"predicted_peak_bytes": pred,
                       "measured_peak_bytes": measured, "ratio": ratio,
                       "argument_bytes": one["memory"]["argument_bytes"],
                       "temp_bytes": one["memory"]["temp_bytes"],
                       "run_s": one["run_s"]},
            "pairs": pairs, "card": card}


# ----------------------------------------------------------------- phase 39
# the MoE family tensor-parallel over "model" at the production layout's
# mp = 16, emulated on one card: the 16 ranks' shards of one full-width MoE
# layer run in turn, each with its f and g over a one-rank group (the
# identity), so that each rank's outputs and input gradients are its
# partial sums and this phase takes the sixteen ranks' sums itself
LAYER_MP = 16
# max |sum over the ranks - whole| / max |whole| of the outputs, input
# gradients and weight gradients, bf16: a rank's partial products round to
# bf16 (up to 2^-9 of the partial) before the sum, where the whole layer
# rounds its sum once; sixteen such roundings of partials up to max |whole|
LAYER_RANK_BAND = 3e-2


class _ModelAxis:
    """A ("data", "model") mesh of ``dp`` x ``mp`` ranks as the rule
    tables read one (``axis_names`` and ``shape``), for the shards'
    layout."""

    def __init__(self, mp: int, dp: int = 1):
        self.axis_names = ("data", "model")
        self.shape = {"data": dp, "model": mp}


@contextlib.contextmanager
def model_rank(group, mp: int, r: int):
    """The tensor-parallel context of rank ``r`` of ``mp`` whose
    collectives run over the one-rank ``group``: *f* and *g* are the
    identity, the blocks read their local heads and hidden dims from the
    shards' shapes (this script's emulation; the port installs a "model"
    group only from a mesh, ``sharding.param_gather``)."""
    from repro_torch import sharding as shlib
    prev = dict(shlib._CTX)
    shlib._CTX.update(mesh=None, rules=None,
                      tp=shlib.TP(group, mp, r))
    try:
        yield
    finally:
        shlib._CTX.update(prev)


@contextlib.contextmanager
def attention_shapes(record: list):
    """The q shape of every ``ops.flash_attention`` call appended to
    ``record``."""
    saved = ops.flash_attention

    def call(q, *a, **k):
        record.append(tuple(q.shape))
        return saved(q, *a, **k)

    ops.flash_attention = call
    try:
        yield
    finally:
        ops.flash_attention = saved


def _layer_regions(cfg) -> tuple:
    """The MoE layer's two tensor-parallel regions, each from its normed
    input: the attention (MLA, or GQA for grok) and the mixture of experts
    (routed and shared; the auxiliary losses, which every "model" rank
    computes whole, are held on four gloo ranks by the tests)."""
    from repro_torch.models import attention as attn_mod, mla as mla_mod
    apply = mla_mod.apply_full if cfg.mla else attn_mod.apply_full
    return (("attn", lambda p, h: apply(p, cfg, h)[0]),
            ("ffn", lambda p, h: moe_mod.apply(p, cfg, h, aux=False)[0]))


def _region(fn, p: dict, h, dy) -> tuple:
    """(output, input gradient, {leaf path: gradient}) of ``fn(p, h)``
    against the upstream gradient ``dy``."""
    leaves = dict(params_lib.leaves(p))
    for t in leaves.values():
        t.requires_grad_(True)
    x = h.detach().requires_grad_()
    y = fn(p, x)
    y.backward(dy)
    grads = {path: t.grad for path, t in leaves.items()}
    for t in leaves.values():
        t.requires_grad_(False)
        t.grad = None
    return y.detach(), x.grad, grads


def layer_ranks(dev, arch: str, group, mp: int = LAYER_MP, cfg=None,
                seed: int = 39) -> dict:
    """One MoE layer of ``arch`` (``cfg``: another config, as a reduced
    one) at full width, bf16 on the card, random weights from ``seed``
    (the query and key projections drawn as ``draw_qk_proj``), its two
    regions from random normed inputs at the flow shape (``B_SERVE`` x
    ``HY_SEQ``) and random upstream gradients: once whole, then as each of
    ``mp`` ranks with its shard of every leaf (``sharding.use_layout``
    under the production rules: MLA's and GQA's heads, the experts' and
    the shared experts' hidden dim) under ``model_rank``.  The ranks'
    outputs and input gradients, summed, the shards' gradients,
    concatenated, and the gradients of the leaves whole on every rank
    (MLA's latent projections and norms, the router, grok's kv
    projections: each rank's heads or hidden dims add a part), summed, are
    held against the whole layer's to ``LAYER_RANK_BAND``.  Returns the
    gaps, the ranks' kernel launches by variant and dim pair and the q
    shape of every attention call."""
    from repro_torch import sharding as shlib
    cfg = cfg or configs.get(arch)
    spec = Backbone(cfg)._block_spec
    axis = _ModelAxis(mp)
    rules = shlib.production_rules(axis)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = params_lib.init(spec, gen, torch.bfloat16, dev)
    _draw_qk(p["attn"], cfg, gen)
    shape = (B_SERVE, HY_SEQ, cfg.d_model)
    out = {"gaps": {}, "launches": {}, "variants": {}, "pairs": {},
           "q_shapes": {}}
    for name, fn in _layer_regions(cfg):
        ps, sp = p[name], spec[name]
        h, dy = (torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(2))
        y, dx, grads = _region(fn, ps, h, dy)
        dims = {path: shlib.use_layout(s.shape, s.axes, rules, axis)[1]
                for path, s in params_lib.leaves(sp)}
        y_sum = torch.zeros_like(y, dtype=torch.float32)
        dx_sum = torch.zeros_like(dx, dtype=torch.float32)
        g_sum = {path: torch.zeros_like(g, dtype=torch.float32)
                 for path, g in grads.items()}
        reset_counts()
        q_shapes = []
        for r in range(mp):
            shard = {}
            for path, t in params_lib.leaves(ps):
                m = dims[path]
                if m is not None:
                    k = t.shape[m] // mp
                    t = t.narrow(m, r * k, k)
                params_lib._set(shard, path, t.clone())
            with model_rank(group, mp, r), attention_shapes(q_shapes):
                y_r, dx_r, g_r = _region(fn, shard, h, dy)
            y_sum += y_r.float()
            dx_sum += dx_r.float()
            for path, g in g_r.items():
                m = dims[path]
                if m is None:
                    g_sum[path] += g.float()
                else:
                    k = g.shape[m]
                    g_sum[path].narrow(m, r * k, k).copy_(g.float())
            del shard, y_r, dx_r, g_r
        gaps = {"out": _rel(y_sum, y), "dx": _rel(dx_sum, dx)}
        gaps.update({"/".join(path) + (" (sum)" if dims[path] is None
                                       else " (shards)"):
                     _rel(g_sum[path], grads[path]) for path in grads})
        out["gaps"][name] = gaps
        out["launches"][name] = counts()
        out["variants"][name] = all_variants()
        out["pairs"][name] = pair_counts()
        out["q_shapes"][name] = sorted(set(q_shapes))
        out["q_calls"] = out.get("q_calls", 0) + len(q_shapes)
        del y, dx, grads, y_sum, dx_sum, g_sum
    del p
    gc.collect()
    return out


def _attention_mla_rank_rows(dev) -> list:
    """The attention at a rank's share of MLA's heads (``B_SERVE``,
    ``HY_SEQ``, 128 / ``LAYER_MP`` heads, 192 / 128, causal, bf16): the
    forward and backward against their plain versions, each row to
    ``ROW_BAND`` of its own max |plain| (phase 28's path check); then the
    kernels' times from replayed graphs, the plain versions' and SDPA's
    with CUDA events, and the bounds."""
    g = torch.Generator(device=dev).manual_seed(391)
    B, S, H = B_SERVE, HY_SEQ, MLA_HEADS // LAYER_MP
    q, k = (torch.randn(B, S, H, MLA_QK, generator=g, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    v, do = (torch.randn(B, S, H, MLA_V, generator=g, device=dev,
                         dtype=torch.bfloat16) for _ in range(2))
    before = all_variants()
    o, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    ran = all_variants()
    if ran["flash_attention"]["wgmma"] - before["flash_attention"][
            "wgmma"] != 1 or ran["flash_attention_bwd"]["wgmma"] - before[
            "flash_attention_bwd"]["wgmma"] != 1:
        fail(f"the attention at {H} heads of (192, 128) did not run on "
             "wgmma")
    r, _ = _mla_plain(ref.flash_attention_fwd_ref, q, k, v)
    want = _mla_plain(ref.flash_attention_bwd_ref, q, k, v, o, lse, do)
    band = ROW_BAND[torch.bfloat16]
    (row_o,), rows_g = _row_errs([o], [r]), _row_errs(got, want)
    err = float((o.float() - r.float()).abs().max())
    gerr = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(got, want))
    log(f"  rank attention ({B}, {S}, {H} heads, 192 / 128) causal bf16 "
        f"(wgmma): per-row o {row_o:.3e}, dq/dk/dv {rows_g[0]:.3e}/"
        f"{rows_g[1]:.3e}/{rows_g[2]:.3e} (band {band} a row); max|err| "
        f"o {err:.3e}, grads {gerr:.3e}")
    if max([row_o] + rows_g) > band:
        fail(f"the attention at {H} heads of (192, 128) is off its band")
    del r, want, got
    ms = graph_ms(lambda: flash_attention(q, k, v, causal=True), 5)
    bwd_ms = graph_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                                  causal=True), 5)
    plain_ms = cuda_ms(lambda: _mla_plain(ref.flash_attention_ref, q, k, v),
                       2, 1)
    plain_bwd_ms = cuda_ms(lambda: _mla_plain(
        ref.flash_attention_bwd_ref, q, k, v, o, lse, do), 2, 1)
    sdpa_ms, sdpa_bwd_ms, note = _sdpa_mla_ms(q, k, v, do)
    fwd_bytes = (q.numel() + k.numel() + v.numel() + o.numel()) * 2
    bwd_bytes = (2 * q.numel() + 2 * k.numel() + 2 * v.numel()
                 + o.numel() + do.numel()) * 2 + 4 * lse.numel()
    rows = []
    for name, kms, pms, lms, flops, nbytes, src, e in (
            ("flash_attention_mla_rank", ms, plain_ms, sdpa_ms,
             _mla_flops(heads=H), fwd_bytes, "flash_attention.cu", err),
            ("flash_attention_bwd_mla_rank", bwd_ms, plain_bwd_ms,
             sdpa_bwd_ms, _mla_flops(True, H), bwd_bytes,
             "flash_attention_bwd.cu", gerr)):
        bound, by = _bound(nbytes, flops)
        lib = "none" if lms is None else f"{lms:.4f} ms"
        log(f"  {name} ({B}, {S}, {H} heads, 192 / 128) causal bf16: kernel "
            f"{kms:.4f} ms (wgmma), plain {pms:.3f} ms, SDPA {lib} ({note}),"
            f" bound {bound:.4f} ms ({flops / 1e12:.4f} TFLOP, "
            f"{nbytes / 1e6:.1f} MB)")
        rows.append({
            "name": name, "route": "cuda", "variant": "wgmma",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": ("src/repro/kernels/flash_attention.py:81"
                         if "bwd" not in name else
                         "none (JAX autodiff of src/repro/models/layers.py "
                         "attention_chunked, called at "
                         "src/repro/models/mla.py:108)"),
            "max_abs_err": e, "ms": kms,
            "plain_ms": pms, "bound_ms": bound, "bound_by": by,
            "library_ms": lms, "library_note": note,
            "shape": [B, S, H, MLA_QK, MLA_V]})
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    return rows


def moe_layer_phase(dev, tmp: str) -> dict:
    """Phase 39: ``layer_ranks`` for one ``deepseek-v2-236b`` and one
    ``grok-1-314b`` MoE layer at mp = 16 on a one-rank NCCL group: every
    gap within ``LAYER_RANK_BAND``; the ranks' attention 16 forwards and
    16 backwards on ``wgmma``, deepseek's at 8 heads of (192, 128) and
    grok's at 3 query heads over its 8 kv heads of 128 (the kv heads do
    not divide 16: each rank projects all 8 and reads one), no other
    kernel; then the rank's MLA attention shape against its plain
    versions, and its times (``_attention_mla_rank_rows``)."""
    import torch.distributed as dist
    mesh, _ = one_rank_group(tmp, "nccl_store_39")
    try:
        res = {arch: layer_ranks(dev, arch, mesh.get_group("model"))
               for arch in (DS_ARCH, GROK_ARCH)}
    finally:
        dist.destroy_process_group()
    ok = True
    for arch, r in res.items():
        cfg = configs.get(arch)
        pair = f"{MLA_QK}x{MLA_V}" if cfg.mla else (
            f"{cfg.resolved_head_dim}x{cfg.resolved_head_dim}")
        q_shape = ((B_SERVE, HY_SEQ, MLA_HEADS // LAYER_MP, MLA_QK)
                   if cfg.mla else (B_SERVE, HY_SEQ,
                                    cfg.n_heads // LAYER_MP,
                                    cfg.resolved_head_dim))
        want = {name: 0 for name in r["launches"]["attn"]}
        want.update(flash_attention=LAYER_MP, flash_attention_bwd=LAYER_MP)
        worst = {name: max(g.values()) for name, g in r["gaps"].items()}
        launches_ok = (
            r["launches"]["attn"] == want
            and all(v == 0 for v in r["launches"]["ffn"].values())
            and r["variants"]["attn"]["flash_attention"] == routed(
                LAYER_MP, "wgmma")
            and r["variants"]["attn"]["flash_attention_bwd"] == routed(
                LAYER_MP, "wgmma")
            and r["pairs"]["attn"]["flash_attention"].get(pair) == LAYER_MP
            and r["pairs"]["attn"]["flash_attention_bwd"].get(pair)
            == LAYER_MP
            and r["q_shapes"]["attn"] == [q_shape]
            and r["q_calls"] == LAYER_MP)
        log(f"  {arch} one MoE layer at mp {LAYER_MP} ({LAYER_MP} ranks in "
            f"turn), ({B_SERVE}, {HY_SEQ}) bf16: worst gap a region "
            f"{worst} (band {LAYER_RANK_BAND}); every gap "
            f"{json.dumps(r['gaps'])}; the ranks' launches "
            f"{r['launches']['attn']} (expected {want}), variants "
            f"{r['variants']['attn']}, by dim pair {r['pairs']['attn']}, "
            f"q shapes {r['q_shapes']['attn']}")
        if max(worst.values()) > LAYER_RANK_BAND or not launches_ok:
            ok = False
    if not ok:
        fail("a MoE layer's 16 rank shards do not sum to the whole layer, "
             "or their attention did not run as the layout calls for")
    res["rank_rows"] = _attention_mla_rank_rows(dev)
    res["card"] = card_line()
    return res


# ----------------------------------------------------------------- phase 40
# the Mamba-2 blocks tensor-parallel over "model" at mp = 16, emulated on one
# card as phase 39 emulates the MoE layer: each rank's shards run in turn
# over a one-rank group.  Two of the block's collectives carry values
# between ranks mid-block, which a one-rank group cannot: the gather of the
# B and C columns (each rank is handed the gathered columns, and each
# rank's gradient of them is summed as the reduce-scatter sums it), and
# the gated norm's sum of squares (``_SsmNormStat``: three passes over the
# ranks, the statistic first, then each rank's gradient of the total, then
# the backward with their sum).  (tag, arch) of the two blocks:
SSM_LAYER_ARCHS = (("zamba2", HY_ARCH), ("mamba2", SSM_ARCH))


class _StatStop(Exception):
    """Ends the statistic pass once a rank's sum of squares is known."""


class _SsmNormStat(torch.autograd.Function):
    """A rank's norm statistic under the emulation: forward the total over
    the ranks, backward the sum of the ranks' gradients of it, both
    collected by earlier passes over the ranks."""

    @staticmethod
    def forward(ctx, x, total, grad_total):
        ctx.grad_total = grad_total
        return total.clone()

    @staticmethod
    def backward(ctx, grad):
        return ctx.grad_total, None, None


@contextlib.contextmanager
def _ssm_rank_collectives(bc_in, stat):
    """``sharding.gather_model_sum`` handing each rank ``bc_in()`` (the
    gathered B and C columns) and ``sharding.sum_over_model`` replaced by
    ``stat`` in the body; ``ops.ssd_scan`` left as it is."""
    from repro_torch import sharding as shlib
    saved = shlib.gather_model_sum, shlib.sum_over_model
    shlib.gather_model_sum = lambda x, dim, tp: bc_in()
    shlib.sum_over_model = stat
    try:
        yield
    finally:
        shlib.gather_model_sum, shlib.sum_over_model = saved


@contextlib.contextmanager
def scan_shapes(record: list):
    """(x shape, state width) of every ``ops.ssd_scan`` call appended to
    ``record``."""
    saved = ops.ssd_scan

    def call(x, dt, a, bm, cm, **k):
        record.append(tuple(x.shape) + (bm.shape[-1],))
        return saved(x, dt, a, bm, cm, **k)

    ops.ssd_scan = call
    try:
        yield
    finally:
        ops.ssd_scan = saved


def ssm_layer_ranks(dev, arch: str, group, mp: int = LAYER_MP, cfg=None,
                    seed: int = 40) -> dict:
    """One Mamba-2 block of ``arch`` (``cfg``: another config, as a reduced
    one) at full width, bf16 on the card, random weights from ``seed``
    with the SSM leaves drawn from Mamba-2's init (``draw_ssm_leaves``),
    from a random normed input at the flow shape (``B_SERVE`` x
    ``HY_SEQ``) and a random upstream gradient: once whole, then as each of
    ``mp`` ranks with its shard of every leaf (the production layout's
    ``use_layout``, a packed leaf cut by ``sharding.pack_cut``) under
    ``model_rank``, the B / C gather and the norm's statistic emulated
    (``_ssm_rank_collectives``).  The ranks' outputs and input gradients,
    summed, the shards' gradients, concatenated, and the gathered B / C
    columns' gradients, summed, are held against the whole block's to
    ``LAYER_RANK_BAND``.  Returns the gaps, the ranks' kernel launches by
    variant and the (x shape, N) of every scan call."""
    from repro_torch import sharding as shlib
    from repro_torch.models import ssm as ssm_mod
    cfg = cfg or configs.get(arch)
    m = ssm_mod.dims(cfg)
    d_in, N, K, d = m["d_in"], m["N"], m["d_conv"], cfg.d_model
    spec = ssm_mod.spec(cfg)
    rules = shlib.production_rules(_ModelAxis(mp))
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = params_lib.init(spec, gen, torch.bfloat16, dev)
    draw_ssm_leaves(p, seed)
    h, dy = (torch.randn((B_SERVE, HY_SEQ, d), generator=gen,
                         device=dev).to(torch.bfloat16) for _ in range(2))

    def fn(q, x):
        return ssm_mod.apply_full(q, cfg, x)[0]

    y, dx, grads = _region(fn, p, h, dy)
    # the B and C columns of in_proj, conv_w and conv_b, canonical [B | C],
    # and in the order an all-gather of the ranks' packed shards gives them
    whole_bc = torch.cat([p["in_proj"][:, 2 * d_in:2 * d_in + 2 * N],
                          p["conv_w"][:, d_in:], p["conv_b"][None, d_in:]], 0)
    order = [c for r in range(mp) for c in shlib.pack_columns((N, N), mp, r)]
    gathered = whole_bc[:, order].contiguous()
    cut = {}
    for path, s in params_lib.leaves(spec):
        dim = shlib.use_layout(s.shape, s.axes, rules, _ModelAxis(mp))[1]
        cut[path] = (dim, s.parts if shlib.packed(s.parts, s.shape, dim, mp)
                     else ())

    def shard_of(r):
        out = {}
        for path, t in params_lib.leaves(p):
            dim, parts = cut[path]
            if parts:
                t = shlib.pack_cut(t, dim, parts, mp, r)
            elif dim is not None:
                k = t.shape[dim] // mp
                t = t.narrow(dim, r * k, k)
            params_lib._set(out, path, t.clone())
        return out

    reset_counts()
    shapes = []
    # pass 1: each rank's sum of squares (forward to the norm)
    stats = []

    def record(x, tp):
        stats.append(x.detach().clone())
        raise _StatStop

    with torch.no_grad(), scan_shapes(shapes):
        for r in range(mp):
            with model_rank(group, mp, r), _ssm_rank_collectives(
                    lambda: gathered, record):
                try:
                    fn(shard_of(r), h)
                except _StatStop:
                    pass
    total = torch.stack(stats).sum(0)
    # pass 2: each rank's gradient of the total
    grad_total = torch.zeros_like(total)
    for r in range(mp):
        t = total.clone().requires_grad_()
        with model_rank(group, mp, r), _ssm_rank_collectives(
                lambda: gathered, lambda x, tp: t), scan_shapes(shapes):
            y_r = fn(shard_of(r), h)
        grad_total += torch.autograd.grad(y_r, t, dy)[0]
        del y_r
    # pass 3: the backward with the summed gradient of the statistic
    y_sum = torch.zeros_like(y, dtype=torch.float32)
    dx_sum = torch.zeros_like(dx, dtype=torch.float32)
    g_cat = {path: torch.zeros_like(g, dtype=torch.float32)
             for path, g in grads.items()}
    bc_sum = torch.zeros_like(gathered, dtype=torch.float32)
    for r in range(mp):
        bc_in = gathered.clone().requires_grad_()
        shard = shard_of(r)
        with model_rank(group, mp, r), _ssm_rank_collectives(
                lambda: bc_in, lambda x, tp: _SsmNormStat.apply(
                    x, total, grad_total)), scan_shapes(shapes):
            y_r, dx_r, g_r = _region(fn, shard, h, dy)
        y_sum += y_r.float()
        dx_sum += dx_r.float()
        bc_sum += bc_in.grad.float()
        held = dict(params_lib.leaves(shard))
        for path, g in g_r.items():
            dim, parts = cut[path]
            if g is None:      # a leaf this rank does not read
                g = torch.zeros_like(held[path])
            if dim is None:
                g_cat[path] += g.float()
            elif parts:
                cols = torch.tensor(shlib.pack_columns(parts, mp, r),
                                    device=dev)
                g_cat[path].index_add_(dim, cols, g.float())
            else:
                k = g.shape[dim]
                g_cat[path].narrow(dim, r * k, k).add_(g.float())
        del shard, y_r, dx_r, g_r, bc_in
    bc = torch.empty_like(bc_sum)
    bc[:, order] = bc_sum
    g_cat[("in_proj",)][:, 2 * d_in:2 * d_in + 2 * N] += bc[:d]
    g_cat[("conv_w",)][:, d_in:] += bc[d:d + K]
    g_cat[("conv_b",)][d_in:] += bc[d + K]
    whole_bc_grad = torch.cat([
        grads[("in_proj",)][:, 2 * d_in:2 * d_in + 2 * N],
        grads[("conv_w",)][:, d_in:], grads[("conv_b",)][None, d_in:]], 0)
    gaps = {"out": _rel(y_sum, y), "dx": _rel(dx_sum, dx),
            "B/C columns (sum)": _rel(bc, whole_bc_grad)}
    gaps.update({"/".join(path) + (" (sum)" if cut[path][0] is None
                                   else " (shards)"):
                 _rel(g_cat[path], grads[path]) for path in grads})
    out = {"gaps": gaps, "launches": counts(), "variants": all_variants(),
           "scan_shapes": sorted(set(shapes)), "scan_calls": len(shapes)}
    del p, y, dx, grads, y_sum, dx_sum, g_cat, gathered, whole_bc
    gc.collect()
    return out


def ssm_layer_phase(dev, tmp: str) -> dict:
    """Phase 40: ``ssm_layer_ranks`` for one ``zamba2-2.7b`` and one
    ``mamba2-370m`` Mamba-2 block at mp = 16 on a one-rank NCCL group:
    every gap within ``LAYER_RANK_BAND``; every scan of the ranks, three
    forwards and one backward a rank, on ``wgmma`` at a rank's heads (5 of
    80 at state 64, 2 of 32 at state 128), no other kernel; then the scan
    forward and backward at those shapes against their plain versions, and
    their times (``ssd_shape_rows``)."""
    import torch.distributed as dist
    mesh, _ = one_rank_group(tmp, "nccl_store_40")
    try:
        res = {tag: ssm_layer_ranks(dev, arch, mesh.get_group("model"))
               for tag, arch in SSM_LAYER_ARCHS}
    finally:
        dist.destroy_process_group()
    ok = True
    for tag, arch in SSM_LAYER_ARCHS:
        r = res[tag]
        cfg = configs.get(arch)
        H = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
        want_shape = [(B_SERVE, HY_SEQ, H // LAYER_MP, cfg.ssm.head_dim,
                       cfg.ssm.d_state)]
        want = {name: 0 for name in r["launches"]}
        want.update(ssd_scan=3 * LAYER_MP, ssd_scan_bwd=LAYER_MP)
        worst = max(r["gaps"].values())
        launches_ok = (
            r["launches"] == want
            and r["variants"]["ssd_scan"] == routed(3 * LAYER_MP, "wgmma")
            and r["variants"]["ssd_scan_bwd"] == routed(LAYER_MP, "wgmma")
            and r["scan_shapes"] == want_shape
            and r["scan_calls"] == 3 * LAYER_MP)
        log(f"  {arch} one Mamba-2 block at mp {LAYER_MP} ({LAYER_MP} ranks "
            f"in turn), ({B_SERVE}, {HY_SEQ}) bf16: worst gap {worst:.3e} "
            f"(band {LAYER_RANK_BAND}); every gap {json.dumps(r['gaps'])}; "
            f"the ranks' launches {r['launches']} (expected {want}), "
            f"variants {r['variants']['ssd_scan']} / "
            f"{r['variants']['ssd_scan_bwd']}, scan (x shape, N) "
            f"{r['scan_shapes']} (expected {want_shape})")
        if worst > LAYER_RANK_BAND or not launches_ok:
            ok = False
    if not ok:
        fail("a Mamba-2 block's 16 rank shards do not match the whole block, "
             "or their scans did not run as the layout calls for")
    res["rank_rows"] = []
    for tag, arch in SSM_LAYER_ARCHS:
        cfg = configs.get(arch)
        H = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
        res["rank_rows"] += ssd_shape_rows(dev, H // LAYER_MP,
                                           cfg.ssm.d_state, f"{tag}_rank",
                                           400 + len(res["rank_rows"]))
    res["card"] = card_line()
    return res


# ----------------------------------------------------------------- phase 41
# the sequence-sharded decode at mp = 16 (the reference's cache_seq rule
# under REPRO_CACHE_SEQ_SHARD=model), emulated on one card: the 16 ranks
# run the port's own decode at once, one host thread each, over a group
# whose collectives meet at a barrier (``ThreadGroup``).  Each rank holds
# its 2048-entry segment of a 32768-entry cache at decode_32k's 8 rows a
# data rank (128 over 16)
SEQ_LAYERS = (("flux_dit", "24 heads of 128, whole over model"),
              ("qwen3-32b", "4 of 64 q heads a rank, 8 kv heads whole"),
              ("deepseek-v2-236b", "MLA, 8 of 128 heads a rank"))
SEQ_ROWS = INPUT_SHAPES["decode_32k"].global_batch // LAYER_MP
SEQ_CACHE = INPUT_SHAPES["decode_32k"].seq_len
SEQ_STEPS = 4
# max |rank's output - one device's| / max |one device's|, bf16: the merge
# adds each segment's sums in another order, so the f32 values before each
# later bf16 rounding differ in their last bits; a value that sits at a
# rounding boundary then lands one ulp (2^-8 of it) away, at p, at the
# attention output (o, or MLA's o_lat and o), and at the layer's output:
# three roundings, each at most 2^-8 of max, and the second and third
# carry the earlier one's ulp through a product with random weights.  A
# merge that drops the global max or a segment moves the output by O(1)
# of its max.
SEQ_BAND = 2e-2


class ThreadGroup:
    """A process-group stand-in for ``n`` host threads of this process,
    one emulated rank each (``rank`` is the calling thread's): the port's
    all-reduces and all-gathers on it meet at a barrier, rank 0 combines
    the ranks' tensors in rank order, and every rank copies the result.
    All threads issue work to the one default stream, so the card runs it
    in the order the barriers impose.  ``solo``: a group of ``n`` whose
    collectives see this rank alone (an all-reduce is the identity, a
    gather repeats the rank's tensor), for timing one rank."""

    def __init__(self, n: int, solo: bool = False):
        import threading
        self.n, self.solo = n, solo
        self.local = threading.local()
        self.slots = [None] * n
        self.barrier = threading.Barrier(n, timeout=120)
        # (dtype, shape) of each all-reduce the ranks meet in, when a list
        self.log = None
        # the backward rounds' state (``begin_rounds``), and the rank whose
        # backward runs
        self.rounds, self.current = None, 0

    @property
    def rank(self) -> int:
        return self.current if self.rounds is not None else self.local.rank

    # -- backward rounds: autograd runs every CUDA backward on one device
    # thread, so the ranks' backwards cannot meet at a barrier.  They run
    # one after another, each from the start, as often as it takes: a
    # rank stops (``_RoundStop``) at the first collective whose other
    # ranks' inputs are not all known, having left its own; once every
    # rank has left its input to a collective, ``settle`` computes each
    # rank's result, and the next round serves it and goes on to the next
    # collective.
    def begin_rounds(self) -> None:
        self.rounds = {"calls": [0] * self.n, "inputs": {}, "results": {},
                       "stopped": False}

    def _round(self, kind: str, out, src, op=None) -> None:
        st, r = self.rounds, self.current
        i = st["calls"][r]
        st["calls"][r] += 1
        res = st["results"].get((i, r))
        if res is not None:
            out.copy_(res.view_as(out))
            return
        st["inputs"].setdefault((i, r), (kind, op, src.clone()))
        st["stopped"] = True
        raise _RoundStop(f"rank {r} at collective {i} ({kind})")

    def settle(self) -> bool:
        """The results of every collective all ranks have reached; whether
        there was one."""
        import torch.distributed as dist
        st, n = self.rounds, self.n
        ready = sorted({i for i, _ in st["inputs"]
                        if all((i, r) in st["inputs"] for r in range(n))})
        for i in ready:
            kind, op, _ = st["inputs"][(i, 0)]
            srcs = [st["inputs"].pop((i, r))[2] for r in range(n)]
            if kind == "all-gather":
                outs = [torch.cat(srcs, 0)] * n
            elif kind == "all-to-all":
                outs = [torch.cat([t.chunk(n)[r] for t in srcs], 0)
                        for r in range(n)]
            else:
                acc = srcs[0].clone()
                for t in srcs[1:]:
                    if op == dist.ReduceOp.MAX:
                        torch.maximum(acc, t, out=acc)
                    else:
                        acc += t
                outs = ([acc] * n if kind == "all-reduce"
                        else list(acc.chunk(n)))
            for r in range(n):
                st["results"][(i, r)] = outs[r]
        return bool(ready)

    def all_reduce(self, x, op) -> None:
        import torch.distributed as dist
        if self.rounds is not None:
            return self._round("all-reduce", x, x, op)
        if self.solo:
            return
        r = self.rank
        self.slots[r] = x
        self.barrier.wait()
        if r == 0:
            if self.log is not None:
                self.log.append((x.dtype, tuple(x.shape)))
            acc = self.slots[0].clone()
            for t in self.slots[1:]:
                if op == dist.ReduceOp.MAX:
                    torch.maximum(acc, t, out=acc)
                else:
                    acc += t
            self.result = acc
        self.barrier.wait()
        x.copy_(self.result)
        self.barrier.wait()

    def all_gather(self, out, src) -> None:
        if self.rounds is not None:
            return self._round("all-gather", out, src)
        if self.solo:
            out.view(self.n, *src.shape).copy_(src.expand(self.n,
                                                          *src.shape))
            return
        self.slots[self.rank] = src
        self.barrier.wait()
        torch.cat(self.slots, 0, out=out)
        self.barrier.wait()

    def reduce_scatter(self, out, src) -> None:
        """This rank's chunk (dim 0) of the ranks' sum, added in rank
        order in ``src``'s dtype."""
        if self.rounds is not None:
            return self._round("reduce-scatter", out, src)
        r = self.rank
        if self.solo:
            out.copy_(src.chunk(self.n)[r])
            return
        self.slots[r] = src
        self.barrier.wait()
        acc = self.slots[0].chunk(self.n)[r].clone()
        for t in self.slots[1:]:
            acc += t.chunk(self.n)[r]
        out.copy_(acc)
        self.barrier.wait()

    def all_to_all(self, out, src) -> None:
        """Chunk r (dim 0) of each rank's ``src``, in rank order."""
        if self.rounds is not None:
            return self._round("all-to-all", out, src)
        r = self.rank
        if self.solo:
            out.copy_(src)
            return
        self.slots[r] = src
        self.barrier.wait()
        torch.cat([t.chunk(self.n)[r] for t in self.slots], 0, out=out)
        self.barrier.wait()


class _ThreadCtx(dict):
    """``sharding._CTX`` with one value per host thread (each emulated
    rank installs its own "model" group and sequence axis), starting from
    the values it had."""

    def __init__(self, base: dict):
        import threading
        super().__init__(base)
        self._tl = threading.local()

    def _mine(self) -> dict:
        d = getattr(self._tl, "d", None)
        if d is None:
            d = self._tl.d = dict(super().items())
        return d

    def __getitem__(self, k):
        return self._mine()[k]

    def __setitem__(self, k, v):
        self._mine()[k] = v

    def update(self, *a, **k):
        self._mine().update(*a, **k)


@contextlib.contextmanager
def thread_ranks():
    """The port's collectives on a ``ThreadGroup`` routed to it, and the
    sharding context made per thread, for the ``with`` body."""
    import torch.distributed as dist
    from repro_torch import sharding as shlib
    names = ("all_reduce", "all_gather_into_tensor", "all_gather_single",
             "reduce_scatter_tensor", "reduce_scatter_single",
             "all_to_all_single")
    saved = {n: getattr(dist, n, None) for n in names}

    def all_reduce(x, op=dist.ReduceOp.SUM, group=None, **k):
        if isinstance(group, ThreadGroup):
            return group.all_reduce(x, op)
        return saved["all_reduce"](x, op=op, group=group, **k)

    def routed_to(name, method):
        def fn(out, src, *a, group=None, **k):
            if isinstance(group, ThreadGroup):
                return getattr(group, method)(out, src)
            return saved[name](out, src, *a, group=group, **k)
        return fn

    ctx = shlib._CTX
    dist.all_reduce = all_reduce
    for n in names[1:]:
        if saved[n] is not None:
            setattr(dist, n, routed_to(n, "all_gather" if "gather" in n
                                       else "reduce_scatter" if "scatter"
                                       in n else "all_to_all"))
    shlib._CTX = _ThreadCtx(ctx)
    try:
        yield
    finally:
        shlib._CTX = ctx
        for n, fn in saved.items():
            if fn is not None:
                setattr(dist, n, fn)


def _seq_rank_ctx(group, mp: int, r: int, tensor_parallel: bool) -> None:
    """This thread's sharding context: rank ``r`` of ``mp`` on "model",
    which also carries the caches' sequence."""
    from repro_torch import sharding as shlib
    group.local.rank = r
    shlib._CTX.update(mesh=None, rules=None,
                      tp=shlib.TP(group, mp, r) if tensor_parallel else None,
                      seq=shlib.SeqGroup("model", group, mp, r))


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in (tree.values() if isinstance(tree, dict) else tree))


def seq_layer_ranks(dev, arch: str, mp: int = LAYER_MP, cfg=None,
                    rows: int = SEQ_ROWS, cache_len: int = SEQ_CACHE,
                    steps: int = SEQ_STEPS, seed: int = 41,
                    time_it: bool = True) -> dict:
    """One attention layer of ``arch`` (``cfg``: another config, as a
    reduced one) at full width, bf16, random weights from ``seed`` (q and
    k projections drawn as ``draw_qk_proj``) and a random ``cache_len``
    cache of ``rows`` rows: ``steps`` decode steps of the port's decode
    (``attention.apply_decode`` or ``mla.apply_decode``) on one device,
    and as ``mp`` ranks at once (``ThreadGroup``, ``thread_ranks``), each
    with its shard of the weights (``sharding.use_layout``: the heads
    where the axis divides them) and its ``cache_len / mp`` segment.
    Each step: the worst rank's output gap to one device's, and whether
    the ranks' rolled segments, concatenated, equal one device's rolled
    cache bit for bit.  Then (``time_it``) ms a step of the whole layer
    and of the last rank on its segment (its collectives seeing it alone),
    beside their bytes bounds at 3.35 TB/s."""
    import threading
    from repro_torch import sharding as shlib
    from repro_torch.models import attention as attn_mod, mla as mla_mod
    cfg = cfg or configs.get(arch)
    spec = Backbone(cfg)._block_spec["attn"]
    axis = _ModelAxis(mp)
    rules = shlib.production_rules(axis)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = params_lib.init(spec, gen, torch.bfloat16, dev)
    _draw_qk(p, cfg, gen)
    if cfg.mla:
        decode, mk = mla_mod.apply_decode, mla_mod.MLACache
        shapes = [(rows, cache_len, cfg.mla.kv_lora_rank),
                  (rows, cache_len, cfg.mla.qk_rope_head_dim)]
    else:
        decode, mk = attn_mod.apply_decode, attn_mod.KVCache
        shapes = [(rows, cache_len, cfg.n_kv_heads,
                   cfg.resolved_head_dim)] * 2
    whole = mk(*(torch.randn(s, generator=gen, device=dev).to(
        torch.bfloat16) for s in shapes))
    xs = [torch.randn((rows, 1, cfg.d_model), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(steps)]
    dims = {path: shlib.use_layout(s.shape, s.axes, rules, axis)[1]
            for path, s in params_lib.leaves(spec)}
    tensor_parallel = any(m is not None for m in dims.values())

    def shard(r):
        out = {}
        for path, t in params_lib.leaves(p):
            m = dims[path]
            if m is not None:
                k = t.shape[m] // mp
                t = t.narrow(m, r * k, k)
            params_lib._set(out, path, t.contiguous())
        return out

    seg = cache_len // mp
    ps = [shard(r) for r in range(mp)]
    segs = [mk(*(t[:, r * seg:(r + 1) * seg].clone() for t in whole))
            for r in range(mp)]
    group = ThreadGroup(mp)
    outs = [[None] * mp for _ in range(steps)]
    calls, errors = [0] * mp, []

    def rank(r):
        try:
            _seq_rank_ctx(group, mp, r, tensor_parallel)
            with torch.no_grad():
                for i in range(steps):
                    outs[i][r], segs[r] = decode(ps[r], cfg, xs[i], segs[r],
                                                 cache_len + i)
                    calls[r] += 1
        except Exception as e:   # the others leave the barrier too
            errors.append(f"rank {r}: {type(e).__name__}: {e}")
            group.barrier.abort()

    gaps, rolled_equal = [], []
    cache = whole
    with thread_ranks():
        threads = [threading.Thread(target=rank, args=(r,))
                   for r in range(mp)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            fail("phase 41: an emulated rank failed: " + "; ".join(errors))
        with torch.no_grad():
            for i in range(steps):
                y, cache = decode(p, cfg, xs[i], cache, cache_len + i)
                gaps.append(max(_rel(o.float(), y.float())
                                for o in outs[i]))
        rolled_equal = [bool(torch.equal(torch.cat([s[j] for s in segs], 1),
                                         cache[j]))
                        for j in range(len(cache))]
        res = {"gaps": gaps, "rolled_bitwise": rolled_equal,
               "rank_calls": calls, "tensor_parallel": tensor_parallel,
               "segment": seg, "q_heads_a_rank": (
                   ps[0]["w_uq" if cfg.mla else "wq"].shape[1])}
        if time_it:
            bw = mesh_lib.HBM_BW
            solo = ThreadGroup(mp, solo=True)
            _seq_rank_ctx(solo, mp, mp - 1, tensor_parallel)
            last = segs[-1]
            with torch.no_grad():
                rank_ms = cuda_ms(lambda: decode(ps[-1], cfg, xs[0], last,
                                                 cache_len), 10)
            shlib._CTX.update(tp=None, seq=None)
            with torch.no_grad():
                whole_ms = cuda_ms(lambda: decode(p, cfg, xs[0], cache,
                                                  cache_len), 5)
            # each cache tensor read once and its rolled copy written once,
            # the weights read once
            rank_bytes = 2 * _nbytes(list(last)) + _nbytes(
                dict(params_lib.leaves(ps[-1])))
            whole_bytes = 2 * _nbytes(list(cache)) + _nbytes(
                dict(params_lib.leaves(p)))
            res.update(rank_ms=rank_ms, whole_ms=whole_ms,
                       rank_bound_ms=rank_bytes / bw * 1e3,
                       whole_bound_ms=whole_bytes / bw * 1e3,
                       rank_bytes=rank_bytes, whole_bytes=whole_bytes)
    del p, ps, segs, whole, cache
    gc.collect()
    return res


def seq_decode_phase(dev) -> dict:
    """Phase 41: ``seq_layer_ranks`` for one ``flux_dit``, one
    ``qwen3-32b`` and one ``deepseek-v2-236b`` attention layer at mp =
    16: every step's worst rank within ``SEQ_BAND`` of one device's
    output, the rolled segments gathered equal to one device's rolled
    cache bit for bit, every rank's own decode called every step, and
    the times."""
    res, ok = {}, True
    for arch, what in SEQ_LAYERS:
        r = seq_layer_ranks(dev, arch)
        res[arch] = r
        good = (max(r["gaps"]) <= SEQ_BAND and all(r["rolled_bitwise"])
                and r["rank_calls"] == [SEQ_STEPS] * LAYER_MP)
        log(f"  {arch} ({what}) at mp {LAYER_MP}, {SEQ_ROWS} rows x "
            f"{SEQ_CACHE} entries, {r['segment']} a rank: output gaps "
            f"{['%.3e' % g for g in r['gaps']]} (band {SEQ_BAND}), rolled "
            f"segments bitwise {r['rolled_bitwise']}, the ranks' decode "
            f"calls {r['rank_calls']}; ms a step: whole layer "
            f"{r['whole_ms']:.4f} (bytes bound {r['whole_bound_ms']:.4f}), "
            f"one rank's segment {r['rank_ms']:.4f} (bytes bound "
            f"{r['rank_bound_ms']:.4f}, {r['rank_bytes']} B at 3.35 TB/s)")
        ok &= good
        torch.cuda.empty_cache()
    if not ok:
        fail("the sequence-sharded decode's ranks do not match one device, "
             "or their rolled segments are not one device's cache")
    res["card"] = card_line()
    return res


# ----------------------------------------------------------------- phase 42
# expert parallelism (REPRO_MOE_MODE=ep_model) at mp = 16 on one card: a
# full-width deepseek-v2-236b MoE layer, whole and as the 16 ranks at once
# on host threads (``ThreadGroup``), each with its 8 of 128 MLA heads, its
# 10 of 160 routed experts at the whole hidden dim and its 1/16 of the
# shared experts' hidden dim; then the same ranks with REPRO_BF16_REDUCE.
# Each rank's forward runs the port's own code, and its g all-reduces
# meet the other ranks' at the group's barrier.  The backwards run one
# rank after another from this thread, over the group in its solo mode,
# and this phase sums the ranks' input gradients and the gradients of the
# leaves every rank holds whole (f's backward all-reduce): autograd runs
# every backward on a CUDA tensor on one device thread, where a barrier
# across the ranks' backwards would wait for itself.  (tag, REPRO_BF16_REDUCE)
# of the two passes:
EP_PASSES = (("ep_model", None), ("ep_model_bf16_reduce", "1"))


@contextlib.contextmanager
def env_vars(**values):
    """The environment variables set to ``values`` (None: unset) in the
    body."""
    prev = {k: os.environ.get(k) for k in values}

    def put(vals):
        for k, v in vals.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    put(values)
    try:
        yield
    finally:
        put(prev)


@contextlib.contextmanager
def rank_calls(lock, q_shapes: list, expert_uses: list):
    """Each ``ops.flash_attention`` call made under ``lock`` (the
    wrappers' launch counters are plain attributes, added to one thread
    at a time) with its q shape appended to ``q_shapes``; each MoE call's
    routed expert table shapes appended to ``expert_uses``."""
    saved_fa, saved_moe = ops.flash_attention, moe_mod.apply

    def fa(q, *a, **k):
        with lock:
            q_shapes.append(tuple(q.shape))
            return saved_fa(q, *a, **k)

    def moe_apply(p, *a, **k):
        expert_uses.extend(tuple(p[n].shape)
                           for n in ("w_gate", "w_up", "w_down"))
        return saved_moe(p, *a, **k)

    ops.flash_attention, moe_mod.apply = fa, moe_apply
    try:
        yield
    finally:
        ops.flash_attention, moe_mod.apply = saved_fa, saved_moe


def _ep_pass(fn, shards: list, dims: dict, h, dy, want: tuple) -> dict:
    """One region of the ``mp`` ranks (``shards``: each rank's leaves;
    ``dims``: each leaf's "model" dim, None where every rank holds it
    whole): the forwards at once on host threads over a ``ThreadGroup``,
    then each rank's backward in turn over the group in its solo mode.
    ``want`` = (the whole region's output, input gradient, {leaf path:
    gradient}).  Returns the gaps (each rank's output; the ranks' input
    gradients summed; each leaf's gradient, the shards' concatenated or
    the whole leaves' summed), the launches, the q shapes, the routed
    expert tables' shapes at use and the dtype and shape of each all-reduce
    the forwards handed the group."""
    import threading
    from repro_torch import sharding as shlib
    y, dx, grads = want
    mp = len(shards)
    group = ThreadGroup(mp)
    group.log = []
    # a leaf every rank holds whole is one tensor in every shard: its
    # gradient is read and cleared after each rank's backward
    leaves = [dict(params_lib.leaves(s)) for s in shards]
    xs = [h.detach().requires_grad_() for _ in range(mp)]
    ys, errors, q_shapes, uses = [None] * mp, [], [], []

    def rank(r):
        try:
            group.local.rank = r
            shlib._CTX.update(mesh=None, rules=None,
                              tp=shlib.TP(group, mp, r), seq=None)
            ys[r] = fn(shards[r], xs[r])
        except Exception as e:   # the others leave the barrier too
            errors.append(f"rank {r}: {type(e).__name__}: {e}")
            group.barrier.abort()

    for lv in leaves:
        for t in lv.values():
            t.requires_grad_(True)
    lock = threading.Lock()
    reset_counts()
    with thread_ranks(), rank_calls(lock, q_shapes, uses):
        threads = [threading.Thread(target=rank, args=(r,))
                   for r in range(mp)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            fail("phase 42: an emulated rank failed: " + "; ".join(errors))
        forward_log = list(group.log)
        group.solo = True
        with torch.no_grad():
            out_gap = max(_rel(t, y) for t in ys)
        dx_sum = torch.zeros_like(dx, dtype=torch.float32)
        g_sum = {path: torch.zeros_like(g, dtype=torch.float32)
                 for path, g in grads.items() if dims[path] is None}
        g_err = dict.fromkeys(grads, 0.0)
        for r in range(mp):
            ys[r].backward(dy)
            ys[r] = None
            dx_sum += xs[r].grad.float()
            xs[r].grad = None
            for path, t in leaves[r].items():
                m = dims[path]
                if m is None:
                    g_sum[path] += t.grad.float()
                else:
                    k = t.grad.shape[m]
                    want_r = grads[path].narrow(m, r * k, k)
                    g_err[path] = max(g_err[path], float(
                        (t.grad.float() - want_r.float()).abs().max()))
                t.grad = None
    for lv in leaves:
        for t in lv.values():
            t.requires_grad_(False)
    gaps = {"out": out_gap, "dx": _rel(dx_sum, dx)}
    for path, g in grads.items():
        key = "/".join(path) + (" (sum)" if dims[path] is None
                                else " (shards)")
        gaps[key] = (_rel(g_sum[path], g) if dims[path] is None else
                     g_err[path] / max(float(g.float().abs().max()), 1e-30))
    return {"gaps": gaps, "launches": counts(), "variants": all_variants(),
            "pairs": pair_counts(), "q_shapes": sorted(set(q_shapes)),
            "q_calls": len(q_shapes), "expert_uses": sorted(set(uses)),
            "g_all_reduces": [[str(dt), list(s)] for dt, s in forward_log]}


def _expert_times(p: dict, cfg, h, dy, mp: int, r: int) -> dict:
    """Rank ``r``'s routed experts of the MoE layer ``p`` at mp, forward
    and backward (``moe._slot_dispatch`` with its partial through *g* over
    a solo ``ThreadGroup``, and the backward into the tables and the
    rows), on the normed input ``h`` and the router's own assignments:
    tensor mode (every expert at f / mp) against ep_model (E / mp experts
    at the whole f).  ms from CUDA events, with the bound: the larger of
    the bytes (the rows, the rank's tables, the upstream gradient in; the
    output, the rows' and the tables' gradients out) over the memory rate
    and the operations (three products forward, six backward, over the
    assignments the capacity keeps in the rank's experts) over the bf16
    tensor-core rate."""
    from repro_torch import sharding as shlib
    m = cfg.moe
    E, f, d = m.n_experts, m.expert_d_ff, cfg.d_model
    G, T, _ = h.shape
    C = moe_mod.capacity(T, cfg)
    with torch.no_grad():
        _, _, gates, idx = moe_mod.route(p, cfg, h)
        _, keep = moe_mod._slots(idx, E, C)
        kept = torch.bincount(idx.reshape(-1)[keep.reshape(-1)],
                              minlength=E)
    n, fl = E // mp, f // mp
    modes = {
        "tensor": ({nm: p[nm].narrow(2 if nm != "w_down" else 1, r * fl,
                                     fl).contiguous()
                    for nm in ("w_gate", "w_up", "w_down")},
                   int(kept.sum()), E, fl),
        "ep_model": ({nm: p[nm].narrow(0, r * n, n)
                      for nm in ("w_gate", "w_up", "w_down")},
                     int(kept[r * n:(r + 1) * n].sum()), n, fl * mp)}
    solo = ThreadGroup(mp, solo=True)
    out = {}
    with thread_ranks():
        solo.local.rank = r
        tp = shlib.TP(solo, mp, r)
        for mode, (tabs, rows, n_e, width) in modes.items():
            for t in tabs.values():
                t.requires_grad_(True)
            x = h.detach().requires_grad_()

            def step():
                y = shlib.reduce_from_model(moe_mod._slot_dispatch(
                    tabs, cfg, x, gates, idx, C, tp), tp, x.dtype)
                y.backward(dy)
                x.grad = None
                for t in tabs.values():
                    t.grad = None

            ms = cuda_ms(step, 3, 1)
            for t in tabs.values():
                t.requires_grad_(False)
            flops = 9 * 2 * rows * d * width
            table_bytes = 3 * n_e * d * width * 2
            nbytes = 2 * table_bytes + 4 * G * T * d * 2
            bound, by = _bound(nbytes, flops)
            out[mode] = {"experts": n_e, "f": width, "kept_rows": rows,
                         "ms": ms, "bound_ms": bound, "bound_by": by,
                         "tflop": flops / 1e12, "mbytes": nbytes / 1e6}
    return out


def ep_layer_ranks(dev, arch: str = DS_ARCH, mp: int = LAYER_MP, cfg=None,
                   seed: int = 42, time_it: bool = True) -> dict:
    """One MoE layer of ``arch`` (``cfg``: another config, as a reduced
    one) under ``REPRO_MOE_MODE=ep_model`` at full width, bf16, random
    weights from ``seed`` (the query and key projections drawn as
    ``draw_qk_proj``), its two regions (``_layer_regions``) from random
    normed inputs at the flow shape (``B_SERVE`` x ``HY_SEQ``) and random
    upstream gradients: once whole, then as the ``mp`` ranks of each pass
    of ``EP_PASSES`` (``_ep_pass``), each rank with its shard of every
    leaf (``sharding.use_layout`` under the production rules: MLA's heads,
    the routed experts' expert dim, the shared experts' hidden dim).  Then
    (``time_it``) one rank's routed experts in both modes
    (``_expert_times``)."""
    from repro_torch import sharding as shlib
    cfg = cfg or configs.get(arch)
    axis = _ModelAxis(mp)
    with env_vars(REPRO_MOE_MODE="ep_model", REPRO_BF16_REDUCE=None):
        spec = Backbone(cfg)._block_spec
        rules = shlib.production_rules(axis)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = params_lib.init(spec, gen, torch.bfloat16, dev)
    _draw_qk(p["attn"], cfg, gen)
    shape = (B_SERVE, HY_SEQ, cfg.d_model)
    out = {tag: {} for tag, _ in EP_PASSES}
    for name, fn in _layer_regions(cfg):
        ps, sp = p[name], spec[name]
        h, dy = (torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(2))
        with env_vars(REPRO_MOE_MODE="ep_model", REPRO_BF16_REDUCE=None):
            want = _region(fn, ps, h, dy)
        dims = {path: shlib.use_layout(s.shape, s.axes, rules, axis)[1]
                for path, s in params_lib.leaves(sp)}
        shards = []
        for r in range(mp):
            shard = {}
            for path, t in params_lib.leaves(ps):
                m = dims[path]
                if m is not None:
                    k = t.shape[m] // mp
                    t = t.narrow(m, r * k, k).contiguous()
                params_lib._set(shard, path, t)
            shards.append(shard)
        for tag, bf16 in EP_PASSES:
            with env_vars(REPRO_MOE_MODE="ep_model", REPRO_BF16_REDUCE=bf16):
                out[tag][name] = _ep_pass(fn, shards, dims, h, dy, want)
        if name == "ffn" and time_it:
            out["expert_times"] = _expert_times(ps, cfg, h, dy, mp, mp - 1)
        del shards, want, h, dy
        gc.collect()
        torch.cuda.empty_cache()
    del p
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ep_layer_phase(dev) -> dict:
    """Phase 42: ``ep_layer_ranks`` for one ``deepseek-v2-236b`` MoE layer
    at mp = 16.  In each pass: every gap within ``LAYER_RANK_BAND``; the
    ranks' attention 16 forwards and 16 backwards on ``wgmma`` at 8 heads
    of (192, 128), no other kernel; every MoE call on 10 of the 160
    experts at the whole hidden dim; each region's one *g* all-reduce a
    forward handed the group in f32, or in bf16 under
    ``REPRO_BF16_REDUCE``.  Then one rank's routed experts timed in both
    modes beside their bounds."""
    cfg = configs.get(DS_ARCH)
    m = cfg.moe
    res = ep_layer_ranks(dev)
    n = m.n_experts // LAYER_MP
    uses = sorted({(n, cfg.d_model, m.expert_d_ff),
                   (n, m.expert_d_ff, cfg.d_model)})
    pair = f"{MLA_QK}x{MLA_V}"
    q_shape = (B_SERVE, HY_SEQ, MLA_HEADS // LAYER_MP, MLA_QK)
    ok = True
    for tag, bf16 in EP_PASSES:
        r = res[tag]
        att, ffn = r["attn"], r["ffn"]
        want = {name: 0 for name in att["launches"]}
        want.update(flash_attention=LAYER_MP, flash_attention_bwd=LAYER_MP)
        g_dtype = "torch.bfloat16" if bf16 else "torch.float32"
        g_shape = [B_SERVE, HY_SEQ, cfg.d_model]
        worst = {name: max(r[name]["gaps"].values())
                 for name in ("attn", "ffn")}
        launches_ok = (
            att["launches"] == want
            and all(v == 0 for v in ffn["launches"].values())
            and att["variants"]["flash_attention"] == routed(LAYER_MP,
                                                             "wgmma")
            and att["variants"]["flash_attention_bwd"] == routed(LAYER_MP,
                                                                 "wgmma")
            and att["pairs"]["flash_attention"].get(pair) == LAYER_MP
            and att["pairs"]["flash_attention_bwd"].get(pair) == LAYER_MP
            and att["q_shapes"] == [q_shape] and att["q_calls"] == LAYER_MP)
        experts_ok = [tuple(s) for s in ffn["expert_uses"]] == uses
        g_ok = all(r[name]["g_all_reduces"] == [[g_dtype, g_shape]]
                   for name in ("attn", "ffn"))
        log(f"  {tag}: {DS_ARCH} one MoE layer at mp {LAYER_MP} ({LAYER_MP} "
            f"ranks at once), ({B_SERVE}, {HY_SEQ}) bf16: worst gap a region "
            f"{worst} (band {LAYER_RANK_BAND}); every gap "
            f"{json.dumps({k: r[k]['gaps'] for k in ('attn', 'ffn')})}; "
            f"the ranks' launches {att['launches']} (expected {want}), "
            f"variants {att['variants']}, by dim pair {att['pairs']}, q "
            f"shapes {att['q_shapes']}; expert tables at use "
            f"{ffn['expert_uses']} (expected {uses}); g all-reduces "
            f"attn {att['g_all_reduces']}, ffn {ffn['g_all_reduces']} "
            f"(expected {g_dtype})")
        if (max(worst.values()) > LAYER_RANK_BAND or not launches_ok
                or not experts_ok or not g_ok):
            ok = False
    t = res["expert_times"]
    for mode, row in t.items():
        log(f"  one rank's routed experts ({mode}: {row['experts']} experts "
            f"at f {row['f']}, {row['kept_rows']} kept assignments), "
            f"forward + backward: {row['ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}: "
            f"{row['tflop']:.4f} TFLOP, {row['mbytes']:.1f} MB)")
    if not ok:
        fail("the ep_model layer's 16 ranks do not match the whole layer, "
             "or their attention, expert tables or g all-reduces are not "
             "what the layout calls for")
    res["card"] = card_line()
    return res


# ----------------------------------------------------------------- phase 43
# the activation-gathered route (REPRO_NO_WEIGHT_GATHER, and every decode)
# at dp = 16 on one card: each rank holds 1/16 of every matrix's d dim
# (its stored "data" shard, kept at use) and each product moves rows over
# "data" instead (``sharding.rows_in`` / ``rows_out``).  One full-width
# smollm-360m dense layer and one mamba2-370m block at 16 rows x 1024
# tokens (a row a rank), forward and backward, then one deepseek-v2-236b
# decode layer (MLA and MoE) at decode_32k's 128 rows over a 4096-entry
# cache.  The ranks' forwards run at once on host threads over a
# ``ThreadGroup``; their backwards in rounds (``ThreadGroup.begin_rounds``).
NWG_DP, NWG_SEQ = 16, 1024
NWG_LAYERS = (("smollm", DENSE_ARCH), ("mamba2", SSM_ARCH))
NWG_ROWS, NWG_CACHE = INPUT_SHAPES["decode_32k"].global_batch, 4096


class _RoundStop(Exception):
    """Ends a rank's backward at a collective whose other ranks' inputs
    are not all known yet (``ThreadGroup._round``)."""


def _route_shards(p: dict, spec: dict, dp: int) -> tuple:
    """(each rank's leaves, each leaf's "data" dim at use) on the route:
    a matrix's dim cut to rank r's 1/dp (``sharding.use_layout`` under
    ``production_rules(activations=True)``), every other leaf whole (one
    tensor, shared by the ranks)."""
    from repro_torch import sharding as shlib
    axis = _ModelAxis(1, dp)
    rules = shlib.production_rules(axis, activations=True)
    dims = {path: shlib.use_layout(s.shape, s.axes, rules, axis)[0]
            for path, s in params_lib.leaves(spec)}
    shards = []
    for r in range(dp):
        shard = {}
        for path, t in params_lib.leaves(p):
            d = dims[path]
            if d is not None:
                k = t.shape[d] // dp
                t = t.narrow(d, r * k, k).contiguous()
            params_lib._set(shard, path, t)
        shards.append(shard)
    return shards, dims


@contextlib.contextmanager
def locked_kernels(lock, shapes: list):
    """``ops.flash_attention`` and ``ops.ssd_scan`` called under ``lock``
    (their launch counters are plain attributes), each call's q or x
    shape appended to ``shapes`` with its kernel's name."""
    saved = ops.flash_attention, ops.ssd_scan

    def wrap(name, fn):
        def call(x, *a, **k):
            with lock:
                shapes.append((name, tuple(x.shape)))
                return fn(x, *a, **k)
        return call

    ops.flash_attention = wrap("flash_attention", saved[0])
    ops.ssd_scan = wrap("ssd_scan", saved[1])
    try:
        yield
    finally:
        ops.flash_attention, ops.ssd_scan = saved


def _rank_rows_ctx(group, dp: int, r: int) -> None:
    """This thread's sharding context: rank ``r`` of ``dp`` on the
    route's "data" axis, each rank its own rows."""
    from repro_torch import sharding as shlib
    group.local.rank = r
    shlib._CTX.update(mesh=None, rules=None, tp=None, seq=None,
                      rows=shlib.RowGroup(group, dp, r, True))


def _threads(fn, group, what: str) -> None:
    """``fn(r)`` for every rank r of ``group`` at once, one host thread
    each; a rank's exception fails the phase."""
    import threading
    errors = []

    def rank(r):
        try:
            fn(r)
        except Exception as e:   # the others leave the barrier too
            errors.append(f"rank {r}: {type(e).__name__}: {e}")
            group.barrier.abort()

    threads = [threading.Thread(target=rank, args=(r,))
               for r in range(group.n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        fail(f"phase 43: an emulated rank failed ({what}): "
             + "; ".join(errors))


def route_layer_ranks(dev, arch: str, dp: int = NWG_DP, cfg=None,
                      seq: int = NWG_SEQ, seed: int = 43) -> dict:
    """One block of ``arch`` (``cfg``: another config, as a reduced one) at
    full width, bf16, random weights from ``seed`` (the q and k
    projections drawn as ``draw_qk_proj``, the SSM leaves from Mamba-2's
    init), on ``dp`` random rows of ``seq`` tokens and a random upstream
    gradient: once whole, then as ``dp`` ranks on the activation-gathered
    route, rank r holding row r and 1/dp of every matrix's d dim.  The
    forwards run at once on host threads over a ``ThreadGroup``, the
    backwards in rounds.  Gaps to the whole block: the ranks' outputs and
    input gradients (their rows, concatenated), each matrix's shard
    gradient times dp (the route's gradient is the data-parallel mean)
    against its slice, each whole leaf's gradients summed over the ranks.
    Returns the gaps, the launches, the kernels' shapes, the rounds, the
    seconds and the peak memory of the ranks against the reckoning of
    their gathered rows and f32 partials."""
    import threading
    from repro_torch import sharding as shlib
    cfg = cfg or configs.get(arch)
    bb = Backbone(cfg)
    spec = bb._block_spec
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = params_lib.init(spec, gen, torch.bfloat16, dev)
    if "ssm" in spec:
        draw_ssm_leaves(p["ssm"], seed)

        def fn(q, x):
            return bb._ssm_block(q, x)[0]
    else:
        _draw_qk(p["attn"], cfg, gen)
        pos = torch.arange(seq, dtype=torch.int32, device=dev)

        def fn(q, x):
            return bb._dense_block(q, x, causal=True, window=0,
                                   positions=pos)[0]
    h, dy = (torch.randn((dp, seq, cfg.d_model), generator=gen,
                         device=dev).to(torch.bfloat16) for _ in range(2))
    y, dx, grads = _region(fn, p, h, dy)
    shards, dims = _route_shards(p, spec, dp)
    leaves = [dict(params_lib.leaves(s)) for s in shards]
    every = list({id(t): t for lv in leaves for t in lv.values()}.values())
    for t in every:
        t.requires_grad_(True)
    xs = [h[r:r + 1].detach().clone().requires_grad_() for r in range(dp)]
    ys, got, dxs = [None] * dp, [None] * dp, [None] * dp
    group = ThreadGroup(dp)
    lock, shapes = threading.Lock(), []
    # the reckoning: every rank's largest gathered rows (bf16) and f32
    # partial at once
    widths = [math.prod(s.shape[1:]) if d == 0 else math.prod(s.shape[:d])
              for path, s in params_lib.leaves(spec)
              for d in [dims[path]] if d is not None]
    reckoned = dp * dp * seq * (cfg.d_model * 2 + max(widths) * 4)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
    reset_counts()
    t0 = time.perf_counter()

    def forward(r):
        _rank_rows_ctx(group, dp, r)
        ys[r] = fn(shards[r], xs[r])

    with thread_ranks(), locked_kernels(lock, shapes):
        _threads(forward, group, "forward")
        fwd_s = time.perf_counter() - t0
        group.begin_rounds()
        rounds = 0
        while not all(g is not None for g in got):
            rounds += 1
            for r in range(dp):
                if got[r] is not None:
                    continue
                group.current = r
                group.rounds["calls"][r] = 0
                for t in every + [xs[r]]:
                    t.grad = None
                try:
                    ys[r].backward(dy[r:r + 1], retain_graph=True)
                except Exception:
                    if not group.rounds["stopped"]:
                        raise
                    group.rounds["stopped"] = False
                    continue
                got[r] = {path: (torch.zeros_like(t) if t.grad is None
                                 else t.grad.clone())
                          for path, t in leaves[r].items()}
                dxs[r] = xs[r].grad.clone()
            if not all(g is not None for g in got) and not group.settle():
                fail(f"phase 43: the {arch} ranks' backwards stopped "
                     f"without a collective to settle")
        if dev.type == "cuda":
            torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base
            if dev.type == "cuda" else 0)
    launches, variants = counts(), all_variants()
    for t in every:
        t.requires_grad_(False)
        t.grad = None
    with torch.no_grad():
        gaps = {"out": _rel(torch.cat([t.detach() for t in ys]), y),
                "dx (rows)": _rel(torch.cat(dxs), dx)}
        for path, want in grads.items():
            d = dims[path]
            key = "/".join(path)
            if d is None:
                gaps[key + " (sum)"] = _rel(
                    sum(g[path].float() for g in got), want)
                continue
            k = want.shape[d] // dp
            err = max(float((g[path].float() * dp - want.narrow(
                d, r * k, k).float()).abs().max()) for r, g in
                enumerate(got))
            gaps[key + " (shard x dp)"] = err / max(
                float(want.float().abs().max()), 1e-30)
    res = {"gaps": gaps, "rounds": rounds, "launches": launches,
           "variants": variants,
           "shapes": sorted({f"{n} {s}" for n, s in shapes}),
           "kernel_calls": len(shapes), "forward_s": fwd_s,
           "total_s": total_s, "peak_bytes": peak,
           "reckoned_bytes": reckoned}
    del ys, got, dxs, xs, shards, leaves, every, p, y, dx, grads, h, dy
    gc.collect()
    return res


def route_decode_ranks(dev, dp: int = NWG_DP, cfg=None,
                       rows: int = NWG_ROWS, cache_len: int = NWG_CACHE,
                       seed: int = 44) -> dict:
    """One ``deepseek-v2-236b`` decode layer (``cfg``: another config) at
    full width, bf16, random weights from ``seed`` (MLA's w_uq / w_uk as
    ``draw_qk_proj``) and a random latent cache of ``rows`` x
    ``cache_len``: the port's decode block (MLA's absorbed decode and the
    MoE) once whole, then as ``dp`` ranks on the activation-gathered route
    at once on host threads, rank r holding rows/dp rows of the token and
    the cache and 1/dp of every matrix's d dim, every expert's capacity
    ample (``ample_capacity``: a rank's group is its own rows).  Gaps of
    the outputs and the rolled caches to one device's, and the seconds.
    One device takes the ranks' expert assignments (``routing``'s replay,
    the gates from its own probabilities): a rank's layer input differs
    from one device's by bf16 roundings (the attention's d-partials add
    in another order), which moves a token's router logits by ≈ 1e-3 of
    their size and can swap its k-th and (k+1)-th experts; the swaps are
    counted (``flipped``)."""
    from repro_torch.models import mla as mla_mod
    cfg = cfg or configs.get(DS_ARCH)
    bb = Backbone(cfg)
    spec = bb._block_spec
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = params_lib.init(spec, gen, torch.bfloat16, dev)
    _draw_qk(p["attn"], cfg, gen)
    m = cfg.mla
    x = torch.randn((rows, 1, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    cache = mla_mod.MLACache(*(torch.randn(
        (rows, cache_len, w), generator=gen, device=dev).to(torch.bfloat16)
        for w in (m.kv_lora_rank, m.qk_rope_head_dim)))
    shards, _ = _route_shards(p, spec, dp)
    k = rows // dp
    slots = [mla_mod.MLACache(*(t[r * k:(r + 1) * k].clone()
                                for t in cache)) for r in range(dp)]
    whole = mla_mod.MLACache(*(t.clone() for t in cache))
    ys, picks = [None] * dp, [None] * dp
    group = ThreadGroup(dp)
    route = moe_mod.route

    def picked(q, c, xg):
        out = route(q, c, xg)
        picks[group.rank] = out[3].clone()
        return out

    def rank(r):
        _rank_rows_ctx(group, dp, r)
        with torch.no_grad():
            ys[r] = bb._attn_block_decode(shards[r], x[r * k:(r + 1) * k],
                                          slots[r], cache_len, 0, "moe")

    own = []
    with ample_capacity():
        t0 = time.perf_counter()
        moe_mod.route = picked
        try:
            with thread_ranks():
                _threads(rank, group, "decode")
        finally:
            moe_mod.route = route
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ranks_s = time.perf_counter() - t0
        chosen = torch.cat(picks, 1)
        with torch.no_grad(), routing(record=own, replay=[chosen]):
            y = bb._attn_block_decode(p, x, whole, cache_len, 0, "moe")
    res = {"gaps": {"out": _rel(torch.cat(ys), y), **{
        f"rolled {f}": _rel(torch.cat([getattr(s, f) for s in slots]),
                            getattr(whole, f)) for f in whole._fields}},
           "flipped": _assign_diff(own, [chosen]),
           "assignments": chosen.numel(), "ranks_s": ranks_s,
           "rows_a_rank": k}
    del p, shards, slots, whole, cache, ys, y
    gc.collect()
    return res


def route_phase(dev) -> dict:
    """Phase 43: ``route_layer_ranks`` for one ``smollm-360m`` dense layer
    and one ``mamba2-370m`` block at dp = 16, then ``route_decode_ranks``
    for one ``deepseek-v2-236b`` decode layer.  Every gap within
    ``LAYER_RANK_BAND``; the dense layer's 16 attention forwards and its
    backwards, the block's 16 scans and their backwards, all on
    ``wgmma`` at a rank's row, no other kernel."""
    res, ok = {}, True
    for tag, arch in NWG_LAYERS:
        r = route_layer_ranks(dev, arch)
        res[tag] = r
        cfg = configs.get(arch)
        fwd, bwd = (("flash_attention", "flash_attention_bwd")
                    if tag == "smollm" else ("ssd_scan", "ssd_scan_bwd"))
        lv = r["launches"]
        good = (max(r["gaps"].values()) <= LAYER_RANK_BAND
                and lv[fwd] == NWG_DP and lv[bwd] >= NWG_DP
                and all(v == 0 for n, v in lv.items() if n not in (fwd, bwd))
                and r["variants"][fwd] == routed(lv[fwd], "wgmma")
                and r["variants"][bwd] == routed(lv[bwd], "wgmma"))
        log(f"  {arch} one {'layer' if tag == 'smollm' else 'block'} at dp "
            f"{NWG_DP} ({NWG_DP} rows x {NWG_SEQ}, a row a rank, bf16): "
            f"worst gap {max(r['gaps'].values()):.3e} (band "
            f"{LAYER_RANK_BAND}); every gap {json.dumps(r['gaps'])}; "
            f"backward rounds {r['rounds']}; launches "
            f"{ {n: v for n, v in lv.items() if v} } variants "
            f"{ {n: r['variants'][n] for n in (fwd, bwd)} }, shapes "
            f"{r['shapes']}; forward {r['forward_s']:.2f} s, forward + "
            f"backward {r['total_s']:.2f} s; peak of the ranks "
            f"{r['peak_bytes'] / 1e9:.2f} GB (reckoned gathered rows and "
            f"f32 partials at once {r['reckoned_bytes'] / 1e9:.2f} GB; d "
            f"{cfg.d_model})")
        ok &= good
        torch.cuda.empty_cache()
    d = route_decode_ranks(dev)
    res["deepseek_decode"] = d
    log(f"  {DS_ARCH} one decode layer at dp {NWG_DP} ({NWG_ROWS} rows, "
        f"{d['rows_a_rank']} a rank, {NWG_CACHE}-entry cache): gaps "
        f"{json.dumps(d['gaps'])} (band {LAYER_RANK_BAND}), one device on "
        f"the ranks' routing ({d['flipped']} of {d['assignments']} "
        f"assignments its own router swaps); the ranks {d['ranks_s']:.2f} s")
    ok &= max(d["gaps"].values()) <= LAYER_RANK_BAND
    torch.cuda.empty_cache()
    if not ok:
        fail("the activation-gathered route's ranks do not match one "
             "device, or their kernels are not the wgmma ones at a rank's "
             "row")
    res["card"] = card_line()
    return res


# ----------------------------------------------------------------- phase 44
# long_500k (524288 positions, batch 1, decode): a prefill of 4095 whole
# 128-token chunks (the scan takes no ragged chunk), then decodes at its
# last 128 positions, 524160-524287.  Over 65536 tokens the attention archs
# take their sliding window (``tasks.effective_window``: 8192) and decode
# over a cache of the window's length (``effective_cache_len``)
LONG_SHAPE = INPUT_SHAPES["long_500k"]
LONG_DECODES = 128
LONG_PREFILL = InputShape("prefill_512k", LONG_SHAPE.seq_len - LONG_DECODES,
                          1, "prefill")
# (tag, arch, layers) of the full-width paths: smollm-360m at 8 of its 32
# layers, mamba2-370m at 12 of its 48, zamba2-2.7b at one of its nine
# groups (one shared-block site, with a 5.4 GB whole-length cache in the
# prefill); cut from 32, 48 and 12 when phase 46 came
LONG_ARCHS = (("smollm", DENSE_ARCH, 8), ("mamba2", SSM_ARCH, 12),
              ("zamba2", HY_ARCH, 6))
# query rows of one checked block of the attention, and of one plain call
LONG_BLOCK = 1024
# the exact check's prefill lengths, longest first: the first whose f32
# prefill, decodes and forward fit the card (zamba2-2.7b's group at 524160
# peaks at 77.7 GiB: it fits a fresh process, not always the whole script)
LONG_EXACT_LENS = (LONG_PREFILL.seq_len, 491520, 393216)
# heads of one plain scan call (the plain chunked scan over 4095 chunks
# and all of zamba2-2.7b's 80 heads would hold ~75 GB of f32 temporaries)
LONG_PLAIN_HEADS = 16
# RoPE on the card at long_500k's decoded positions against the float64
# rotation of the same f32 angles: max |err| / max |x| (CUDA's cosf and
# sinf are within 2 ulp, 2.4e-7 of a unit value)
ROPE_BAND = 1e-6


def window_caches(cfg, caches, T: int):
    """Every attention and latent cache of ``caches`` cut to its last
    ``T`` entries, a copy (the whole-length caches are then free), the SSM
    caches as they are: long_500k's window-sized decode cache, made from
    a whole-length prefill."""
    axes = map_cache_spec(lambda leaf, _: (
        leaf[1].index("cache_seq") if "cache_seq" in leaf[1] else None),
        Backbone(cfg).cache_specs(1, 1))

    def walk(node, ax):
        if isinstance(node, tuple):
            vals = [walk(n, a) for n, a in zip(node, ax)]
            return type(node)(*vals) if hasattr(node, "_fields") \
                else tuple(vals)
        if ax is None:
            return node
        return node.narrow(ax, node.shape[ax] - T, T).clone(
            memory_format=torch.contiguous_format)
    return walk(caches, axes)


def _window_pairs(S: int, W: int) -> int:
    """(query row, key) pairs a causal mask under window W keeps over S
    rows: row r sees min(r + 1, W) keys."""
    n = min(S, W)
    return n * (n + 1) // 2 + (S - n) * W


def _band(x, r0: int, n: int, W: int):
    """``x``'s keys or values that rows [r0, r0 + n) of a causal attention
    under window W reach, [max(0, r0 - W + 1), r0 + n), and their
    positions."""
    k0 = max(0, r0 - W + 1)
    return x[:, k0:r0 + n], torch.arange(k0, r0 + n, dtype=torch.int32,
                                         device=x.device)


def _band_plain(q, k, v, r0: int, n: int, W: int):
    """Rows [r0, r0 + n) of the causal attention under window W, plain:
    ``layers.attention_chunked`` over the only keys their window reaches
    (``_band``), through ``q_positions`` / ``k_positions``."""
    (ks, kp), (vs, _) = _band(k, r0, n, W), _band(v, r0, n, W)
    return attention_chunked(
        q[:, r0:r0 + n], ks, vs, causal=True, window=W, chunk_q=LONG_BLOCK,
        q_positions=torch.arange(r0, r0 + n, dtype=torch.int32,
                                 device=q.device), k_positions=kp)


def _band_lse(q, k, r0: int, n: int, W: int):
    """Those rows' log-sum-exp of the scaled, masked scores, f32
    (B, H, n), as the kernel writes it."""
    B, _, H, D = q.shape
    K = k.shape[2]
    ks, kp = _band(k, r0, n, W)
    qp = torch.arange(r0, r0 + n, dtype=torch.int32, device=q.device)
    s = torch.einsum("bckgd,btkd->bkgct",
                     q[:, r0:r0 + n].reshape(B, n, K, H // K, D).float(),
                     ks.float()) * D ** -0.5
    ok = (kp[None, :] <= qp[:, None]) & (kp[None, :] > qp[:, None] - W)
    lse = torch.logsumexp(s.masked_fill(~ok, float("-inf")), -1)
    return lse.reshape(B, H, n)


def _band_plain_all(q, k, v, W: int) -> None:
    """The plain attention over the whole sequence, a block of
    ``LONG_BLOCK`` rows at a time (its time is the plain ms)."""
    for r0 in range(0, q.shape[1], LONG_BLOCK):
        _band_plain(q, k, v, r0, min(LONG_BLOCK, q.shape[1] - r0), W)


def long_attention_row(dev, name: str, what: str, H: int, K: int, D: int,
                       W: int, seed: int, path: str) -> dict:
    """The bf16 attention kernel at (1, 524160, H / K, D), causal, window
    W, on its wgmma variant: o at the first block of ``LONG_BLOCK`` rows
    (the window not yet full), the block across row W, one in the middle,
    one at an odd offset and the last, each row within ``ROW_BAND`` of its
    own max |plain| (``_band_plain``, the plain rows over their band of
    keys: a plain version over the whole sequence would hold 524160^2
    scores), the LSE within ``LSE_BAND`` (``_band_lse``).  Then its ms (a replayed graph),
    the plain ms over every block, and the operations bound over the
    (row, key) pairs the window keeps.  A kernel row of the ``kernels``
    line, its launches those of ``path``."""
    S = LONG_PREFILL.seq_len
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(1, S, H, D, generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(1, S, K, D, generator=g, device=dev).to(
        torch.bfloat16) for _ in range(2))
    before = all_variants()["flash_attention"]["wgmma"]
    o, lse = flash_attention(q, k, v, causal=True, window=W,
                             return_lse=True)
    if all_variants()["flash_attention"]["wgmma"] - before != 1:
        fail(f"the attention at the {what} shape did not run its wgmma "
             "kernel")
    blocks = (0, W - LONG_BLOCK // 2, S // 2, S // 2 + 333 * 3,
              S - LONG_BLOCK)
    rows, lse_err, abs_err = [], 0.0, 0.0
    for r0 in blocks:
        want = _band_plain(q, k, v, r0, LONG_BLOCK, W)
        want_lse = _band_lse(q, k, r0, LONG_BLOCK, W)
        rows += _row_errs([o[:, r0:r0 + LONG_BLOCK]], [want])
        got_lse = lse[:, :, r0:r0 + LONG_BLOCK]
        lse_err = max(lse_err, float((got_lse - want_lse).abs().max()) / max(
            1.0, float(want_lse.abs().max())))
        abs_err = max(abs_err, float((o[:, r0:r0 + LONG_BLOCK].float()
                                      - want.float()).abs().max()))
        del want, want_lse
    torch.cuda.synchronize()
    band = ROW_BAND[torch.bfloat16]
    log(f"  {what} (1, {S}, {H} / {K} heads of {D}) causal, window {W}, "
        f"bf16 (wgmma), rows {list(blocks)} + {LONG_BLOCK}: per-row "
        f"max|err| / max|plain| of the row " + ", ".join(
            f"{e:.3e}" for e in rows) + f" (band {band}); lse {lse_err:.2e}"
        f" (band {LSE_BAND})")
    if max(rows) > band or lse_err > LSE_BAND:
        fail(f"the attention at the {what} shape is off its band")
    del o, lse
    torch.cuda.empty_cache()
    ms = graph_ms(lambda: flash_attention(q, k, v, causal=True, window=W),
                  1, 3)
    plain_ms = cuda_ms(lambda: _band_plain_all(q, k, v, W), 1, 0)
    pairs = _window_pairs(S, W)
    bound, by = _bound((2 * q.numel() + 2 * k.numel()) * 2,
                       4 * pairs * H * D)
    log(f"  {name}: kernel {ms:.4f} ms (wgmma, replayed graph), plain "
        f"{plain_ms:.3f} ms ({(S + LONG_BLOCK - 1) // LONG_BLOCK} blocks of "
        f"{LONG_BLOCK} rows over their bands), bound {bound:.4f} ms ({by}: "
        f"{pairs} (row, key) pairs x {H} heads x 4 x {D}); library: none")
    del q, k, v
    torch.cuda.empty_cache()
    return {"name": name, "route": "cuda", "variant": "wgmma",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:81",
            "max_abs_err": abs_err, "max_rel_err": max(rows),
            "lse_err": lse_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "library_note": "none: SDPA takes a window only as a dense "
                            f"({S}, {S}) mask",
            "shape": [1, S, H, K, D, W], "path": path}


def _plain_scan_heads(x, dt, a, bm, cm):
    """The plain chunked scan (``ref.ssd_chunked_ref``), ``LONG_PLAIN_HEADS``
    heads a call (the heads are independent; B and C are shared), joined:
    (y, final state)."""
    ys, hs = [], []
    for h0 in range(0, x.shape[2], LONG_PLAIN_HEADS):
        h1 = h0 + LONG_PLAIN_HEADS
        y, h = ref.ssd_chunked_ref(x[:, :, h0:h1], dt[:, :, h0:h1], a[h0:h1],
                                   bm, cm, SSM_CHUNK)
        ys.append(y)
        hs.append(h)
    return torch.cat(ys, 2), torch.cat(hs, 1)


def long_scan_row(dev, name: str, what: str, H: int, N: int, seed: int,
                  path: str) -> dict:
    """The bf16 scan at (1, 524160, H heads of 64, state N, chunk 128):
    4095 chunks walked by each of H blocks, x, bm and cm column slices of
    one buffer as the model passes them, on the wgmma variant: y and the
    final state against the plain chunked scan (``_plain_scan_heads``)
    at ``SSD_Y_BAND`` and ``SSD_H_BAND``, the state's gap also after 36
    and 512 chunks (its growth with the chunk count); then its ms (a
    replayed graph), the plain ms and the bytes bound; its launches those
    of ``path``."""
    L, P, Q = LONG_PREFILL.seq_len, SSM_HEAD_DIM, SSM_CHUNK
    g = torch.Generator(device=dev).manual_seed(seed)
    x, dt, a, bm, cm = _ssd_inputs(g, dev, 1, L, H, P, N, "mamba2",
                                   torch.bfloat16)
    x, bm, cm = _ssd_conv_slices(x, bm, cm)
    h_by_chunks = {}
    for nc in (36, 512, L // Q):
        n = nc * Q
        (y, hT), variant = _ssd_variant(lambda: ssd_scan(
            x[:, :n], dt[:, :n], a, bm[:, :n], cm[:, :n], chunk=Q))
        if variant != "wgmma":
            fail(f"the scan at the {what} shape ran {variant}")
        y_ref, h_ref = _plain_scan_heads(x[:, :n], dt[:, :n].contiguous(),
                                         a, bm[:, :n], cm[:, :n])
        h_by_chunks[nc] = _rel(hT, h_ref)
        del hT, h_ref
        if nc != L // Q:
            del y, y_ref
    torch.cuda.synchronize()
    y_err = _rel(y, y_ref)
    abs_err = float((y.float() - y_ref.float()).abs().max())
    h_err = h_by_chunks[L // Q]
    log(f"  {what} (1, {L}, {H} heads of {P}, state {N}, chunk {Q}) bf16 "
        f"(wgmma), x {x.numel()} elements: y {y_err:.2e} of max|plain| "
        f"(band {SSD_Y_BAND[torch.bfloat16]}), final state {h_err:.2e} "
        f"(band {SSD_H_BAND}); the state after "
        + ", ".join(f"{nc} chunks {e:.2e}" for nc, e in h_by_chunks.items()))
    if y_err > SSD_Y_BAND[torch.bfloat16] or h_err > SSD_H_BAND:
        fail(f"ssd_scan off at the {what} shape")
    del y, y_ref
    torch.cuda.empty_cache()
    ms = graph_ms(lambda: ssd_scan(x, dt, a, bm, cm, chunk=Q), 1, 3)
    plain_ms = cuda_ms(lambda: _plain_scan_heads(x, dt, a, bm, cm), 1, 0)
    bound, by, nbytes, flops = _ssd_fwd_bound(1, L, H, P, N, Q)
    log(f"  {name}: kernel {ms:.4f} ms (wgmma, replayed graph), plain "
        f"{plain_ms:.3f} ms, bound {bound:.4f} ms ({by}: "
        f"{nbytes / 1e9:.3f} GB, {flops / 1e9:.1f} GFLOP); library: none")
    del x, dt, a, bm, cm
    torch.cuda.empty_cache()
    return {"name": name, "route": "cuda", "variant": "wgmma",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:77",
            "max_abs_err": abs_err, "max_rel_err": y_err,
            "state_err_by_chunks": h_by_chunks, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None,
            "library_note": "none: no single PyTorch call runs the scan",
            "shape": [1, L, H, P, N, Q], "path": path}


def _long_params(dev, cfg, dtype, seed: int):
    """``cfg``'s params from a seed on the card, with phase 35's draws:
    the SSM leaves from Mamba-2's init, the attention's query and key
    projections (the hybrid's shared ones) at 1/sqrt(d_model)."""
    p = tasks.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                          dtype, dev)
    bb = {"backbone": p}
    if cfg.family in ("ssm", "hybrid"):
        draw_ssm(bb, seed=seed + 1)
    if cfg.family == "hybrid":
        draw_shared_attention(bb, cfg.d_model, seed=seed + 2)
    elif cfg.family != "ssm":
        draw_qk_proj(bb, cfg, seed=seed + 2)
    return p


def _long_kernels(cfg) -> tuple:
    """(attention, scan) launches of one pass over ``cfg``'s layers."""
    if cfg.family == "ssm":
        return 0, cfg.n_layers
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid.attn_every, cfg.n_layers
    return cfg.n_layers, 0


def long_path(dev, tag: str, arch: str, layers: int) -> dict:
    """``arch`` at full width and ``layers`` layers, bf16, through the
    LM task path's entry points: ``tasks.make_prefill_step`` at
    ``effective_window(cfg, prefill_512k)`` over 524160 tokens (its
    attention and scan launches counted, all on wgmma), every attention
    cache cut to its last ``effective_cache_len(cfg, long_500k)`` entries
    (``window_caches``), then 128 greedy ``make_decode_step`` steps at
    ``effective_window(cfg, long_500k)``, positions 524160-524287 (no
    kernel launch): finite logits; prefill tokens/s, decode ms a step,
    peak memory."""
    cfg = depth_cfg(arch, layers)
    W = tasks.effective_window(cfg, LONG_PREFILL)
    Wd = tasks.effective_window(cfg, LONG_SHAPE)
    T = tasks.effective_cache_len(cfg, LONG_SHAPE)
    L = LONG_PREFILL.seq_len
    p = _long_params(dev, cfg, torch.bfloat16, 440)
    gen = torch.Generator(device=dev).manual_seed(443)
    toks = torch.randint(0, cfg.vocab_size, (1, L), generator=gen,
                         device=dev)
    prefill = tasks.make_prefill_step(cfg, window=W)
    dec = tasks.make_decode_step(cfg, window=Wd)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    logits, caches = prefill(p, {"tokens": toks})
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    launches, variants = counts(), all_variants()
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    n_attn, n_scan = _long_kernels(cfg)
    want = {name: 0 for name in launches}
    want.update(flash_attention=n_attn, ssd_scan=n_scan)
    if launches != want or variants["flash_attention"] != routed(
            n_attn, "wgmma") or variants["ssd_scan"] != routed(
            n_scan, "wgmma") or not torch.isfinite(logits).all():
        fail(f"{arch}'s long prefill: launches {launches} ({variants}), "
             f"expected {want} on wgmma, or its logits are not finite")
    caches = window_caches(cfg, caches, T) if W else caches
    gc.collect()
    torch.cuda.empty_cache()
    tok = logits.argmax(-1)[:, None]
    reset_counts()
    times = []
    for i in range(LONG_DECODES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = dec(p, caches, tok, L + i)
        tok = logits.argmax(-1)[:, None]
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if any(counts().values()) or not torch.isfinite(logits).all():
        fail(f"{arch}'s long decode launched kernels {counts()} or its "
             "logits are not finite")
    dec_peak = torch.cuda.max_memory_allocated()
    dec_ms = 1e3 * sum(times[1:]) / (len(times) - 1)
    log(f"  {tag}: {arch} {cfg.n_layers} layers bf16, prefill {L} tokens "
        f"at window {W}: {pre_s:.4f} s, {L / pre_s:.1f} tokens/s, "
        f"max_memory_allocated {peak / 2**30:.2f} GiB ({peak} bytes), "
        f"reserved {reserved / 2**30:.2f} GiB; launches {launches}; "
        f"{LONG_DECODES} decodes at positions {L}-{L + LONG_DECODES - 1}, "
        f"window {Wd}, cache {T if W else 'state'}: {dec_ms:.3f} ms a step "
        f"(steps 2-{LONG_DECODES}), max_memory_allocated "
        f"{dec_peak / 2**30:.2f} GiB")
    del p, caches, logits, toks
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": arch, "layers": cfg.n_layers, "window": W,
            "decode_window": Wd, "cache_len": T if W else None,
            "prefill_tokens": L, "prefill_s": pre_s,
            "prefill_tokens_per_s": L / pre_s, "peak_bytes": peak,
            "reserved_bytes": reserved, "launches": launches,
            "variants": variants, "decodes": LONG_DECODES,
            "decode_ms_per_step": dec_ms,
            "decode_ms_first_step": 1e3 * times[0],
            "decode_peak_bytes": dec_peak}


def long_exact(dev, tag: str, arch: str) -> dict:
    """The exact check, f32, at depth 2 (zamba2-2.7b one group of 6 SSM
    blocks and the shared block), teacher-forced: a prefill of L tokens at
    window W + 1 (W = ``effective_window``; the SSM arch 0), every
    attention cache cut to its last W entries, 128 decodes at window W,
    each attending its W cached keys and itself, against the forward over
    L + 128 tokens at W + 1, at every decoded position, within
    ``DECODE_BAND`` of max |forward logits|.  L is the longest of
    ``LONG_EXACT_LENS`` whose prefill, decodes and forward fit the card
    (each longer one printed with its out-of-memory); the prefill and the
    forward run the f32 kernels (launches counted)."""
    cfg = _decode_cfg(arch)
    W = tasks.effective_window(cfg, LONG_PREFILL)
    wp = W + 1 if W else 0
    p = _long_params(dev, cfg, torch.float32, 445)
    model = Backbone(cfg)
    gen = torch.Generator(device=dev).manual_seed(448)
    toks = torch.randint(0, cfg.vocab_size, (1, LONG_SHAPE.seq_len),
                         generator=gen, device=dev)
    prefill = tasks.make_prefill_step(cfg, window=wp)
    dec = tasks.make_decode_step(cfg, window=W)
    n_attn, n_scan = _long_kernels(cfg)
    refused = {}
    for L in LONG_EXACT_LENS:
        try:
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            _, caches = prefill(p, {"tokens": toks[:, :L]})
            pre = counts(), all_variants()
            caches = window_caches(cfg, caches, W) if W else caches
            outs = []
            for i in range(L, L + LONG_DECODES):
                lg, caches = dec(p, caches, toks[:, i:i + 1], i)
                outs.append(lg)
            got = torch.stack(outs, 1)
            del caches, outs
            reset_counts()
            with torch.no_grad():
                hidden = model.forward_embeds(
                    p, model.embed_inputs(p, toks[:, :L + LONG_DECODES]),
                    window=wp)
                full = model.logits(p, hidden[:, L:])
            del hidden
            fwd = counts(), all_variants()
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError as e:
            refused[L] = str(e).splitlines()[0][:200]
            log(f"  {tag} exact check at L = {L}: out of memory "
                f"({refused[L]})")
            caches = outs = hidden = None
            gc.collect()
            torch.cuda.empty_cache()
        else:
            break
    else:
        fail(f"{arch}'s exact check fits at no length")
    peak = torch.cuda.max_memory_allocated()
    want = {name: 0 for name in pre[0]}
    want.update(flash_attention=n_attn, ssd_scan=n_scan)
    for launches, variants in (pre, fwd):
        if launches != want or variants["flash_attention"] != routed(
                n_attn, "fma") or variants["ssd_scan"] != routed(
                n_scan, "fma"):
            fail(f"{arch}'s exact check: launches {launches} ({variants}), "
                 f"expected {want} on the f32 kernels")
    scale = float(full.abs().max())
    err = float((got - full).abs().max()) / scale
    by_pos = ((got - full).abs().amax(-1) / scale)[0]
    log(f"  {tag}: {arch} depth {cfg.n_layers} f32, prefill {L} at window "
        f"{wp}, caches cut to {W or 'state'}, {LONG_DECODES} decodes at "
        f"positions {L}-{L + LONG_DECODES - 1} (window {W}) against the "
        f"forward over {L + LONG_DECODES} at window {wp}: max |decode - "
        f"forward| {err:.3e} of max|logits| (band {DECODE_BAND}; first / "
        f"last position {float(by_pos[0]):.3e} / {float(by_pos[-1]):.3e}), "
        f"max_memory_allocated {peak / 2**30:.2f} GiB; launches prefill "
        f"{pre[0]}, forward {fwd[0]}")
    if not torch.isfinite(got).all() or err > DECODE_BAND:
        fail(f"{arch}: the long decodes disagree with the forward at "
             f"window {wp}")
    del p, got, full
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": arch, "layers": cfg.n_layers, "prefill_len": L,
            "refused": refused, "prefill_window": wp, "decode_window": W,
            "err_forward": err, "err_by_position": by_pos.tolist(),
            "peak_bytes": peak, "launches": pre[0],
            "forward_launches": fwd[0]}


def check_long_rope(dev) -> dict:
    """``layers.apply_rope`` on the card (f32) at the decoded positions
    524160-524287, at head dims 64 and 80 and the archs' theta, against
    the float64 rotation of the card's own f32 angles (its frequencies
    times the positions, as ``apply_rope`` forms them; the reference
    computes its angles in f32 too) within ``ROPE_BAND`` of max |x|.
    Beside it, the card's f32 frequencies against the CPU's, in ulps, and
    the gap that makes between the two devices' angles at these
    positions."""
    g = torch.Generator(device=dev).manual_seed(449)
    pos = torch.arange(LONG_PREFILL.seq_len, LONG_SHAPE.seq_len,
                       dtype=torch.int32, device=dev)
    out = {}
    for D, arch in ((64, DENSE_ARCH), (80, HY_ARCH)):
        theta = configs.get(arch).rope_theta
        x = torch.randn(1, LONG_DECODES, 8, D, generator=g, device=dev)
        got = layers_mod.apply_rope(x, pos, theta).cpu().double()
        freqs = layers_mod.rope_frequencies(D, theta, dev)
        ang = (pos.to(torch.float32)[:, None] * freqs).cpu()
        cos, sin = (f(ang.double())[:, None] for f in (torch.cos, torch.sin))
        x1, x2 = x.cpu().double().chunk(2, dim=-1)
        want = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
        host = layers_mod.rope_frequencies(D, theta)
        ulps = ((freqs.cpu() - host).abs()
                / torch.finfo(torch.float32).eps / host).max()
        out[f"D{D}"] = {
            "err": float((got - want).abs().max() / x.abs().max()),
            "freq_ulps_vs_cpu": float(ulps),
            "angle_gap_vs_cpu": float((ang - pos.cpu().float()[:, None]
                                       * host).abs().max())}
    last = torch.tensor(float(LONG_SHAPE.seq_len - 1))
    half_ulp = float(torch.nextafter(last, last + 1) - last) / 2
    last = int(last)
    log(f"  apply_rope on the card at positions {LONG_PREFILL.seq_len}-"
        f"{last} against the float64 rotation of its f32 "
        f"angles: " + ", ".join(f"{k} {v['err']:.2e}" for k, v in
                               out.items()) + f" of max|x| (band {ROPE_BAND});"
        f" the card's frequencies against the CPU's: " + ", ".join(
            f"{k} {v['freq_ulps_vs_cpu']:.2f} ulp, angles "
            f"{v['angle_gap_vs_cpu']:.3e} rad apart" for k, v in out.items())
        + f" (half an f32 ulp at {last}: {half_ulp:.4f} rad)")
    if max(v["err"] for v in out.values()) > ROPE_BAND:
        fail("apply_rope at long_500k's positions is off float64")
    return out


def long_phase(dev) -> dict:
    """Phase 44: (a) the attention and the scan at long_500k's prefill
    shapes against their plain versions, with times; (b) the three archs'
    full-width paths; (c) the exact checks and RoPE at those positions."""
    sm, hy = configs.get(DENSE_ARCH), configs.get(HY_ARCH)
    W = tasks.effective_window(sm, LONG_PREFILL)
    # the window W on the prefill path, W + 1 on the exact check's
    rows = [long_attention_row(dev, f"flash_attention_long_smollm_w{w}",
                               f"{DENSE_ARCH} long prefill", sm.n_heads,
                               sm.n_kv_heads, sm.resolved_head_dim, w, 440 + i,
                               path)
            for i, (w, path) in enumerate(((W, "long_smollm"),
                                           (W + 1, "long_exact_smollm")))]
    rows.append(long_attention_row(
        dev, "flash_attention_long_zamba2", f"{HY_ARCH} long prefill",
        hy.n_heads, hy.n_kv_heads, hy.resolved_head_dim,
        tasks.effective_window(hy, LONG_PREFILL), 442, "long_zamba2"))
    rows.append(long_scan_row(dev, "ssd_scan_long_mamba2",
                              f"{SSM_ARCH} long prefill", SSM_HEADS,
                              SSM_STATE, 443, "long_mamba2"))
    rows.append(long_scan_row(dev, "ssd_scan_long_zamba2",
                              f"{HY_ARCH} long prefill", HY_SSD_HEADS,
                              HY_STATE, 444, "long_zamba2"))
    gc.collect()
    torch.cuda.empty_cache()
    res = {"kernel_rows": rows}
    for tag, arch, n in LONG_ARCHS:
        res[tag] = long_path(dev, tag, arch, n)
    for tag, arch, _ in LONG_ARCHS:
        res[f"exact_{tag}"] = long_exact(dev, tag, arch)
    res["rope"] = check_long_rope(dev)
    return res


# ----------------------------------------------------------------- phase 45
# the engine's captured executables: each (bucket, steps, x0_only) shape of
# a serving engine runs as one CUDA graph, captured at warmup (or, cold, at
# its first dispatch), every later dispatch a replay.  (b) serves 5
# requests at buckets (1, 4): one b4 and one b1 dispatch.
GRAPH_BUCKETS, GRAPH_REQUESTS = (1, 4), 5
# (b)'s depths: smollm-360m at 8 of its 32 layers, mamba2-370m at 12 of
# its 48 (cut from 32 and 48 when phase 46 came)
GRAPH_DENSE_LAYERS, GRAPH_SSM_LAYERS = 8, 12
# (c)'s mix_grpo steps: its window moves each step, a mask pattern a step
MIX_STEPS = 2


def _traced(fn) -> dict:
    """One traced call of ``fn`` (warmed) under ``torch.profiler``, the
    device's activity only (no host op is recorded, so the eager route
    pays less for the trace): the traced wall ms, the device busy ms (the
    kernels' summed time, graph replays' kernels included) and the idle
    share."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.time_range.elapsed_us() / 1e3 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    if busy == 0:
        fail("a traced batch of the engine holds no device time")
    return {"traced_wall_ms": wall, "device_busy_ms": busy,
            "idle_share": max(0.0, 1 - busy / wall)}


def replay_vs_eager(eng, bucket: int, tag: str, reps: int = 3) -> dict:
    """One bucket of ``eng``'s queue variant at NUM_STEPS, replayed from
    its graph (captured first where the engine has none at that shape)
    and run through the eager executor on the same condition and seeds:
    for each route the median seconds of ``reps`` synchronised calls
    (host clock), s a step, req/s, and one traced call's device busy ms
    and idle share; the latents bitwise.  The two routes run the same
    kernels, so where their traced busy times differ by over a tenth the
    profiler lost records, and both are traced again (a trace never
    counts a kernel twice: the larger is kept)."""
    cond = torch.from_numpy(eng.encode(synthetic_prompts(bucket))).to(
        eng.device)
    seeds = request_seeds(0, bucket)
    eager_fn = eng._fn(NUM_STEPS, x0_only=True)
    routes = {"replayed": lambda: eng._run(eng.params, cond, seeds,
                                           NUM_STEPS, True),
              "eager": lambda: eager_fn(eng.params, cond, seeds)}
    shapes = [g["shape"] for g in eng.graph_report()["graphs"]]
    if f"b{bucket}/s{NUM_STEPS}" not in shapes:
        routes["replayed"]()            # the capture (its eager run warms)
    out, lat = {}, {}
    for k, fn in routes.items():
        secs = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lat[k] = fn()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        sec = sorted(secs)[len(secs) // 2]
        out[k] = {"s": sec, "s_per_step": sec / NUM_STEPS,
                  "req_per_s": bucket / sec, "s_calls": secs,
                  **_traced(fn)}
    r, e = out["replayed"], out["eager"]
    if abs(r["device_busy_ms"] - e["device_busy_ms"]) > 0.1 * max(
            r["device_busy_ms"], e["device_busy_ms"]):
        for k, fn in routes.items():
            again = _traced(fn)
            if again["device_busy_ms"] > out[k]["device_busy_ms"]:
                out[k].update(again)
    same = bool(torch.equal(lat["replayed"], lat["eager"]))
    out["bitwise"] = same
    log(f"  {tag} b{bucket}: replayed / eager {r['s_per_step']:.4f} / "
        f"{e['s_per_step']:.4f} s a step ({r['req_per_s']:.4f} / "
        f"{e['req_per_s']:.4f} req/s; median of {reps}), device busy "
        f"{r['device_busy_ms']:.3f} / {e['device_busy_ms']:.3f} ms a batch, "
        f"traced idle share {r['idle_share']:.4f} / {e['idle_share']:.4f}; "
        f"latents bitwise {same}")
    if not same:
        fail(f"{tag}: the replayed b{bucket} latents differ from the eager "
             "executor's")
    return out


def graph_rows(eng, tag: str) -> dict:
    """(d) ``eng.graph_report()``: each graph's eager-run and capture
    seconds and launches per replay, the pool's bytes beside
    ``max_memory_allocated``."""
    rep = eng.graph_report()
    rep["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    for g in rep["graphs"]:
        log(f"    {tag} {g['shape']}: eager run {g['warm_s']:.3f} s, capture "
            f"{g['capture_s']:.3f} s, launches per replay "
            f"{g['launches_per_replay']}")
    log(f"    {tag}: {rep['captures']} captures {rep['captures_by_mask']}, "
        f"{rep['replays']} replays, pool {rep['pool_bytes']} bytes, "
        f"max_memory_allocated {rep['max_memory_allocated']} bytes")
    return rep


def graphs_flux(eng=None) -> dict:
    """(a) Phase 5's flux_dit engine (38 blocks; built by phase 5's path
    when ``eng`` is None): replay against the eager executor at b4 (the
    warmed shape) and b1 (captured here)."""
    if eng is None:
        eng = main_path()["engine"]
    out = {f"b{b}": replay_vs_eager(eng, b, "flux_dit", reps=1)
           for b in (B_SERVE, 1)}
    out["graphs"] = graph_rows(eng, "flux_dit")
    return out


def graphs_arch(argv: list, tag: str) -> dict:
    """(b) ``serve.main`` at buckets (1, 4), one tier of NUM_STEPS steps,
    serving 5 requests (one b4 and one b1 dispatch, both replays: the CLI
    raises on a cold one); a cold engine on the same params serves them
    again (one cold dispatch a shape; its batches are the captures' eager
    runs) and must give the same latents bitwise; then
    ``replay_vs_eager`` at both buckets."""
    argv = list(argv)
    for flag, val in (("--bucket", ",".join(map(str, GRAPH_BUCKETS))),
                      ("--requests", str(GRAPH_REQUESTS))):
        argv[argv.index(flag) + 1] = val
    torch.cuda.reset_peak_memory_stats()
    out = serve.main(argv)
    eng, st = out["engine"], out["stats"]
    want = {f"b{b}/s{NUM_STEPS}": 1 for b in GRAPH_BUCKETS}
    rep = eng.graph_report()
    if (st["dispatches"] != want or st["cold_dispatches"]
            or rep["replays"] != len(GRAPH_BUCKETS)):
        fail(f"{tag}: the warmed engine dispatched {st['dispatches']} with "
             f"{st['cold_dispatches']} cold, {rep['replays']} replays")
    cond = eng.encode(synthetic_prompts(GRAPH_REQUESTS))
    cold = ServingEngine(eng.adapter, eng.scheduler, eng.params,
                         num_steps=NUM_STEPS, device=eng.device,
                         max_batch=max(GRAPH_BUCKETS), buckets=GRAPH_BUCKETS,
                         cond_len=eng.cond_len)
    lat = cold.serve(cond, 0)
    cst = cold.stats
    same = bool(torch.equal(lat, out["latents"]))
    log(f"  {tag}: warmed engine {st['dispatches']}, cold_dispatches "
        f"{st['cold_dispatches']}; cold engine cold_dispatches "
        f"{cst['cold_dispatches']}, compiles {cst['compiles']}; its eager "
        f"batches bitwise the warmed engine's replays {same}")
    if cst["cold_dispatches"] != len(GRAPH_BUCKETS) or not same:
        fail(f"{tag}: the cold engine's accounting or latents are wrong")
    del cold
    res = {"dispatches": st["dispatches"],
           "cold_dispatches": st["cold_dispatches"],
           "cold_engine_cold_dispatches": cst["cold_dispatches"],
           "cold_engine_bitwise": same,
           "warmup_s": out["warmup"], "serve_s": out["serve_s"]}
    for b in GRAPH_BUCKETS:
        res[f"b{b}"] = replay_vs_eager(eng, b, tag)
    res["graphs"] = graph_rows(eng, tag)
    del eng, out
    gc.collect()
    torch.cuda.empty_cache()
    return res


def graphs_trainer(dev) -> dict:
    """(c) The trainer path at phase 24's cell (mamba2-370m at full width,
    depth 2, f32, SSM leaves drawn, 2 prompts x group 2 through an engine
    of max_batch 2): after one flow_grpo step (its rollout captured, AdamW
    updating the params in place), the engine's replayed rollout equals
    an eager rollout at the new params bitwise and differs from one at
    the old; then mix_grpo with its window moving every step, the
    engine's captures per SDE-mask pattern."""
    cfg, flow, opt, cond = _mesh_setup(dev, SSM_ARCH, 30)
    cond = cond.expand(2, -1, -1).contiguous()
    cond[1].mul_(-1.0)
    out = {}
    for tname in ("flow_grpo", "mix_grpo"):
        fl = (flow if tname == "flow_grpo" else
              replace(flow, sde_window_shift_every=1))
        tr = registry.build("trainer", tname, cfg, fl, opt, seed=0,
                            cond_dim=COND_DIM, device=dev,
                            dtype=torch.float32,
                            perf=PerfConfig(policy_dtype="float32"))
        draw_ssm(tr.state.params, seed=32)
        eng = ServingEngine.for_trainer(tr, max_batch=2,
                                        cond_len=SSM_COND_LEN)
        tr.attach_engine(eng)
        if tname == "mix_grpo":
            for it in range(MIX_STEPS):
                tr.step(cond, 5, it=it)
            rep = graph_rows(eng, tname)
            if len(rep["captures_by_mask"]) < 2:
                fail("mix_grpo's moving window captured one mask pattern")
            out[tname] = {"captures_by_mask": rep["captures_by_mask"],
                          "graphs": rep}
            del tr, eng
            continue
        old = _clone(tr.state.params)
        tr.step(cond, 5, it=0)
        new = tr.state.params
        rows = group_repeat(cond, fl.group_size)
        traj = eng.rollout(new, rows, 9)
        fn = eng._fn(NUM_STEPS)
        seeds = request_seeds(9, rows.shape[0])

        def eager(params):
            parts = [fn(params, rows[i:i + 2], seeds[i:i + 2])
                     for i in (0, 2)]
            return (torch.cat([t.xs for t in parts], 1),
                    torch.cat([t.logps for t in parts], 1))

        xs_new, lp_new = eager(new)
        xs_old, _ = eager(old)
        same = bool(torch.equal(traj.xs, xs_new)
                    and torch.equal(traj.logps, lp_new))
        moved = float((xs_new - xs_old).abs().max())
        rep = graph_rows(eng, tname)
        log(f"  flow_grpo through the engine: after one AdamW update the "
            f"replayed rollout bitwise an eager rollout at the new params "
            f"{same}; the update moved the eager rollout by {moved:.3e}; "
            f"{rep['replays']} replays, {rep['captures']} captures")
        if not same or moved == 0 or rep["replays"] < 2:
            fail("the engine's replayed rollout is not the eager rollout at "
                 "the updated params")
        out[tname] = {"bitwise_after_update": same, "moved": moved,
                      "graphs": rep}
        del tr, eng, old, new, traj
    gc.collect()
    torch.cuda.empty_cache()
    return out


def graphs_phase(dev, flux_eng=None) -> dict:
    """Phase 45: the engine's captured executables, (a)-(d), each part's
    seconds logged."""
    t0 = time.perf_counter()
    out = {"flux_dit": graphs_flux(flux_eng)}
    del flux_eng
    gc.collect()
    torch.cuda.empty_cache()
    parts = {"flux_dit": time.perf_counter() - t0}
    for tag, run in ((DENSE_ARCH, lambda: graphs_arch(
                         _dense_argv(GRAPH_DENSE_LAYERS), DENSE_ARCH)),
                     (SSM_ARCH, lambda: graphs_arch(
                         _ssm_argv("bfloat16", GRAPH_SSM_LAYERS), SSM_ARCH)),
                     ("trainer", lambda: graphs_trainer(dev))):
        t0 = time.perf_counter()
        out[tag] = run()
        parts[tag] = time.perf_counter() - t0
    log(f"  phase 45's parts: {json.dumps(parts)} s")
    out["part_s"] = parts
    return out


# ----------------------------------------------------------------- phase 46
EXAMPLES_DIR = ROOT / "examples_torch"
# the metrics of a train row that a resumed run must reproduce bitwise (the
# rest are host clocks: dt, steps_per_s)
ROW_TIMING = ("dt", "steps_per_s")
LEARN_TRAINERS = ("flow_grpo", "nft", "awm")
# phase 46's paths by their key in its result
EXAMPLE_PATHS = ("e2e", "multi_reward", "quickstart", "serve_flow")
LEARN_STEPS, LEARN_MARGIN = 45, 0.02     # tests/test_trainers.py:52-63
LEARN_PROMPTS = 8
# pickscore and pref_group share "pickscore-base": 4 reward configs, 3
# frozen towers (the reference's count, pinned against it on the CPU by
# tests/test_torch_examples.py)
MULTI_REWARD_UNIQUE_LOADS = 3
SERVE_STEPS = 6          # examples_torch/serve_flow.py's num_steps


def load_example(name: str):
    """``examples_torch/<name>.py`` as a module (importing runs nothing:
    each example's work is in its ``main``)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", EXAMPLES_DIR / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def tmp_cwd():
    """A fresh temporary directory as the working directory: the examples'
    configs write ``cache/...`` relative to it."""
    old = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            yield tmp
        finally:
            os.chdir(old)


def _since(before: dict) -> dict:
    now = counts()
    return {k: now[k] - before[k] for k in now}


def _finite_rows(hist: list, what: str) -> None:
    for r in hist:
        bad = {k: v for k, v in r.items()
               if isinstance(v, float) and not math.isfinite(v)}
        if bad:
            fail(f"{what} step {r['step']}: non-finite metrics {bad}")


def _metric_rows(rows: list) -> list:
    return [{k: v for k, v in r.items() if k not in ROW_TIMING}
            for r in rows]


def _state_equal(a, b) -> list:
    """The leaves (params, AdamW moments) where two RLStates differ, and
    "step" when their AdamW steps do."""
    bad = []
    for tag, ta, tb in (("params", a.params, b.params),
                        ("mu", a.opt.mu, b.opt.mu),
                        ("nu", a.opt.nu, b.opt.nu)):
        la, lb = list(params_lib.leaves(ta)), list(params_lib.leaves(tb))
        if [p for p, _ in la] != [p for p, _ in lb]:
            bad.append(f"{tag}: leaf paths differ")
            continue
        bad += [f"{tag}/{'/'.join(p)}" for (p, x), (_, y) in zip(la, lb)
                if not torch.equal(x, y)]
    if not torch.equal(a.opt.step, b.opt.step):
        bad.append("step")
    return bad


def _e2e_want(exp, n_steps: int) -> dict:
    """The e2e path's launches over ``n_steps`` train steps, reckoned as
    ``train_path`` reckons them: a rollout of T velocity calls, then T
    recomputed with their backward, one attention per block each."""
    L, T = exp.arch.n_layers, exp.cfg.flow.num_steps
    return {"sde_step": T * n_steps,
            "flash_attention": 2 * L * T * n_steps,
            "flash_attention_bwd": L * T * n_steps,
            "grpo_loss": T * n_steps, "grpo_loss_bwd": T * n_steps,
            "ssd_scan": 0, "ssd_scan_bwd": 0}


# the e2e example's first steps run eagerly, as the example runs by
# default; the 200 steps and the resumed 100 then run under perf.fuse_step
# (each step one replayed CUDA graph of the same kernels), whose first rows
# must equal the eager ones bitwise: an eager step is host-bound at ≈ 34k
# launches, and 300 of them would take ≈ 220 s of the script's 1200
E2E_EAGER_STEPS = 4
E2E_FUSED = "perf.fuse_step=true"


def _e2e_config(mod, out: str, *overrides: str):
    """The e2e example's full configuration over ``out``, with
    ``overrides`` (``--set`` syntax)."""
    return apply_overrides(mod.build_config(mod.parse_args(["--out", out])),
                           list(overrides))


def _lay_out_resume(a_out: str, b_out: str, at: int) -> None:
    """``b_out`` as an interrupted run leaves it at step ``at``: the
    first run's step-``at`` checkpoint, its prompt cache and the reward
    log's first ``at`` rows (not the identity file, which names the first
    run's ``cache_dir``: the resumed run writes its own)."""
    name = f"step_{at:08d}"
    os.makedirs(f"{b_out}/ckpt")
    for ext in (".manifest", ".npz"):
        shutil.copy(f"{a_out}/ckpt/{name}{ext}", f"{b_out}/ckpt/")
    shutil.copytree(f"{a_out}/cache", f"{b_out}/cache")
    with open(f"{a_out}/reward_log.json") as f:
        rows = [r for r in json.load(f) if r["step"] < at]
    with open(f"{b_out}/reward_log.json", "w") as f:
        json.dump(rows, f)


def _median(xs: list) -> float:
    return sorted(xs)[len(xs) // 2]


def example_e2e() -> dict:
    """(a) ``examples_torch/train_grpo_e2e.py`` at its full configuration
    (the ~100M DiT, 200 steps, checkpoints at 100 and 200, the reward
    log) through the example's ``run``: its first ``E2E_EAGER_STEPS``
    steps eagerly, as the example runs by default; the 200 steps under
    ``perf.fuse_step``, their first rows bitwise the eager ones; then a
    second run resumed from a copy of the step-100 checkpoint (and the
    reward log as it stood there) to step 200: its final state (its
    step-200 checkpoint), rows 100-199 and reward log bitwise the first
    run's.  One eager and one replayed step traced."""
    mod = load_example("train_grpo_e2e")
    base = mod.build_config(mod.parse_args([]))
    steps, at = base.loop.steps, base.loop.save_every
    a_out, b_out = "e2e_full", "e2e_resumed"
    t0, parts = time.perf_counter(), {}

    def part(tag):
        nonlocal t0
        t = time.perf_counter()
        parts[tag] = t - t0
        t0 = t

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    r0 = mod.run(_e2e_config(mod, "e2e_eager",
                             f"loop.steps={E2E_EAGER_STEPS}"), "cuda")
    peak_eager = torch.cuda.max_memory_allocated()
    part("eager run")
    torch.cuda.reset_peak_memory_stats()
    ra = mod.run(_e2e_config(mod, a_out, E2E_FUSED), "cuda")
    peak = torch.cuda.max_memory_allocated()
    part("captured run")
    _lay_out_resume(a_out, b_out, at)
    part("resume layout")
    rb = mod.run(_e2e_config(mod, b_out, E2E_FUSED), "cuda")
    part("resumed run")
    launches = counts()
    wgmma = all_variants()["flash_attention"]["wgmma"]
    with open(f"{a_out}/reward_log.json") as f:
        log_a = json.load(f)
    with open(f"{b_out}/reward_log.json") as f:
        log_b = json.load(f)
    with open("e2e_eager/reward_log.json") as f:
        log_0 = json.load(f)
    h0, ha, hb = r0["history"], ra["history"], rb["history"]
    exp = ra["experiment"]
    ran = len(h0) + len(ha) + len(hb)
    want = _e2e_want(exp, ran)
    log(f"  launches over the {len(h0)} + {len(ha)} + {len(hb)} steps "
        f"{launches} (expected {want}); attention on wgmma {wgmma}")
    if launches != want or wgmma != want["flash_attention"]:
        fail("the e2e path's kernel launches do not match the path")
    if (len(h0), len(ha), rb["start_step"], len(hb)) != (
            E2E_EAGER_STEPS, steps, at, steps - at):
        fail(f"the runs took {len(h0)} and {len(ha)} steps, resumed at "
             f"{rb['start_step']} and took {len(hb)}")
    for tag, h in (("eager", h0), ("", ha), ("resumed", hb)):
        _finite_rows(h, f"e2e {tag}".strip())
    diff = _state_equal(ra["state"], rb["state"])
    eager_same = (_metric_rows(h0) == _metric_rows(ha[:E2E_EAGER_STEPS])
                  and _metric_rows(log_0)
                  == _metric_rows(log_a[:E2E_EAGER_STEPS]))
    rows_same = _metric_rows(ha[at:]) == _metric_rows(hb)
    log_same = ([r["step"] for r in log_b] == list(range(steps))
                and _metric_rows(log_a) == _metric_rows(log_b))
    log(f"  eager steps 0-{E2E_EAGER_STEPS - 1} (rows and reward log) "
        f"bitwise the captured run's: {eager_same}; resumed at step "
        f"{rb['start_step']}: final params, AdamW moments and step bitwise "
        f"the uninterrupted run's: {not diff}; rows {at}-{steps - 1} "
        f"bitwise: {rows_same}; reward log ({len(log_b)} rows) bitwise: "
        f"{log_same}")
    if not eager_same:
        fail("the captured e2e run's first steps differ from the eager "
             "run's")
    if diff or not rows_same or not log_same:
        fail(f"the resumed e2e run differs from the uninterrupted one: "
             f"{diff[:8]}, rows {rows_same}, log {log_same}")
    # from the second step of each run
    s_eager = _median([r["dt"] for r in h0[1:]])
    s_fused = _median([r["dt"] for r in ha[1:]])
    s_resumed = _median([r["dt"] for r in hb[1:]])
    rewards = [r["reward"] for r in ha]
    early, late = float(sum(rewards[:5]) / 5), float(sum(rewards[-5:]) / 5)
    per_step = {k: n / ran for k, n in launches.items()}
    cond = exp.build_provider().get(
        exp.build_dataset().prompts[:base.data.batch_prompts])["cond"]
    what = (f"{base.data.batch_prompts} x {base.flow.group_size} samples, "
            f"{exp.arch.n_layers} blocks, {base.flow.num_steps} timesteps")
    # the eager step traced for its idle share alone (the device's
    # activity: its ≈ 34k host ops would take the trace ≈ 25 s to read
    # back); the replayed one, the same kernels, by kernel group too
    profs = {}
    for tag, tr, it in (("eager", r0["experiment"].build_trainer(),
                         E2E_EAGER_STEPS),
                        ("replayed", exp.build_trainer(), steps)):
        its = [it]

        def one_step(tr=tr, its=its):
            m = tr.step(cond, base.seed, it=its[0])
            its[0] += 1
            return float(m["loss"])

        if tag == "eager":
            one_step()
            profs[tag] = _traced(one_step)
        else:
            profs[tag] = profile(one_step,
                                 f"one {tag} e2e train step, {what}")
            profs[tag]["idle_share"] = max(
                0.0, 1 - profs[tag]["device_busy_ms"]
                / profs[tag]["traced_wall_ms"])
        part(f"{tag} trace")
    log(f"  e2e: {exp.arch.n_params()} params, s a step (median from the "
        f"second) {s_eager:.4f} eager ({E2E_EAGER_STEPS} steps), "
        f"{s_fused:.4f} replayed, {s_resumed:.4f} the resumed run; peak "
        f"{peak / 2**30:.2f} GiB ({peak} bytes; eager {peak_eager}); "
        f"launches a step {per_step}; traced idle share "
        f"{profs['eager']['idle_share']:.4f} eager, "
        f"{profs['replayed']['idle_share']:.4f} replayed; reward "
        f"{early:+.4f} -> {late:+.4f} "
        f"({'improved' if late > early else 'no gain'}; recorded, not "
        f"asserted, as the example does)")
    log("  e2e seconds by part: " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    res = {"n_params": exp.arch.n_params(), "s_per_step_eager": s_eager,
           "s_per_step": s_fused, "s_per_step_resumed": s_resumed,
           "peak_bytes": peak, "peak_bytes_eager": peak_eager,
           "launches": launches, "launches_per_step": per_step,
           "idle_share": profs["eager"]["idle_share"],
           "idle_share_replayed": profs["replayed"]["idle_share"],
           "profile": profs, "reward_early": early, "reward_late": late,
           "reward": rewards, "bitwise_resume": True,
           "bitwise_eager": True, "parts_s": parts}
    del r0, ra, rb, exp, cond
    return res


def learning_signal(dev) -> dict:
    """(b) tests/test_trainers.py:38-63's test_reward_improves on the card:
    reduced flux_dit, LEARN_FLOW / LEARN_OPT, 8 prompts, 45 steps, for
    flow_grpo, nft and awm in the trainers' default dtype; mean(last 10)
    above mean(first 5) + 0.02."""
    flow = FlowRLConfig(
        num_steps=4, group_size=8, latent_tokens=8, latent_dim=8,
        clip_range=0.2,
        rewards=(RewardSpec("text_render", 1.0,
                            args={"latent_dim": 8, "latent_tokens": 8}),))
    opt = OptimConfig(lr=1e-3, total_steps=135, warmup_steps=2)
    cond = torch.randn(LEARN_PROMPTS, 4, 512,
                       generator=torch.Generator().manual_seed(3)).to(dev)
    out = {}
    for name in LEARN_TRAINERS:
        before = counts()
        tr = registry.build("trainer", name, configs.get_reduced("flux_dit"),
                            flow, opt, seed=3, device=dev)
        hist = [float(tr.step(cond, 3, it=it)["reward_mean"])
                for it in range(LEARN_STEPS)]
        early, late = sum(hist[:5]) / 5, sum(hist[-10:]) / 10
        out[name] = {"early": early, "late": late, "curve": hist,
                     "launches": _since(before)}
        log(f"  {name}: reward mean(first 5) {early:+.4f} -> mean(last 10) "
            f"{late:+.4f} (margin {LEARN_MARGIN}); curve "
            + " ".join(f"{r:+.3f}" for r in hist))
        if not late > early + LEARN_MARGIN:
            fail(f"{name}: no learning signal on the card ({early:+.4f} -> "
                 f"{late:+.4f})")
        del tr
    return out


def example_multi_reward() -> dict:
    """(c) ``examples_torch/multi_reward.py``: the dedup count and both
    aggregations' 15 steps finite."""
    before = counts()
    res = load_example("multi_reward").main([])
    out = {"launches": _since(before)}
    for agg, r in res.items():
        _finite_rows(r["history"], f"multi_reward {agg}")
        if r["unique_loads"] != MULTI_REWARD_UNIQUE_LOADS:
            fail(f"multi_reward {agg}: {r['unique_loads']} unique loads, "
                 f"the reference loads {MULTI_REWARD_UNIQUE_LOADS}")
        out[agg] = {"unique_loads": r["unique_loads"],
                    "reward": [h["reward"] for h in r["history"]],
                    "per_reward": [{k: v for k, v in h.items()
                                    if k.startswith("reward/")}
                                   for h in r["history"]]}
    return out


def example_quickstart() -> dict:
    """(d) ``examples_torch/quickstart.py``: flow_grpo for 10 steps, then
    the one-override swap to awm, both finite."""
    before = counts()
    res = load_example("quickstart").main([])
    out = {"launches": _since(before)}
    for name, r in res.items():
        _finite_rows(r["history"], f"quickstart {name}")
        out[name] = [h["reward"] for h in r["history"]]
    log(f"  quickstart: awm final reward {out['awm'][-1]:+.4f}")
    return out


def example_serve_flow() -> dict:
    """(e) ``examples_torch/serve_flow.py``: flux_dit and mamba2-370m
    (reduced) under ode and dance_sde through the warmed engine; no cold
    dispatch, the condition cache hit, and each engine's latents bitwise
    an eager ``rollout_keyed`` over each dispatched batch on the same
    injected draws."""
    before = counts()
    ssd_var = all_variants()["ssd_scan"]["fma"]
    res = load_example("serve_flow").main([])
    launches = _since(before)
    ssd_fma = all_variants()["ssd_scan"]["fma"] - ssd_var
    out = {"launches": launches}
    if ssd_fma != launches["ssd_scan"] or not launches["ssd_scan"]:
        fail(f"serve_flow's scans ran {launches['ssd_scan']} times, "
             f"{ssd_fma} on the FMA passes")
    for (arch, sde), r in res.items():
        eng, st, prompts = r["engine"], r["stats"], r["prompts"]
        n = len(prompts)
        hits = (n - len(set(prompts))) + n   # the priming encode + serve
        want = {f"b{eng.grid.capacity}/s{SERVE_STEPS}":
                n // eng.grid.capacity}
        if st["cold_dispatches"] or st["cond_cache"]["hits"] != hits \
                or st["dispatches"] != want:
            fail(f"serve_flow {arch} {sde}: cold_dispatches "
                 f"{st['cold_dispatches']}, cache hits "
                 f"{st['cond_cache']['hits']} (want {hits}), dispatches "
                 f"{st['dispatches']} (want {want})")
        cond = torch.from_numpy(eng.encode(prompts)).to(eng.device)
        seeds = request_seeds(0, n)
        cap = eng.grid.capacity
        eager = []
        with torch.no_grad():
            for i in range(0, n, cap):
                draws = [request_draws(eng.adapter, s, SERVE_STEPS,
                                       eng.device) for s in seeds[i:i + cap]]
                eager.append(rollout_keyed(
                    eng.adapter, eng.params, cond[i:i + cap],
                    seeds[i:i + cap], eng.scheduler, SERVE_STEPS,
                    x_init=torch.stack([d[0] for d in draws]),
                    eps=torch.stack([d[1] for d in draws], dim=1)).x0.cpu())
        same = bool(torch.equal(r["latents"], torch.cat(eager)))
        rep = eng.graph_report()
        log(f"  serve_flow {arch} {sde}: {n / r['serve_s']:.2f} req/s, warmup "
            f"{r['warmup_s']:.3f} s, dispatches {st['dispatches']}, "
            f"cold {st['cold_dispatches']}, cache hits "
            f"{st['cond_cache']['hits']}, {rep['captures']} captures / "
            f"{rep['replays']} replays; latents bitwise eager "
            f"rollout_keyed: {same}")
        if not same or not torch.isfinite(r["latents"]).all():
            fail(f"serve_flow {arch} {sde}: the served latents are not "
                 "bitwise an eager rollout_keyed on the same draws")
        out[f"{arch}/{sde}"] = {
            "req_per_s": n / r["serve_s"], "serve_s": r["serve_s"],
            "warmup_s": r["warmup_s"], "dispatches": st["dispatches"],
            "cold_dispatches": st["cold_dispatches"],
            "cache_hits": st["cond_cache"]["hits"],
            "captures": rep["captures"], "replays": rep["replays"],
            "bitwise_eager": same}
    del res
    return out


def _example_attention_rows(dev, g, name, what, B, S, H, D) -> list:
    """The attention forward and backward at (B, S, H heads of D),
    non-causal, bf16 on wgmma: o, the LSE and dq / dk / dv row by row
    against the plain versions (``ROW_BAND``, ``LSE_BAND``), the backward
    also against torch.autograd through the plain forward; then the
    kernels' ms (replayed graphs), the plain versions', SDPA's and the
    bounds (every (query, key) pair: forward 4 D operations, backward 10
    D; each input read once, each output written once)."""
    dt = torch.bfloat16
    q, k, v, do = (torch.randn(B, S, H, D, generator=g, device=dev).to(dt)
                   for _ in range(4))
    before = all_variants()
    o, lse = flash_attention(q, k, v, causal=False, return_lse=True)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=False)
    ran = all_variants()
    for kern in ("flash_attention", "flash_attention_bwd"):
        if ran[kern]["wgmma"] - before[kern]["wgmma"] != 1:
            fail(f"the attention at the {what} shape did not run {kern} on "
                 f"wgmma: {before} -> {ran}")
    o_ref, lse_ref = ref.flash_attention_fwd_ref(q, k, v, causal=False)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=False)
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    ref.flash_attention_ref(*leaves, causal=False).backward(do.float())
    auto = _grad_errs(got, [t.grad for t in leaves])
    (o_row,) = _row_errs([o], [o_ref])
    g_rows = _row_errs(got, want)
    lse_err = float((lse - lse_ref).abs().max()) / max(
        1.0, float(lse_ref.abs().max()))
    errs = [float((o.float() - o_ref.float()).abs().max()), max(
        float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))]
    log(f"  attention {what} ({B}, {S}, {H} heads of {D}) non-causal bf16 "
        f"(wgmma): per-row max|err| / max|plain| o {o_row:.3e}, dq/dk/dv "
        + "/".join(f"{e:.3e}" for e in g_rows) + f" (band {ROW_BAND[dt]}); "
        f"lse {lse_err:.2e} (band {LSE_BAND}); vs autograd "
        + "/".join(f"{e:.2e}" for e in auto)
        + f" (band {ATTN_BWD_BAND[dt]})")
    if max([o_row] + g_rows) > ROW_BAND[dt] or lse_err > LSE_BAND or \
            max(auto) > ATTN_BWD_BAND[dt]:
        fail(f"the attention at the {what} shape is off its band")
    del leaves, want, o_ref, lse_ref
    ms = graph_ms(lambda: flash_attention(q, k, v, causal=False), 20)
    bwd_ms = graph_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                                  causal=False), 20)
    plain_ms = cuda_ms(lambda: ref.flash_attention_ref(q, k, v,
                                                       causal=False), 20)
    plain_bwd_ms = cuda_ms(lambda: ref.flash_attention_bwd_ref(
        q, k, v, o, lse, do, causal=False), 20)
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (a.transpose(1, 2).detach().requires_grad_()
                  for a in (q, k, v))
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION,
                      SDPBackend.CUDNN_ATTENTION]):
        with torch.no_grad():
            sdpa_ms = cuda_ms(lambda: sdpa(qt, kt, vt), 20)
        out_t = sdpa(qt, kt, vt)
        sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            out_t, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), 20)
    pairs = B * H * S * S
    n = q.numel()
    rows = []
    for kname, kms, pms, lib, nbytes, flops, src, rep_, err, row_err in (
            (f"flash_attention_{name}", ms, plain_ms, sdpa_ms, 4 * n * 2,
             4 * pairs * D, "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:81", errs[0], o_row),
            (f"flash_attention_bwd_{name}", bwd_ms, plain_bwd_ms,
             sdpa_bwd_ms, 7 * n * 2 + lse.numel() * 4, 10 * pairs * D,
             "flash_attention_bwd.cu",
             "none (JAX autodiff of src/repro/models/attention.py:71)",
             errs[1], max(g_rows))):
        bound, by = _bound(nbytes, flops)
        log(f"  {kname} ({B}, {S}, {H} heads of {D}) non-causal bf16: "
            f"kernel {kms:.4f} ms (wgmma), plain {pms:.4f} ms, SDPA "
            f"{lib:.4f} ms, bound {bound:.2e} ms ({by})")
        rows.append({"name": kname, "route": "cuda", "variant": "wgmma",
                     "source": f"src/repro_torch/kernels/csrc/{src}",
                     "replaces": rep_, "max_abs_err": err,
                     "max_rel_err": row_err, "ms": kms, "plain_ms": pms,
                     "bound_ms": bound, "bound_by": by, "library_ms": lib,
                     "shape": [B, S, H, H, D]})
    del q, k, v, do, o, lse, got, qt, kt, vt, out_t
    torch.cuda.empty_cache()
    return rows


def _example_ssd_row(dev, g, B, L, H, P, N, Q) -> dict:
    """The scan at the reduced mamba2-370m's shape (bf16 at head dim 32,
    state 32, chunk 32: the FMA passes) against the plain chunked version
    at phase 10's bands, then its ms, the plain version's and the
    bound."""
    dt_ = torch.bfloat16
    x, dt, a, bm, cm = _ssd_inputs(g, dev, B, L, H, P, N, "mamba2", dt_)
    (y, hT), variant = _ssd_variant(lambda: ssd_scan(x, dt, a, bm, cm,
                                                     chunk=Q))
    if variant != ssd_want(dt_, L, P, N, Q) or variant != "fma":
        fail(f"ssd_scan at the reduced mamba2 shape ran {variant}")
    y_ref, h_ref = ref.ssd_chunked_ref(x, dt, a, bm, cm, Q)
    y_err, h_err = _rel(y, y_ref), _rel(hT, h_ref)
    if y_err > SSD_Y_BAND[dt_] or h_err > SSD_H_BAND:
        fail(f"ssd_scan off at the reduced mamba2 shape: y {y_err:.2e}, "
             f"state {h_err:.2e}")
    ms = graph_ms(lambda: ssd_scan(x, dt, a, bm, cm, chunk=Q), 20)
    plain_ms = cuda_ms(lambda: ref.ssd_chunked_ref(x, dt, a, bm, cm, Q), 20)
    nc, qe = -(-L // Q), min(Q, L)
    nbytes = (2 * B * L * H * P * 2 + B * L * H * 4 + H * 4
              + 2 * B * L * N * 2 + B * H * P * N * 4)
    flops = 2 * B * nc * qe * (qe * N + H * qe * P + 2 * H * P * N)
    bound, by = _bound(nbytes, flops)
    log(f"  ssd_scan reduced mamba2 (B={B}, L={L}, H={H}, P={P}, N={N}, "
        f"Q={Q}) bf16 (FMA passes): y {y_err:.2e}, state {h_err:.2e} of "
        f"max|plain| (bands {SSD_Y_BAND[dt_]}, {SSD_H_BAND}); kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.2e} ms ({by})")
    return {"name": "ssd_scan_reduced_mamba2", "route": "cuda",
            "variant": "fma",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:77",
            "max_abs_err": float((y.float() - y_ref.float()).abs().max()),
            "max_rel_err": y_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "shape": [B, L, H, P, N, Q]}


def _example_small_rows(dev, g, B, Lt, ld) -> list:
    """``sde_step`` at the e2e's latents (B, Lt, ld) f32 and ``grpo_loss``
    forward and backward at its B rows, against their plain versions,
    then their ms (replayed graphs), the plain versions' and the bytes
    bounds."""
    v, x, e = (torch.randn(B, Lt, ld, generator=g, device=dev)
               for _ in range(3))
    sde_err = lp_err = 0.0
    for t, tn in [(0.9999, 0.75), (0.5, 0.4), (0.25, 1e-4)]:
        xn, lp = sde_step(v, x, e, t, tn, eta=0.7)
        xr, lr = ref.sde_step_ref(v, x, t, tn, e, eta=0.7)
        sde_err = max(sde_err, float((xn - xr).abs().max()))
        # a row's logp sums Lt * ld terms of either sign: its error is
        # held against the largest row's |logp| (at least 1), as
        # grpo_loss's against its largest loss
        lp_err = max(lp_err, float((lp - lr).abs().max()) / max(
            1.0, float(lr.abs().max())))
        if not torch.allclose(xn, xr, atol=1e-5, rtol=1e-5) or \
                lp_err > 1e-5:
            fail(f"sde_step off at the e2e shape, t={t}: x_next "
                 f"{sde_err:.2e}, logp {lp_err:.2e} of max |logp| "
                 f"{float(lr.abs().max()):.3e}")
    lpn, lpo = (torch.randn(B, generator=g, device=dev) * 0.05
                for _ in range(2))
    adv, gl = (torch.randn(B, generator=g, device=dev) for _ in range(2))
    loss, frac = grpo_loss(lpn, lpo, adv, clip=0.2)
    l_ref, f_ref = ref.grpo_loss_ref(lpn, lpo, adv, clip=0.2)
    f_err = float((loss - l_ref).abs().max()) / max(
        1.0, float(l_ref.abs().max()))
    got = grpo_loss_bwd(lpn, lpo, adv, gl, clip=0.2)
    want = ref.grpo_loss_bwd_ref(lpn, lpo, adv, gl, clip=0.2)
    b_err = max(float((a_ - b_).abs().max()) / max(1.0, float(
        b_.abs().max())) for a_, b_ in zip(got, want))
    if f_err > GRPO_BAND or b_err > GRPO_BAND or not torch.equal(frac,
                                                                 f_ref):
        fail(f"grpo_loss off at B={B}: {f_err:.2e}, {b_err:.2e}")
    n = v.numel()
    rows = []
    for name, kern, plain, nbytes, src, rep_, err in (
            ("sde_step_e2e", lambda: sde_step(v, x, e, 0.5, 0.375, eta=0.7),
             lambda: ref.sde_step_ref(v, x, 0.5, 0.375, e, eta=0.7),
             4 * n * 4 + B * 4, "sde_step.cu",
             "src/repro/kernels/sde_step.py:50", sde_err),
            ("grpo_loss_e2e", lambda: grpo_loss(lpn, lpo, adv, clip=0.2),
             lambda: ref.grpo_loss_ref(lpn, lpo, adv, clip=0.2),
             5 * B * 4, "grpo_loss.cu",
             "src/repro/kernels/grpo_loss.py:36", f_err),
            ("grpo_loss_bwd_e2e",
             lambda: grpo_loss_bwd(lpn, lpo, adv, gl, clip=0.2),
             lambda: ref.grpo_loss_bwd_ref(lpn, lpo, adv, gl, clip=0.2),
             7 * B * 4, "grpo_loss.cu",
             "src/repro/kernels/grpo_loss.py:80", b_err)):
        ms = graph_ms(kern, 40)
        plain_ms = cuda_ms(plain, 100)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"  {name} ({'x'.join(map(str, v.shape)) if 'sde' in name else B})"
            f": kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bound:.2e} ms ({nbytes} bytes), max rel err {err:.2e}")
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{src}",
                     "replaces": rep_, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": "bytes", "library_ms": None,
                     "shape": list(v.shape) if "sde" in name else [B]})
    return rows


def example_kernel_rows(dev) -> list:
    """(f) Each kernel at the examples' new shapes against its plain
    version, with its time, bound and SDPA's time: the attention at the
    e2e shape (16 rows of 16 + 64 tokens, 12 heads of 64) and at the
    learning signal's reduced one (64 rows of 4 + 8 tokens, 8 heads of
    32), the scan at serve_flow's reduced mamba2-370m (4 rows of 8 + 1 +
    8 tokens, 16 heads of 32, state 32, chunk 32), ``sde_step`` and
    ``grpo_loss`` at the e2e's sizes."""
    g = torch.Generator(device=dev).manual_seed(46)
    e2e = load_example("train_grpo_e2e")
    cfg = e2e.build_config(e2e.parse_args([]))
    ov, fl = cfg.arch_overrides, cfg.flow
    B = cfg.data.batch_prompts * fl.group_size
    cond_len = 16                 # the default frozen encoder's
    rows = _example_attention_rows(
        dev, g, "e2e", "e2e", B, cond_len + fl.latent_tokens,
        ov["n_heads"], ov["head_dim"])
    red = configs.get_reduced("flux_dit")
    rows += _example_attention_rows(
        dev, g, "reduced", "learning-signal", LEARN_PROMPTS * 8, 4 + 8,
        red.n_heads, red.head_dim)
    ssm = configs.get_reduced("mamba2-370m").ssm
    sf = load_example("serve_flow")
    heads = ssm.expand * configs.get_reduced("mamba2-370m").d_model \
        // ssm.head_dim
    rows.append(_example_ssd_row(
        dev, g, 4, sf.ENCODER["cond_len"] + 1 + 8, heads, ssm.head_dim,
        ssm.d_state, ssm.chunk))
    rows += _example_small_rows(dev, g, B, fl.latent_tokens, fl.latent_dim)
    return rows


def examples_phase(dev) -> dict:
    """Phase 46: (f) the kernels at the examples' shapes, then (a)-(e) in
    turn, each in a fresh working directory, with its seconds."""
    res = {"kernel_rows": example_kernel_rows(dev)}
    for key, fn in (("e2e", example_e2e),
                    ("learning", lambda: learning_signal(dev)),
                    ("multi_reward", example_multi_reward),
                    ("quickstart", example_quickstart),
                    ("serve_flow", example_serve_flow)):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with tmp_cwd():
            res[key] = fn()
        res[key]["s"] = time.perf_counter() - t0
        log(f"  ({key}: {res[key]['s']:.1f} s)")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="", metavar="N,N,...",
                    help="run only these of phases 3-46 after the device and "
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
    # one cuobjdump a library, all started together
    tc_libs = ("flash_attention", "flash_attention_bwd", "ssd_scan",
               "ssd_scan_bwd_wgmma")
    with concurrent.futures.ThreadPoolExecutor(len(tc_libs)) as pool:
        all_sass = list(pool.map(sass_counts, tc_libs))
    for name, sass in zip(tc_libs, all_sass):
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

    begin(5, f"main path: repro_torch.launch.serve, flux_dit at full "
          f"width, {N_LAYERS} blocks")
    res = main_path()
    eng, lat_zero = res.pop("engine"), res.pop("latents")

    begin(6, "profile of one denoising step of the engine")
    res["profile"] = profile_step(eng, SEQ)

    begin(7, "drawn modulation: served through the kernels vs plain replay")
    res["modulated"] = check_modulated(eng, lat_zero)
    del lat_zero

    begin(45, "the engine's captured executables (phase 5's engine first)")
    graphs_res = graphs_phase(dev, eng)
    del eng
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
            f", {DENSE_TRAIN_LAYERS} layers, the five trainers")
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

        begin(20, f"{SSM_ARCH}, {BLOCK_LAYERS} layers, under "
            f"perf.remat=block; scan + remat_offload against phase 19's "
            f"none; one update at depth {UPDATE_LAYERS} under block against "
            f"none")
        perf_res = {"ssm_block": ssm_block_path(tmp,
                                                ssm_train["flow_grpo"]),
                    "block_update": check_block_update(dev, SSM_ARCH)}
        gc.collect()
        torch.cuda.empty_cache()

        begin(21, f"the fused, pipelined step: {SSM_ARCH}, "
            f"{FUSED_LAYERS} layers, {FUSED_STEPS} steps; at depth "
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
            f"{SSM_ARCH} at {MESH_SSM_LAYERS} layers and flux_dit at "
            f"{MESH_FLUX_BLOCKS} blocks with microbatch 2; checkpoint; "
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
            f"{a} served at {n} layers and trained at "
            f"{FE_TRAIN_LAYERS[a]}" for a, n in
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

    begin(37, "the linter: python -m repro_torch.analysis over "
          "src/repro_torch and examples_torch with torch, numpy, jax and repro blocked")
    lint_res = lint_path()

    begin(38, f"the production layout (tensor parallel over model, ZeRO-3 "
          f"over data) on a one-rank NCCL group: {LM_ARCH} at full width "
          f"and depth, {LAYOUT_STEPS} LM steps, prefill and decodes against "
          f"no mesh; the dry run against the card; two 16 x 16 pairs")
    with tempfile.TemporaryDirectory() as tmp:
        layout_res = layout_phase(dev, tmp)
    gc.collect()
    torch.cuda.empty_cache()

    begin(39, f"the MoE family tensor-parallel at mp {LAYER_MP}: one "
          f"{DS_ARCH} and one {GROK_ARCH} MoE layer at full width, their "
          f"{LAYER_MP} rank shards in turn against the whole layer")
    with tempfile.TemporaryDirectory() as tmp:
        layer_res = moe_layer_phase(dev, tmp)

    begin(40, f"the Mamba-2 blocks tensor-parallel at mp {LAYER_MP}: one "
          f"{HY_ARCH} and one {SSM_ARCH} block at full width, their "
          f"{LAYER_MP} rank shards in turn against the whole block")
    with tempfile.TemporaryDirectory() as tmp:
        ssm_layer_res = ssm_layer_phase(dev, tmp)

    begin(41, f"the sequence-sharded decode at mp {LAYER_MP}: one "
          f"flux_dit, one qwen3-32b and one {DS_ARCH} attention layer at "
          f"full width over a {SEQ_CACHE}-entry cache, the {LAYER_MP} "
          f"ranks' segments at once against one device")
    seq_res = seq_decode_phase(dev)

    begin(42, f"expert parallelism (ep_model) at mp {LAYER_MP}: one "
          f"{DS_ARCH} MoE layer at full width, its {LAYER_MP} ranks at once "
          f"against the whole layer, then under REPRO_BF16_REDUCE; one "
          f"rank's routed experts timed in tensor mode and ep_model")
    ep_res = ep_layer_phase(dev)

    begin(43, f"the activation-gathered route (REPRO_NO_WEIGHT_GATHER, and "
          f"decode) at dp {NWG_DP}: one {DENSE_ARCH} layer and one "
          f"{SSM_ARCH} block at full width, {NWG_DP} rows x {NWG_SEQ}, the "
          f"ranks' forwards at once and their backwards in rounds, then one "
          f"{DS_ARCH} decode layer at {NWG_ROWS} rows, against one device")
    nwg_res = route_phase(dev)

    begin(44, f"long_500k: the attention and the scan at "
          f"{LONG_PREFILL.seq_len} tokens against their plain versions; "
          + ", ".join(f"{a} at {n} layers" for _, a, n in LONG_ARCHS)
          + f" prefilled over {LONG_PREFILL.seq_len} tokens and decoded at "
          f"positions {LONG_PREFILL.seq_len}-{LONG_SHAPE.seq_len - 1}; the "
          f"exact check at W + 1 in f32")
    long_res = long_phase(dev)

    begin(46, "the examples (examples_torch/): the kernels at their shapes; "
          "train_grpo_e2e at its full configuration for 200 steps and "
          "resumed from step 100; the learning signal of flow_grpo, nft and "
          "awm; multi_reward; quickstart; serve_flow")
    ex_res = examples_phase(dev)

    def layer_launches(arch: str, name: str) -> int:
        return layer_res[arch]["launches"]["attn"].get(name, 0)

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
                "train_flux8_block_mb2_mesh": dist_res["train"]["flux_dit"][
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
                "lm_train_internvl2_production": layout_res["launches"][name],
                **{f"sweep_{t}": r["launches"][name]
                   for t, r in sweep_res["combos"].items()},
                "layer_deepseek_mp16": layer_launches(DS_ARCH, name),
                "layer_grok_mp16": layer_launches(GROK_ARCH, name),
                **{f"layer_{tag}_mp16": ssm_layer_res[tag]["launches"][name]
                   for tag, _ in SSM_LAYER_ARCHS},
                **{f"layer_deepseek_ep16{tag[8:]}": ep_res[tag]["attn"][
                    "launches"][name] for tag, _ in EP_PASSES},
                **{f"nwg16_{tag}": nwg_res[tag]["launches"][name]
                   for tag, _ in NWG_LAYERS},
                **{f"long_{tag}": long_res[tag]["launches"][name]
                   for tag, _, _ in LONG_ARCHS},
                **{f"long_exact_{tag}": long_res[f"exact_{tag}"]["launches"][
                    name] + long_res[f"exact_{tag}"]["forward_launches"][name]
                   for tag, _, _ in LONG_ARCHS},
                **{f"example_{k}": ex_res[k]["launches"][name]
                   for k in EXAMPLE_PATHS},
                **{f"example_learning_{t}": ex_res["learning"][t][
                    "launches"][name] for t in LEARN_TRAINERS}}

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
    # the rank's (192, 128) shape (8 of 128 heads): launches on phase 39's
    # deepseek layer, the (192, 128) pair's there
    for row in layer_res["rank_rows"]:
        base = row["name"].rsplit("_mla_rank", 1)[0]
        row["launches_by_path"] = {
            "layer_deepseek_mp16": layer_res[DS_ARCH]["pairs"]["attn"][base][
                f"{MLA_QK}x{MLA_V}"],
            **{f"layer_deepseek_ep16{tag[8:]}": ep_res[tag]["attn"]["pairs"][
                base][f"{MLA_QK}x{MLA_V}"] for tag, _ in EP_PASSES}}
        row["launches"] = row["launches_by_path"]["layer_deepseek_mp16"]
    rows += layer_res["rank_rows"]
    # the scan at a rank's heads (phase 40): launches on that rank's block
    for row in ssm_layer_res["rank_rows"]:
        kernel, tag, _ = row["name"].rsplit("_", 2)
        path = f"layer_{tag}_mp16"
        row["launches_by_path"] = {
            path: ssm_layer_res[tag]["launches"][kernel]}
        row["launches"] = row["launches_by_path"][path]
    rows += ssm_layer_res["rank_rows"]
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
    # long_500k's shapes: launches on the phase-44 path that runs each
    # (the prefill's window on its prefill, W + 1 on the exact check's)
    for row in long_res["kernel_rows"]:
        kernel = row["name"].split("_long_")[0]
        path = row.pop("path")
        row["launches_by_path"] = {k: v for k, v in by_path(kernel).items()
                                   if k.startswith("long_")}
        row["launches"] = row["launches_by_path"][path]
    rows += long_res.pop("kernel_rows")
    # the examples' shapes: launches on the phase-46 path that runs each
    # (the learning signal's, summed over its three trainers)
    for row in ex_res["kernel_rows"]:
        kernel, tag = row["name"].rsplit("_", 1)
        if tag == "mamba2":
            kernel, path = "ssd_scan", "example_serve_flow"
        else:
            path = "example_learning" if tag == "reduced" else "example_e2e"
        paths = by_path(kernel)
        paths["example_learning"] = sum(paths[f"example_learning_{t}"]
                                        for t in LEARN_TRAINERS)
        row["launches_by_path"] = {k: v for k, v in paths.items()
                                   if k.startswith("example_")}
        row["launches"] = row["launches_by_path"][path]
    rows += ex_res.pop("kernel_rows")
    keys = ("name", "route", "variant", "source", "replaces", "launches",
            "max_abs_err", "max_rel_err", "max_rel_err_wgmma", "ms", "fma_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms",
            "launches_by_path", "times_by_batch", "dense_shape",
            "launch_floor_ms", "max_abs_err_f32", "forward_with_lse_ms",
            "library_note", "shape", "lse_err", "state_err_by_chunks")
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
    print(json.dumps({"lint": lint_res}))
    print(json.dumps({"layout_path": layout_res}))
    print(json.dumps({"moe_layer_path": {k: v for k, v in layer_res.items()
                                         if k != "rank_rows"}}))
    print(json.dumps({"ssm_layer_path": {
        k: v for k, v in ssm_layer_res.items() if k != "rank_rows"}}))
    print(json.dumps({"seq_decode_path": seq_res}))
    print(json.dumps({"ep_layer_path": ep_res}))
    print(json.dumps({"route_path": nwg_res}))
    print(json.dumps({"long_path": long_res}))
    print(json.dumps({"graphs_path": graphs_res}))
    print(json.dumps({"examples_path": ex_res}))
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
              35: lambda: lm_phase(dev), 36: _in_tmp(sweep_path),
              37: lint_path,
              38: _in_tmp(lambda tmp: layout_phase(dev, tmp)),
              39: _in_tmp(lambda tmp: moe_layer_phase(dev, tmp)),
              40: _in_tmp(lambda tmp: ssm_layer_phase(dev, tmp)),
              41: lambda: seq_decode_phase(dev),
              42: lambda: ep_layer_phase(dev),
              43: lambda: route_phase(dev), 44: lambda: long_phase(dev),
              45: lambda: graphs_phase(dev),
              46: lambda: examples_phase(dev)}
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
