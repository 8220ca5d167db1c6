#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

    python3 chip_smoke.py

Needs one CUDA device and nvcc; without a card it exits non-zero and
prints no result.  Phases, each of which raises on failure:

  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
     nvcc per source, all at once), printing ``-Xptxas -v`` and, for every
     head-dim-256 kernel, its registers and spills; count the HGMMA
     (``wgmma``) instructions of the flash libraries with ``cuobjdump
     --dump-sass`` and fail if a bf16 flash kernel has none (the forward
     and the backward at every head dim, 16-256: at 256 the backward is
     ``flash_bwd_sm90_wide``); count the HMMA (``mma.sync``)
     instructions of the SSD library's bf16 kernels (``ssd_scan_tc``,
     chunks of 32 and 64 rows) and fail if one has none;
  3. hold each kernel against its plain PyTorch version on the card:
     decode attention at the serving shapes (B 8, T 256, 32 query heads
     on 8 KV heads of dim 128) in bf16 and fp32, lengths 0, 1, T and
     ragged, plus windowed, soft-capped and T % 32 != 0 cases, and
     RecurrentGemma-2B's heads (10 on 1 KV head of 256, window 2048) by
     index and by stored positions, wrapped rings of 64 entries with
     stored positions, RecurrentGemma's full 2048-entry ring wrapped
     (lengths 2049-4000), Qwen3's heads over T 4096, and phase 22's
     serve shapes (``NEW_DECODE``, T 256): CodeQwen1.5-7B's 32 on 32,
     Gemma-7B's 16 on 16 of 256, Gemma2-27B's 32 on 16 with cap 50,
     window 4096, scale 144^-0.5 and stored positions, Qwen2-VL-72B's 64
     on 8, Whisper's decoder self-attention 20 on 20 of 64, and phase
     23's cross-attention (B 8, T 1500, 20 on 20 of 64; every frame, and
     ragged fills) (tolerances 2e-5 fp32, 2e-2 bf16; empty rows exactly
     0);
  4. time the decode kernel and one PyTorch call that computes the same
     function (``scaled_dot_product_attention`` with an explicit mask,
     timed here only; the kernels it ran, from a profile, are logged) as
     CUDA-graph replays (``ms``, ``library_ms``) and launched eagerly
     from Python (``eager_ms``, ``library_eager_ms``), K/V rotated through
     more buffers than the 50 MB L2 holds (as the layers' caches are on
     the main path), beside its least time from bytes and its plain
     version: Qwen3's heads at T 256 and T 4096, RecurrentGemma's at T
     256 and on its wrapped 2048-entry ring (stored positions), and the
     four shapes of phase 22's serves and Whisper's self-attention at T
     256 (SDPA has no soft-cap: at Gemma2's shape it computes, and times,
     the uncapped function);
  5. the main path: full-width, full-depth Qwen3-8B with random weights
     from a seed serves ``serve_mixed_slo`` (3 tenants, 12 requests,
     8 slots, max_len 256, prefill chunk 32) through ``ServeRuntime`` +
     ``ModelExecutor``; every request must end done and the decode kernel
     must have run 36 times per decode step;
  6. correctness of the served model: on a small fp32 model the kernel
     path gives the plain path's logits (1e-4) and greedy tokens; at full
     width one decode step's logits are finite, of shape (8, 151936), and
     agree with the plain path's;
  7. a profile of one full-width decode step: device time by kernel, and
     the decode kernel's time per launch and share of the step;
  8. the WLBVT dispatch kernel against its plain version, bit for bit
     on picks, ql' and co': float32 and float64, R 1/7/256/4096, T
     2/8/128, max_picks 1/4/16/128, random and integer priorities, ties
     (every metric 0), free_k 0, empty rows; T 129 and max_picks 129
     raise.  Its round (``csrc/wlbvt_round.cuh``) is the one the sweep
     scan kernel runs in every step;
  9. its time (CUDA events around CUDA-graph replays, and launched
     eagerly from Python) beside its plain version and its least time
     from bytes, at the sweep shape (R 256, T 8, max_picks 1, float64
     and float32) and at R 4096, T 128, max_picks 32 (float32); no
     single PyTorch call computes it, so it has no library time;
 10. the sweep datapath at full size in exact mode through
     ``launch.sweep.run_sweep``: the JAX package's headline mix (8
     tenants, 24 us, 256 seeds) and ``fig9_congestor_victim`` at its
     published defaults (300 us) under wlbvt and rr, 8 seeds each.  The
     scan kernel must have run once per scheduler group (1 for the mix,
     2 for fig9) and ``wlbvt_select`` never; every replica's arrivals
     must equal completed + killed + drops (a drained run leaves nothing
     queued); the card's rows must equal the port's CPU rows on the
     first 8 mix replicas and fig9 seed 0 under wlbvt; then the mix's
     stages on the host clock, its scan's device time (CUDA events) and
     the card's idle share over the scan;
 11. the flash-attention kernels against their plain versions on the card:
     the forward (output and log-sum-exp) and the backward (dq, dk, dv,
     against the plain backward and against autograd of the plain
     forward) on the cases of tests/test_kernels.py, causal off, the bf16
     kernels' edges (S * G and T off their 128-row tiles, G = 3 and 8,
     head dims 16 to 128, a window shorter than a tile, a cap with a
     window, non-causal T != S), head dim 256 with RecurrentGemma-2B's
     10 heads on 1 (ragged, a window, a cap with a window, and its
     cache-free shape S 4096, window 2048), MHA at head dim 256 (4 on 4,
     S 100 off the bf16 backward's 64-row tiles, and Gemma-7B's training
     shape: B 4, S 1024, 16 on 16), Whisper's encoder (non-causal,
     S = T 1500, 20 on 20 of 64), q/k/v as slices of one fused
     buffer, and Qwen3-8B's heads (32 on 8 KV heads of dim 128) at S
     1024, in bf16
     (the wgmma kernels) and fp32 (the scalar kernels) (forward 2e-5
     fp32 / 2e-2 bf16 absolute, lse 1e-4; gradients max |diff| <= 1e-4
     fp32 / 2e-2 bf16 times max |reference|); a head dim of 48 and a
     misaligned address raise;
 12. their times at the training shape (B 4, S = T 1024, 32 / 8 heads of
     dim 128, causal, bf16) and at RecurrentGemma-2B's cache-free
     attention (B 1, S = T 4096, 10 / 1 heads of 256, window 2048):
     forward, backward and forward + backward of the kernels, the plain
     versions and ``scaled_dot_product_attention`` (timed here only),
     each beside its least time, with the achieved TFLOP/s and the share
     of the bound, and the kernel's backward and SDPA's in three
     alternating pairs (SDPA's backward moves from call to call);
 13. the training path: Qwen3-8B's published widths with the depth cut
     to 8 of 36 layers, random weights from seed 0, f32 parameters and
     bf16 compute, AdamW, full remat, ``SyntheticLM`` batches of 4 x 1024,
     5 steps through ``launch.train.run_training``; every attention call
     goes through the two kernels (2 x 8 forward and 8 backward launches
     a step under full remat); the first loss is finite and near
     ln(151936); then the same first 2 steps on the plain ``chunked``
     attention give the same losses (1e-2 relative);
 14. (run after phase 7) the SSD scan kernels against their plain
     version: tests/test_kernels.py's three shapes (groups, ragged
     chunks; N 16 and 32), S 1 with P 32, a ragged last chunk of 8 rows,
     48-row chunks with 2 groups and N 20 / P 24 (unaligned rows), each
     with and without an initial state, B/C in fp32 and, with bf16 x,
     also in bf16 (the tensor-core kernel); Mamba2-370M's serve shape (B
     8, S 32, 32 heads of 64, state 128, chunk 256: Q 32) with and
     without a state and a cache-free run at its widths (B 4, S 1024:
     four chunks of 256 rows), B/C in x's dtype; in bf16 and fp32 (5e-2
     / 1e-3); where x, B and C are bf16 (the tensor-core kernel), also
     against ``ref.ssd_scan_bf16_ref``, its own rounding (y within one
     bf16 ulp, the state within 1e-4 of its largest entry).  The RG-LRU scan kernel on tests/test_kernels.py's three
     shapes, the serve shape (B 8, S 32, W 2560), S 1, W 33 over 1000
     steps and phase 18's shape (B 1, S 4096, W 2560), each with and
     without h0, the serve and W 33 shapes also with a and b read as
     halves of one (B, S, 2W) buffer (1e-5);
 15. their device times (CUDA-graph replays, inputs rotated past the
     L2) and eager times, beside their plain versions and their least
     time from bytes or operations, at the serve shapes, the SSD's
     cache-free shape and the RG-LRU's phase-18 shape, the RG-LRU's also
     beside one elementwise pass (a + b) over the same inputs; no single
     PyTorch call computes either, so neither has a library time.  Then the bf16
     SSD kernel's clock64 cycles by phase at the serve shape (a build
     with ``-DSSD_PHASE_TRACE``, ``ssd_phases``);
 16. small fp32 Mamba2 and RecurrentGemma models on the card: the kernel
     path gives the ``chunked`` path's logits (1e-4) over a ragged
     two-chunk prefill and 16 decode steps that wrap the local ring;
 17. the recurrent families' main path: Mamba2-370M and RecurrentGemma-2B
     at full width and depth, random weights from a seed, serve
     ``serve_mixed_slo`` as in phase 5; every request must end done and
     the launches must be exactly ssd_scan = 48 x prefill chunks,
     rglru_scan = 18 x prefill chunks and decode_attention = 8 x decode
     steps (RecurrentGemma's local layers); the kernel path's prefill and
     decode logits against the ``chunked`` path's at full width; a
     profile of a prefill step (with the SSD or RG-LRU kernel's share of
     its device time) and of a decode step; peak memory;
 18. (run after phase 17) RecurrentGemma-2B's cache-free forward at full
     width and depth, ``module(tokens, positions)`` under ``pallas`` on
     1 x 4096 tokens, so the 2048 window binds: exactly 8 flash_attention
     (head dim 256) and 18 rglru_scan launches, finite bf16 logits, and
     fp32 logits within 2e-3 of their range of the ``chunked`` path's.
 19. (run after phase 10) the sweep scan kernel against the plain step
     (``ref.sweep_scan_ref``, CUDA-graph replays) on the card, element
     for element on every [S, R] record and every final state field:
     the mix's first 32 replicas at its full S, fig9 at 300 us under
     wlbvt and rr (8 seeds), 128 tenants (8 seeds, 6 us), each in
     float64 and float32; T 129 and P 129 raise.  Then its times: one
     launch for the mix (R 256) beside its least time from bytes and
     the whole graph-replayed run of the plain step and of the step the
     sweep ran before (its round the ``wlbvt_select`` kernel); the mix
     at R 1 (ns a step of one replica's serial chain); fig9 under wlbvt
     and rr.
 20. (run after phase 19) the scenario CLI and the host simulators:
     (a) ``launch.scenario --all`` runs every registered scenario on every
     backend it supports at its published size, and every report
     validates; (b) ``run_one("serve_mixed_slo", "serve", {},
     arch="mamba2-370m")`` serves full-width, full-depth Mamba2-370M on
     the card: every request done, ssd_scan = 48 x prefill chunks, and
     the per-tenant summary equal to phase 17's where the engine shape is
     the same; (c) the card's sweep (one ``sweep_scan`` launch a leg)
     against the port's host ``BatchedSimulator``: fig9 at 300 us under
     wlbvt and rr, a fifo_capacity=8 leg (drops) and a budget-kill leg
     (kills), and four mix replicas: time, completion stream, EQ events,
     per-tenant stats and p99, final scheduler state equal, Jain within
     1e-9; fig9 wlbvt's per-tenant counts on the event-loop ``Simulator``
     equal the batched run's; (d) wall times of the event loop, the
     batched host path and the card's sweep (1 and 8 seeds) for fig9
     under wlbvt and rr, with scenarios/s and packets/s, beside the
     card's name and power limit.
 21. (run after phase 20) the observability planes: (a) full-width,
     full-depth Qwen3-8B serves phase 5's ``serve_mixed_slo`` again
     (weights rebuilt from the same seed) with ``trace=True``, the
     ``"torch"`` telemetry backend on the card, and a metrics bus with
     the JSONL and OpenMetrics exporters and a headless dashboard: every
     request done, decode_attention 36 launches a decode step, the
     RunReport equal to phase 5's but for ``extras["trace_summary"]``
     (and the telemetry block's backend label), the OpenMetrics schema
     equal to ``tests/data/openmetrics_schema.serve.golden``, the
     device state's counts and histogram equal to phase 5's numpy
     backend and its ring within 1e-6, every ``commit`` /
     ``commit_window`` run under ``torch.cuda.set_sync_debug_mode(
     "error")``, and the commits' device time (CUDA events behind a
     spin kernel) under 3 % of phase 7's decode-step device time; then
     the planes off on the same weights; (b) the trace CLI's path on
     ``fig9_congestor_victim`` at 300 us on both datapaths (identical
     decision and span rows), ``launch.scenario qos_closed_loop
     --export`` against the sim golden and ``launch.telemetry_report
     --surface sim --controller``; (c) the commits' device and
     host time and share, the trace's
     host time a step, spans and decisions retained, bus frames
     published and dropped, the Perfetto file's events and bytes and
     (b)'s walls, beside the card's name and power limit.

 22. (run after phase 21) the dense, vision-language and MoE/MLA
     families at their published widths, random weights from a seed,
     each serving phase 5's ``serve_mixed_slo``: CodeQwen1.5-7B (32
     layers), Gemma-7B (28), Gemma2-27B (12 of 46: 6 local / global
     pairs), Qwen2-VL-72B (6 of 80; text, so its three M-RoPE streams
     are one) and DeepSeek-V2-Lite (27; MLA, 64 routed experts top-6 + 2
     shared under ``gshard``); f32 parameters of one card, each model
     freed before the next.  First its fp32 smoke config (kernel path
     against ``chunked``, 1e-4, greedy tokens equal); then every request
     done, the decode kernel exactly once a layer a decode step (0 for
     DeepSeek: MLA's absorbed decode, K dim 576 and V dim 512, takes the
     plain path), one decode step's logits against the ``chunked``
     path's (5 % of the range) or, for DeepSeek, the absorbed prefill's
     fp32 logits against the expanded cache-free forward's (5e-3); peak
     memory and a profiled decode step.  Llama-4
     Maverick (1.6 TB of f32 parameters) fits no card and is not served.
 23. (run after phase 22) the encoder-decoder, whisper-large-v3: (a) its
     fp32 smoke config with random frames, kernel path against
     ``chunked`` (1e-4, greedy tokens equal) over prefills of 16 tokens
     (as many as the frames: the cross-attention takes the flash kernel)
     and 24; (b) its published widths at full depth (32 encoder + 32
     decoder layers, 1.95 B f32 parameters), random weights from a seed,
     serving phase 5's ``serve_mixed_slo`` over the zero cross K/V the
     engine serves with (it passes no frames, as the JAX package's):
     every request done, decode_attention exactly 2 x 32 a decode step
     (self, then cross with fill 1500), no flash launch; peak memory, a
     profiled decode step with the cross launches' share;
     (c) ``Model.prefill(frames=...)`` on 8 x 1500 random frames, then 4
     decode steps: exactly 32 flash launches (the encoder, non-causal) in
     the prefill and 64 decode launches a step, the decode logits within
     5 % of the range of the ``chunked`` path's, the prefill's wall and
     device time; (d) training at its widths with 2 encoder + 2 decoder
     layers, AdamW, 2 x 448 tokens and 2 x 1500 frames: 2 steps under
     the kernels against ``chunked`` (losses and grad norms 1e-2), the
     flash forward and backward launches exact (the cross-attention, 448
     queries over 1500 frames, takes the plain path); (e) the cross
     decode (B 8, T 1500) and the encoder's flash forward and backward
     (B 8, S = T 1500, non-causal) timed beside their bounds and SDPA.

 24. (run after phase 23) the fleet plane, its single-NIC twins and the
     examples: (a) ``fleet_fabric`` (4 NICs, 120 us), ``fleet_incast``
     (16 NICs, 80 us) and ``fleet_migrate`` (2 NICs, 240 us) through
     ``launch.scenario.run_one`` on the event and batched datapaths, host
     code: every report valid, the switch's conservation law, the
     drift-free projections equal across the datapaths, the incast's
     output 0 saturated with the quiet pair flat, the migration (victim
     2 from NIC 0 to 1, MIGRATE_START / MIGRATE_DONE, its p99 under half
     the ``migrate=False`` arm's and under target, fleet Jain held), an N
     = 1 ideal-fabric ``qos_closed_loop`` equal to its single NIC, the
     fleet OpenMetrics golden; host walls and packets/s; (b) the twins
     (``FleetSpec.plain()``) of ``fleet_fabric`` (T 8) and
     ``fleet_incast`` (T 16) through ``run_sweep`` on the card, 8 seeds,
     one ``sweep_scan`` launch each and no ``wlbvt_select``, every
     replica held against the port's host ``BatchedSimulator`` as in
     phase 20 (c); ``fleet_migrate``'s twin refused (QoS controller); (c)
     the examples: ``qos_controller_demo`` as a user runs it;
     ``quickstart`` on the card (3 finite losses, 2 requests of 8 tokens,
     decode and flash launches exact); ``multi_tenant_serving`` on the
     card (every request done, decode launches = layers x decode steps,
     the RunReport equal under ``chunked``); ``train_100m`` for 100 steps
     (6 layers, d_model 512, gradient accumulation 2, 8 x 256 tokens, full
     remat): flash launches exact, tokens/s, step wall, a profiled step's
     device time and idle share, the save's stall and peak memory; then,
     with ``fairness_demo --exp all`` started in its own process (after
     the timed legs), the checks: the first loss near ln V, the step-100
     checkpoint loaded into a fresh state equal bit for bit; the decode
     kernel (quickstart's 4 x 128 cache, ``serve_three_class``'s 6 x 256;
     4 on 4 heads of 16) and the flash pair (quickstart's 4 x 64,
     train_100m's micro-batch 4 x 256 with 8 on 4 heads of 64; causal)
     against their plain versions in bf16 and fp32; both serves again
     with a ``chunked`` twin on the same weights fed the same inputs
     (every decode step's logits within 0.1 of the largest); both
     training legs' first micro-batch from their initial weights, logits
     and every parameter's gradient against ``chunked`` (0.1).
 25. (run after phase 13, last) sharded training on NCCL: (a) a (data,
     model) = (1, 1) mesh from ``launch/mesh.py`` (NCCL, world 1),
     Qwen3-8B's widths at 8 layers, 3 steps of the sharded trainer
     through ``run_training(..., mesh=)`` on phase 13's seed and batches:
     the state is DTensors, the flash launches exact (2 x 8 forward, 8
     backward a step), the losses and grad norms within 1e-2 relative of
     phase 13's one-device steps (the kernel path's own rerun spread,
     from the flash backward's dQ atomics, is printed beside it), and
     under ``chunked``, which is reproducible, 2 sharded steps within
     1e-5 of phase 13's chunked ones; step wall, tokens/s, peak memory, a
     profiled step's device time by kernel and idle share; (b) a
     ``train_100m``-config state after one sharded step, saved through
     the sharded path by the async writer (its stall and write time),
     reloaded into a one-device state and onto a (1, 1) mesh, bit for
     bit; (c) int8 compression of (a)'s full-width gradients, one tensor
     at a time: every element within half its block's scale, the
     residual carried, ``psum_compressed`` over one rank equal to
     ``dequantize``; the pass's device time.
 26. (run after phase 25) sharded serving on NCCL: (a) full-width Qwen3-8B
     serves phase 5's ``serve_mixed_slo`` through ``ModelExecutor(mesh=)``
     on a (1, 1) mesh: every request done, decode launches exact, the
     RunReport phase 5's, the bytes held after init against the dry run's
     argument bytes (1 %); (b) the decode kernel at Qwen3-8B's
     tensor-parallel local shapes and on a length shard with its lse,
     checked and timed; (c) the dry run (started right after the build in
     a subprocess, card hidden) of Qwen3-8B decode_32k and train_4k (and
     train_4k with ``--seq-parallel``) and Llama-4 decode_32k on 16 x 16,
     and of (a)'s cell.
 27. (run after phase 26, last) training's tensor-parallel compute with
     ``seq_parallel``: (a) phase 25's cell (Qwen3-8B's widths at 8
     layers, 3 steps under the kernels, phase 13's seed and batches)
     through ``run_training(..., mesh=, seq_parallel=True)`` on a (1, 1)
     NCCL mesh: flash launches exact, losses and grad norms within 1e-2
     of phase 13's, then 2 ``chunked`` steps bit for bit phase 25's
     chunked ones (at world 1 nothing is sliced: the plumbing only); step
     wall, tokens/s, peak, a profiled step's device time and idle share;
     (b) the flash pair at the TP-local shapes of Qwen3-8B's train_4k (B
     2, S 4096, causal: 8 / 2 heads of 128 at model 4, 2 / 1 at model
     16) against the plain versions in bf16 and fp32 (phase 11's
     tolerances), timed as CUDA-graph replays and eagerly beside the
     plain versions, SDPA and the bounds; (c) the dry run's train_4k plans
     with and without ``seq_parallel``: live bytes and collectives by
     type against the plan of the trainer that gathered every weight
     whole (37,924,475,916 B; 432 all-reduces, 505 all-gathers); the live
     bytes must fall, and further with ``seq_parallel``.
 28. (run after phase 27, last) tensor-parallel compute for MLA, the SSD
     and RG-LRU mixers and the encoder-decoder: (a) Mamba2-370M and
     RecurrentGemma-2B (phase 17's scenario), DeepSeek-V2-Lite (phase
     22's) and Whisper-large-v3 (phase 23's), full width and depth,
     serve through ``ModelExecutor(mesh=)`` on a (1, 1) NCCL mesh: every
     request done, the RunReport JSON byte-equal to the one-device
     phase's, launches exact (ssd_scan 48 a prefill chunk, rglru_scan 18,
     decode 8 a RecurrentGemma step and 64 a Whisper step, none for
     DeepSeek), a profiled decode step's device time beside the
     one-device phase's; (b) the kernels at the families' TP-local
     shapes against their plain versions (attention 2e-5 fp32 / 2e-2
     bf16, the scans phase 14's tolerances) and timed as CUDA-graph
     replays beside their bounds and, for attention, SDPA: the decode
     kernel on Whisper's 5 of 20 heads (self T 256, cross T 1500) and on
     RecurrentGemma's 2048 ring cut into 4 and 16 length slices (10 on 1
     of 256, stored positions, lse; the slices merged against the whole
     ring), the flash pair on Whisper's encoder at 5 heads (B 8, S 1500,
     non-causal), the SSD scan on 8 and 2 of Mamba2's heads and the
     RG-LRU scan on 640 and 160 channels (one prefill chunk); (c) phase
     23 (d)'s Whisper training through the trainer's tensor-parallel
     compute on the mesh: flash launches exact, losses and grad norms
     within 1e-2 of phase 23 (d)'s; (d) the dry run's decode_32k plans of
     the four on 16 x 16 (phase 26's subprocess), each ``[ ok ]`` with
     its argument and live bytes.  At world 1 nothing is sliced: the
     slicing is held on gloo at world 4 by the CPU tests.
 29. (run after phase 28) the port's static analysis: (a) ``python
     -m repro_torch.analysis.check --json`` on this checkout must be ok
     (no JAX on the card's machine); (b) every function of
     ``tests/data/analysis_torch/sync_bad.py`` that ``host-sync`` flags
     runs on CUDA tensors under ``torch.cuda.set_sync_debug_mode("error")``
     and must raise there, but the three the debug mode cannot show
     (``SYNC_NOT_SHOWN``: ``.numpy()`` and numpy on a CUDA tensor raise
     TypeError before any copy; ``torch.cuda.synchronize()`` bypasses the
     hook); every function of ``sync_good.py`` in the rule's scope runs
     there without a raise, then replays from a CUDA graph equal to its
     eager run (outputs and in-place writes);
 30. (run after phase 29, last) Gemma-7B trained on the card under the
     kernels: its published widths (d_model 3072, 16 on 16 heads of 256,
     GeGLU d_ff 24576, vocab 256,000, tied and scaled embeddings) cut to
     8 of 28 layers, phase 13's run otherwise (AdamW, full remat, 4 x
     1024 tokens, 5 steps, then 2 under ``chunked`` from the same seed);
     launches exact (2 x 8 forward, 8 backward a step: the bf16 backward
     at head dim 256 is ``flash_bwd_sm90_wide``), the first loss within
     0.25 of its expectation (``gemma_first_loss``: a plain forward
     written here, on weights drawn anew from the initial weights'
     distributions; with scaled embeddings a token's own logit
     dominates), losses and grad norms
     within 1e-2 of the ``chunked`` twin's; step wall, tokens/s, peak
     memory and one profiled step; then the flash pair timed at its shape
     (B 4, S 1024, 16 / 16 of 256, causal) as phase 12 times Qwen3's, and
     the bf16 backward's clock64 cycles by phase at that shape and at
     phase 12's RecurrentGemma shape (``flash_bwd_phases``: a build with
     ``-DFLASH_BWD_PHASE_TRACE``).

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import inspect
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.analysis import RepoIndex  # noqa: E402
from repro_torch.analysis.purity import HostSyncRule  # noqa: E402
from repro_torch.api import (ArrivalSpec, RunReport, ScenarioSpec,  # noqa: E402
                             ServeRuntime, SweepAxis, SweepSpec, TenantSpec,
                             WorkloadSpec, build_traces, get_scenario,
                             list_scenarios, run_scenario)
from repro_torch.configs import (  # noqa: E402
    GLOBAL_ATTN, LOCAL_ATTN, RGLRU, SSD, get_config, smoke_config)
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as kssd  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_cuda  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd_cuda, flash_attention_cuda)
from repro_torch.kernels.ref import (GRAPH_STEPS, SWEEP_STATE,  # noqa: E402
                                    decode_attention_ref,
                                    flash_attention_bwd_ref,
                                    flash_attention_ref, rglru_scan_ref,
                                    ssd_scan_bf16_ref, ssd_scan_ref,
                                    sweep_scan_ref,
                                    wlbvt_select_rounds_ref)
from repro_torch.kernels.rglru_scan import rglru_scan_cuda  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan_cuda  # noqa: E402
from repro_torch.kernels.sweep_scan import sweep_scan_cuda  # noqa: E402
from repro_torch.kernels.wlbvt_select import wlbvt_select_cuda  # noqa: E402
from repro_torch.core.slo import ECTX  # noqa: E402
from repro_torch.launch import scenario as scenario_cli  # noqa: E402
from repro_torch.launch import sweep as sweep_cli  # noqa: E402
from repro_torch.launch.sweep import build_sweep, run_sweep  # noqa: E402
from repro_torch.launch.train import run_training  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving.engine import ModelExecutor  # noqa: E402
from repro_torch.serving.request import RequestStatus  # noqa: E402
from repro_torch.serving.sampler import sample  # noqa: E402
from repro_torch.sim import devicepath as DP  # noqa: E402
from repro_torch.sim.fastpath import build_simulator  # noqa: E402

HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
L2_BYTES = 50 * 2**20
SERVE = dict(B=8, T=256, Hq=32, Hkv=8, D=128)
RG_DECODE = dict(B=8, T=256, Hq=10, Hkv=1, D=256)   # RecurrentGemma-2B
# a wrapped 2048-entry ring: every row has seen 2049-4000 tokens
RG_RING_LENGTHS = [2049, 4000, 2817, 3500, 2100, 3999, 2560, 3072]
# the decode shapes of phase 22's serves (B 8, T 256): name, heads, window,
# soft-cap, scale (None: 1/sqrt(D)), stored positions
NEW_DECODE = [
    ("codeqwen_g1", dict(B=8, T=256, Hq=32, Hkv=32, D=128), 0, 0.0, None,
     False),
    ("gemma7b_g1_d256", dict(B=8, T=256, Hq=16, Hkv=16, D=256), 0, 0.0,
     None, False),
    ("gemma2_g2_cap", dict(B=8, T=256, Hq=32, Hkv=16, D=128), 4096, 50.0,
     144.0 ** -0.5, True),
    ("qwen2vl_g8", dict(B=8, T=256, Hq=64, Hkv=8, D=128), 0, 0.0, None,
     False),
    # phase 23's Whisper decoder self-attention: 20 on 20 of 64
    ("whisper_self_g1_d64", dict(B=8, T=256, Hq=20, Hkv=20, D=64), 0, 0.0,
     None, False),
]
# phase 23's cross-attention: every decode step of a Whisper decoder layer
# attends all 1500 encoder frames (fill 1500 in every row)
WHISPER_CROSS = dict(B=8, T=1500, Hq=20, Hkv=20, D=64)
SEED = 0


def log(*a) -> None:
    print(*a, flush=True)


def fields(d: dict) -> str:
    return " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in d.items())


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# phase 3: kernel against its plain version
# ---------------------------------------------------------------------------
def attn_inputs(B, T, Hq, Hkv, D, lengths, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, 1, Hq, D), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, T, Hkv, D), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, T, Hkv, D), generator=g, device="cuda").to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, k, v, lens


def ring_positions(lengths, T: int, seed: int) -> torch.Tensor:
    """(B, T) int32 stored positions of a ring cache of T entries that
    has seen ``lengths[b]`` tokens: index t holds the latest position
    p < length with p = t mod T, or -1; two random entries of each row
    filled past 2 are -1, as a ragged prefill's pad rows leave them."""
    rng = np.random.default_rng(seed)
    pos = np.full((len(lengths), T), -1, np.int32)
    for b, n in enumerate(lengths):
        t = np.arange(T)
        last = t + ((n - 1 - t) // T) * T
        pos[b] = np.where(t <= n - 1, last, -1)
        if n > 2:
            pos[b, rng.choice(T, 2, replace=False)] = -1
    return torch.tensor(pos, device="cuda")


def check_decode_attention() -> float:
    """Returns the max |kernel - plain| of the serving case in bf16."""
    S = SERVE
    T = S["T"]
    ragged = [0, 1, T, 7, 100, 129, 64, T - 1]
    ring = [0, 1, 64, 65, 100, 200, 37, 130]
    cases = [
        ("serve", dict(S), ragged, 0, 0.0, False),
        ("window", dict(S), ragged, 64, 0.0, False),
        ("softcap", dict(S), ragged, 0, 30.0, False),
        ("T%32!=0", dict(S, T=250), [0, 1, 250, 7, 100, 129, 64, 249], 0,
         0.0, False),
        ("window+cap", dict(S, T=250), [250, 3, 31, 33, 0, 200, 64, 1], 40,
         20.0, False),
        # RecurrentGemma-2B's local layers: MQA, 10 heads of 256, window
        # 2048 over a 256-entry cache, masked by the stored positions
        ("rg_d256", dict(RG_DECODE), ragged, 2048, 0.0, False),
        ("rg_d256_pos", dict(RG_DECODE), ragged, 2048, 0.0, True),
        # rings of 64 entries that wrapped, window the ring or less
        ("ring", dict(S, T=64), ring, 64, 0.0, True),
        ("ring_w48", dict(RG_DECODE, T=64), ring, 48, 0.0, True),
        # RecurrentGemma-2B's full 2048-entry ring, wrapped in every row
        ("rg_ring2048", dict(RG_DECODE, T=2048), RG_RING_LENGTHS, 2048, 0.0,
         True),
        # Qwen3-8B's heads over a 4096-entry cache, ragged
        ("qwen3_t4096", dict(S, T=4096),
         [4096, 1, 0, 3000, 2049, 4095, 17, 1024], 0, 0.0, False),
        # Whisper's cross-attention: 1500 frames, 1500 = 23 x 64 + 28 keys
        # (bf16 tiles), full as served, and ragged
        ("whisper_cross", dict(WHISPER_CROSS), [1500] * 8, 0, 0.0, False),
        ("whisper_cross_rag", dict(WHISPER_CROSS),
         [1500, 1, 0, 1499, 1472, 64, 65, 1000], 0, 0.0, False),
    ]
    cases = [c + (None,) for c in cases] + [
        (name, shp, ragged, win, cap, ring_pos, sc)
        for name, shp, win, cap, sc, ring_pos in NEW_DECODE]
    serve_err = None
    for dtype in (torch.bfloat16, torch.float32):
        for i, case in enumerate(cases):
            err = check_decode_case(*case, dtype=dtype, seed=SEED + i)
            if case[0] == "serve" and dtype == torch.bfloat16:
                serve_err = err
    return serve_err


def check_decode_case(name, shp, lengths, win, cap, ring_pos, sc, *, dtype,
                      seed) -> float:
    """The kernel against its plain version on one case (``shp``: B, T,
    Hq, Hkv, D; ``sc`` None: 1/sqrt(D)); returns max |kernel - plain|."""
    q, k, v, lens = attn_inputs(**shp, lengths=lengths, dtype=dtype,
                                seed=seed)
    pos = ring_positions(lengths, shp["T"], seed) if ring_pos else None
    scale = sc or 1.0 / math.sqrt(shp["D"])
    got = decode_attention_cuda(q, k, v, lens, scale=scale, window=win,
                                cap=cap, positions=pos)
    torch.cuda.synchronize()
    want = decode_attention_ref(q, k, v, lens, scale=scale, window=win,
                                cap=cap, positions=pos)
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), atol=TOL[dtype],
                        rtol=TOL[dtype])
    empty_zero = bool(torch.all(got[lens <= 0] == 0))
    log(f"check decode_attention {name:<15} {str(dtype):<15} "
        f"max_abs_err={err:.3e} tol={TOL[dtype]:g} "
        f"empty_rows_zero={empty_zero}")
    if not (ok and empty_zero and torch.isfinite(got).all()):
        raise AssertionError(f"decode_attention {name} {dtype}: "
                             f"kernel disagrees with plain version")
    return err


# ---------------------------------------------------------------------------
# phase 4: timing
# ---------------------------------------------------------------------------
def event_ms(fn, argsets, iters) -> float:
    for a in argsets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*argsets[i % len(argsets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def library_kernels(fn) -> list:
    """Names of the CUDA kernels one call of ``fn`` runs (profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key[:80] for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA})


def time_decode_attention(T: int, calls: int, shape=None, window: int = 0,
                          ring: bool = False, lengths=None, cap: float = 0.0,
                          scale=None, positions=None,
                          lse: bool = False) -> dict:
    """Device time per call of the kernel and of SDPA (CUDA-graph replays
    of ``calls`` calls, K/V rotated through more buffers than the 50 MB L2
    holds, as the layers' caches are on the main path), the same launched
    eagerly from Python (``eager_ms``, ``library_eager_ms``), and the
    plain version's eager time.  Full caches (length T in every row)
    unless ``lengths`` is given; ``ring``: the kernel masks by stored
    positions, as RecurrentGemma's local layers call it (a wrapped ring
    when a length exceeds T).  SDPA has no soft-cap: with ``cap`` it is
    held to, and times, the uncapped function (``library_uncapped``).
    ``positions``: given stored positions (B, T) (a length shard);
    ``lse``: the kernel and the plain version also return the
    log-sum-exp (SDPA is timed without it)."""
    S = dict(shape or SERVE, T=T)
    B, Hq, Hkv, D = S["B"], S["Hq"], S["Hkv"], S["D"]
    dtype, G = torch.bfloat16, S["Hq"] // S["Hkv"]
    lengths = lengths or [T] * B
    pair_bytes = 2 * B * T * Hkv * D * 2
    nbuf = max(2, math.ceil(4 * L2_BYTES / pair_bytes))
    sets = [attn_inputs(**S, lengths=lengths, dtype=dtype, seed=100 + i)
            for i in range(nbuf)]
    scale = scale or 1.0 / math.sqrt(D)
    pos = positions if positions is not None else (
        ring_positions(lengths, T, SEED) if ring else None)
    kw = dict(scale=scale, window=window, positions=pos, cap=cap)

    def kernel(q, k, v, lens):
        return decode_attention_cuda(q, k, v, lens, return_lse=lse, **kw)

    def plain(q, k, v, lens):
        return decode_attention_ref(q, k, v, lens, return_lse=lse, **kw)

    # the keys that count, as the kernel masks them
    kpos = (pos.long() if pos is not None
            else torch.arange(T, device="cuda")[None, :])
    lens = sets[0][3].long()[:, None]
    mask = (kpos >= 0) & (kpos < lens)
    if window:
        mask &= lens - kpos <= window
    lib_sets = [(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                 mask[:, None, None, :]) for (q, k, v, _) in sets]

    def library(q, k, v, m):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                              scale=scale, enable_gqa=True)

    # the yardstick computes the same function (but for a soft-cap, which
    # SDPA lacks): check it once
    lib_out = library(*lib_sets[0]).transpose(1, 2)
    ker_out = decode_attention_cuda(*sets[0], **dict(kw, cap=0.0))
    lib_err = (lib_out.float() - ker_out.float()).abs().max().item()
    if lib_err > TOL[dtype]:
        raise AssertionError(f"library yardstick disagrees: {lib_err}")
    lib_kernels = library_kernels(lambda: library(*lib_sets[0]))

    ms = graph_ms(kernel, calls, 20, sets)
    library_ms = graph_ms(library, calls, 20, lib_sets)
    eager_ms = event_ms(kernel, sets, 20 * calls)
    library_eager_ms = event_ms(library, lib_sets, 20 * calls)
    plain_ms = event_ms(plain, sets, max(calls // 5, 5))
    counted = int(mask.sum().item())
    kv_elems = counted * Hkv * D               # K (and V) read
    nbytes = 2 * kv_elems * 2 + 2 * (B * Hq * D * 2) + B * 4 \
        + (B * T * 4 if pos is not None else 0) \
        + (B * Hq * 4 if lse else 0)    # + q, out, lens, positions, lse
    flops = 2 * 2 * G * kv_elems          # one MAC per query row, QK and PV
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(B=B, T=T, Hq=Hq, Hkv=Hkv, D=D, window=window, ring=ring,
                cap=cap, library_uncapped=bool(cap), counted_keys=counted,
                ms=ms, library_ms=library_ms,
                eager_ms=eager_ms, library_eager_ms=library_eager_ms,
                plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops, buffers=nbuf,
                library_kernels="|".join(lib_kernels))


# ---------------------------------------------------------------------------
# phases 5-7: the served model
# ---------------------------------------------------------------------------
def serve_spec(cfg, seed: int):
    return get_scenario("serve_mixed_slo", tenants=3, requests=12,
                        max_slots=8, max_len=256, prefill_chunk=32,
                        vocab=cfg.vocab_size, seed=seed)


def serve(cfg, seed: int):
    """``serve_spec`` served through ``ServeRuntime`` + ``ModelExecutor``
    on the card: (runtime, validated report, kernel launches)."""
    spec = serve_spec(cfg, seed)
    rt = ServeRuntime.from_spec(
        spec, executor=lambda e: ModelExecutor(cfg, e, rng_seed=seed,
                                               device="cuda"))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    rep = rt.run(spec).validate()
    launches = dict(ops.LAUNCHES)
    return rt, rep, launches


def prefill_decode_logits(cfg, module, max_len: int, prompts,
                          decode_tokens, frames=None, trace=None):
    """``module`` run as ``cfg`` (its dtype and attention implementation)
    on a fresh cache: one prefill of ``prompts`` (B, C), with an
    encoder-decoder's ``frames`` (B, T_enc, d) when given, then one decode
    step per column of ``decode_tokens`` (B, n).  Returns [prefill last
    logits, decode logits...]; ``trace`` (a list) gets a copy of
    ``ops.LAUNCHES`` after the prefill and after each step.  MoE layers
    dispatch as served (``gshard``)."""
    model = build_model(cfg, moe_impl="gshard")
    B, C = prompts.shape
    cache = model.init_cache(B, max_len, "cuda")
    lengths = torch.zeros(B, dtype=torch.int32, device="cuda")
    active = torch.ones((B, 1), dtype=torch.bool, device="cuda")
    kw = {} if frames is None else dict(frames=frames)
    trace = [] if trace is None else trace
    served = module.cfg
    module.cfg = cfg
    try:
        with torch.no_grad():
            logits, cache = model.prefill(module, prompts, cache, lengths,
                                          **kw)
            trace.append(dict(ops.LAUNCHES))
            out = [logits[:, -1]]
            lengths = lengths + C
            for i in range(decode_tokens.shape[1]):
                logits, cache = model.decode_step(
                    module, decode_tokens[:, i:i + 1], cache, lengths,
                    valid=active)
                trace.append(dict(ops.LAUNCHES))
                out.append(logits[:, -1])
                lengths = lengths + 1
    finally:
        module.cfg = served
    return out


def check_small(arch: str, prompt_len: int, steps: int,
                kernels: bool = True, **changes) -> None:
    """fp32 smoke model on the card: the kernel path gives the plain
    (``chunked``) path's logits (1e-4) and greedy tokens over a prefill
    of ``prompt_len`` tokens and ``steps`` decode steps; an
    encoder-decoder gets random frames with its prefill.  ``kernels``
    False: the model runs no kernel (MLA's absorbed decode), and the
    ``pallas`` path must launch none."""
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32",
                              attn_impl="pallas", **changes)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    module = build_model(cfg).init(gen)
    prompts = torch.randint(1, cfg.vocab_size, (4, prompt_len), generator=gen,
                            device="cuda", dtype=torch.int32)
    toks = torch.randint(1, cfg.vocab_size, (4, steps), generator=gen,
                         device="cuda", dtype=torch.int32)
    frames = (torch.randn((4, cfg.num_audio_frames, cfg.d_model),
                          generator=gen, device="cuda")
              if cfg.is_encoder_decoder else None)
    ops.reset_launches()
    ker = prefill_decode_logits(cfg, module, 64, prompts, toks, frames)
    launched = {k: v for k, v in ops.LAUNCHES.items() if v}
    plain = prefill_decode_logits(
        dataclasses.replace(cfg, attn_impl="chunked"), module, 64, prompts,
        toks, frames)
    err = max((a - b).abs().max().item() for a, b in zip(ker, plain))
    same = all(torch.equal(a.argmax(-1), b.argmax(-1))
               for a, b in zip(ker, plain))
    log(f"check small fp32 {arch}: prefill of {prompt_len} + {steps} decode "
        f"steps, kernels {launched}, max_abs_err={err:.3e} tol=1e-4 "
        f"greedy_tokens_equal={same}")
    if err > 1e-4 or not same or bool(launched) != kernels:
        raise AssertionError(f"small {arch}: kernel path disagrees")


def check_full_width(module, cfg) -> None:
    """A full-width model (Qwen3-8B, phase 22's attention models): one
    decode step's logits through the kernel against the plain path's
    (``chunked``: its decode is ``naive_attention``), after the same
    prefill."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    prompts = torch.randint(1, cfg.vocab_size, (8, 32), generator=g,
                            device="cuda", dtype=torch.int32)
    toks = torch.randint(1, cfg.vocab_size, (8, 1), generator=g,
                         device="cuda", dtype=torch.int32)
    ker = prefill_decode_logits(cfg, module, 256, prompts, toks)[1]
    plain = prefill_decode_logits(dataclasses.replace(
        cfg, attn_impl="chunked"), module, 256, prompts, toks)[1]
    if ker.shape != (8, cfg.vocab_size) or not torch.isfinite(ker).all():
        raise AssertionError(f"full-width logits: shape {tuple(ker.shape)}, "
                             f"finite={bool(torch.isfinite(ker).all())}")
    err = (ker - plain).abs().max().item()
    scale = plain.abs().max().item()
    agree = (ker.argmax(-1) == plain.argmax(-1)).float().mean().item()
    # bf16 through 36 layers: the two paths round q*scale and the
    # probabilities at different points; hold them to 5% of the logit range
    log(f"check {cfg.name} ({cfg.num_layers} layers) full-width decode "
        f"logits: shape={tuple(ker.shape)} finite "
        f"max_abs_err={err:.4g} max_abs_logit={scale:.4g} "
        f"greedy_agreement={agree:.3f}")
    if err > 0.05 * scale:
        raise AssertionError("full-width decode: kernel path disagrees")


def profile_decode(ex) -> float:
    """Phase 7; returns the decode step's device time (ms)."""
    B = 8
    tokens = np.ones(B, np.int32)
    lengths = np.full(B, 128, np.int32)
    active = np.ones(B, bool)
    return profile_step("qwen3-8b full-width decode step",
                        lambda: ex.decode(tokens, lengths, active),
                        kernel="decode_attention")


# ---------------------------------------------------------------------------
# phases 11-13: flash attention and the training path
# ---------------------------------------------------------------------------
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# B, S, T, Hq, Hkv, D, window, cap, causal: tests/test_kernels.py's cases,
# causal off, and the training path's shape (TRAIN: Qwen3-8B's heads)
# the bf16 kernels' edges: S * G and T not multiples of their 128-row and
# 128-key tiles, G = 3 and 8, every head dim, a window shorter than a tile,
# a cap with a window, non-causal with T != S
FLASH_CASES = [
    ("mha", (2, 128, 128, 4, 4, 64, 0, 0.0, True)),
    ("gqa4", (2, 256, 256, 8, 2, 64, 0, 0.0, True)),
    ("mqa_unaligned", (2, 192, 192, 4, 1, 128, 0, 0.0, True)),
    ("window96", (2, 256, 256, 8, 4, 64, 96, 0.0, True)),
    ("cap50", (2, 128, 128, 4, 4, 64, 0, 50.0, True)),
    ("win_cap_odd", (2, 320, 320, 2, 2, 32, 64, 30.0, True)),
    ("noncausal", (1, 64, 96, 2, 2, 32, 0, 0.0, False)),
    ("g3_ragged", (2, 200, 200, 6, 2, 64, 0, 0.0, True)),
    ("d16", (2, 130, 130, 4, 2, 16, 0, 0.0, True)),
    ("win20_d128", (1, 300, 300, 8, 2, 128, 20, 0.0, True)),
    ("noncausal_ragged", (1, 300, 200, 4, 2, 64, 0, 0.0, False)),
    ("g8_cap_win", (1, 260, 260, 8, 1, 32, 50, 20.0, True)),
    # head dim 256 with RecurrentGemma-2B's grouping (10 heads on 1): S * G
    # off the tiles, a window, a cap with a window, and its cache-free
    # forward's shape (S 4096, window 2048)
    ("g10_d256", (1, 200, 200, 10, 1, 256, 0, 0.0, True)),
    ("g10_d256_win", (2, 300, 300, 10, 1, 256, 100, 0.0, True)),
    ("g10_d256_cap_win", (1, 260, 260, 10, 1, 256, 64, 30.0, True)),
    ("rg_cache_free", (1, 4096, 4096, 10, 1, 256, 2048, 0.0, True)),
    # head dim 256 with one query head a KV head (the bf16 backward's rows
    # by TMA): S off the 64-row tiles, and Gemma-7B's training shape
    ("mha_d256", (2, 100, 100, 4, 4, 256, 0, 0.0, True)),
    ("gemma7b", (4, 1024, 1024, 16, 16, 256, 0, 0.0, True)),
    # Whisper's encoder: non-causal, S = T = 1500 (the last 128-row tile
    # holds 92 rows, the last 128-key tile 92 keys), 20 on 20 of 64
    ("whisper_enc", (2, 1500, 1500, 20, 20, 64, 0, 0.0, False)),
    ("qwen3", (4, 1024, 1024, 32, 8, 128, 0, 0.0, True)),
]
TRAIN = dict(B=4, S=1024, Hq=32, Hkv=8, D=128)
# RecurrentGemma-2B's local attention, cache-free (B 1, S 4096)
RG_FLASH = dict(B=1, S=4096, Hq=10, Hkv=1, D=256, window=2048)
# Whisper's encoder attention at phase 23's batch: non-causal, B 8
WHISPER_ENC = dict(B=8, S=1500, Hq=20, Hkv=20, D=64, causal=False)
# Gemma-7B's attention at phase 30's batch: MHA, 16 heads of 256
GEMMA_FLASH = dict(B=4, S=1024, Hq=16, Hkv=16, D=256)
assert FLASH_CASES[-1][1] == (TRAIN["B"], TRAIN["S"], TRAIN["S"], TRAIN["Hq"],
                              TRAIN["Hkv"], TRAIN["D"], 0, 0.0, True)


def flash_inputs(case, dtype, seed, fused=False):
    """q, k, v, dO of a case; ``fused``: q, k, v are strided slices of one
    (B, S, Hq + 2 Hkv, D) buffer, as a fused projection gives them."""
    B, S, T, Hq, Hkv, D, win, cap, causal = case
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    if fused:
        assert S == T
        x = rnd(B, S, Hq + 2 * Hkv, D)
        q, k, v = x[:, :, :Hq], x[:, :, Hq:Hq + Hkv], x[:, :, Hq + Hkv:]
    else:
        q, k, v = rnd(B, S, Hq, D), rnd(B, T, Hkv, D), rnd(B, T, Hkv, D)
    do = rnd(B, S, Hq, D)
    kw = dict(scale=1.0 / math.sqrt(D), causal=causal, window=win, cap=cap)
    return q, k, v, do, kw


def rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1e-30)).item()


# q, k, v as slices of one fused buffer (bf16 only)
FLASH_FUSED = [("fused_qwen3", (2, 256, 256, 32, 8, 128, 0, 0.0, True)),
               ("fused_g3", (1, 200, 200, 6, 2, 64, 0, 0.0, True))]


def check_flash_attention():
    """Both kernels against their plain versions on every case.  Returns
    the qwen3 case's errors in bf16: max |o - plain|, max |grad - plain|
    over dq, dk, dv, and the worst relative gradient error."""
    out = {}
    runs = [(name, case, dtype, False, SEED + i)
            for dtype in (torch.bfloat16, torch.float32)
            for i, (name, case) in enumerate(FLASH_CASES)]
    runs += [(name, case, torch.bfloat16, True, SEED + len(FLASH_CASES) + i)
             for i, (name, case) in enumerate(FLASH_FUSED)]
    for name, case, dtype, fused, seed in runs:
        err, gabs, gerr = check_flash_case(name, case, dtype, seed, fused)
        if name == "qwen3" and dtype == torch.bfloat16:
            out = dict(fwd_err=err, bwd_err=gabs, bwd_rel_err=gerr)
    x = torch.zeros((1, 8, 6, 64), device="cuda", dtype=torch.bfloat16)
    for what, args in (
            ("head dim 48", [torch.zeros((1, 8, 2, 48), device="cuda")] * 3),
            # slices starting one element in: 2-byte aligned addresses
            ("a misaligned address", [x[:, :, 2 * i:2 * i + 2, 1:33]
                                      for i in range(3)])):
        try:
            flash_attention_cuda(*args, scale=1.0)
        except ValueError as e:
            log(f"check flash_attention {what} raises: {e}")
        else:
            raise AssertionError(f"flash_attention: {what} did not raise")
    return out


def check_flash_case(name, case, dtype, seed, fused=False) -> tuple:
    """Both kernels against their plain versions on one case (B, S, T,
    Hq, Hkv, D, window, cap, causal).  Returns max |o - plain|, max
    |grad - plain| over dq, dk, dv, and the worst relative gradient
    error against the plain backward."""
    q, k, v, do, kw = flash_inputs(case, dtype, seed, fused)
    o, lse = flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    want_o, want_lse = flash_attention_ref(q, k, v, **kw)
    err = (o.float() - want_o.float()).abs().max().item()
    lse_err = (lse - want_lse).abs().max().item()
    grads = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    gerr = [rel_err(a, b) for a, b in zip(grads, want)]
    gabs = max((a.float() - b.float()).abs().max().item()
               for a, b in zip(grads, want))
    # autograd of the plain forward: the gradient's second oracle
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    ref_o, _ = flash_attention_ref(*leaves, **kw)
    auto = torch.autograd.grad(ref_o, leaves, do)
    aerr = [rel_err(a, b) for a, b in zip(grads, auto)]
    del ref_o, auto, leaves
    ok = (err <= TOL[dtype] and lse_err <= 1e-4
          and max(gerr + aerr) <= GRAD_TOL[dtype]
          and all(torch.isfinite(x).all() for x in (o, *grads)))
    log(f"check flash_attention {name:<16} {str(dtype):<15} "
        f"fwd max_abs_err={err:.3e} (tol {TOL[dtype]:g}) "
        f"lse_err={lse_err:.3e} bwd rel_err dq/dk/dv="
        f"{'/'.join(f'{e:.2e}' for e in gerr)} vs autograd of "
        f"plain {'/'.join(f'{e:.2e}' for e in aerr)} "
        f"(tol {GRAD_TOL[dtype]:g})")
    if not ok:
        raise AssertionError(f"flash_attention {name} {dtype}: "
                             "kernel disagrees with plain version")
    return err, gabs, max(gerr)


def time_flash_attention(iters: int, shape=None) -> dict:
    """CUDA-event times at the training shape (or ``shape``: causal unless
    it says otherwise, with its window).  At the training shape q, k, v
    and o together (84 MB) exceed the 50 MB L2, so no buffers are
    rotated (at Whisper's encoder shape they are 123 MB)."""
    T = shape or TRAIN
    B, S, Hq, Hkv, D = T["B"], T["S"], T["Hq"], T["Hkv"], T["D"]
    win, causal = T.get("window", 0), T.get("causal", True)
    dtype = torch.bfloat16
    case = (B, S, S, Hq, Hkv, D, win, 0.0, causal)
    q, k, v, do, kw = flash_inputs(case, dtype, 200)
    # SDPA takes a window only as an explicit mask
    qp = torch.arange(S, device="cuda")
    lib_mask = ((qp[None, :] <= qp[:, None])
                & (qp[:, None] - qp[None, :] < win)) if win else None
    o, lse = flash_attention_cuda(q, k, v, **kw)
    lq, lk, lv = (x.detach().transpose(1, 2).clone().requires_grad_(True)
                  for x in (q, k, v))
    ldo = do.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(lq, lk, lv, attn_mask=lib_mask,
                                              is_causal=(causal and lib_mask
                                                         is None),
                                              scale=kw["scale"],
                                              enable_gqa=True)
    # the yardstick computes the same function: check it once
    lib_err = (sdpa().transpose(1, 2).float() - o.float()).abs().max().item()
    if lib_err > TOL[dtype]:
        raise AssertionError(f"library yardstick disagrees: {lib_err}")
    lib_out = sdpa()

    def lib_fwd_bwd():
        torch.autograd.grad(sdpa(), (lq, lk, lv), ldo)

    def lib_bwd():
        torch.autograd.grad(lib_out, (lq, lk, lv), ldo, retain_graph=True)

    gq, gk, gv = (x.detach().requires_grad_(True) for x in (q, k, v))

    def ker_fwd_bwd():
        torch.autograd.grad(ops.flash_attention(gq, gk, gv, **kw),
                            (gq, gk, gv), do)

    def plain_fwd_bwd():
        po, plse = flash_attention_ref(q, k, v, **kw)
        flash_attention_bwd_ref(q, k, v, po, plse, do, **kw)

    few = max(iters // 10, 3)
    r = dict(
        fwd_ms=event_ms(lambda: flash_attention_cuda(q, k, v, **kw), [()],
                        iters),
        bwd_ms=event_ms(lambda: flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                         **kw), [()], iters),
        fwd_bwd_ms=event_ms(ker_fwd_bwd, [()], iters),
        plain_fwd_ms=event_ms(lambda: flash_attention_ref(q, k, v, **kw),
                              [()], few),
        plain_bwd_ms=event_ms(lambda: flash_attention_bwd_ref(
            q, k, v, o, lse, do, **kw), [()], few),
        plain_fwd_bwd_ms=event_ms(plain_fwd_bwd, [()], few),
        library_fwd_ms=event_ms(sdpa, [()], iters),
        library_bwd_ms=event_ms(lib_bwd, [()], iters),
        library_fwd_bwd_ms=event_ms(lib_fwd_bwd, [()], iters))
    # causal: every (query, key) pair with key <= query (and within the
    # window), counted exactly; non-causal: all S * S
    pairs = B * Hq * (sum(min(s + 1, win or S) for s in range(S)) if causal
                      else S * S)
    elt = 2
    fwd_bytes = (2 * B * S * Hq * D + 2 * B * S * Hkv * D) * elt \
        + B * Hq * S * 4                                # q, o, k, v, lse
    bwd_bytes = (3 * B * S * Hq * D + 2 * B * S * Hkv * D) * elt \
        + B * Hq * S * 4 + (B * S * Hq * D + 2 * B * S * Hkv * D) * elt
    for name, flops, nbytes in (("fwd", 4 * D * pairs, fwd_bytes),
                                ("bwd", 10 * D * pairs, bwd_bytes)):
        t_b = nbytes / HBM_BYTES_PER_S * 1e3
        t_o = flops / PEAK_FLOPS[dtype] * 1e3
        r[f"{name}_bound_ms"] = max(t_b, t_o)
        r[f"{name}_bound_by"] = "bytes" if t_b >= t_o else "operations"
        r[f"{name}_flops"] = flops
        r[f"{name}_bytes"] = nbytes
        # achieved rate and share of the bound, kernel and library call
        r[f"{name}_tflops"] = flops / r[f"{name}_ms"] / 1e9
        r[f"{name}_bound_share"] = r[f"{name}_bound_ms"] / r[f"{name}_ms"]
        r[f"library_{name}_tflops"] = flops / r[f"library_{name}_ms"] / 1e9
    r["library_max_abs_diff"] = lib_err
    # SDPA's backward moves from call to call: the kernel's and its in
    # alternating pairs
    pairs = [(event_ms(lambda: flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                        **kw), [()], iters),
              event_ms(lib_bwd, [()], iters)) for _ in range(3)]
    r["paired_bwd_ms"] = "/".join(f"{a:.6g}" for a, _ in pairs)
    r["paired_library_bwd_ms"] = "/".join(f"{b:.6g}" for _, b in pairs)
    if shape is not None:
        return r
    # the same shape without the causal mask: every block walks all 8 KV
    # tiles and no tile is masked, which shows what the causal blocks'
    # shortness and diagonal tiles cost
    nq, nk, nv, ndo, nkw = flash_inputs((B, S, S, Hq, Hkv, D, 0, 0.0, False),
                                        dtype, 201)
    no, nlse = flash_attention_cuda(nq, nk, nv, **nkw)
    for name, per_pair, fn in (
            ("fwd", 4, lambda: flash_attention_cuda(nq, nk, nv, **nkw)),
            ("bwd", 10, lambda: flash_attention_bwd_cuda(
                nq, nk, nv, no, nlse, ndo, **nkw))):
        ms = event_ms(fn, [()], iters)
        r[f"noncausal_{name}_ms"] = ms
        r[f"noncausal_{name}_tflops"] = (per_pair * D * B * Hq * S * S
                                         / ms / 1e9)
    return r


def sass_counts(lib: str, opcode: str) -> dict:
    """Instructions of ``opcode`` in each function of a kernel library
    (``cuobjdump --dump-sass``)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", str(kbuild.lib_path(lib))],
                          capture_output=True, text=True, check=True).stdout
    per, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            per[fn] = 0
        elif fn is not None and opcode in line:
            per[fn] += 1
    return per


def check_tensor_cores() -> dict:
    """Count the HGMMA (wgmma) instructions of every function in the two
    flash libraries and the HMMA (mma.sync) instructions of the SSD
    library; each bf16 flash kernel and each bf16 SSD kernel
    (``ssd_scan_tc``, chunks of 32 and 64 rows) must have some.  Returns
    the count per library."""
    counts = {}
    for lib, kernel in (("flash_attention", "flash_fwd_sm90"),
                        ("flash_attention_bwd", "flash_bwd_sm90")):
        per = sass_counts(lib, "HGMMA")
        ours = {int(re.search(r"ILi(\d+)E", f).group(1)): c
                for f, c in per.items() if kernel in f}
        others = sum(c for f, c in per.items() if kernel not in f)
        log(f"tensor cores: {lib} HGMMA instructions, bf16 {kernel} by "
            f"head dim {dict(sorted(ours.items()))}, every other function "
            f"{others}")
        # the backward at D 256 is flash_bwd_sm90_wide (flash_attention_bwd.cu)
        if sorted(ours) != [16, 32, 64, 128, 256] or min(ours.values()) == 0:
            raise AssertionError(f"{lib}: a bf16 kernel has no HGMMA "
                                 f"instruction: {ours}")
        counts[lib] = sum(ours.values())
    per = sass_counts("ssd_scan", "HMMA")
    ours = {f: c for f, c in per.items() if "ssd_scan_tc" in f}
    log(f"tensor cores: ssd_scan HMMA instructions, bf16 ssd_scan_tc "
        f"{list(ours.values())}, every other function "
        f"{sum(per.values()) - sum(ours.values())}")
    if len(ours) != 2 or min(ours.values()) == 0:
        raise AssertionError(f"ssd_scan: a bf16 kernel has no HMMA "
                             f"instruction: {ours}")
    counts["ssd_scan"] = sum(ours.values())
    return counts


def ptxas_report(logs: dict, pattern: str) -> list:
    """(library, function, registers, spill stores, spill loads) of every
    entry function whose mangled name matches ``pattern``, from the
    ``-Xptxas -v`` build logs."""
    out = []
    for lib, text in logs.items():
        fn, spill = None, (0, 0)
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn, spill = m.group(1), (0, 0)
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                spill = (int(m.group(1)), int(m.group(2)))
                continue
            m = re.search(r"Used (\d+) registers", line)
            if m and fn is not None and re.search(pattern, fn):
                out.append((lib, fn, int(m.group(1)), *spill))
                fn = None
    return out


def profile_train_step(cfg, state, seq_len: int = 1024, batch: int = 4,
                       grad_accum: int = 1, label: str = "train",
                       trainer=None) -> dict:
    """Device time by kernel over one more training step of ``state``
    (after the measured run), against the step's wall time; ``trainer``
    (a sharded one) must suit ``state``, else a one-device trainer."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.trainer import build_trainer
    trainer = trainer or build_trainer(cfg, total_steps=5,
                                       grad_accum=grad_accum, device="cuda")
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in
             next(SyntheticLM(cfg, seq_len, batch, seed=SEED + 1)).items()}
    state, _ = trainer.train_step(state, batch)        # warm
    (state, _), wall = sync_time(lambda: trainer.train_step(state, batch))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train_step(state, batch)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in rows) / 1e3
    attn = sum(e.self_device_time_total for e in rows
               if "flash_" in e.key) / 1e3
    idle = 1 - total / (wall * 1e3)
    log(f"profile: {label} step wall {wall * 1e3:.3f} ms (host clock, "
        f"unprofiled), device time {total:.3f} ms over "
        f"{sum(e.count for e in rows)} kernels, idle share "
        f"{idle:.3f}, flash kernels {attn:.3f} ms "
        f"({attn / total:.3f} of device time)")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"profile:   {e.self_device_time_total / 1e3:9.3f} ms  "
            f"{e.count:5d}x  {e.key[:90]}")
    return dict(wall_ms=wall * 1e3, device_ms=total, idle=idle)


def train_phase() -> dict:
    """Phase 13: Qwen3-8B's widths at 8 layers, 5 steps on the kernels,
    then 2 steps on the plain chunked attention from the same seed."""
    return train_cell("qwen3-8b", 8, "train", qwen3_first_loss)


def qwen3_first_loss(cfg) -> tuple:
    """Random init: the final hidden has unit RMS and the tied embedding
    std 0.02, so the logits have variance d_model * 0.02^2 and the
    expected loss is ln V + var / 2 (+ the z-loss, ~0.016)."""
    return (math.log(cfg.vocab_size) + cfg.d_model * 0.02 ** 2 / 2,
            "ln V + d_model * 0.02^2 / 2")


def train_cell(arch: str, layers: int, label: str, first_loss) -> dict:
    """``arch``'s published widths cut to ``layers``, full remat: 5 steps
    on the kernels (``attn_impl="pallas"``) through ``run_training``, a
    profiled step, then 2 steps on the plain chunked attention from the
    same seed.  ``first_loss(cfg)`` gives the first loss's expectation
    and how it was reached; the first loss must lie within 0.25 of it."""
    full = get_config(arch)
    base = dataclasses.replace(full, num_layers=layers, remat="full")
    run = dict(seq_len=1024, global_batch=4, seed=SEED, log_every=1,
               device="cuda", log=log)
    cfg = dataclasses.replace(base, attn_impl="pallas")
    log(f"train {arch} widths: layers={cfg.num_layers} (of "
        f"{full.num_layers}) d_model={cfg.d_model} heads={cfg.num_heads}/"
        f"{cfg.num_kv_heads}x{cfg.head_dim} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab_size} param_dtype={cfg.param_dtype} "
        f"dtype={cfg.dtype} optimizer={cfg.optimizer} remat={cfg.remat} "
        f"batch 4x1024")
    want_first, how = first_loss(cfg)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    (state, hist), wall = sync_time(lambda: run_training(cfg, steps=5, **run))
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in state.params.parameters())
    prof = profile_train_step(cfg, state, label=label)
    log(f"{label}: params={n_params} wall_s={wall:.3f} "
        f"max_memory_allocated={peak} launches flash_attention="
        f"{launches['flash_attention']} flash_attention_bwd="
        f"{launches['flash_attention_bwd']} (per step "
        f"{launches['flash_attention'] / 5:g} / "
        f"{launches['flash_attention_bwd'] / 5:g}; layers "
        f"{cfg.num_layers})")
    del state
    torch.cuda.empty_cache()
    first = hist[0]["loss"]
    log(f"check {label} first loss {first:.4f}: ln V = "
        f"{math.log(cfg.vocab_size):.4f}, {how} = {want_first:.4f} "
        f"(tol 0.25)")
    if not (all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                for h in hist) and abs(first - want_first) < 0.25):
        raise AssertionError(f"{label}: losses {[h['loss'] for h in hist]}, "
                             f"first should be near {want_first:.3f}")
    if (launches["flash_attention"] != 2 * cfg.num_layers * 5
            or launches["flash_attention_bwd"] != cfg.num_layers * 5):
        raise AssertionError(f"{label}: launches {launches}, want 2 x "
                             f"{cfg.num_layers} forward and "
                             f"{cfg.num_layers} backward per step")
    plain_cfg = dataclasses.replace(base, attn_impl="chunked")
    ops.reset_launches()
    (pstate, phist), pwall = sync_time(
        lambda: run_training(plain_cfg, steps=2, **run))
    del pstate
    torch.cuda.empty_cache()
    if ops.LAUNCHES["flash_attention"] or ops.LAUNCHES["flash_attention_bwd"]:
        raise AssertionError("chunked training launched a flash kernel")
    diffs = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
             for a, b in zip(hist[:2], phist)]
    # under the warmup the first steps barely move the weights, so the
    # losses hold the forward; the grad norms hold the backward kernel
    gdiffs = [abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"])
              for a, b in zip(hist[:2], phist)]
    log(f"check {label} kernels vs chunked: losses "
        f"{[h['loss'] for h in hist[:2]]} vs {[h['loss'] for h in phist]} "
        f"rel diff {[f'{d:.2e}' for d in diffs]} (tol 1e-2); grad norms "
        f"{[h['grad_norm'] for h in hist[:2]]} vs "
        f"{[h['grad_norm'] for h in phist]} rel diff "
        f"{[f'{d:.2e}' for d in gdiffs]} (tol 1e-2); chunked "
        f"wall_s={pwall:.3f} step_s {[round(h['step_s'], 4) for h in phist]}")
    if max(diffs) > 1e-2:
        raise AssertionError(f"{label}: the kernel path's losses disagree "
                             "with the chunked path's")
    if max(gdiffs) > 1e-2:
        raise AssertionError(f"{label}: the kernel path's grad norms "
                             "disagree with the chunked path's")
    return dict(hist=hist, launches=launches, peak=peak, wall=wall,
                plain_hist=phist, profile=prof)


# ---------------------------------------------------------------------------
# phase 30: Gemma-7B trained under the kernels (the bf16 flash backward at
# head dim 256)
# ---------------------------------------------------------------------------
GEMMA_LAYERS = 8


def gemma_first_loss(cfg, device: str = "cuda") -> tuple:
    """The first loss's expectation for Gemma's tied embedding scaled by
    sqrt(d_model), reached without the port's model: a plain fp32 forward
    of the architecture written here (the scaled embedding, pre-norm
    layers of RoPE attention and a GeGLU MLP, the final norm, logits on
    the tied table; the trainer's loss, z-loss included) on phase 30's
    first batch, with weights drawn anew, from a seed of their own, out of
    the initial weights' distributions: embedding N(0, 0.02^2), each
    dense N(0, 1 / fan-in), every norm's scale 0 (so 1 + 0).  Phase 13's
    ln V + d_model * 0.02^2 / 2 does not hold here: scaled, a token's own
    row is a large part of its residual stream, so its own logit (~30)
    rules the softmax.  The loss is a mean over 4,096 tokens of weights
    that concentrate, so two draws agree to a few hundredths."""
    from repro_torch.training.data import make_pipeline
    from repro_torch.training.trainer import Z_LOSS
    d, H, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    batch = next(make_pipeline(cfg, 1024, 4, seed=SEED))
    tok, lab = (torch.from_numpy(batch[k]).long().to(device)
                for k in ("tokens", "labels"))
    B, S = tok.shape
    g = torch.Generator(device=device).manual_seed(SEED + 1)

    def draw(*shape, std):
        return torch.randn(shape, generator=g, device=device) * std

    def norm(x):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                               + cfg.norm_eps)

    half = hd // 2
    freqs = cfg.rope_theta ** (-torch.arange(half, device=device) / half)
    ang = torch.arange(S, device=device)[:, None, None] * freqs
    cos, sin = ang.cos(), ang.sin()

    def rope(x):                        # (B, S, H, hd), rotate-half
        a, b = x[..., :half], x[..., half:]
        return torch.cat([a * cos - b * sin, b * cos + a * sin], -1)

    causal = torch.ones(S, S, dtype=torch.bool, device=device).tril()
    with torch.no_grad():
        table = draw(cfg.vocab_size, d, std=0.02)
        # Gemma's normalizer is sqrt(d_model) in the compute dtype
        x = table[tok] * torch.tensor(math.sqrt(d),
                                      dtype=getattr(torch, cfg.dtype)).item()
        for _ in range(cfg.num_layers):
            h = norm(x)
            q, k, v = (h @ draw(d, H * hd, std=d ** -0.5) for _ in range(3))
            q, k = (rope(t.view(B, S, H, hd)).transpose(1, 2) for t in (q, k))
            v = v.view(B, S, H, hd).transpose(1, 2)
            att = (q @ k.transpose(-1, -2) * hd ** -0.5).masked_fill(
                ~causal, float("-inf")).softmax(-1)
            o = (att @ v).transpose(1, 2).reshape(B, S, H * hd)
            x = x + o @ draw(H * hd, d, std=(H * hd) ** -0.5)
            h = norm(x)
            gate = F.gelu(h @ draw(d, cfg.d_ff, std=d ** -0.5),
                          approximate="tanh")
            up = h @ draw(d, cfg.d_ff, std=d ** -0.5)
            x = x + (gate * up) @ draw(cfg.d_ff, d, std=cfg.d_ff ** -0.5)
        logits = norm(x) @ table.T
        lse = logits.logsumexp(-1)
        z_self = logits.gather(-1, tok[..., None])[..., 0]
        z_lab = logits.gather(-1, lab[..., None])[..., 0]
        want = (lse - z_lab + Z_LOSS * lse.square()).mean().item()
        zs = z_self.mean().item()
    del table, x, logits
    if device == "cuda":
        torch.cuda.empty_cache()
    return want, (f"a plain fp32 forward on weights drawn anew (seed "
                  f"{SEED + 1}; its own-token logit mean {zs:.4f})")


@contextlib.contextmanager
def traced_library(name: str, macro: str, reader: str):
    """``csrc/<name>.cu`` built with ``-D<macro>`` (a library of its own,
    through ``kbuild``'s cache) and loaded in place of the kernel's
    library while the block runs; yields it, with ``reader(out, blocks)``
    bound, the function that copies the trace to the host."""
    import ctypes
    flags = (f"-D{macro}",)
    kbuild.build([name], flags)
    lib = ctypes.CDLL(str(kbuild.lib_path(name, flags)))
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    getattr(lib, reader).argtypes = [ctypes.c_void_p, ctypes.c_int]
    getattr(lib, reader).restype = ctypes.c_int
    saved = kbuild._LOADED.get(name)
    kbuild._LOADED[name] = lib
    try:
        yield lib
    finally:
        if saved is None:
            del kbuild._LOADED[name]
        else:
            kbuild._LOADED[name] = saved


BWD_PHASES = ("ring wait", "score product", "exchange",
              "dV, dK, dQ products", "dQ staged and reduced")


def flash_bwd_phases() -> None:
    """clock64 cycles a tile of each phase of ``flash_bwd_sm90_wide`` (the
    bf16 backward at head dim 256), by consumer warpgroup, at Gemma-7B's
    training shape and RecurrentGemma-2B's cache-free one:
    ``csrc/flash_attention_bwd.cu`` built with ``-DFLASH_BWD_PHASE_TRACE``
    into a library of its own, whose kernel sums thread 0's cycles of
    each warpgroup by phase over a block's tiles."""
    from repro_torch.kernels import flash_attention as kflash
    with traced_library(kflash.BWD_NAME, "FLASH_BWD_PHASE_TRACE",
                        "flash_bwd_phase_read") as lib:
        for label, shp in (("gemma-7b", GEMMA_FLASH), ("rg", RG_FLASH)):
            case = (shp["B"], shp["S"], shp["S"], shp["Hq"], shp["Hkv"],
                    shp["D"], shp.get("window", 0), 0.0, True)
            q, k, v, do, kw = flash_inputs(case, torch.bfloat16, 200)
            o, lse = flash_attention_cuda(q, k, v, **kw)
            for _ in range(3):          # the last launch is the one read
                flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
            torch.cuda.synchronize()
            blocks = shp["B"] * shp["Hkv"] * -(-shp["S"] // 64)
            clk = np.zeros((blocks, 2, len(BWD_PHASES) + 1), np.int64)
            code = lib.flash_bwd_phase_read(clk.ctypes.data, blocks)
            if code:
                raise RuntimeError(f"flash_bwd_phase_read: cudaError {code}")
            tiles = clk[:, 0, -1].sum()
            for w in (0, 1):
                per = clk[:, w, :-1].sum(axis=0) / tiles
                log(f"flash_attention_bwd phases {label} warpgroup {w} "
                    f"(clock64 cycles a tile, {tiles} tiles in {blocks} "
                    f"blocks): " + ", ".join(
                        f"{n} {c:.0f}" for n, c in zip(BWD_PHASES, per))
                    + f"; total {per.sum():.0f}")


def gemma_train_phase(smi: str) -> dict:
    """Phase 30: Gemma-7B's widths at ``GEMMA_LAYERS`` layers through
    ``train_cell``, then the flash pair timed at its shape."""
    t0 = time.perf_counter()
    out = train_cell("gemma-7b", GEMMA_LAYERS, "gemma-7b train",
                     gemma_first_loss)
    for h in out["hist"]:
        log(f"gemma-7b train step {h['step']}: loss={h['loss']:.6f} "
            f"grad_norm={h['grad_norm']:.6f} step_s={h['step_s']:.4f} "
            f"tokens_per_s={h['tokens_per_s']:.1f}")
    out["flash"] = time_flash_attention(10, GEMMA_FLASH)
    log(f"time flash_attention bf16 B=4 S=T=1024 Hq=16 Hkv=16 D=256 causal "
        f"({smi}) " + fields(out["flash"]))
    flash_bwd_phases()
    log(f"phase 30: {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 25: sharded training on NCCL
# ---------------------------------------------------------------------------
SHARDED_STEPS = 3


def compression_leg(grads: dict, group, smi: str) -> dict:
    """Phase 25 (c): int8 block compression of full-width gradients, one
    tensor at a time: every element within half its block's scale, the
    residual carried (what a second pass sends plus what it keeps equals
    the gradient plus the first residual), ``psum_compressed`` over a
    group of one equal to ``dequantize``; then the pass's device time."""
    from repro_torch.distributed import compression as Q
    worst, carry, n_el, n_blk = 0.0, 0.0, 0, 0
    for name, g in grads.items():
        comp, err = Q.compress_with_feedback({name: g},
                                             {name: torch.zeros_like(g)})
        c = comp[name]
        deq = Q.dequantize(c)
        half = (0.5 * c.scale).repeat_interleave(Q.BLOCK)[:g.numel()]
        slack = half + 2.0 ** -22 * g.float().abs().reshape(-1)
        worst = max(worst, float(((deq - g).abs().reshape(-1)
                                  / slack).max()))
        if not torch.equal(err[name], g.float() - deq):
            raise AssertionError(f"compression: {name}'s residual is not "
                                 "the gradient minus what was sent")
        if not torch.equal(Q.psum_compressed(comp, group)[name], deq):
            raise AssertionError(f"compression: psum_compressed of {name} "
                                 "over one rank is not dequantize")
        comp2, err2 = Q.compress_with_feedback({name: g}, err)
        kept = Q.dequantize(comp2[name]) + err2[name]
        carry = max(carry, float((kept - (g.float() + err[name])).abs().max()
                                 / g.float().abs().max().clamp(min=1e-30)))
        n_el += g.numel()
        n_blk += c.scale.numel()
        del comp, err, c, deq, half, slack, comp2, err2, kept
    if worst > 1.0 or carry > 1e-6:
        raise AssertionError(f"compression: error / half scale {worst}, "
                             f"carried residual off by {carry}")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for name, g in grads.items():
        comp, _ = Q.compress_with_feedback({name: g},
                                           {name: torch.zeros_like(g)})
        Q.psum_compressed(comp, group)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    log(f"sharded compression ({smi}): {len(grads)} gradients, {n_el} "
        f"elements, int8 payload {n_blk * Q.BLOCK} B + scales "
        f"{4 * n_blk} B against {4 * n_el} B fp32; max "
        f"|dequantize - g| / (scale / 2) {worst:.6f} (<= 1); carried "
        f"residual rel err {carry:.3e} (<= 1e-6); psum_compressed over one "
        f"rank == dequantize; compress + psum pass {ms:.3f} ms (CUDA "
        f"events, one pass)")
    return dict(worst=worst, carry=carry, ms=ms)


def checkpoint_leg(mesh, smi: str) -> dict:
    """Phase 25 (b): a train_100m-config state after one sharded step,
    saved through the sharded path (the async writer), reloaded into a
    one-device state and onto a (1, 1) mesh, bit for bit."""
    from torch.distributed.tensor import DTensor
    from repro_torch.examples import train_100m
    from repro_torch.training import checkpoint as CKPT
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.trainer import build_trainer
    cfg = train_100m.config_100m()
    tr = build_trainer(cfg, mesh, total_steps=10, warmup_steps=2,
                       device="cuda")
    state = tr.init_state(SEED)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in
             next(SyntheticLM(cfg, 256, 8, seed=SEED)).items()}
    state, _ = tr.train_step(state, batch)
    ckpt = ROOT / "build" / "chip_smoke_sharded_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    writer = CKPT.AsyncCheckpointer(str(ckpt))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    writer.save(state, 1, extra={"step": 1})
    stall = time.perf_counter() - t0
    writer.wait()
    write_s = time.perf_counter() - t0
    live = {k: (v.to_local() if isinstance(v, DTensor) else v)
            for k, v in CKPT.state_leaves(state).items()}
    n_dt = sum(isinstance(v, DTensor)
               for v in CKPT.state_leaves(state).values())
    with open(ckpt / "step_00000001" / "index.json") as f:
        files = sum(len(e["shards"]) for e in json.load(f)["leaves"].values())
    same = {}
    for label, m in (("one device", None), ("mesh (1, 1)", mesh)):
        fresh = build_trainer(cfg, m, device="cuda").init_state(SEED + 1)
        (loaded, extra), load_s = sync_time(
            lambda: CKPT.load(str(ckpt), fresh))
        got = {k: (v.to_local() if isinstance(v, DTensor) else v)
               for k, v in CKPT.state_leaves(loaded).items()}
        same[label] = (set(got) == set(live) and extra == {"step": 1}
                       and all(torch.equal(got[k], live[k]) for k in live))
        log(f"sharded checkpoint reload onto {label}: "
            f"{'bit for bit' if same[label] else 'DIFFERENT'}, "
            f"{load_s:.3f} s")
        del fresh, loaded, got
    shutil.rmtree(ckpt)
    nbytes = sum(t.numel() * t.element_size() for t in live.values())
    log(f"sharded checkpoint ({smi}): train_100m config, {len(live)} leaves "
        f"({n_dt} DTensors), {files} shard files, {nbytes} B; save stall "
        f"{stall:.3f} s (host clock: the copy to the host), write + commit "
        f"{write_s:.3f} s")
    if not all(same.values()) or n_dt == 0:
        raise AssertionError(f"sharded checkpoint: reloads {same}, "
                             f"{n_dt} DTensor leaves")
    return dict(stall=stall, write_s=write_s)


def rel_diffs(hist: list, ref: list, key: str) -> list:
    return [abs(a[key] - b[key]) / abs(b[key]) for a, b in zip(hist, ref)]


def sharded_phase(p13: dict, smi: str) -> dict:
    """Phase 25: (a) Qwen3-8B's widths at 8 layers, 3 steps of the
    sharded trainer on a (1, 1) NCCL mesh from ``launch/mesh.py`` under
    the kernels, then 2 under ``chunked``, each held to phase 13's
    one-device steps of the same attention (same seed, same batches);
    (b) the sharded checkpoint; (c) compression on (a)'s gradients.

    The kernel path is not reproducible bit for bit on the card: the
    flash backward sums dQ with fp32 atomics, whose order varies, and
    rounds it to bf16, so a one-device rerun leaves phase 13's steps by
    1e-4 (printed here).  ``chunked`` is reproducible, so the 1e-5
    equality is held there; the kernel path's sharded steps are held to
    1e-2, phase 13's tolerance for the kernels against ``chunked``:
    well over that spread, and a wrong gradient share moves the grad
    norm by a factor."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.trainer import build_trainer
    t0 = time.perf_counter()
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    cfg = dataclasses.replace(get_config("qwen3-8b"), num_layers=8,
                              remat="full", attn_impl="pallas")
    run = dict(seq_len=1024, global_batch=4, seed=SEED, log_every=1,
               device="cuda", log=log)
    log(f"phase 25: {dist.get_backend()} world {dist.get_world_size()}, "
        f"mesh {mesh.mesh_dim_names} {tuple(mesh.mesh.shape)}; qwen3-8b "
        f"widths at {cfg.num_layers} layers, batch 4x1024, "
        f"{SHARDED_STEPS} steps")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    (state, hist), wall = sync_time(lambda: run_training(
        cfg, steps=SHARDED_STEPS, mesh=mesh, **run))
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if not all(isinstance(v, DTensor) for v in state.params.values()):
        raise AssertionError("phase 25: the state is not DTensors")
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want["flash_attention"] = 2 * cfg.num_layers * SHARDED_STEPS
    want["flash_attention_bwd"] = cfg.num_layers * SHARDED_STEPS
    ld, gd = rel_diffs(hist, p13["hist"], "loss"), \
        rel_diffs(hist, p13["hist"], "grad_norm")
    for h in hist:
        log(f"sharded train step {h['step']}: loss={h['loss']:.6f} "
            f"grad_norm={h['grad_norm']:.6f} step_s={h['step_s']:.4f} "
            f"tokens_per_s={h['tokens_per_s']:.1f}")
    log(f"sharded train ({smi}): wall_s={wall:.3f} max_memory_allocated="
        f"{peak} launches {launches} (want {want}); against phase 13's "
        f"one-device steps: loss rel diff {[f'{d:.2e}' for d in ld]}, grad "
        f"norm rel diff {[f'{d:.2e}' for d in gd]} (tol 1e-2)")
    if launches != want or len(ld) != SHARDED_STEPS or max(ld + gd) > 1e-2:
        raise AssertionError(f"phase 25: launches {launches} (want {want}) "
                             f"or the steps leave the one-device trainer's")
    tr = build_trainer(cfg, mesh, total_steps=5, device="cuda")
    prof = profile_train_step(cfg, state, label="sharded train", trainer=tr)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in
             next(SyntheticLM(cfg, 1024, 4, seed=SEED + 2)).items()}
    _, grads = tr.grads(state, batch)
    comp = compression_leg(grads, mesh.get_group("data"), smi)
    del grads, state, tr
    torch.cuda.empty_cache()
    # the kernel path's own spread: the one-device trainer again
    state, rerun = run_training(cfg, steps=SHARDED_STEPS,
                                **dict(run, log=lambda _: None))
    del state
    torch.cuda.empty_cache()
    spread = max(rel_diffs(rerun, p13["hist"], "loss")
                 + rel_diffs(rerun, p13["hist"], "grad_norm"))
    # chunked attention is reproducible: the sharded steps equal the
    # one-device ones there
    plain = dataclasses.replace(cfg, attn_impl="chunked")
    ops.reset_launches()
    state, phist = run_training(plain, steps=len(p13["plain_hist"]),
                                mesh=mesh, **dict(run, log=lambda _: None))
    del state
    torch.cuda.empty_cache()
    pd = rel_diffs(phist, p13["plain_hist"], "loss") \
        + rel_diffs(phist, p13["plain_hist"], "grad_norm")
    log(f"sharded train vs one device ({smi}): the kernel path rerun on "
        f"one device leaves phase 13's steps by {spread:.2e} (max rel, "
        f"losses and grad norms: the flash backward's dQ atomics); under "
        f"chunked the sharded steps leave phase 13's chunked ones by "
        f"{[f'{d:.2e}' for d in pd]} (tol 1e-5)")
    if max(pd) > 1e-5 or ops.LAUNCHES["flash_attention"]:
        raise AssertionError("phase 25: under chunked the sharded steps "
                             "leave the one-device trainer's")
    ck = checkpoint_leg(mesh, smi)
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    log(f"phase 25: {time.perf_counter() - t0:.1f} s")
    return dict(hist=hist, launches=launches, peak=peak, prof=prof,
                comp=comp, ckpt=ck, spread=spread, chunked=pd,
                plain_hist=phist)


# ---------------------------------------------------------------------------
# phase 26: sharded serving on NCCL, the decode kernel at tensor-parallel
# shapes, the dry run's plans
# ---------------------------------------------------------------------------
# Qwen3-8B's decode at tensor-parallel degrees 2, 4 and 8: its 32 query /
# 8 kv heads over model as 16/4, 8/2 and 4/1 a rank; and its length
# shard, every head over a sixteenth of T 256 (kv 8 on a 16-way axis),
# masked by the slice's stored positions, with the log-sum-exp output
TP_DECODE = [("tp2", dict(SERVE, Hq=16, Hkv=4)),
             ("tp4", dict(SERVE, Hq=8, Hkv=2)),
             ("tp8", dict(SERVE, Hq=4, Hkv=1))]
LEN_SHARDS = 16
LEN_SHARD = dict(SERVE, T=SERVE["T"] // LEN_SHARDS)
LEN_ROWS = [0, 3, 1, 0, 15, 0, 5, 15]      # each row's slice of the 16
LEN_LENGTHS = [130, 200, 17, 0, 256, 5, 90, 241]
DRYRUN_CELLS = [("qwen3-8b", "decode_32k"), ("qwen3-8b", "train_4k"),
                ("llama4-maverick-400b-a17b", "decode_32k")]
DRYRUN_DIR = ROOT / "build" / "dryrun_torch_chip"
DRYRUN_CARD = "qwen3-8b__decode_32k__1x1__card.json"


def start_dryrun() -> subprocess.Popen:
    """Phase 26 (c), started after the build so that its host work (one
    core; the card is hidden from it) overlaps the card's phases: the dry
    run of ``DRYRUN_CELLS`` on the single-pod mesh under ``pallas`` (the
    card's attention path), then the plan of (a)'s own cell (Qwen3-8B
    decode at B 8, T 256 on the (1, 1) mesh), then phase 28 (d)'s
    decode_32k cells of the tensor-parallel families."""
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    common = ["--attn-impl", "pallas", "--out-dir", str(DRYRUN_DIR)]
    cells = [["--arch", a, "--shape", sh, "--mesh", "single"] + common
             for a, sh in DRYRUN_CELLS]
    # phase 27 (c): the train cell with the sequence-sharded residual
    cells.append(["--arch", "qwen3-8b", "--shape", "train_4k", "--mesh",
                  "single", "--seq-parallel"] + common)
    cells.append(["--arch", "qwen3-8b", "--shape", "decode_32k",
                  "--mesh-shape", "1x1", "--batch", str(SERVE["B"]),
                  "--seq-len", str(SERVE["T"]), "--tag", "card"] + common)
    # phase 28 (d): the tensor-parallel families' decode cells
    cells += [["--arch", a, "--shape", "decode_32k", "--mesh", "single"]
              + common for a in FAMILY_DRYRUN]
    code = "\n".join([
        "import json, sys, time",
        "import torch",
        "print('dryrun: torch', torch.__version__, flush=True)",
        "from torch.testing._internal.distributed.fake_pg import FakeStore",
        "print('dryrun: torch.testing FakeStore imports', flush=True)",
        "from repro_torch.launch import dryrun",
        "rc = 0",
        "for argv in json.loads(sys.argv[1]):",
        "    t = time.perf_counter()",
        "    r = dryrun.main(argv)",
        "    print('dryrun: %s: %.1f s, rc %d' % (' '.join(argv[:4]),",
        "          time.perf_counter() - t, r), flush=True)",
        "    rc |= r",
        "sys.exit(rc)"])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen([sys.executable, "-c", code, json.dumps(cells)],
                            env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    import atexit
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def check_len_shard(dtype) -> float:
    """The kernel's output and log-sum-exp on a length shard against the
    plain version's (phase 4's tolerance; lse 1e-5 fp32, 1e-2 bf16), and
    the whole T 256 cache cut into its 16 slices: the slices' outputs
    merged by their lse equal the kernel on the whole cache.  Returns
    the shard's max |kernel - plain| of the output."""
    B, T, Hq, Hkv, D = (SERVE[k] for k in ("B", "T", "Hq", "Hkv", "D"))
    Tl = LEN_SHARD["T"]
    q, k, v, lens = attn_inputs(B, T, Hq, Hkv, D, LEN_LENGTHS, dtype, SEED)
    scale = 1.0 / math.sqrt(D)
    ar = torch.arange(Tl, dtype=torch.int32, device="cuda")
    pos = torch.stack([ar + Tl * r for r in LEN_ROWS])
    rows = torch.arange(B, device="cuda")[:, None]
    idx = pos.long()
    ks, vs = k[rows, idx].contiguous(), v[rows, idx].contiguous()
    o, lse = decode_attention_cuda(q, ks, vs, lens, scale=scale,
                                   positions=pos, return_lse=True)
    wo, wl = decode_attention_ref(q, ks, vs, lens, scale=scale,
                                  positions=pos, return_lse=True)
    torch.cuda.synchronize()
    err = (o.float() - wo.float()).abs().max().item()
    lse_tol = 1e-5 if dtype == torch.float32 else 1e-2
    lse_err = (lse - wl).abs().max().item()
    parts = [decode_attention_cuda(
        q, k[:, r * Tl:(r + 1) * Tl], v[:, r * Tl:(r + 1) * Tl], lens,
        scale=scale, positions=(ar + Tl * r)[None].expand(B, Tl)
        .contiguous(), return_lse=True) for r in range(LEN_SHARDS)]
    os_ = torch.stack([p[0].float() for p in parts])
    ls = torch.stack([p[1] for p in parts])[:, :, None, :]
    w = torch.exp(ls - ls.amax(dim=0))
    merged = (w[..., None] * os_).sum(0) / w.sum(0)[..., None]
    whole = decode_attention_cuda(q, k, v, lens, scale=scale)
    merge_err = (merged - whole.float()).abs().max().item()
    log(f"check decode_attention len_shard {str(dtype):<15} "
        f"max_abs_err={err:.3e} tol={TOL[dtype]:g} lse_max_abs_err="
        f"{lse_err:.3e} tol={lse_tol:g}; {LEN_SHARDS} slices merged by lse "
        f"against the whole T {T}: max_abs_err={merge_err:.3e}")
    if err > TOL[dtype] or lse_err > lse_tol or merge_err > TOL[dtype] \
            or not torch.isfinite(o).all():
        raise AssertionError(f"decode_attention len_shard {dtype}: the "
                             "kernel or its lse disagrees")
    return err


def sharded_serve_phase(p5: dict, decode_device_ms: float,
                        dry: subprocess.Popen, smi: str) -> dict:
    """Phase 26: (a) full-width, full-depth Qwen3-8B serves phase 5's
    ``serve_mixed_slo`` through ``ModelExecutor(mesh=)`` on a (1, 1) NCCL
    mesh: 12 of 12 done, decode launches exactly layers x steps, the
    RunReport phase 5's, the bytes held after init against the plan's
    argument bytes (1 %) and a decode step's peak against its live bytes;
    (b) the kernel at the tensor-parallel local shapes and on a length
    shard with its lse, checked and timed; (c) the dry run's records."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    t0 = time.perf_counter()
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    cfg = dataclasses.replace(get_config("qwen3-8b"), attn_impl="pallas")
    spec = serve_spec(cfg, SEED)
    log(f"phase 26: {dist.get_backend()} world {dist.get_world_size()}, "
        f"mesh {mesh.mesh_dim_names} {tuple(mesh.mesh.shape)}; qwen3-8b "
        f"{cfg.num_layers} layers through the mesh branch")
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    rt = ServeRuntime.from_spec(
        spec, executor=lambda e: ModelExecutor(cfg, e, rng_seed=SEED,
                                               device="cuda", mesh=mesh))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    ex = rt.engine.exe
    if ex.fns.layout is None:
        raise AssertionError("phase 26: the executor took no mesh branch")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    rep = rt.run(spec).validate()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    done = rt.engine.done
    steps = rep.extras["decode_steps"]
    generated = sum(len(r.generated) for r in done)
    log(f"phase 26 serve: steps={int(rep.duration)} "
        f"prefill_chunks={rep.extras['prefill_chunks']} decode_steps={steps} "
        f"generated_tokens={generated} max_memory_allocated={peak}; {smi}")
    if len(done) != 12 or any(r.status != RequestStatus.DONE for r in done):
        raise AssertionError("phase 26: not every request ended done")
    if launches["decode_attention"] != cfg.num_layers * steps or any(
            v for k, v in launches.items() if k != "decode_attention"):
        raise AssertionError(f"phase 26: launches {launches} (want "
                             f"decode_attention {cfg.num_layers} x {steps})")
    if rep.to_json() != p5["json"]:
        raise AssertionError("phase 26: the RunReport differs from phase 5's")
    log("check: phase 26's RunReport JSON equals phase 5's; decode "
        f"launches {launches['decode_attention']} = {cfg.num_layers} x "
        f"{steps}")
    B = SERVE["B"]
    tokens, lengths = np.ones(B, np.int32), np.full(B, 128, np.int32)
    active = np.ones(B, bool)
    ex.decode(tokens, lengths, active)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ex.decode(tokens, lengths, active)
    torch.cuda.synchronize()
    step_peak = torch.cuda.max_memory_allocated() - before
    dev_ms = profile_step("qwen3-8b full-width decode step, (1, 1) NCCL "
                          "mesh", lambda: ex.decode(tokens, lengths, active),
                          kernel="decode_attention")
    log(f"phase 26 decode step device time {dev_ms:.3f} ms against phase "
        f"7's {decode_device_ms:.3f} ms (ratio "
        f"{dev_ms / decode_device_ms:.4f})")
    del rt, ex
    torch.cuda.empty_cache()
    dist.destroy_process_group()

    # (b) the kernel at the tensor-parallel shapes
    errs = []
    for i, (name, shp) in enumerate(TP_DECODE):
        lens = [shp["T"], 1, 0, 7, 100, 129, 64, shp["T"] - 1]
        for dtype in (torch.bfloat16, torch.float32):
            errs.append(check_decode_case(name, shp, lens, 0, 0.0, False,
                                          None, dtype=dtype, seed=SEED + i))
    for dtype in (torch.bfloat16, torch.float32):
        errs.append(check_len_shard(dtype))
    times = [time_decode_attention(SERVE["T"], 100, shape=shp)
             for _, shp in TP_DECODE]
    ar = torch.arange(LEN_SHARD["T"], dtype=torch.int32, device="cuda")
    len_pos = torch.stack([ar + LEN_SHARD["T"] * r for r in LEN_ROWS])
    times.append(time_decode_attention(LEN_SHARD["T"], 100, shape=LEN_SHARD,
                                       positions=len_pos,
                                       lengths=[SERVE["T"]] * B, lse=True))
    for (name, _), t in zip(TP_DECODE + [("len_shard_lse", None)], times):
        log(f"time decode_attention bf16 {name} (ms, library_ms: CUDA-graph "
            f"replays; eager_ms, library_eager_ms, plain_ms: launched from "
            f"Python) " + fields(t))

    # (c) the dry run
    out, _ = dry.communicate(timeout=900)
    for line in out.strip().splitlines():
        log(f"  {line}")
    if dry.returncode != 0:
        raise AssertionError(f"phase 26: the dry run exited {dry.returncode}")
    recs = {}
    for a, sh in DRYRUN_CELLS:
        rec = json.loads((DRYRUN_DIR / f"{a}__{sh}__singlepod.json")
                         .read_text())
        if "skipped" in rec or rec["cost"]["flops"] <= 0:
            raise AssertionError(f"phase 26: no plan of {a} x {sh}")
        recs[f"{a} {sh}"] = rec
        log(f"phase 26 dry run {a} x {sh} x singlepod: " + json.dumps(rec))
    plan = json.loads((DRYRUN_DIR / DRYRUN_CARD).read_text())
    log("phase 26 dry run of the card's cell: " + json.dumps(plan))
    args = plan["memory"]["argument_bytes"]
    gap = held / args - 1
    log(f"phase 26 memory: held after init {held} B against the plan's "
        f"argument bytes {args} B (rel {gap:+.5f}, limit 0.01); a decode "
        f"step's peak above its start {step_peak} B against the plan's "
        f"live bytes {plan['memory']['temp_bytes']} B (rel "
        f"{step_peak / max(plan['memory']['temp_bytes'], 1) - 1:+.4f})")
    if abs(gap) > 0.01:
        raise AssertionError("phase 26: the plan's argument bytes miss the "
                             "bytes held after init by more than 1 %")
    log(f"phase 26: {time.perf_counter() - t0:.1f} s")
    return dict(launches=launches, err=max(errs), times=times, recs=recs,
                held=held, step_peak=step_peak, plan=plan, dev_ms=dev_ms)


# ---------------------------------------------------------------------------
# phase 27: training's tensor-parallel compute with seq_parallel on NCCL,
# the flash pair at the TP-local training shapes, the dry run's train plans
# ---------------------------------------------------------------------------
# Qwen3-8B's train_4k cell on the 16 x 16 mesh: a rank's microbatch is 256
# rows / 8 accumulation steps / 16 data ranks = 2 rows of 4096; its 32 / 8
# heads of 128 over model 4 and 16 are 8 / 2 and 2 / 1 a rank (over 16 the
# kv columns are gathered and each rank keeps the kv head of its 2 query
# heads)
TP_FLASH = [("tp4", dict(B=2, S=4096, Hq=8, Hkv=2, D=128)),
            ("tp16", dict(B=2, S=4096, Hq=2, Hkv=1, D=128))]
# the plan of that cell (pallas) by the trainer that gathered every weight
# whole, every model rank repeating the blocks: live bytes a device and its
# collectives
WHOLE_TRAIN_PLAN = {"temp_bytes": 37_924_475_916,
                   "all-reduce": (432, 30_274_408_488),
                   "all-gather": (505, 2_000_551_936)}
TRAIN_PLANS = (("without seq_parallel", "qwen3-8b__train_4k__singlepod.json"),
               ("with seq_parallel",
                "qwen3-8b__train_4k__singlepod__seqpar.json"))


def time_flash_tp(shape: dict, per_graph: int = 5, replays: int = 10) -> dict:
    """``time_flash_attention`` at ``shape`` (eager CUDA events: the
    kernels, the plain versions, SDPA forward and backward, the bounds),
    plus the kernels' and SDPA's forward as CUDA-graph replays."""
    r = time_flash_attention(10, shape)
    case = (shape["B"], shape["S"], shape["S"], shape["Hq"], shape["Hkv"],
            shape["D"], 0, 0.0, shape.get("causal", True))
    q, k, v, do, kw = flash_inputs(case, torch.bfloat16, 300)
    o, lse = flash_attention_cuda(q, k, v, **kw)
    lq, lk, lv = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    r["graph_fwd_ms"] = graph_ms(lambda: flash_attention_cuda(q, k, v, **kw),
                                 per_graph, replays)
    r["graph_bwd_ms"] = graph_ms(lambda: flash_attention_bwd_cuda(
        q, k, v, o, lse, do, **kw), per_graph, replays)
    r["library_graph_fwd_ms"] = graph_ms(
        lambda: F.scaled_dot_product_attention(
            lq, lk, lv, is_causal=kw["causal"], scale=kw["scale"],
            enable_gqa=True),
        per_graph, replays)
    return r


def check_train_plans() -> dict:
    """Phase 27 (c): the dry run's train_4k plans with and without
    ``seq_parallel`` (run in phase 26's subprocess) against the
    whole-weight trainer's; the live bytes must fall, and further with
    ``seq_parallel``."""
    plans = {}
    for label, fname in TRAIN_PLANS:
        rec = json.loads((DRYRUN_DIR / fname).read_text())
        if "skipped" in rec:
            raise AssertionError(f"phase 27: no plan {label}")
        m, c = rec["memory"], rec["collectives"]
        plans[label] = rec
        log(f"phase 27 dry run qwen3-8b x train_4k x singlepod {label}: "
            f"live bytes {m['temp_bytes']} B ("
            f"{m['temp_bytes'] / WHOLE_TRAIN_PLAN['temp_bytes']:.4f} of the "
            f"whole-weight plan's {WHOLE_TRAIN_PLAN['temp_bytes']} B), "
            "argument bytes "
            f"{m['argument_bytes']} B, flops {rec['cost']['flops']:.4e}; "
            "collectives " + ", ".join(
                f"{k} {v['count']}x {v['bytes']:.4e} B" for k, v in c.items()
                if isinstance(v, dict) and v["count"])
            + f" (total {c['total_bytes']:.4e} B); whole-weight: "
            + ", ".join(
                f"{k} {WHOLE_TRAIN_PLAN[k][0]}x {WHOLE_TRAIN_PLAN[k][1]:.4e} B"
                for k in ("all-reduce", "all-gather")))
    live = [plans[label]["memory"]["temp_bytes"] for label, _ in TRAIN_PLANS]
    if not live[1] < live[0] < WHOLE_TRAIN_PLAN["temp_bytes"]:
        raise AssertionError(f"phase 27: live bytes {live} do not fall below "
                             "the whole-weight plan's, or not further with "
                             "seq_parallel")
    return plans


def tp_train_phase(p13: dict, p25: dict, smi: str) -> dict:
    """Phase 27: (a) phase 25's cell (Qwen3-8B's widths at 8 layers, 3
    steps under the kernels, phase 13's seed and batches) through the
    trainer's tensor-parallel compute with ``seq_parallel=True`` on a
    (1, 1) NCCL mesh, held to phase 13's one-device steps (1e-2, as phase
    25), then 2 steps under ``chunked`` held to phase 25's chunked ones
    bit for bit; (b) the flash pair at the TP-local shapes of Qwen3-8B's
    train_4k, checked and timed; (c) the dry run's train_4k plans with
    and without ``seq_parallel`` against the whole-weight trainer's.

    At world 1 ``model`` is 1: no weight is sliced and the residual stays
    whole, so (a) exercises the plumbing only; the sharded compute is
    held on gloo at world 4 on the CPU (tests/test_torch_tp_training.py)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training.trainer import build_trainer
    t0 = time.perf_counter()
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    cfg = dataclasses.replace(get_config("qwen3-8b"), num_layers=8,
                              remat="full", attn_impl="pallas")
    run = dict(seq_len=1024, global_batch=4, seed=SEED, log_every=1,
               device="cuda", log=log, mesh=mesh, seq_parallel=True)
    log(f"phase 27: {dist.get_backend()} world {dist.get_world_size()}, "
        f"mesh {mesh.mesh_dim_names} {tuple(mesh.mesh.shape)}; qwen3-8b "
        f"widths at {cfg.num_layers} layers, batch 4x1024, {SHARDED_STEPS} "
        "steps, tensor-parallel compute with seq_parallel=True: at world 1 "
        "(model 1) no weight is sliced and the residual stays whole, so "
        "this exercises the plumbing only")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    (state, hist), wall = sync_time(lambda: run_training(
        cfg, steps=SHARDED_STEPS, **run))
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want["flash_attention"] = 2 * cfg.num_layers * SHARDED_STEPS
    want["flash_attention_bwd"] = cfg.num_layers * SHARDED_STEPS
    ld, gd = rel_diffs(hist, p13["hist"], "loss"), \
        rel_diffs(hist, p13["hist"], "grad_norm")
    for h in hist:
        log(f"tp train step {h['step']}: loss={h['loss']:.6f} "
            f"grad_norm={h['grad_norm']:.6f} step_s={h['step_s']:.4f} "
            f"tokens_per_s={h['tokens_per_s']:.1f}")
    log(f"tp train ({smi}): wall_s={wall:.3f} max_memory_allocated={peak} "
        f"launches {launches} (want {want}); against phase 13's one-device "
        f"steps: loss rel diff {[f'{d:.2e}' for d in ld]}, grad norm rel "
        f"diff {[f'{d:.2e}' for d in gd]} (tol 1e-2)")
    if launches != want or len(ld) != SHARDED_STEPS or max(ld + gd) > 1e-2:
        raise AssertionError(f"phase 27: launches {launches} (want {want}) "
                             "or the steps leave the one-device trainer's")
    tr = build_trainer(cfg, mesh, total_steps=5, device="cuda",
                       seq_parallel=True)
    prof = profile_train_step(cfg, state, label="tp train (seq_parallel)",
                              trainer=tr)
    del state, tr
    torch.cuda.empty_cache()
    plain = dataclasses.replace(cfg, attn_impl="chunked")
    ops.reset_launches()
    state, phist = run_training(plain, steps=len(p25["plain_hist"]),
                                **dict(run, log=lambda _: None))
    del state
    torch.cuda.empty_cache()
    same = all((a["loss"], a["grad_norm"]) == (b["loss"], b["grad_norm"])
               for a, b in zip(phist, p25["plain_hist"]))
    pd = rel_diffs(phist, p25["plain_hist"], "loss") \
        + rel_diffs(phist, p25["plain_hist"], "grad_norm")
    log(f"tp train under chunked against phase 25's chunked steps: losses "
        f"{[h['loss'] for h in phist]} vs "
        f"{[h['loss'] for h in p25['plain_hist']]}, grad norms "
        f"{[h['grad_norm'] for h in phist]} vs "
        f"{[h['grad_norm'] for h in p25['plain_hist']]}: "
        + ("bit for bit" if same else
           f"NOT bit for bit, max rel diff {max(pd):.2e} (tol 1e-5)"))
    if ops.LAUNCHES["flash_attention"] or max(pd) > 1e-5:
        raise AssertionError("phase 27: under chunked the steps leave phase "
                             "25's")
    dist.destroy_process_group()

    # (b) the flash pair at the TP-local training shapes
    errs = []
    for i, (name, shp) in enumerate(TP_FLASH):
        case = (shp["B"], shp["S"], shp["S"], shp["Hq"], shp["Hkv"],
                shp["D"], 0, 0.0, True)
        for dtype in (torch.bfloat16, torch.float32):
            errs.append(check_flash_case(f"train_4k_{name}", case, dtype,
                                         SEED + 40 + i))
    times = {}
    for name, shp in TP_FLASH:
        times[name] = t = time_flash_tp(shp)
        log(f"time flash_attention bf16 train_4k {name} B={shp['B']} "
            f"S=T={shp['S']} Hq={shp['Hq']} Hkv={shp['Hkv']} D={shp['D']} "
            "causal (graph_*: CUDA-graph replays; the rest eager CUDA "
            "events) " + fields(t))
        torch.cuda.empty_cache()

    plans = check_train_plans()
    log(f"phase 27: {time.perf_counter() - t0:.1f} s")
    return dict(hist=hist, launches=launches, peak=peak, prof=prof,
                chunked_same=same, chunked_diff=pd, err=errs, times=times,
                plans=plans, wall=wall)


# ---------------------------------------------------------------------------
# phase 28: tensor-parallel compute for MLA, the SSD and RG-LRU mixers and
# the encoder-decoder: the four serves through the mesh branch at world 1,
# the kernels at the families' TP-local shapes, Whisper's TP trainer and
# the dry run's decode_32k plans
# ---------------------------------------------------------------------------
# the families' decode_32k cells planned on the single pod (16 x 16) in
# phase 26's dry-run subprocess
FAMILY_DRYRUN = ("mamba2-370m", "recurrentgemma-2b", "whisper-large-v3",
                 "deepseek-v2-lite-16b")
# the decode kernel at the TP-local shapes: Whisper's 20 heads of 64 over
# model 4 (5 a rank; the self-attention's cache T 256, the cross K/V's
# 1500 frames, every frame counted)
TP28_DECODE = [("whisper_self_tp4", dict(B=8, T=256, Hq=5, Hkv=5, D=64)),
               ("whisper_cross_tp4", dict(B=8, T=1500, Hq=5, Hkv=5, D=64))]
# RecurrentGemma-2B's local layers: the single kv head cannot split, so
# its 2048-entry ring's length goes over model (512 entries a rank at 4,
# 128 at 16), every one of the 10 heads attending its slice, masked by
# the stored positions, with the log-sum-exp (rows past the ring)
TP28_RING = [("rg_ring_tp4", 4), ("rg_ring_tp16", 16)]
# Whisper's encoder at model 4: non-causal, B 8, S = T 1500, 5 on 5 of 64
TP28_FLASH = ("whisper_enc_tp4",
              dict(B=8, S=1500, Hq=5, Hkv=5, D=64, causal=False))
# one prefill chunk of Mamba2-370M (B 8, S 32) on 8 (model 4) and 2
# (model 16) of its 32 heads of 64, state 128; of RecurrentGemma-2B on
# 640 and 160 of its 2560 channels
TP28_SSD = [("mamba2_tp4", (8, 32, 8, 64, 1, 128, 256)),
            ("mamba2_tp16", (8, 32, 2, 64, 1, 128, 256))]
TP28_RGLRU = [("rg_tp4", (8, 32, 640)), ("rg_tp16", (8, 32, 160))]


def check_ring_shard(name: str, n: int, dtype) -> float:
    """RecurrentGemma's wrapped 2048-entry ring (lengths 2049-4000, window
    2048) cut into ``n`` slices of its length: each slice's output and
    lse against the plain version's (phase 4's tolerance; lse 1e-5 fp32,
    1e-2 bf16), and the slices merged by their lse against the kernel on
    the whole ring.  Returns the slices' max |kernel - plain|."""
    shp = dict(RG_DECODE, T=2048)
    B, T, Hq, Hkv, D = (shp[k] for k in ("B", "T", "Hq", "Hkv", "D"))
    Tl = T // n
    q, k, v, lens = attn_inputs(B, T, Hq, Hkv, D, RG_RING_LENGTHS, dtype,
                                SEED + 50 + n)
    pos = ring_positions(RG_RING_LENGTHS, T, SEED)
    kw = dict(scale=1.0 / math.sqrt(D), window=2048)
    lse_tol = 1e-5 if dtype == torch.float32 else 1e-2
    err = lse_err = 0.0
    parts = []
    for r in range(n):
        sl = slice(r * Tl, (r + 1) * Tl)
        ks, vs = k[:, sl].contiguous(), v[:, sl].contiguous()
        ps = pos[:, sl].contiguous()
        o, lse = decode_attention_cuda(q, ks, vs, lens, positions=ps,
                                       return_lse=True, **kw)
        wo, wl = decode_attention_ref(q, ks, vs, lens, positions=ps,
                                      return_lse=True, **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(o).all():
            raise AssertionError(f"decode_attention {name}: not finite")
        err = max(err, (o.float() - wo.float()).abs().max().item())
        lse_err = max(lse_err, (lse - wl).abs().max().item())
        parts.append((o, lse))
    os_ = torch.stack([o.float() for o, _ in parts])
    ls = torch.stack([lse for _, lse in parts])[:, :, None, :]
    w = torch.exp(ls - ls.amax(dim=0))
    merged = (w[..., None] * os_).sum(0) / w.sum(0)[..., None]
    whole = decode_attention_cuda(q, k, v, lens, positions=pos, **kw)
    merge_err = (merged - whole.float()).abs().max().item()
    log(f"check decode_attention {name} {str(dtype):<15} {n} slices of "
        f"{Tl}: max_abs_err={err:.3e} tol={TOL[dtype]:g} lse_max_abs_err="
        f"{lse_err:.3e} tol={lse_tol:g}; merged by lse against the whole "
        f"ring: max_abs_err={merge_err:.3e}")
    if err > TOL[dtype] or lse_err > lse_tol or merge_err > TOL[dtype]:
        raise AssertionError(f"decode_attention {name} {dtype}: the kernel "
                             "or its lse disagrees")
    return err


def serve_family_mesh(arch: str, one: dict, mesh, smi: str) -> dict:
    """Phase 28 (a) for one family: full width and depth through
    ``ModelExecutor(mesh=)`` on the (1, 1) NCCL mesh, random weights from
    SEED, its one-device phase's ``serve_mixed_slo``: every request done,
    the launches exact, the RunReport JSON byte-equal to the one-device
    phase's; a profiled decode step's device time beside that phase's."""
    cfg = dataclasses.replace(get_config(arch), attn_impl="pallas")
    spec = serve_spec(cfg, SEED)
    torch.cuda.empty_cache()
    rt = ServeRuntime.from_spec(
        spec, executor=lambda e: ModelExecutor(cfg, e, rng_seed=SEED,
                                               device="cuda", mesh=mesh))
    ex = rt.engine.exe
    if ex.fns.layout is None:
        raise AssertionError(f"phase 28 {arch}: no mesh branch")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    rep = rt.run(spec).validate()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    done = rt.engine.done
    pc, ds = rep.extras["prefill_chunks"], rep.extras["decode_steps"]
    kinds = cfg.pattern_for_layers()
    attn = kinds.count(LOCAL_ATTN) + kinds.count(GLOBAL_ATTN)
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want.update(
        decode_attention=(0 if cfg.mla is not None else
                          2 * cfg.num_layers if cfg.is_encoder_decoder
                          else attn) * ds,
        ssd_scan=kinds.count(SSD) * pc, rglru_scan=kinds.count(RGLRU) * pc)
    generated = sum(len(r.generated) for r in done)
    log(f"phase 28 serve {arch} ({smi}): layers={cfg.num_layers} "
        f"prefill_chunks={pc} decode_steps={ds} "
        f"generated_tokens={generated} max_memory_allocated={peak} "
        f"launches={launches} (want {want})")
    if len(done) != 12 or any(r.status != RequestStatus.DONE for r in done):
        raise AssertionError(f"phase 28 {arch}: not every request ended done")
    if launches != want:
        raise AssertionError(f"phase 28 {arch}: launches {launches}, want "
                             f"{want}")
    if rep.to_json() != one["json"]:
        raise AssertionError(f"phase 28 {arch}: the RunReport differs from "
                             "the one-device phase's")
    log(f"check: phase 28's {arch} RunReport JSON equals its one-device "
        "phase's")
    B = 8
    dev_ms = profile_step(
        f"{arch} full-width decode step, (1, 1) NCCL mesh", lambda: ex.decode(
            np.ones(B, np.int32), np.full(B, 128, np.int32),
            np.ones(B, bool)),
        kernel="" if cfg.mla is not None else "decode_attention")
    log(f"phase 28 {arch} decode step device time {dev_ms:.3f} ms against "
        f"the one-device phase's {one['dec_ms']:.3f} ms (ratio "
        f"{dev_ms / one['dec_ms']:.4f}; {smi})")
    del rt, ex
    torch.cuda.empty_cache()
    return dict(launches=launches, dev_ms=dev_ms, peak=peak)


def whisper_tp_train(mesh, hist23: list, smi: str) -> dict:
    """Phase 28 (c): phase 23 (d)'s cell (Whisper's widths at 2 + 2
    layers, its batch, 2 steps under ``pallas``) through the trainer's
    tensor-parallel compute on the (1, 1) NCCL mesh: the flash launches
    exact, the losses and grad norms within phase 23 (d)'s tolerance
    (1e-2) of its kernel steps (the flash backward's atomics spread a
    rerun by ~1e-5)."""
    from repro_torch.training.trainer import build_trainer
    base, batch = whisper_train_batch()
    cfg = dataclasses.replace(base, attn_impl="pallas")
    trainer = build_trainer(cfg, mesh, total_steps=10, device="cuda")
    state = trainer.init_state(SEED)
    ops.reset_launches()
    hist = []
    for _ in range(2):
        (state, m), wall = sync_time(lambda: trainer.train_step(state, batch))
        hist.append(dict(loss=m["loss"].item(),
                         grad_norm=m["grad_norm"].item(), step_s=wall))
    launches = dict(ops.LAUNCHES)
    want = whisper_want(base)
    diffs = rel_diffs(hist, hist23, "loss") \
        + rel_diffs(hist, hist23, "grad_norm")
    log(f"phase 28 whisper tp train ({smi}): losses "
        f"{[h['loss'] for h in hist]} vs phase 23 (d) "
        f"{[h['loss'] for h in hist23]}, grad norms "
        f"{[h['grad_norm'] for h in hist]} vs "
        f"{[h['grad_norm'] for h in hist23]}: max rel diff {max(diffs):.2e} "
        f"(tol 1e-2); step_s {[round(h['step_s'], 4) for h in hist]}; "
        f"launches {launches} (want {want})")
    del state, trainer
    torch.cuda.empty_cache()
    if launches != want or max(diffs) > 1e-2 \
            or not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError("phase 28: Whisper's TP trainer leaves phase 23 "
                             "(d)'s steps or its launches")
    return dict(hist=hist, launches=launches, diff=max(diffs))


def family_plans() -> dict:
    """Phase 28 (d): the families' decode_32k plans on the single pod,
    from phase 26's dry-run subprocess; each must plan ``[ ok ]``."""
    plans = {}
    for a in FAMILY_DRYRUN:
        rec = json.loads((DRYRUN_DIR / f"{a}__decode_32k__singlepod.json")
                         .read_text())
        if "skipped" in rec or rec["cost"]["flops"] <= 0:
            raise AssertionError(f"phase 28: no plan of {a} x decode_32k")
        m, c = rec["memory"], rec["collectives"]
        plans[a] = rec
        log(f"phase 28 dry run [ ok ] {a} x decode_32k x singlepod: argument "
            f"bytes {m['argument_bytes']} B (params {m['param_bytes']}, cache "
            f"{m['cache_bytes']}), live bytes {m['temp_bytes']} B, flops "
            f"{rec['cost']['flops']:.4e}, collectives " + ", ".join(
                f"{k} {v['count']}x {v['bytes']:.4e} B" for k, v in c.items()
                if isinstance(v, dict) and v["count"]))
    return plans


def family_tp_phase(one: dict, hist23: list, smi: str) -> dict:
    """Phase 28: (a) Mamba2-370M, RecurrentGemma-2B, DeepSeek-V2-Lite and
    Whisper-large-v3 serve through ``ModelExecutor(mesh=)`` on a (1, 1)
    NCCL mesh, byte-equal to their one-device phases (17, 22, 23); (b)
    the decode, flash, SSD and RG-LRU kernels at the families' TP-local
    shapes against their plain versions, timed as CUDA-graph replays
    beside their bounds (and SDPA for attention); (c) Whisper's trainer
    through its tensor-parallel compute on the mesh; (d) the dry run's
    decode_32k plans.  At world 1 nothing is sliced: (a) and (c) run the
    mesh branch's plumbing; the slicing is held on gloo at world 4
    (tests/test_torch_serve_mesh_families.py,
    tests/test_torch_tp_training_families.py)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    t0 = time.perf_counter()
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    log(f"phase 28: {dist.get_backend()} world {dist.get_world_size()}, "
        f"mesh {mesh.mesh_dim_names} {tuple(mesh.mesh.shape)}")
    serves = {a: serve_family_mesh(a, one[a], mesh, smi) for a in
              ("mamba2-370m", "recurrentgemma-2b", "deepseek-v2-lite-16b",
               WHISPER)}
    train = whisper_tp_train(mesh, hist23, smi)
    dist.destroy_process_group()

    # (b) the kernels at the TP-local shapes
    errs = {"decode_attention": [], "flash_attention": [], "ssd_scan": [],
            "rglru_scan": []}
    times = {}
    for i, (name, shp) in enumerate(TP28_DECODE):
        lens = [shp["T"], 1, 0, 7, 100, 129, 64, shp["T"] - 1]
        for dtype in (torch.bfloat16, torch.float32):
            errs["decode_attention"].append(check_decode_case(
                name, shp, lens, 0, 0.0, False, None, dtype=dtype,
                seed=SEED + 60 + i))
        times[name] = time_decode_attention(shp["T"], 100, shape=shp)
    ring = ring_positions(RG_RING_LENGTHS, 2048, SEED)
    for name, n in TP28_RING:
        for dtype in (torch.bfloat16, torch.float32):
            errs["decode_attention"].append(check_ring_shard(name, n, dtype))
        Tl = 2048 // n
        times[name] = time_decode_attention(
            Tl, 100, shape=dict(RG_DECODE, T=Tl), window=2048,
            positions=ring[:, :Tl].contiguous(), lengths=RG_RING_LENGTHS,
            lse=True)
    for name, t in times.items():
        log(f"time decode_attention bf16 {name} (ms, library_ms: CUDA-graph "
            f"replays; eager_ms, library_eager_ms, plain_ms: launched from "
            f"Python; {smi}) " + fields(t))
    name, shp = TP28_FLASH
    case = (shp["B"], shp["S"], shp["S"], shp["Hq"], shp["Hkv"], shp["D"],
            0, 0.0, shp["causal"])
    for dtype in (torch.bfloat16, torch.float32):
        e, g, _ = check_flash_case(name, case, dtype, SEED + 70)
        errs["flash_attention"].append(max(e, g))
    times[name] = t = time_flash_tp(shp)
    log(f"time flash_attention bf16 {name} B=8 S=T=1500 Hq=Hkv=5 D=64 "
        f"non-causal (graph_*: CUDA-graph replays; the rest eager CUDA "
        f"events; {smi}) " + fields(t))
    torch.cuda.empty_cache()
    for i, (name, case) in enumerate(TP28_SSD):
        for dtype in (torch.bfloat16, torch.float32):
            for state in (False, True):
                errs["ssd_scan"].append(check_ssd_case(
                    name, case, dtype, dtype, state, SEED + 80 + i))
        times[name] = t = time_ssd_scan(case, True, 200, 10)
        log(f"time ssd_scan bf16 {name} (ms, plain_ms: CUDA-graph replays; "
            f"eager_ms: launched from Python; {smi}) " + fields(t))
    for i, (name, case) in enumerate(TP28_RGLRU):
        for h0 in (False, True):
            errs["rglru_scan"].append(check_rglru_case(
                name, case, h0, False, SEED + 90 + i))
        times[name] = t = time_rglru_scan(case, 200)
        log(f"time rglru_scan fp32 {name} (ms, plain_ms: CUDA-graph "
            f"replays; eager_ms: launched from Python; {smi}) " + fields(t))

    plans = family_plans()
    log(f"phase 28: {time.perf_counter() - t0:.1f} s")
    launches = {k: sum(v["launches"][k] for v in serves.values())
                + train["launches"][k] for k in ops.LAUNCHES}
    return dict(serves=serves, train=train, errs=errs, times=times,
                plans=plans, launches=launches)


# ---------------------------------------------------------------------------
# phase 29: the port's static analysis, and host-sync held to the card
# ---------------------------------------------------------------------------
SYNC_FIXTURES = ROOT / "tests" / "data" / "analysis_torch"
SYNC_ERROR = "called a synchronizing CUDA operation"
# sync_bad functions whose finding the sync debug mode cannot show, and
# why: their findings are held on the CPU only (tests/test_torch_analysis.py)
SYNC_NOT_SHOWN = {
    "numpy_torch": "a CUDA tensor's .numpy() raises TypeError before any "
                   "copy: no sync happens",
    "numpy_call_torch": "numpy refuses a CUDA tensor (TypeError): no sync "
                        "happens",
    "synchronize_torch": "torch.cuda.synchronize() waits for the whole "
                         "device without the debug mode's hook: no raise",
}


def sync_inputs(seed: int) -> dict:
    """The fixtures' parameters by name (``x``, ``s``, ``mask``, ``out``,
    ``idx``, ``ring``, ``ptr``), on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return {"x": torch.randn(8, device="cuda", generator=g),
            "s": torch.rand((), device="cuda", generator=g),
            "mask": torch.rand(8, device="cuda", generator=g) > 0.5,
            "out": torch.randn(8, device="cuda", generator=g),
            "idx": torch.randperm(8, device="cuda", generator=g),
            "ring": torch.randn(4, 8, device="cuda", generator=g),
            "ptr": torch.tensor(5, dtype=torch.int32, device="cuda")}


def fixture_call(mod, qual: str, inputs: dict):
    """``qual`` of the fixture module (a method on a fresh instance of
    its class) and fresh copies of the inputs its parameters name."""
    fn = mod
    for part in qual.split("."):
        fn = getattr(fn, part)
        if isinstance(fn, type):
            fn = fn()
    kw = {n: inputs[n].clone()
          for n, p in inspect.signature(fn).parameters.items()
          if p.default is p.empty}
    return fn, kw


def under_sync_error(fn, kw):
    """``fn(**kw)`` with ``torch.cuda.set_sync_debug_mode("error")``: a
    host sync inside it raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(**kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a, b))
    if isinstance(a, (tuple, list, dict)):
        if isinstance(a, dict):
            a, b = list(a.items()), list(b.items())
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


def analysis_phase() -> dict:
    """Phase 29: (a) ``python -m repro_torch.analysis.check --json`` on
    this checkout must be ok (the card's machine has no JAX: the checker
    needs none); (b) every ``sync_bad`` function ``host-sync`` flags
    raises under the sync debug mode on CUDA tensors (but those in
    ``SYNC_NOT_SHOWN``), and every ``sync_good`` function in its scope
    runs there without a raise and replays from a CUDA graph equal to
    its eager result."""
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.check", "--json"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    gate_s = time.perf_counter() - t0
    gate = json.loads(r.stdout)
    if r.returncode != 0 or not gate["ok"]:
        raise AssertionError(f"phase 29: the port's gate failed "
                             f"(rc {r.returncode}): {r.stdout[-2000:]}"
                             f"{r.stderr[-2000:]}")
    log(f"phase 29 gate: ok, modules_scanned={gate['modules_scanned']} "
        f"findings={len(gate['findings'])} baselined={gate['baselined']} "
        f"new={len(gate['new'])} stale={len(gate['stale_baseline'])} "
        f"gate_s={gate_s:.3f}")

    rule = HostSyncRule(scope=("*",), sync_free=("*",))
    inputs = sync_inputs(SEED)
    mods, bad = {}, {}
    for name in ("sync_bad", "sync_good"):
        spec = importlib.util.spec_from_file_location(
            name, SYNC_FIXTURES / f"{name}.py")
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    index = RepoIndex.load(str(SYNC_FIXTURES), paths=["sync_bad.py"],
                           excludes=())
    for f in rule.run(index):
        bad.setdefault(f.symbol, f.message.split(" (")[0])
    shown = []
    for qual, msg in sorted(bad.items()):
        fn, kw = fixture_call(mods["sync_bad"], qual, inputs)
        try:
            under_sync_error(fn, kw)
            got = "no raise"
        except (RuntimeError, TypeError) as e:
            got = f"{type(e).__name__}: {str(e).splitlines()[0][:80]}"
        torch.cuda.synchronize()
        raised = got.startswith("RuntimeError") and SYNC_ERROR in got
        note = SYNC_NOT_SHOWN.get(qual)
        log(f"phase 29 sync_bad {qual} [{msg}]: {got}"
            + (f" (not shown on the card: {note})" if note else ""))
        if note is None and not raised:
            raise AssertionError(f"phase 29: sync_bad {qual} ({msg}) did not "
                                 f"raise under the sync debug mode: {got}")
        if note is not None and raised:
            raise AssertionError(f"phase 29: sync_bad {qual} raised under the "
                                 "sync debug mode: drop it from SYNC_NOT_SHOWN")
        shown += [qual] if raised else []
    index = RepoIndex.load(str(SYNC_FIXTURES), paths=["sync_good.py"],
                           excludes=())
    if rule.run(index):
        raise AssertionError("phase 29: host-sync flags sync_good.py")
    good = sorted(q for _, q in rule.in_scope(index))
    for qual in good:
        fn, kw = fixture_call(mods["sync_good"], qual, inputs)
        eager = under_sync_error(fn, kw)
        gfn, gkw = fixture_call(mods["sync_good"], qual, inputs)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = gfn(**gkw)
        graph.replay()
        torch.cuda.synchronize()
        if not (same(out, eager) and same(gkw, kw)):
            raise AssertionError(f"phase 29: sync_good {qual}'s graph replay "
                                 "differs from its eager run")
    log(f"phase 29 sync_good: {len(good)} functions ({', '.join(good)}) "
        "ran under the sync debug mode without a raise, and their CUDA-graph "
        "replays equal their eager results (outputs and in-place writes)")
    log(f"phase 29: {len(shown)} of {len(bad)} flagged sync_bad functions "
        f"raised under the sync debug mode; {time.perf_counter() - t0:.1f} s")
    return dict(gate=gate, gate_s=gate_s, shown=shown, good=good)


# ---------------------------------------------------------------------------
# phases 8-10: the WLBVT dispatch kernel and the sweep datapath
# ---------------------------------------------------------------------------
PEAK_FLOPS_F64 = 34e12               # H100 SXM FP64 outside the tensor cores
SELECT_PUS = 32                      # PsPIN PUs: the sweep's num_pus


def select_inputs(R, T, dtype, seed, kind="rand"):
    """[R, T] round inputs on the card from a numpy seed.  ``kind``:
    rand (random priorities), int (integer priorities), ties (every
    metric 0, as at t = 0), free0 (no PU grantable), empty (half the
    rows have no queued packet)."""
    rng = np.random.RandomState(seed)
    prio = (rng.randint(1, 5, (R, T)) if kind == "int"
            else rng.uniform(0.5, 4.0, (R, T)))
    ql = rng.randint(0, 6, (R, T))
    co = rng.randint(0, 3, (R, T))
    to = rng.uniform(0.0, 5e4, (R, T))
    bvt = rng.uniform(0.0, 2e4, (R, T))
    free = rng.randint(0, SELECT_PUS + 1, (R,))
    if kind == "ties":
        to[:] = 0.0
        bvt[:] = 0.0
    if kind == "free0":
        free[:] = 0
    if kind == "empty":
        ql[::2] = 0

    def dev(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device="cuda")
    return (dev(prio, dtype), dev(ql, torch.int32), dev(co, torch.int32),
            dev(to, dtype), dev(bvt, dtype), dev(free, torch.int32))


def check_wlbvt_select() -> float:
    """Kernel == plain version, bit for bit, on picks, ql' and co'.
    Returns the max |kernel - plain| over every output (0 when exact)."""
    worst = 0.0
    n = 0
    for dtype in (torch.float32, torch.float64):
        for R in (1, 7, 256, 4096):
            for T in (2, 8, 128):
                for mp in (1, 4, 16, 128):
                    kinds = ["rand", "int"] if R > 1 else ["rand"]
                    if R == 256 and mp == 4:
                        kinds += ["ties", "free0", "empty"]
                    for kind in kinds:
                        args = select_inputs(R, T, dtype,
                                             seed=R * 1000 + T + mp,
                                             kind=kind)
                        got = wlbvt_select_cuda(*args, num_pus=SELECT_PUS,
                                                max_picks=mp)
                        torch.cuda.synchronize()
                        want = wlbvt_select_rounds_ref(
                            *args, num_pus=SELECT_PUS, max_picks=mp)
                        err = max((a.long() - b.long()).abs().max().item()
                                  for a, b in zip(got, want))
                        worst = max(worst, float(err))
                        n += 1
                        if err != 0:
                            raise AssertionError(
                                f"wlbvt_select {dtype} R={R} T={T} "
                                f"max_picks={mp} {kind}: kernel != plain "
                                f"(max |diff| {err})")
    for T, mp in ((129, 1), (8, 129)):
        args = select_inputs(2, T, torch.float32, seed=0)
        try:
            wlbvt_select_cuda(*args, num_pus=SELECT_PUS, max_picks=mp)
        except ValueError as e:
            log(f"check wlbvt_select T={T} max_picks={mp} raises: {e}")
        else:
            raise AssertionError(f"wlbvt_select T={T} max_picks={mp} "
                                 "did not raise")
    log(f"check wlbvt_select: {n} cases (float32 and float64, R 1/7/256/"
        f"4096, T 2/8/128, max_picks 1/4/16/128, random/integer "
        f"priorities, ties, free_k 0, empty rows) bit-exact, "
        f"max_abs_err={worst:g}")
    return worst


def graph_ms(fn, per_graph: int, replays: int, argsets=((),)) -> float:
    """Device time per call: ``per_graph`` calls (cycling through
    ``argsets``) captured in one CUDA graph, replayed ``replays`` times
    between CUDA events, so the host's launch cost is out of the
    measurement."""
    fn(*argsets[0])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(per_graph):
            fn(*argsets[i % len(argsets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (per_graph * replays)


def time_wlbvt_select(R, T, mp, dtype, iters) -> dict:
    """Device time per call (CUDA-graph replays, as the sweep runs it)
    and the time per call launched eagerly from Python (CUDA events over
    ``iters`` launches after warm-up).  The inputs stay in L2, as in the
    sweep step, where the ops just before the kernel wrote them."""
    args = select_inputs(R, T, dtype, seed=1)

    def kernel():
        return wlbvt_select_cuda(*args, num_pus=SELECT_PUS, max_picks=mp)

    def plain():
        return wlbvt_select_rounds_ref(*args, num_pus=SELECT_PUS,
                                       max_picks=mp)

    picks = kernel()[0]
    ms = graph_ms(kernel, 100, 20)
    plain_ms = graph_ms(plain, max(100 // mp, 2), 10)
    eager_ms = event_ms(kernel, [()], iters)
    fsize = torch.finfo(dtype).bits // 8
    # three float and two int32 [R,T] arrays and free_k read once; picks,
    # ql' and co' written once
    nbytes = 3 * R * T * fsize + 2 * R * T * 4 + R * 4 + R * mp * 4 \
        + 2 * R * T * 4
    # picks this run's data needs: a row stops at its first -1
    granted = (picks >= 0).sum(dim=1)
    evaluated = torch.clamp(granted + 1, max=mp).sum().item()
    # per lane: 2 divisions for the hoisted metric; per evaluated pick
    # and lane: the psum add, mul, div, sub, ceil, the limit compare and
    # the argmin compare
    flops = R * T * 2 + evaluated * T * 7
    peak = PEAK_FLOPS_F64 if dtype == torch.float64 else PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return dict(R=R, T=T, max_picks=mp, dtype=str(dtype).split(".")[-1],
                ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops, library_ms=None)


def mix_spec(T: int, duration_us: float, seed: int = 0):
    """The JAX package's headline sweep mix (benchmarks/sweep_throughput.py
    ``_mix_spec``): distinct cost slope, packet size and priority per
    tenant, so no two scheduler lanes look alike."""
    tens = tuple(
        TenantSpec(
            f"t{i}",
            workload=WorkloadSpec(name=f"w{i}", compute_base=40.0,
                                  compute_per_byte=0.3 + 0.05 * (i % 7)),
            arrival=ArrivalSpec(size=256 + 64 * (i % 5), share=1.0 / T,
                                seed_offset=i),
            priority=1.0 + (i % 3))
        for i in range(T))
    return ScenarioSpec(name=f"sweep_mix_T{T}", tenants=tens,
                        duration_us=duration_us, seed=seed)


def scan_steps(specs) -> tuple:
    """(S, packets) of one batched loop: S = 2 max(n_live) + 2 steps, as
    the sweep datapath sizes it, and the packets of all replicas."""
    n = [len(build_traces(s, arrays=True)) for s in specs]
    return 2 * max(n) + 2, sum(n)


def run_sweep_leg(name, sweep):
    """The main path: ``run_sweep`` on the card, launches counted: one
    scan kernel per scheduler group, and no standalone WLBVT round."""
    pairs = list(sweep.replicas())
    groups = {}
    for _, spec in pairs:
        groups.setdefault(spec.scheduler, []).append(spec)
    steps = {k: scan_steps(v) for k, v in groups.items()}
    ops.reset_launches()
    (rows, wall) = sync_time(lambda: run_sweep(sweep, device="cuda")[0])
    launches = dict(ops.LAUNCHES)
    S_all = sum(S for S, _ in steps.values())
    pkts = sum(p for _, p in steps.values())
    log(f"sweep {name}: {len(rows)} replicas, {S_all} scan steps "
        f"({', '.join(f'{k} S={v[0]}' for k, v in steps.items())}), "
        f"{pkts} packets, wall_s={wall:.4f} scenarios_per_s="
        f"{len(rows) / wall:.3f} packets_per_s={pkts / wall:.1f} "
        f"sweep_scan_launches={launches['sweep_scan']} "
        f"wlbvt_select_launches={launches['wlbvt_select']}")
    if launches["sweep_scan"] != len(groups) or launches["wlbvt_select"]:
        raise AssertionError(f"{name}: launches {launches}, want sweep_scan "
                             f"= {len(groups)} scheduler groups and "
                             "wlbvt_select = 0")
    for (knobs, spec), row in zip(pairs, rows):
        arrivals = np.bincount(build_traces(spec, arrays=True).tenants,
                               minlength=len(spec.tenants))
        for i, t in enumerate(row["tenants"]):
            queued = arrivals[i] - (t["completed"] + t["killed"]
                                    + t["drops"])
            if queued != 0 or not all(
                    math.isfinite(t[k]) for k in ("throughput_gbps",
                                                  "p50_kernel_ns",
                                                  "p99_kernel_ns")):
                raise AssertionError(
                    f"{name} {knobs} tenant {i}: {arrivals[i]} arrivals "
                    f"!= completed + killed + drops ({t}); a drained run "
                    f"leaves nothing queued")
    return rows, launches, wall, S_all


def check_rows_against_cpu(name, sweep, rows) -> None:
    """The card's exact rows == the port's CPU run of the same code."""
    cpu_rows = run_sweep(sweep, device="cpu")[0]
    for i, (got, want) in enumerate(zip(rows, cpu_rows)):
        if got != want:
            raise AssertionError(f"{name} replica {i}: card row {got} != "
                                 f"CPU row {want}")
    log(f"check {name}: card rows == CPU rows, field for field, on "
        f"{len(cpu_rows)} replica(s) {[r['knobs'] for r in cpu_rows]}")


def mix_specs(n: int, T: int = 8, duration_us: float = 24.0) -> list:
    return [dataclasses.replace(mix_spec(T, duration_us), seed=s)
            for s in range(n)]


def fig9_specs(scheduler: str, n: int = 8) -> list:
    """fig9_congestor_victim at its published defaults (300 us)."""
    base = dataclasses.replace(get_scenario("fig9_congestor_victim",
                                            scheduler=scheduler),
                               record_timeline=False)
    return [dataclasses.replace(base, seed=s) for s in range(n)]


def scan_inputs(specs, precision: str = "exact"):
    """The scan's inputs on the card and its geometry."""
    from repro_torch.sim import devicepath as DP
    _, data, kw = DP.scan_inputs(specs, DP.PRECISIONS[precision], "cuda")
    return data, kw


def scan_diff(got, want) -> float:
    """max |kernel - plain| over every record and state field; raises
    unless every element is equal."""
    worst = 0.0
    pairs = list(zip(("eq_pack", "t", "comp_meta", "comp_ktime"),
                     got[1], want[1]))
    pairs += [(n, got[0][n], want[0][n]) for n in SWEEP_STATE]
    for name, a, b in pairs:
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"sweep_scan {name}: {a.dtype} "
                                 f"{tuple(a.shape)} != {b.dtype} "
                                 f"{tuple(b.shape)}")
        if not torch.equal(a, b):
            idx = (a != b).nonzero()[0].tolist()
            raise AssertionError(f"sweep_scan {name} differs first at "
                                 f"{idx}: {a[tuple(idx)].item()} != "
                                 f"{b[tuple(idx)].item()}")
        worst = max(worst, (a.double() - b.double()).abs().max().item()
                    if a.numel() else 0.0)
    return worst


def check_sweep_scan() -> float:
    """Phase 19: the scan kernel against the plain step (CUDA-graph
    replays of ``GRAPH_STEPS`` steps) on the card, element for element on
    the [S, R] records and the final state: the mix's first 32 replicas
    at its full S, fig9 at 300 us (wlbvt and rr, 8 seeds), and 128
    tenants; float64 and float32.  T 129 and P 129 raise."""
    worst = 0.0
    cases = [("mix R32", mix_specs(32)), ("fig9 wlbvt", fig9_specs("wlbvt")),
             ("fig9 rr", fig9_specs("rr")),
             ("mix T128 R8", mix_specs(8, 128, 6.0))]
    for precision in ("exact", "fast"):
        for label, specs in cases:
            data, kw = scan_inputs(specs, precision)
            got = sweep_scan_cuda(data, **kw)
            torch.cuda.synchronize()
            want, plain_s = sync_time(lambda: sweep_scan_ref(
                data, **kw, graph_steps=GRAPH_STEPS))
            worst = max(worst, scan_diff(got, want))
            log(f"check sweep_scan {label} {precision}: R={len(specs)} "
                f"T={kw['T']} S={kw['S']} kernel == plain step on every "
                f"record and state field (plain graph-replayed run "
                f"{plain_s:.3f} s)")
    data, kw = scan_inputs(mix_specs(2))
    for T, P in ((129, 32), (8, 129)):
        try:
            sweep_scan_cuda(data, **{**kw, "T": T, "P": P})
        except ValueError as e:
            log(f"check sweep_scan T={T} P={P} raises: {e}")
        else:
            raise AssertionError(f"sweep_scan T={T} P={P} did not raise")
    return worst


def scan_cost(data, kw, state, ys) -> tuple:
    """(bytes, flops) the scan must move and compute for this run's
    data: each input read once (arrivals [R, NB+1]: time, tenant (int64),
    cycles; prio, klim, tlim; four per-row values), each output written
    once (24 B of records a step and row, the final state); operations
    per live step (a live step consumes one event: na + completions),
    for T tenants: the fold (2 mul + 2 add + 1 div + 1 mul a tenant), the
    three lane sums, Jain (5), dt (1), the slot start and kill time (5),
    and under wlbvt the round (2 div for the metric, mul, div, sub, ceil
    and the compare a tenant, the psum)."""
    T, S = kw["T"], kw["S"]
    R, NB1 = data["arr_t"].shape
    f = data["prio"].element_size()
    nbytes = R * NB1 * (2 * f + 8) + 3 * R * T * f + R * (12 + f)
    nbytes += S * R * (8 + 2 * f)
    nbytes += sum(v.numel() * v.element_size() for v in state.values())
    live = int((state["na"] + (ys[2] != -1).sum(dim=0)).sum().item())
    per_step = 6 * T + 3 * (T - 1) + 11
    if kw["scheduler"] == "wlbvt":
        per_step += 7 * T + (T - 1)
    return nbytes, live * per_step


def time_sweep_scan() -> dict:
    """Phase 19's times.  The kernel (CUDA events around single launches,
    the median of 5) at the sweep's shapes: the mix (R 256, float64), the
    mix at R 1 (each step's serial chain alone), fig9 wlbvt and rr (R 8,
    300 us); beside the mix's bound and, on the host clock, the plain
    step's whole graph-replayed run and the step the sweep ran before
    (its WLBVT round the ``wlbvt_select`` kernel), also graph-replayed."""
    out = {}

    def kernel_ms(data, kw):
        sweep_scan_cuda(data, **kw)
        torch.cuda.synchronize()
        ts = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            sweep_scan_cuda(data, **kw)
            end.record()
            torch.cuda.synchronize()
            ts.append(start.elapsed_time(end))
        return float(np.median(ts))

    data, kw = scan_inputs(mix_specs(256))
    state, ys = sweep_scan_cuda(data, **kw)
    nbytes, flops = scan_cost(data, kw, state, ys)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS_F64 * 1e3
    out["ms"] = kernel_ms(data, kw)
    out["S"] = kw["S"]
    out["us_per_step"] = out["ms"] * 1e3 / kw["S"]
    out["bound_ms"] = max(t_bytes, t_ops)
    out["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    out["bytes"], out["flops"] = nbytes, flops
    _, out["plain_s"] = sync_time(lambda: sweep_scan_ref(
        data, **kw, graph_steps=GRAPH_STEPS))
    _, out["old_step_s"] = sync_time(lambda: sweep_scan_ref(
        data, **kw, graph_steps=GRAPH_STEPS,
        select=ops.wlbvt_select_rounds))
    out["plain_ms"] = out["plain_s"] * 1e3
    del data, state, ys
    data1, kw1 = scan_inputs(mix_specs(1))
    out["r1_ms"] = kernel_ms(data1, kw1)
    out["r1_ns_per_step"] = out["r1_ms"] * 1e6 / kw1["S"]
    for sched in ("wlbvt", "rr"):
        d9, k9 = scan_inputs(fig9_specs(sched))
        out[f"fig9_{sched}_ms"] = kernel_ms(d9, k9)
        out[f"fig9_{sched}_ns_per_step"] = (out[f"fig9_{sched}_ms"] * 1e6
                                            / k9["S"])
    out["library_ms"] = None
    return out


def profile_sweep_scan() -> None:
    """Where the mix's sweep time goes: the stages of
    ``devicepath._run_batch`` on the host clock (traces, replica arrays
    and their copy to the card; the scan; the results back to the host
    and their materialisation), then the scan's device time (CUDA events
    around its one launch) and the card's idle share over the scan's wall
    time.  Not ``torch.profiler``: in this script's process it saw no
    kernel of the scan and slowed the scan 5.8x (PERF.md)."""
    from repro_torch.sim import devicepath as DP
    specs = mix_specs(256)
    (per_spec, data, kw), t_inputs = sync_time(
        lambda: DP.scan_inputs(specs, np.float64, "cuda"))
    (fin, ys), t_scan = sync_time(lambda: sweep_scan_cuda(data, **kw))

    def results():
        fin_np = {k: v.cpu().numpy() for k, v in fin.items()}
        ys_np = tuple(y.cpu().numpy() for y in ys)
        return [DP._materialize(s, per_spec[r], fin_np, ys_np, r, False)
                for r, s in enumerate(specs)]

    _, t_results = sync_time(results)
    log(f"profile: sweep mix R=256 T=8 float64 S={kw['S']}, stages (host "
        f"clock): traces, replica arrays and their copy to the card "
        f"{t_inputs:.4f} s, scan {t_scan:.4f} s, results to host and "
        f"materialised {t_results:.4f} s")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def scan():
        start.record()
        sweep_scan_cuda(data, **kw)
        end.record()

    _, wall = sync_time(scan)
    dev_s = start.elapsed_time(end) / 1e3
    log(f"profile: sweep mix scan: wall {wall * 1e3:.4f} ms (host clock), "
        f"device {dev_s * 1e3:.4f} ms (CUDA events around its one launch), "
        f"idle share {1 - dev_s / wall:.4f}")


def sweep_phase():
    """Phase 10: the sweep datapath at full size, exact mode, on the card."""
    mix = SweepSpec(name="sweep_mix_T8", base=mix_spec(8, 24.0),
                    seeds=tuple(range(256)))
    fig9 = build_sweep("fig9_congestor_victim", {},
                       [SweepAxis("scheduler", ("wlbvt", "rr"))], 8)
    mix_rows, mix_launches, _, _ = run_sweep_leg("mix", mix)
    fig9_rows, fig9_launches, _, _ = run_sweep_leg("fig9", fig9)
    for sched in ("wlbvt", "rr"):
        jain = [r["jain_pu_timeavg"] for r in fig9_rows
                if r["knobs"]["scheduler"] == sched]
        log(f"sweep fig9 {sched}: jain_pu_timeavg per seed "
            f"{[round(j, 6) for j in jain]} mean {np.mean(jain):.6f}")
    # the CLI runs on the card by default
    out = ROOT / "build" / "chip_smoke_sweep.json"
    sweep_cli.main(["fig9_congestor_victim", "--set", "duration_us=10",
                    "--axis", "tenants.0.priority=1,2", "--seeds", "2",
                    "--out", str(out)])
    doc = json.loads(out.read_text())
    if doc["device"] != "cuda" or len(doc["rows"]) != 4:
        raise AssertionError(f"sweep CLI: {doc['device']}, "
                             f"{len(doc['rows'])} rows")
    check_rows_against_cpu(
        "mix", dataclasses.replace(mix, seeds=tuple(range(8))), mix_rows[:8])
    check_rows_against_cpu(
        "fig9", dataclasses.replace(fig9, axes=(
            SweepAxis("scheduler", ("wlbvt",)),), seeds=(0,)), fig9_rows[:1])
    profile_sweep_scan()
    return {k: mix_launches[k] + fig9_launches[k] for k in mix_launches}

# ---------------------------------------------------------------------------
# phases 14-17: the SSD and RG-LRU scan kernels and the recurrent families
# ---------------------------------------------------------------------------
SCAN_TOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
RGLRU_TOL = 1e-5
# B, S, H, P, G, N, chunk: tests/test_kernels.py's three (groups, ragged
# chunks; N 16 and 32), the serve shape (one prefill chunk of Mamba2-370M:
# Q = 32), a cache-free run at its widths (4 chunks of 256 rows), and the
# tensor-core kernel's edges: S 1 with P 32, a ragged last chunk of 8
# rows, chunks of 48 rows with 2 groups, and N 20 / P 24 (rows that are
# not whole 16-byte pieces: the element-by-element loads)
SSD_CASES = [
    ("k128", (2, 128, 4, 32, 1, 16, 64)),
    ("k200_groups", (2, 200, 4, 32, 2, 16, 64)),
    ("k96", (2, 96, 2, 64, 1, 32, 32)),
    ("serve", (8, 32, 32, 64, 1, 128, 256)),
    ("cache_free", (4, 1024, 32, 64, 1, 128, 256)),
    ("s1_p32", (2, 1, 4, 32, 1, 16, 64)),
    ("ragged", (2, 40, 4, 64, 1, 128, 32)),
    ("q48_groups", (2, 100, 4, 64, 2, 64, 48)),
    ("unaligned", (2, 50, 4, 24, 1, 20, 32)),
]
SSD_SERVE = dict(SSD_CASES)["serve"]
# B, S, W: tests/test_kernels.py's three, the serve shape (one prefill
# chunk of RecurrentGemma-2B), S 1, W 33 over 1000 steps (a cluster of 8
# blocks) and phase 18's cache-free forward (1 x 4096: four tiles of a
# cluster of 8)
RGLRU_CASES = [("k128", (2, 128, 128)), ("k100x96", (2, 100, 96)),
               ("k64x256", (2, 64, 256)), ("serve", (8, 32, 2560)),
               ("s1", (2, 1, 2560)), ("w33", (2, 1000, 33)),
               ("rg_free", (1, 4096, 2560))]
SSD_STATE_TOL = 1e-4   # the bf16 kernel's state against its rounding
RGLRU_SERVE = dict(RGLRU_CASES)["serve"]
RGLRU_FREE = dict(RGLRU_CASES)["rg_free"]


def ssd_inputs(case, xdtype, bcdtype, state: bool, seed: int):
    B, S, H, P, G, N, _ = case
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    args = ((rnd(B, S, H, P) * 0.5).to(xdtype), F.softplus(rnd(B, S, H)),
            torch.log(torch.linspace(1.0, 16.0, H, device="cuda")),
            (rnd(B, S, G, N) * 0.3).to(bcdtype),
            (rnd(B, S, G, N) * 0.3).to(bcdtype))
    return args, (rnd(B, H, P, N) * 0.5 if state else None)


def check_ssd_scan() -> float:
    """The SSD kernels against their plain version; returns the serve
    case's max |kernel - plain| (y and state) in bf16.  The serve and
    cache-free shapes read B/C in x's dtype (as the model path); the other
    shapes in fp32 (as tests/test_kernels.py) and, with bf16 x, also in
    bf16 (the tensor-core kernel)."""
    serve_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for i, (name, case) in enumerate(SSD_CASES):
            model_path = name in ("serve", "cache_free")
            states = (False,) if name == "cache_free" else (False, True)
            bcs = ((dtype,) if model_path else
                   (torch.float32,) + ((dtype,) if dtype == torch.bfloat16
                                       else ()))
            for bc, state in ((bc, state) for bc in bcs for state in states):
                err = check_ssd_case(name, case, dtype, bc, state, SEED + i)
                if name == "serve" and dtype == torch.bfloat16:
                    serve_err = max(serve_err, err)
    return serve_err


def check_ssd_case(name, case, dtype, bc, state: bool, seed: int) -> float:
    """The SSD kernel against its plain version on one case (x in
    ``dtype``, B/C in ``bc``, with or without an initial state) and, where
    x and B/C are bf16, against its own rounding; returns max |kernel -
    plain| of y and the state."""
    args, st = ssd_inputs(case, dtype, bc, state, seed)
    y, last = ssd_scan_cuda(*args, chunk=case[-1], init_state=st)
    torch.cuda.synchronize()
    wy, wlast = ssd_scan_ref(*args, init_state=st)
    tol = SCAN_TOL[dtype]
    ey = (y.float() - wy.float()).abs().max().item()
    es = (last - wlast).abs().max().item()
    ok = (torch.allclose(y.float(), wy.float(), atol=tol, rtol=tol)
          and torch.allclose(last, wlast, atol=tol, rtol=tol)
          and bool(torch.isfinite(y).all())
          and bool(torch.isfinite(last).all()))
    log(f"check ssd_scan {name:<11} {str(dtype):<15} "
        f"B/C {str(args[3].dtype):<15} init_state={state!s:<5} "
        f"y max_abs_err={ey:.3e} state max_abs_err={es:.3e} "
        f"(max |y| {wy.float().abs().max().item():.3g}) tol={tol:g}")
    if not ok:
        raise AssertionError(f"ssd_scan {name} {dtype}: kernel disagrees "
                             "with plain version")
    if dtype == torch.bfloat16 and bc == torch.bfloat16:
        check_ssd_rounding(name, args, st, case[-1], y, last)
    return max(ey, es)


def check_ssd_rounding(name, args, st, chunk, y, last) -> None:
    """The tensor-core kernel's y and final state against
    ``ssd_scan_bf16_ref`` (its chunking, cumsum order and hi + lo
    rounding, run on the CPU) on the same inputs: y within one bf16 ulp
    (2^-7 of its size) and 1e-4, the state within 1e-4 of its largest
    entry.  A kernel without the lo products misses the state by ~2^-9."""
    cpu = [a.cpu() for a in args]
    wy, wlast = ssd_scan_bf16_ref(*cpu, None if st is None else st.cpu(),
                                  chunk=chunk)
    yk, lk = y.cpu().float(), last.cpu()
    ey = ((yk - wy.float()).abs()
          / (wy.float().abs() * 2**-7 + 1e-4)).max().item()
    scale = wlast.abs().max().item()
    es = ((lk - wlast).abs().max().item() / scale) if scale else 0.0
    ok = (torch.allclose(yk, wy.float(), rtol=2**-7, atol=1e-4)
          and torch.allclose(lk, wlast, rtol=SSD_STATE_TOL,
                             atol=SSD_STATE_TOL * scale))
    log(f"check ssd_scan {name:<11} against its rounding: y err / (one "
        f"ulp + 1e-4) {ey:.3f}, state err / max |state| {es:.2e} "
        f"(tol {SSD_STATE_TOL:g})")
    if not ok:
        raise AssertionError(f"ssd_scan {name}: tensor-core kernel departs "
                             "from its rounding (ssd_scan_bf16_ref)")


def ssd_cost(case, xbytes: int, state: bool):
    """(bytes, flops) the chunked SSD scan needs: each input read once
    and each output written once; per chunk of q rows the q(q+1)/2
    scores over N and products over P, the state update, and the
    inter-chunk term where a state comes in."""
    B, S, H, P, G, N, chunk = case
    Q = min(chunk, S)
    nbytes = (2 * B * S * H * P * xbytes + B * S * H * 4 + H * 4
              + 2 * B * S * G * N * xbytes + B * H * P * N * 4 * (1 + state))
    flops = 0
    for c0 in range(0, S, Q):
        q = min(Q, S - c0)
        tri = q * (q + 1) // 2
        flops += 2 * tri * (N + P) + 2 * q * P * N
        if state or c0 > 0:
            flops += 2 * q * P * N
    return nbytes, flops * B * H


def time_ssd_scan(case, state: bool, calls: int, plain_calls: int) -> dict:
    """Device times in bf16 (x and B/C, as the model path) from CUDA-graph
    replays (``ms``, ``plain_ms``) and the time launched eagerly from
    Python (``eager_ms``), inputs rotated through more sets than the 50
    MB L2 holds (the 48 layers' states are on the main path)."""
    dtype = torch.bfloat16
    nbytes, flops = ssd_cost(case, 2, state)
    nbuf = max(2, math.ceil(4 * L2_BYTES / nbytes))
    sets = [ssd_inputs(case, dtype, dtype, state, 300 + i)
            for i in range(nbuf)]
    chunk = case[-1]

    def kernel(args, st):
        return ssd_scan_cuda(*args, chunk=chunk, init_state=st)

    def plain(args, st):
        return ssd_scan_ref(*args, init_state=st)

    ms = graph_ms(kernel, calls, 5, sets)
    eager_ms = event_ms(kernel, sets, 10 * calls)
    plain_ms = graph_ms(plain, plain_calls, 2, sets)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3      # the tensor cores' rate
    B, S, H, P, G, N, _ = case
    return dict(B=B, S=S, H=H, P=P, G=G, N=N, chunk=chunk,
                init_state=state, ms=ms, eager_ms=eager_ms,
                plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops, buffers=nbuf, library_ms=None)


SSD_PHASES = ("prologue", "inputs: copies, dt and its cumsum",
              "C B^T and W", "P", "pass 0", "pass 1")


def ssd_phases() -> None:
    """clock64 cycles of each phase of the bf16 SSD kernel at the serve
    shape with 8 rows (256 blocks, two an SM) and with 1 row (32 blocks,
    one an SM), with and without an initial state: ``csrc/ssd_scan.cu``
    built with ``-DSSD_PHASE_TRACE`` into a library of its own, whose
    kernel records the cycle count at each phase boundary of every
    block's first chunk."""
    with traced_library(kssd.NAME, "SSD_PHASE_TRACE",
                        "ssd_phase_read") as lib:
        for rows in (8, 1):
            case = (rows,) + SSD_SERVE[1:]
            for state in (True, False):
                args, st = ssd_inputs(case, torch.bfloat16, torch.bfloat16,
                                      state, 7)
                for _ in range(4):      # the last launch is the one read
                    ssd_scan_cuda(*args, chunk=case[-1], init_state=st)
                torch.cuda.synchronize()
                blocks = rows * case[2]
                clk = np.zeros((blocks, len(SSD_PHASES) + 1), np.int64)
                code = lib.ssd_phase_read(clk.ctypes.data, blocks)
                if code:
                    raise RuntimeError(f"ssd_phase_read: cudaError {code}")
                d = np.diff(clk, axis=1).mean(axis=0)
                log(f"ssd_scan phases B={rows} init_state={state} "
                    f"(clock64 cycles a block, mean of {blocks}): "
                    + ", ".join(f"{n} {c:.0f}" for n, c in zip(SSD_PHASES, d))
                    + f"; total {d.sum():.0f}")


def rglru_inputs(case, h0: bool, seed: int):
    B, S, W = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.sigmoid(torch.randn((B, S, W), generator=g, device="cuda"))
    b = torch.randn((B, S, W), generator=g, device="cuda") * 0.1
    h = torch.randn((B, W), generator=g, device="cuda") if h0 else None
    return a, b, h


def check_rglru_scan() -> float:
    """The RG-LRU kernel against its plain version (tol 1e-5); returns
    the serve case's max |kernel - plain|.  The serve and W 33 shapes are
    also read as a and b halves of one (B, S, 2W) buffer (a row stride of
    2W)."""
    serve_err = None
    for i, (name, case) in enumerate(RGLRU_CASES):
        strided = (False, True) if name in ("serve", "w33") else (False,)
        for h0, split in ((h0, sp) for h0 in (False, True) for sp in strided):
            err = check_rglru_case(name, case, h0, split, SEED + i)
            if name == "serve":
                serve_err = max(serve_err or 0.0, err)
    return serve_err


def check_rglru_case(name, case, h0: bool, split: bool, seed: int) -> float:
    """The RG-LRU kernel against its plain version on one case (with or
    without h0; ``split``: a and b read as halves of one (B, S, 2W)
    buffer); returns max |kernel - plain|."""
    a, b, h = rglru_inputs(case, h0, seed)
    if split:
        W = case[2]
        ab = torch.cat([a, b], dim=-1)
        a, b = ab[..., :W], ab[..., W:]
    got, got_last = rglru_scan_cuda(a, b, h)
    torch.cuda.synchronize()
    want, want_last = rglru_scan_ref(a, b, h)
    err = max((got - want).abs().max().item(),
              (got_last - want_last).abs().max().item())
    ok = (torch.allclose(got, want, atol=RGLRU_TOL, rtol=RGLRU_TOL)
          and torch.allclose(got_last, want_last, atol=RGLRU_TOL,
                             rtol=RGLRU_TOL))
    log(f"check rglru_scan {name:<8} h0={h0!s:<5} a/b row stride "
        f"{a.stride(1)} max_abs_err={err:.3e} tol={RGLRU_TOL:g}")
    if not ok:
        raise AssertionError(f"rglru_scan {name}: kernel disagrees with "
                             "plain version")
    return err


def time_rglru_scan(case, calls: int) -> dict:
    """As ``time_ssd_scan``, in fp32, with h0; ``stream_ms``: one
    elementwise PyTorch kernel (a + b, graph-replayed) over the same
    inputs, which moves the kernel's bytes but for h0 and h_last: what a
    single pass over them costs on this card at this size."""
    B, S, W = case
    nbytes = 3 * B * S * W * 4 + 2 * B * W * 4     # a, b, h; h0, h_last
    flops = 2 * B * S * W
    nbuf = max(2, math.ceil(4 * L2_BYTES / nbytes))
    sets = [rglru_inputs(case, True, 400 + i) for i in range(nbuf)]
    ms = graph_ms(rglru_scan_cuda, calls, 5, sets)
    eager_ms = event_ms(rglru_scan_cuda, sets, 10 * calls)
    plain_ms = graph_ms(rglru_scan_ref, max(calls // 10, 2), 2, sets)
    stream_ms = graph_ms(lambda a, b, h: torch.add(a, b), calls, 5, sets)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
    return dict(B=B, S=S, W=W, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                stream_ms=stream_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops, buffers=nbuf, library_ms=None)


def check_full_width_recurrent(module, cfg) -> None:
    """At full width and depth, a prefill of 8 x 32 tokens and 2
    teacher-forced decode steps: through the kernels in bf16 (as served)
    the logits are finite and of shape (8, vocab); in fp32 the kernel
    path's logits agree with the ``chunked`` path's to 2e-3 of their
    range.  bf16 is not held across paths: they sum in other orders, and
    48 layers of random weights grow a bf16 rounding difference to ~20 %
    of the logit range even between the two plain versions (PERF.md)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    prompts = torch.randint(1, cfg.vocab_size, (8, 32), generator=g,
                            device="cuda", dtype=torch.int32)
    toks = torch.randint(1, cfg.vocab_size, (8, 2), generator=g,
                         device="cuda", dtype=torch.int32)
    served = prefill_decode_logits(cfg, module, 256, prompts, toks)
    for what, a in zip(("prefill", "decode 0", "decode 1"), served):
        if a.shape != (8, cfg.vocab_size) or not torch.isfinite(a).all():
            raise AssertionError(f"{cfg.name} full-width bf16 {what} "
                                 f"logits: shape {tuple(a.shape)}, finite="
                                 f"{bool(torch.isfinite(a).all())}")
    f32 = dataclasses.replace(cfg, dtype="float32")
    ker = prefill_decode_logits(f32, module, 256, prompts, toks)
    plain = prefill_decode_logits(
        dataclasses.replace(f32, attn_impl="chunked"), module, 256, prompts,
        toks)
    for what, a, b, c in zip(("prefill", "decode 0", "decode 1"), ker,
                             plain, served):
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
        log(f"check {cfg.name} full-width {what}: bf16 kernel path shape="
            f"{tuple(c.shape)} finite; fp32 kernel vs chunked max_abs_err="
            f"{err:.4g} max_abs_logit={scale:.4g} (tol 2e-3 of it) "
            f"greedy_agreement={agree:.3f}")
        if err > 2e-3 * scale:
            raise AssertionError(f"{cfg.name} full-width {what}: kernel "
                                 "path disagrees with chunked")


def profile_step(label: str, step, kernel: str = "") -> None:
    """Wall time of ``step`` (host clock, mean of 5) against its device
    time by kernel (profiler, mean of 2 steps): the idle share; with
    ``kernel``, that kernel's device time per launch and its share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()                                      # warm
    _, wall = sync_time(lambda: [step() for _ in range(5)])
    step_ms = wall / 5 * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step()
        torch.cuda.synchronize()
    # kernel rows only: an operator's row repeats its kernels' time
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in rows) / 2 / 1e3
    log(f"profile: {label} wall {step_ms:.3f} ms (host clock, mean of 5), "
        f"device time {total:.3f} ms (sum of kernel self time, mean of 2 "
        f"profiled steps) over {sum(e.count for e in rows) // 2} kernels, "
        f"idle share {1 - total / step_ms:.3f}")
    if kernel:
        mine = [e for e in rows if kernel in e.key]
        t = sum(e.self_device_time_total for e in mine) / 2 / 1e3
        n = sum(e.count for e in mine) // 2
        log(f"profile: {label} {kernel}: {n} launches a step, "
            f"{t:.4f} ms a step, {t / max(n, 1) * 1e3:.3f} us a launch, "
            f"{t / total:.4f} of device time")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"profile:   {e.self_device_time_total / 2 / 1e3:9.3f} ms  "
            f"{e.count // 2:5d}x  {e.key[:90]}")
    return total


def serve_recurrent(arch: str) -> dict:
    """Phase 16/17: serve ``arch`` at full width and depth through the
    kernels; exact launch counts; full-width check; profile of a prefill
    step."""
    cfg = dataclasses.replace(get_config(arch), attn_impl="pallas")
    rt, rep, launches = serve(cfg, SEED)
    done = rt.engine.done
    pc, ds = rep.extras["prefill_chunks"], rep.extras["decode_steps"]
    generated = sum(len(r.generated) for r in done)
    peak = torch.cuda.max_memory_allocated()
    ex = rt.engine.exe
    n_params = sum(p.numel() for p in ex.params.parameters())
    kinds = cfg.pattern_for_layers()
    want = {"decode_attention": (kinds.count(LOCAL_ATTN)
                                 + kinds.count(GLOBAL_ATTN)) * ds,
            "flash_attention": 0, "flash_attention_bwd": 0,
            "wlbvt_select": 0, "ssd_scan": kinds.count(SSD) * pc,
            "rglru_scan": kinds.count(RGLRU) * pc, "sweep_scan": 0}
    log(f"serve {arch}: layers={cfg.num_layers} ({kinds.count(SSD)} ssd, "
        f"{kinds.count(RGLRU)} rglru, {kinds.count(LOCAL_ATTN)} local) "
        f"d_model={cfg.d_model} params={n_params} "
        f"steps={int(rep.duration)} prefill_chunks={pc} decode_steps={ds} "
        f"generated_tokens={generated} max_memory_allocated={peak} "
        f"launches={launches}")
    log(rep.summary())
    if len(done) != 12 or any(r.status != RequestStatus.DONE for r in done):
        raise AssertionError(f"{arch}: not every request ended done: " + str(
            [(r.rid, r.status.value) for r in done]))
    if launches != want:
        raise AssertionError(f"{arch}: launches {launches}, want {want}")
    check_full_width_recurrent(ex.params, cfg)
    B, C = 8, 32
    tokens = np.ones((B, C), np.int32)
    zeros, full = np.zeros(B, np.int32), np.full(B, C, np.int32)
    profile_step(f"{arch} full-width prefill step (8 x 32 tokens)",
                 lambda: ex.prefill(tokens, zeros, full),
                 kernel="ssd_scan" if kinds.count(SSD) else "rglru_scan")
    active = np.ones(B, bool)
    dec_ms = profile_step(f"{arch} full-width decode step",
                          lambda: ex.decode(tokens[:, 0], full, active),
                          kernel="decode_attention")
    del rt, ex
    torch.cuda.empty_cache()
    return dict(launches=launches, peak=peak,
                spec=serve_spec(cfg, SEED), summary=rep.summary(),
                json=rep.to_json(), dec_ms=dec_ms)


def rg_cache_free_phase() -> dict:
    """Phase 18: RecurrentGemma-2B at full width and depth, random weights
    from a seed, one cache-free forward ``module(tokens, positions)`` of
    1 x 4096 tokens under ``pallas``, so the 2048 window binds: every
    local-attention layer runs the flash forward at head dim 256 and every
    RG-LRU layer the scan kernel, exactly once.  The bf16 logits are
    finite; in fp32 the kernel path's logits agree with the ``chunked``
    path's to 2e-3 of their range (phase 17's tolerance)."""
    from repro_torch.models import transformer
    cfg = dataclasses.replace(get_config("recurrentgemma-2b"),
                              attn_impl="pallas")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    module = build_model(cfg).init(gen)
    B, S = 1, 4096
    tokens = torch.randint(1, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda", dtype=torch.int32)
    positions = transformer.make_positions(cfg, B, S, "cuda")
    kinds = cfg.pattern_for_layers()
    want = dict(ops.LAUNCHES, decode_attention=0, flash_attention_bwd=0,
                wlbvt_select=0, ssd_scan=0, sweep_scan=0,
                flash_attention=kinds.count(LOCAL_ATTN),
                rglru_scan=kinds.count(RGLRU))

    def forward(c):
        module.cfg = c
        with torch.no_grad():
            return module(tokens, positions)[0][:, -64:].float()
    ops.reset_launches()
    served, wall = sync_time(lambda: forward(cfg))
    launches = dict(ops.LAUNCHES)
    f32 = dataclasses.replace(cfg, dtype="float32")
    ker = forward(f32)
    ops.reset_launches()
    plain = forward(dataclasses.replace(f32, attn_impl="chunked"))
    plain_launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    module.cfg = cfg
    err = (ker - plain).abs().max().item()
    scale = plain.abs().max().item()
    agree = (ker.argmax(-1) == plain.argmax(-1)).float().mean().item()
    log(f"rg cache-free forward: layers={cfg.num_layers} "
        f"({kinds.count(RGLRU)} rglru, {kinds.count(LOCAL_ATTN)} local, "
        f"window {cfg.window_size}, head dim {cfg.head_dim}) B={B} S={S} "
        f"bf16 wall_s={wall:.3f} launches={launches}; logits of the last 64 "
        f"positions: bf16 finite={bool(torch.isfinite(served).all())}, "
        f"fp32 kernel vs chunked max_abs_err={err:.4g} max_abs_logit="
        f"{scale:.4g} (tol 2e-3 of it) greedy_agreement={agree:.3f}; "
        f"chunked launched {plain_launches}")
    del module
    torch.cuda.empty_cache()
    if launches != want:
        raise AssertionError(f"rg cache-free: launches {launches}, want "
                             f"{want}")
    if not torch.isfinite(served).all() or served.shape != (
            B, 64, cfg.vocab_size):
        raise AssertionError("rg cache-free: bf16 logits not finite or of "
                             "the wrong shape")
    if err > 2e-3 * scale or plain_launches.get("flash_attention"):
        raise AssertionError("rg cache-free: kernel path disagrees with "
                             "chunked")
    return dict(launches=launches, wall=wall, err=err, scale=scale)


# ---------------------------------------------------------------------------
# phase 20: the scenario CLI, and the card's sweep against the host
# simulators
# ---------------------------------------------------------------------------
STAT_FIELDS = ("completed", "killed", "drops", "served_payload_bytes",
               "first_arrival", "last_completion", "kernel_time_count",
               "kernel_time_sum")


def host_run(spec, datapath: str):
    """``spec`` on the port's host simulator (``datapath`` "batched" or
    "event"), the completion stream recorded; the wall time covers the
    traces, the simulator's construction and its run."""
    def run():
        tenants = [ECTX(tenant_id=i, name=t.name, slo=t.slo(),
                        kernel=t.workload.build())
                   for i, t in enumerate(spec.tenants)]
        sim = build_simulator(tenants, datapath=datapath,
                              scheduler=spec.scheduler, frag=spec.frag(),
                              arb=spec.arbiter,
                              fifo_capacity=spec.fifo_capacity,
                              record_completions=True)
        trace = build_traces(spec, arrays=True)
        if datapath == "event":
            trace = trace.to_packets()
        horizon = spec.horizon_us * 1e3 if spec.horizon_us else None
        return sim.run(trace, horizon=horizon)
    t0 = time.perf_counter()
    res = run()
    return res, time.perf_counter() - t0


def eq_events(res) -> list:
    return [(e.tenant, e.kind.value, e.time) for e in res.events]


def check_card_against_host(name, spec, h, d) -> None:
    """tests/test_torch_devicepath.py's exact-mode contract: time,
    completion stream, EQ events, per-tenant stats and p99, final
    scheduler state equal; Jain's time-average within 1e-9."""
    bad = [k for k, a, b in (("time", d.time, h.time),
                             ("completions", d.completions, h.completions),
                             ("events", eq_events(d), eq_events(h))) if a != b]
    for i in range(len(spec.tenants)):
        bad += [f"tenant {i} {f}" for f in STAT_FIELDS
                if getattr(d.stats[i], f) != getattr(h.stats[i], f)]
        if (d.stats[i].kernel_time_percentile(99)
                != h.stats[i].kernel_time_percentile(99)):
            bad.append(f"tenant {i} p99")
    bad += [k for k in ("prio", "total_occup", "bvt", "kv_pressure")
            if not np.array_equal(np.asarray(d.sched_state[k]),
                                  np.asarray(h.sched_state[k]))]
    jain = abs(d.jain_pu_timeavg - h.jain_pu_timeavg)
    counts = {f: [getattr(d.stats[i], f) for i in range(len(spec.tenants))]
              for f in ("completed", "killed", "drops")}
    log(f"check {name}: card sweep vs host BatchedSimulator: time "
        f"{d.time!r}, {len(d.completions)} completions, {len(d.events)} EQ "
        f"events, {counts}, jain {float(d.jain_pu_timeavg)!r} (host "
        f"{float(h.jain_pu_timeavg)!r}, diff {jain:.3g}); mismatches: "
        f"{bad or 'none'}")
    if bad or jain > 1e-9:
        raise AssertionError(f"{name}: the card's sweep disagrees with the "
                             f"host BatchedSimulator on {bad}, jain diff "
                             f"{jain}")


def serve_shape(spec) -> tuple:
    """What the serving schedule reads of a spec: the engine shape, the
    request stream's lengths, the tenants' SLOs, the policies, the seed
    (not the prompts' token values: no model output changes a step)."""
    return (dataclasses.replace(spec.serve, vocab=0),
            tuple((t.priority, t.kv_quota_tokens, t.arrival.requests,
                   t.arrival.prompt_len, t.arrival.max_new_tokens)
                  for t in spec.tenants),
            spec.scheduler, spec.arbiter, spec.seed)


def cli_phase(mamba: dict) -> dict:
    """Phase 20: (a) the scenario CLI over the whole registry; (b)
    Mamba2-370M served through the CLI on the card; (c) the card's sweep
    against the port's host ``BatchedSimulator`` (and the event loop);
    (d) the host simulators' and the card's times."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    # (a) every registered scenario on every backend it supports, at its
    # published size
    out = ROOT / "build" / "chip_smoke_scenarios"
    shutil.rmtree(out, ignore_errors=True)
    rc, wall = sync_time(lambda: scenario_cli.main(
        ["--all", "--out-dir", str(out)]))
    want = [f"{s['name']}.{b}.json" for s in list_scenarios()
            for b in (["sim"] if s["analytic"] else s["backends"])]
    files = sorted(p.name for p in out.glob("*.json"))
    for f in files:
        RunReport.from_json((out / f).read_text()).validate()
    log(f"scenario CLI --all (published sizes): rc={rc} "
        f"{len(files)} reports in {wall:.3f} s (host), every one valid")
    if rc != 0 or files != sorted(want):
        raise AssertionError(f"scenario CLI --all: rc {rc}, reports "
                             f"{files}, want {sorted(want)}")

    # (b) a real model through the CLI: the main path of ssd_scan
    cfg = get_config("mamba2-370m")
    ops.reset_launches()
    rep = scenario_cli.run_one("serve_mixed_slo", "serve", {},
                               arch="mamba2-370m")
    serve_launches = dict(ops.LAUNCHES)
    pc = rep.extras["prefill_chunks"]
    n_ssd = cfg.pattern_for_layers().count(SSD)
    spec = get_scenario("serve_mixed_slo")
    requests = sum(t.arrival.requests for t in spec.tenants)
    done = sum(t.completed for t in rep.tenants.values())
    lost = sum(t.killed + t.rejected + t.drops for t in rep.tenants.values())
    log(f"scenario CLI serve_mixed_slo --backend serve --arch mamba2-370m: "
        f"prefill_chunks={pc} decode_steps="
        f"{rep.extras['decode_steps']} done={done}/{requests} "
        f"launches={serve_launches}")
    log(rep.summary())
    want_l = dict.fromkeys(serve_launches, 0)
    want_l["ssd_scan"] = n_ssd * pc
    if done != requests or lost or serve_launches != want_l:
        raise AssertionError(f"CLI mamba2 serve: done {done}/{requests}, "
                             f"lost {lost}, launches {serve_launches}, "
                             f"want {want_l}")
    if serve_shape(spec) == serve_shape(mamba["spec"]):
        if rep.summary() != mamba["summary"]:
            raise AssertionError("CLI mamba2 serve: per-tenant summary != "
                                 "phase 17's:\n" + mamba["summary"])
        log("check: the CLI's per-tenant summary equals phase 17's (same "
            "engine shape, requests, SLOs and seed; the prompts' vocab "
            f"differs, {spec.serve.vocab} against {mamba['spec'].serve.vocab},"
            " which no schedule reads)")
    else:
        log("check: phase 17 served another engine shape; the summaries "
            "are not compared")

    # (c) the card's sweep against the port's own host simulator
    wl9, rr9 = fig9_specs("wlbvt", 1)[0], fig9_specs("rr", 1)[0]
    legs = [("fig9 wlbvt", wl9), ("fig9 rr", rr9),
            ("fig9 fifo_capacity=8", dataclasses.replace(
                wl9, fifo_capacity=8)),
            ("fig9 budget kills", dataclasses.replace(wl9, tenants=tuple(
                dataclasses.replace(t, kernel_cycle_limit=300,
                                    total_cycle_limit=20000)
                for t in wl9.tenants)))]
    mix4 = mix_specs(4)
    ops.reset_launches()
    card = {}
    for name, spec in legs:
        card[name] = sync_time(lambda: DP.run_device(spec))
    card_mix = DP.run_sweep_specs(mix4, record_completions=True)
    sweep_launches = dict(ops.LAUNCHES)
    host = {name: host_run(spec, "batched") for name, spec in legs}
    for name, spec in legs:
        check_card_against_host(name, spec, host[name][0], card[name][0])
    for i, (spec, d) in enumerate(zip(mix4, card_mix)):
        check_card_against_host(f"mix replica {i}", spec,
                                host_run(spec, "batched")[0], d)
    drops = sum(st.drops for st in host["fig9 fifo_capacity=8"][0]
                .stats.values())
    kills = sum(st.killed for st in host["fig9 budget kills"][0]
                .stats.values())
    log(f"check: fifo_capacity=8 drops {drops}, budget-kill leg kills "
        f"{kills}; launches {sweep_launches}")
    if (not drops or not kills or sweep_launches["sweep_scan"] != len(legs)
            + 1 or sweep_launches["wlbvt_select"]):
        raise AssertionError(f"phase 20 sweep: drops {drops}, kills "
                             f"{kills}, launches {sweep_launches}")
    event = {"wlbvt": host_run(wl9, "event"), "rr": host_run(rr9, "event")}
    ev, bt = event["wlbvt"][0], host["fig9 wlbvt"][0]
    for f in ("completed", "killed", "drops", "kernel_time_count"):
        a = [getattr(ev.stats[i], f) for i in range(len(wl9.tenants))]
        b = [getattr(bt.stats[i], f) for i in range(len(wl9.tenants))]
        if a != b:
            raise AssertionError(f"fig9 wlbvt: event loop {f} {a} != "
                                 f"batched {b}")
    log("check fig9 wlbvt: the event-loop Simulator's per-tenant counts "
        "equal the BatchedSimulator's")

    # (d) times: host simulators against the card's sweep
    times = {}
    for sched, spec in (("wlbvt", wl9), ("rr", rr9)):
        pkts = len(build_traces(spec, arrays=True))
        eight = fig9_specs(sched, 8)
        pkts8 = sum(len(build_traces(s, arrays=True)) for s in eight)
        _, card8 = sync_time(lambda: DP.run_sweep_specs(eight))
        row = {"event_s": event[sched][1],
               "batched_s": host[f"fig9 {sched}"][1],
               "card_1_s": card[f"fig9 {sched}"][1], "card_8_s": card8}
        for k in list(row):
            n, p = (8, pkts8) if k == "card_8_s" else (1, pkts)
            row[k.replace("_s", "_scen_per_s")] = n / row[k]
            row[k.replace("_s", "_pkts_per_s")] = p / row[k]
        times[sched] = row
        log(f"time fig9 {sched} 300 us ({smi}): packets a replica {pkts}; "
            "host clock, traces included: "
            + " ".join(f"{k}={v!r}" for k, v in row.items()))
    return dict(launches={"ssd_scan": serve_launches["ssd_scan"],
                          "sweep_scan": sweep_launches["sweep_scan"]},
                times=times)


# ---------------------------------------------------------------------------
# phase 21: the observability planes
# ---------------------------------------------------------------------------
GOLDEN_SIM = ROOT / "tests" / "data" / "openmetrics_schema.sim.golden"
GOLDEN_SERVE = ROOT / "tests" / "data" / "openmetrics_schema.serve.golden"
BUDGET_PCT = 3.0     # recording's budget, in % of a step's time


class CommitProbe:
    """Wraps a ``"torch"`` ``Telemetry``'s ``commit`` and
    ``commit_window``: each call runs under
    ``torch.cuda.set_sync_debug_mode("error")`` (a host sync inside it
    raises) and only it, on the host clock, and between two CUDA events
    behind a spin kernel (``SPIN_CYCLES``, ~2 ms, over the ~1 ms a call
    can take the host to launch): the card is busy while the host
    launches the call's kernels, so the events bracket the kernels
    alone, their device time.  The spin hides behind the decode step
    that follows, whose launches take the host far longer than the card
    takes to run them."""

    SPIN_CYCLES = 4_000_000

    def __init__(self, tel):
        self.events = []
        self.host_s = []
        for name in ("commit", "commit_window"):
            setattr(tel, name, self._wrap(getattr(tel, name)))

    def _wrap(self, fn):
        def call(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(self.SPIN_CYCLES)
            start.record()
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                fn(*args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            self.host_s.append(time.perf_counter() - t0)
            end.record()
            self.events.append((start, end))
        return call

    def device_ms(self) -> np.ndarray:
        torch.cuda.synchronize()
        return np.array([s.elapsed_time(e) for s, e in self.events])


def warm_telemetry(T: int) -> None:
    """Load the ``"torch"`` backend's kernels and prime the pinned host
    allocator on a scratch state, so the serve's commits show their
    steady cost rather than the first launch's module load."""
    from repro_torch.telemetry import GAUGES, Telemetry
    tel = Telemetry(T, backend="torch")
    for _ in range(3):
        tel.inc("tokens", 0, 1.0)
        tel.lat(0, 3.0)
        tel.lat(0, 5.0)
        tel.commit()
        tel.commit_window(np.ones((len(GAUGES), T)))
    tel.snapshot()


def planes_phase(p5: dict, decode_device_ms: float, smi: str) -> dict:
    """Phase 21: (a) full-width Qwen3-8B serves phase 5's scenario with
    every plane on (the flight recorder, the bus with both exporters and
    a headless dashboard, the ``"torch"`` telemetry backend on the card);
    (b) the trace CLI's path, the scenario CLI's export and the telemetry
    report on the host; (c) their costs and the host legs' walls."""
    import io
    from repro_torch.launch import telemetry_report as report_cli
    from repro_torch.launch import trace as trace_cli
    from repro_torch.launch.dash import Dashboard
    from repro_torch.telemetry import export as E
    from repro_torch.telemetry.bus import MetricsBus
    from repro_torch.telemetry.traceview import write_perfetto
    out = ROOT / "build" / "chip_smoke_planes"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)

    # (a) the serve with every plane on
    cfg = dataclasses.replace(get_config("qwen3-8b"), attn_impl="pallas")
    spec = serve_spec(cfg, SEED)
    names = {i: t.name for i, t in enumerate(spec.tenants)}
    warm_telemetry(max(len(spec.tenants), 2))
    rt = ServeRuntime.from_spec(
        spec, executor=lambda e: ModelExecutor(cfg, e, rng_seed=SEED,
                                               device="cuda"),
        trace=True, telemetry_backend="torch")
    eng = rt.engine
    tel = eng.tel
    if tel.backend != "torch" or tel.state["hist"].device.type != "cuda":
        raise AssertionError(f"telemetry backend {tel.backend} on "
                             f"{tel.state['hist'].device}, want torch on "
                             "cuda")
    bus = MetricsBus()
    om, jl = E.attach_exporters(bus, str(out / "serve_mixed_slo.serve"),
                                names=names)
    panel = io.StringIO()
    dash = bus.add_sink(Dashboard(names=names, out=panel, color=False))
    undrained = bus.subscribe(maxlen=2, name="undrained")
    rt.attach_bus(bus)
    probe = CommitProbe(tel)
    trace_host = [0.0]
    maybe_commit = eng.trace.maybe_commit

    def timed_maybe_commit():
        t0 = time.perf_counter()
        maybe_commit()
        trace_host[0] += time.perf_counter() - t0

    eng.trace.maybe_commit = timed_maybe_commit
    ops.reset_launches()
    rep = rt.run(spec).validate()
    launches = dict(ops.LAUNCHES)
    bus.close()
    rt.flush_trace()
    dev = probe.device_ms()
    host = np.array(probe.host_s) * 1e3
    done = eng.done
    steps = int(rep.duration)
    decode_steps = rep.extras["decode_steps"]
    generated = sum(len(r.generated) for r in done)
    # the planes off again, right after, on the same weights
    ex = eng.exe
    rt_off = ServeRuntime.from_spec(spec, executor=ex)
    ops.reset_launches()
    rt_off.run(spec)
    off_launches = ops.LAUNCHES["decode_attention"]
    del rt_off
    log(f"serve qwen3-8b, every plane on ({smi}): steps={steps} "
        f"decode_steps={decode_steps} generated_tokens={generated}; the "
        f"planes off right after, same weights")
    log(rep.summary())
    if len(done) != 12 or any(r.status != RequestStatus.DONE for r in done):
        raise AssertionError("planes on: not every request ended done: "
                             + str([(r.rid, r.status.value) for r in done]))
    if (launches["decode_attention"] != cfg.num_layers * decode_steps
            or off_launches != launches["decode_attention"]):
        raise AssertionError(f"planes on / off: decode_attention launches "
                             f"{launches['decode_attention']} / "
                             f"{off_launches} != {cfg.num_layers} x "
                             f"{decode_steps}")
    # the schedule reads no token and the planes only watch it: the
    # report equals phase 5's but for the trace summary and the
    # telemetry block's backend label
    got = RunReport.from_json(rep.to_json())
    summary = got.extras.pop("trace_summary")
    if got.telemetry["backend"] != "torch":
        raise AssertionError("planes on: the report's telemetry backend "
                             f"is {got.telemetry['backend']}")
    got.telemetry["backend"] = "numpy"
    if got.to_json() != p5["json"]:
        raise AssertionError("planes on: the RunReport differs from phase "
                             "5's beyond trace_summary")
    log("check: the planes-on RunReport equals phase 5's byte for byte "
        "without extras['trace_summary'] and with the telemetry block's "
        "backend label (torch) read as phase 5's (numpy)")
    schema = E.schema_lines(Path(om.path).read_text())
    want = [ln.strip() for ln in GOLDEN_SERVE.read_text().splitlines()
            if ln.strip()]
    if schema != want:
        raise AssertionError(f"serve OpenMetrics schema != golden: {schema}")
    snap = tel.snapshot()
    for k in ("counts", "hist", "ptr"):
        if not np.array_equal(snap[k], p5["snap"][k]):
            raise AssertionError(f"torch telemetry {k} != numpy backend's")
    ring_err = float(np.abs(snap["ring"] - p5["snap"]["ring"]).max())
    if not np.allclose(snap["ring"], p5["snap"]["ring"], rtol=1e-6,
                       atol=1e-6):
        raise AssertionError(f"torch telemetry ring off by {ring_err}")
    from repro_torch.telemetry import metrics as M
    pow2 = 2.0 ** np.arange(34)
    edges = M.bucket_index_torch(torch.tensor(pow2, device="cuda"), 32)
    if not np.array_equal(edges.cpu().numpy(), M.bucket_index(pow2, 32, np)):
        raise AssertionError("bucket_index_torch misplaces a power of two")
    log(f"check: torch telemetry on the card: counts, histogram and ptr "
        f"equal phase 5's numpy backend, ring max |diff| {ring_err:.3e} "
        f"(tol 1e-6), the powers of two 2^0..2^33 in their buckets; "
        f"{len(probe.events)} commit calls, none synced the host "
        f"(sync debug mode error); OpenMetrics schema equals "
        f"{GOLDEN_SERVE.name}")
    dev_step = dev.sum() / steps
    share = dev_step / decode_device_ms
    log(f"time telemetry commits ({smi}): device time of a step's commit "
        f"pair {dev_step:.4f} ms ({len(dev)} calls in {steps} steps, CUDA "
        f"events behind a spin kernel; a call's median {np.median(dev):.4f}"
        f" ms, max {dev.max():.4f} ms), {100 * share:.3f} % of a decode "
        f"step's device time ({decode_device_ms:.3f} ms, phase 7's "
        f"profile), budget {BUDGET_PCT} %; host {host.sum() / steps:.4f} "
        f"ms a step (a call's median {np.median(host):.4f} ms, max "
        f"{host.max():.4f} ms)")
    if 100 * share >= BUDGET_PCT:
        raise AssertionError(f"telemetry commits {100 * share:.3f} % of a "
                             f"decode step >= {BUDGET_PCT} %")
    perfetto = out / "serve_mixed_slo.perfetto.json"
    doc = write_perfetto(eng.trace, str(perfetto), time_unit="steps",
                         tenant_names=names)
    log(f"trace ({smi}): maybe_commit host time "
        f"{trace_host[0] / steps * 1e3:.4f} ms a step; spans recorded "
        f"{summary['spans_recorded']} retained {summary['spans_retained']}"
        f", decisions recorded {summary['decisions_recorded']} retained "
        f"{summary['decisions_retained']}; bus frames published "
        f"{bus.published}, dropped {bus.dropped} (a 2-deep subscription "
        f"never drained: {undrained.dropped}), JSONL lines {jl.lines}, "
        f"dashboard frames {dash.frames} ({len(panel.getvalue())} chars); "
        f"Perfetto {len(doc['traceEvents'])} events, "
        f"{perfetto.stat().st_size} bytes")
    if not (summary["spans_recorded"] and summary["decisions_recorded"]
            and bus.published and jl.lines == bus.published
            and dash.frames == bus.published):
        raise AssertionError("planes on: a plane recorded nothing")
    del rt, eng, tel, ex
    torch.cuda.empty_cache()

    # (b) host legs: the trace CLI's path at fig9's published 300 us on
    # both datapaths, the scenario CLI's export, the telemetry report
    walls = {}
    traced = {}
    for dp in ("event", "batched"):
        (r, tr, s9), walls[f"trace_fig9_{dp}_s"] = sync_time(
            lambda: trace_cli.run_traced("fig9_congestor_victim", "sim", {},
                                         datapath=dp))
        traced[dp] = (r, tr)
        doc = write_perfetto(tr, str(out / f"fig9.{dp}.json"),
                             time_unit=r.time_unit)
        log(f"trace CLI fig9_congestor_victim {s9.duration_us:g} us "
            f"--datapath {dp}: {tr.span_count} spans, {tr.decision_count} "
            f"decisions, Perfetto {len(doc['traceEvents'])} events")
    (r_ev, t_ev), (r_ba, t_ba) = traced["event"], traced["batched"]
    for what, a, b in (("decision", t_ev.decision_rows(),
                        t_ba.decision_rows()),
                       ("span", t_ev.rows(), t_ba.rows())):
        bad = [k for k in a if not np.array_equal(a[k], b[k])]
        if bad or not len(a[next(iter(a))]):
            raise AssertionError(f"fig9 {what} rows differ across "
                                 f"datapaths: {bad}")
    if r_ev.to_json() != r_ba.to_json().replace('"datapath": "batched"',
                                                 '"datapath": "event"'):
        raise AssertionError("fig9 traced reports differ across datapaths")
    log("check: fig9 at 300 us, event loop and batched datapath: decision "
        "rows, span rows and RunReport (but for the spec's datapath) "
        "identical")
    rc, walls["scenario_qos_export_s"] = sync_time(lambda: scenario_cli.main(
        ["qos_closed_loop", "--export", str(out)]))
    gate = E.main(["--schema", str(out / "qos_closed_loop.sim.om.txt"),
                   "--golden", str(GOLDEN_SIM)])
    if rc or gate:
        raise AssertionError(f"scenario --export: rc {rc}, golden gate "
                             f"{gate}")
    rc, walls["telemetry_report_sim_s"] = sync_time(lambda: report_cli.main(
        ["--surface", "sim", "--controller"]))
    if rc:
        raise AssertionError(f"telemetry_report: rc {rc}")
    log(f"time host legs ({smi}): "
        + " ".join(f"{k}={v!r}" for k, v in walls.items()))
    return dict(launches={"decode_attention": launches["decode_attention"]
                          + off_launches},
                share=share)


# ---------------------------------------------------------------------------
# phase 22: the dense, vision-language and MoE/MLA families
# ---------------------------------------------------------------------------
# published widths; depth as served here (full but for Gemma2-27B, 12 of
# 46 layers, and Qwen2-VL-72B, 6 of 80: f32 parameters of one 80 GB card)
NEW_FAMILIES = [("codeqwen1.5-7b", 32), ("gemma-7b", 28), ("gemma2-27b", 12),
                ("qwen2-vl-72b", 6), ("deepseek-v2-lite-16b", 27)]
MLA_TOL = 5e-3        # tests/test_models.py's absorbed-vs-expanded bound


def check_mla_absorbed(module, cfg) -> None:
    """Full-width DeepSeek-V2-Lite in fp32: the absorbed prefill's logits
    (latent MQA, K dim rank + rope, V dim rank, against the cache) agree
    with the expanded cache-free forward's over the same 2 x 16 tokens
    (5e-3, as the reference's absorbed-vs-expanded test); both legs run
    ``gshard`` on the same rows, so they route the same tokens."""
    f32 = dataclasses.replace(cfg, dtype="float32")
    model = build_model(f32, moe_impl="gshard")
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    toks = torch.randint(1, cfg.vocab_size, (2, 16), generator=g,
                         device="cuda", dtype=torch.int32)
    served = module.cfg
    module.cfg = f32
    try:
        with torch.no_grad():
            expanded, _ = model.forward(module, {"tokens": toks})
            absorbed, _ = model.prefill(
                module, toks, model.init_cache(2, 32, "cuda"),
                torch.zeros(2, dtype=torch.int32, device="cuda"))
    finally:
        module.cfg = served
    err = (absorbed - expanded).abs().max().item()
    finite = bool(torch.isfinite(absorbed).all())
    log(f"check {cfg.name} ({cfg.num_layers} layers) full-width fp32: "
        f"absorbed prefill vs expanded forward max_abs_err={err:.4g} "
        f"tol={MLA_TOL:g} max_abs_logit={expanded.abs().max().item():.4g} "
        f"finite={finite}")
    if err > MLA_TOL or not finite:
        raise AssertionError(f"{cfg.name}: absorbed MLA disagrees with the "
                             "expanded path")


def serve_family(arch: str, depth: int, smi: str) -> dict:
    """Phase 22 for one model: its fp32 smoke config on the card, then
    its published widths at ``depth`` layers, random weights from SEED,
    serving phase 5's ``serve_mixed_slo``; every request done, the decode
    kernel exactly once a layer a decode step (never for MLA, whose
    absorbed decode takes the plain path), the full-width logits check,
    wall, tokens/s, peak memory and one profiled decode step.  Returns
    the serve's kernel launches, its RunReport JSON and the decode step's
    device time."""
    cfg = dataclasses.replace(get_config(arch), attn_impl="pallas",
                              num_layers=depth)
    mla = cfg.mla is not None
    check_small(arch, 24, 16, kernels=not mla)
    rt, rep, launches = serve(cfg, SEED)
    done = rt.engine.done
    pc, ds = rep.extras["prefill_chunks"], rep.extras["decode_steps"]
    generated = sum(len(r.generated) for r in done)
    peak = torch.cuda.max_memory_allocated()
    ex = rt.engine.exe
    n_params = sum(p.numel() for p in ex.params.parameters())
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want["decode_attention"] = 0 if mla else cfg.num_layers * ds
    log(f"serve {arch} ({smi}): layers={cfg.num_layers} of "
        f"{get_config(arch).num_layers} d_model={cfg.d_model} "
        f"heads={cfg.num_heads}/{cfg.num_kv_heads} head_dim={cfg.head_dim} "
        f"params={n_params} steps={int(rep.duration)} "
        f"prefill_chunks={pc} decode_steps={ds} "
        f"generated_tokens={generated} "
        f"max_memory_allocated={peak} launches={launches}")
    log(rep.summary())
    if len(done) != 12 or any(r.status != RequestStatus.DONE for r in done):
        raise AssertionError(f"{arch}: not every request ended done: " + str(
            [(r.rid, r.status.value) for r in done]))
    if launches != want:
        raise AssertionError(f"{arch}: launches {launches}, want {want}")
    if mla:
        check_mla_absorbed(ex.params, cfg)
    else:
        check_full_width(ex.params, cfg)
    B = 8
    dec_ms = profile_step(f"{arch} full-width decode step", lambda: ex.decode(
        np.ones(B, np.int32), np.full(B, 128, np.int32), np.ones(B, bool)),
        kernel="" if mla else "decode_attention")
    del rt, ex
    torch.cuda.empty_cache()
    return dict(launches=launches, json=rep.to_json(), dec_ms=dec_ms)


# ---------------------------------------------------------------------------
# phase 23: the encoder-decoder (whisper-large-v3)
# ---------------------------------------------------------------------------
WHISPER = "whisper-large-v3"
WHISPER_TRAIN = dict(layers=2, B=2, S=448)   # S: Whisper's decoder context


def profile_cross_share(label: str, step) -> None:
    """One profiled decode step of Whisper: its device time and the decode
    kernel's, split into the self-attention launches and the
    cross-attention ones (each layer launches self, then cross, so the
    kernel's launches alternate in time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()                                      # warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    total = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    dec = sorted((e for e in kernels if "decode_attention" in e.name),
                 key=lambda e: e.time_range.start)
    self_ms = sum(e.time_range.elapsed_us() for e in dec[0::2]) / 1e3
    cross_ms = sum(e.time_range.elapsed_us() for e in dec[1::2]) / 1e3
    log(f"profile: {label}: device time {total:.3f} ms over {len(kernels)} "
        f"kernels; decode_attention {len(dec)} launches, self "
        f"{self_ms:.4f} ms ({self_ms / total:.4f} of device time, "
        f"{self_ms / max(len(dec[0::2]), 1) * 1e3:.3f} us a launch), cross "
        f"{cross_ms:.4f} ms ({cross_ms / total:.4f}, "
        f"{cross_ms / max(len(dec[1::2]), 1) * 1e3:.3f} us a launch)")


def whisper_encoder_leg(module, cfg) -> dict:
    """Phase 23 (c): ``Model.prefill(frames=...)`` on 8 x 1500 random
    frames (every encoder layer one non-causal flash launch, every
    decoder layer's cross K/V filled), then 4 decode steps (self and
    cross decode launches a layer); the kernel path's logits against the
    ``chunked`` path's (5 % of the range); the prefill's wall and device
    time.  Returns the launches."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    B, C, steps = 8, 32, 4
    frames = torch.randn((B, cfg.num_audio_frames, cfg.d_model),
                         generator=g, device="cuda")
    prompts = torch.randint(1, cfg.vocab_size, (B, C), generator=g,
                            device="cuda", dtype=torch.int32)
    toks = torch.randint(1, cfg.vocab_size, (B, steps), generator=g,
                         device="cuda", dtype=torch.int32)
    trace = []
    ops.reset_launches()
    ker = prefill_decode_logits(cfg, module, 256, prompts, toks, frames,
                                trace)
    launches = dict(ops.LAUNCHES)
    plain = prefill_decode_logits(dataclasses.replace(
        cfg, attn_impl="chunked"), module, 256, prompts, toks, frames)
    per_step = [b["decode_attention"] - a["decode_attention"]
                for a, b in zip(trace, trace[1:])]
    want_pre = dict.fromkeys(ops.LAUNCHES, 0)
    want_pre["flash_attention"] = cfg.encoder_layers
    errs = [(a - b).abs().max().item() for a, b in zip(ker, plain)]
    scales = [b.abs().max().item() for b in plain]
    agree = (ker[1].argmax(-1) == plain[1].argmax(-1)).float().mean().item()
    finite = all(bool(torch.isfinite(x).all()) for x in ker)
    log(f"check {cfg.name} encoder leg: frames {tuple(frames.shape)}, "
        f"prefill of {C} tokens launches {trace[0]}, decode launches a "
        f"step {per_step}; logits (prefill, decode 1-{steps}) max_abs_err "
        f"{[f'{e:.4g}' for e in errs]} of max_abs_logit "
        f"{[f'{x:.4g}' for x in scales]} (tol 5 % of it), decode 1 "
        f"greedy_agreement={agree:.3f} finite={finite}")
    if trace[0] != want_pre or per_step != [2 * cfg.num_layers] * steps:
        raise AssertionError(f"{cfg.name} encoder leg: launches {trace}, "
                             f"want {want_pre} in the prefill and "
                             f"{2 * cfg.num_layers} decode launches a step")
    if not finite or ker[1].shape != (B, cfg.vocab_size) \
            or errs[1] > 0.05 * scales[1]:
        raise AssertionError(f"{cfg.name} encoder leg: the kernel path's "
                             "decode logits disagree with chunked")
    model = build_model(cfg)
    cache = model.init_cache(B, 256, "cuda")
    zeros = torch.zeros(B, dtype=torch.int32, device="cuda")

    def prefill():
        with torch.no_grad():
            model.prefill(module, prompts, cache, zeros, frames=frames)
    profile_step(f"{cfg.name} encoder prefill (8 x 1500 frames, 8 x {C} "
                 f"tokens)", prefill, kernel="flash_")
    return launches


def whisper_train_batch():
    """Phase 23 (d)'s config (Whisper's widths at 2 encoder + 2 decoder
    layers) and its batch: 2 x 448 tokens and labels, 2 x 1500 random
    frames, from SEED + 6."""
    W = WHISPER_TRAIN
    base = dataclasses.replace(get_config(WHISPER), num_layers=W["layers"],
                               encoder_layers=W["layers"])
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    batch = {
        "tokens": torch.randint(1, base.vocab_size, (W["B"], W["S"]),
                                generator=g, device="cuda",
                                dtype=torch.int32),
        "labels": torch.randint(1, base.vocab_size, (W["B"], W["S"]),
                                generator=g, device="cuda",
                                dtype=torch.int32),
        "frames": torch.randn((W["B"], base.num_audio_frames, base.d_model),
                              generator=g, device="cuda")}
    return base, batch


def whisper_want(base) -> dict:
    """The flash launches of 2 training steps of ``base`` (under full
    remat every layer's forward runs twice a step)."""
    n_attn = base.encoder_layers + base.num_layers
    passes = 2 if base.remat != "none" else 1
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want.update(flash_attention=2 * passes * n_attn,
                flash_attention_bwd=2 * n_attn)
    return want


def whisper_train_leg() -> dict:
    """Phase 23 (d): Whisper's published widths at 2 encoder + 2 decoder
    layers, AdamW, batches of 2 x 448 tokens with 2 x 1500 random frames,
    2 steps under ``pallas`` and under ``chunked`` from the same seed:
    losses and grad norms within 1e-2, the flash launches exact (under
    full remat every layer's forward runs twice a step: the encoder's
    non-causal and the decoder's causal self-attention; the
    cross-attention, 448 queries over 1500 frames, takes the plain
    path).  Returns the pallas leg (its launches and steps)."""
    from repro_torch.training.trainer import build_trainer
    W = WHISPER_TRAIN
    base, batch = whisper_train_batch()
    legs = {}
    for impl in ("pallas", "chunked"):
        cfg = dataclasses.replace(base, attn_impl=impl)
        trainer = build_trainer(cfg, total_steps=10, device="cuda")
        state = trainer.init_state(SEED)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        hist = []
        for _ in range(2):
            (state, m), wall = sync_time(
                lambda: trainer.train_step(state, batch))
            hist.append(dict(loss=m["loss"].item(),
                             grad_norm=m["grad_norm"].item(), step_s=wall))
        legs[impl] = dict(hist=hist, launches=dict(ops.LAUNCHES),
                          peak=torch.cuda.max_memory_allocated(),
                          params=sum(p.numel()
                                     for p in state.params.parameters()))
        del state, trainer
        torch.cuda.empty_cache()
    ker, plain = legs["pallas"], legs["chunked"]
    want = whisper_want(base)
    diffs = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
             for a, b in zip(ker["hist"], plain["hist"])]
    gdiffs = [abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"])
              for a, b in zip(ker["hist"], plain["hist"])]
    log(f"train {WHISPER} widths: {base.encoder_layers} + {base.num_layers} "
        f"layers (of 32 + 32), params={ker['params']}, remat={base.remat}, "
        f"optimizer={base.optimizer}, batch {W['B']} x {W['S']} tokens, "
        f"{W['B']} x {base.num_audio_frames} frames; pallas launches "
        f"{ker['launches']} (want {want}); losses "
        f"{[h['loss'] for h in ker['hist']]} vs chunked "
        f"{[h['loss'] for h in plain['hist']]} rel diff "
        f"{[f'{d:.2e}' for d in diffs]} (tol 1e-2); grad norms "
        f"{[h['grad_norm'] for h in ker['hist']]} vs "
        f"{[h['grad_norm'] for h in plain['hist']]} rel diff "
        f"{[f'{d:.2e}' for d in gdiffs]} (tol 1e-2); step_s pallas "
        f"{[round(h['step_s'], 4) for h in ker['hist']]} chunked "
        f"{[round(h['step_s'], 4) for h in plain['hist']]}; "
        f"max_memory_allocated pallas {ker['peak']} chunked {plain['peak']}")
    if ker["launches"] != want or any(plain["launches"].values()):
        raise AssertionError(f"{WHISPER} training: launches "
                             f"{ker['launches']} / {plain['launches']}, "
                             f"want {want} / none")
    if not all(math.isfinite(h["loss"]) for h in ker["hist"]) \
            or max(diffs + gdiffs) > 1e-2:
        raise AssertionError(f"{WHISPER} training: the kernel path's losses "
                             "or grad norms disagree with chunked")
    return ker


def whisper_phase(smi: str) -> dict:
    """Phase 23: (a) the fp32 smoke config with random frames, kernel path
    against ``chunked`` (a prefill as long as the frames, whose
    cross-attention takes the flash kernel, and a longer one); (b) the
    published widths and full depth serve phase 5's scenario over the
    zero cross K/V the engine serves with; (c) the encoder leg; (d)
    training; (e) the times of the three new kernel shapes.  Returns the
    main paths' launches and the times."""
    check_small(WHISPER, 16, 4)
    check_small(WHISPER, 24, 16)
    cfg = dataclasses.replace(get_config(WHISPER), attn_impl="pallas")
    rt, rep, launches = serve(cfg, SEED)
    done = rt.engine.done
    pc, ds = rep.extras["prefill_chunks"], rep.extras["decode_steps"]
    generated = sum(len(r.generated) for r in done)
    peak = torch.cuda.max_memory_allocated()
    ex = rt.engine.exe
    n_params = sum(p.numel() for p in ex.params.parameters())
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want["decode_attention"] = 2 * cfg.num_layers * ds
    log(f"serve {WHISPER} ({smi}): encoder {cfg.encoder_layers} + decoder "
        f"{cfg.num_layers} layers, d_model={cfg.d_model} "
        f"heads={cfg.num_heads}/{cfg.num_kv_heads} head_dim={cfg.head_dim} "
        f"frames={cfg.num_audio_frames} params={n_params} "
        f"steps={int(rep.duration)} prefill_chunks={pc} "
        f"decode_steps={ds} generated_tokens={generated} "
        f"max_memory_allocated={peak} launches={launches}")
    log(rep.summary())
    if len(done) != 12 or any(r.status != RequestStatus.DONE for r in done):
        raise AssertionError(f"{WHISPER}: not every request ended done: "
                             + str([(r.rid, r.status.value) for r in done]))
    if launches != want:
        raise AssertionError(f"{WHISPER}: launches {launches}, want {want}")
    B = 8
    tokens, full = np.ones(B, np.int32), np.full(B, 128, np.int32)
    active = np.ones(B, bool)
    dec_ms = profile_step(f"{WHISPER} full-width decode step",
                          lambda: ex.decode(tokens, full, active),
                          kernel="decode_attention")
    profile_cross_share(f"{WHISPER} full-width decode step",
                        lambda: ex.decode(tokens, full, active))
    enc = whisper_encoder_leg(ex.params, cfg)
    del rt, ex
    torch.cuda.empty_cache()
    train = whisper_train_leg()
    cross_t = time_decode_attention(WHISPER_CROSS["T"], 50,
                                    shape=WHISPER_CROSS)
    log("time decode_attention bf16 whisper cross (ms, library_ms: "
        "CUDA-graph replays; eager_ms, library_eager_ms, plain_ms: launched "
        f"from Python; {smi}) " + fields(cross_t))
    enc_t = time_flash_attention(10, WHISPER_ENC)
    log(f"time flash_attention bf16 whisper encoder B=8 S=T=1500 Hq=Hkv=20 "
        f"D=64 non-causal ({smi}) " + fields(enc_t))
    return dict(serve=launches, encoder=enc, train=train["launches"],
                train_hist=train["hist"], cross_t=cross_t, enc_t=enc_t,
                json=rep.to_json(), dec_ms=dec_ms)


# ---------------------------------------------------------------------------
# phase 24: the fleet plane, its single-NIC twins and the examples
# ---------------------------------------------------------------------------
GOLDEN_FLEET = ROOT / "tests" / "data" / "openmetrics_schema.fleet.golden"
FLEET = ("fleet_fabric", "fleet_incast", "fleet_migrate")
TWIN_SEEDS = 8
TRAIN_100M_STEPS = 100


def fleet_drift_free(rep) -> str:
    """tests/test_fleet.py's projection: the report but the time-averaged
    Jain accumulators (last-ulp drift between the datapaths) and the spec
    echoes (their ``datapath`` differs)."""
    d = rep.to_dict()
    d.pop("spec")
    d.pop("jain_pu"), d.pop("jain_io")
    for pn in d["extras"]["fleet"]["per_nic"]:
        pn.pop("spec")
        pn.pop("jain_pu"), pn.pop("jain_io")
    return json.dumps(d, sort_keys=True)


def fleet_run(name: str, params: dict, smi: str):
    """One fleet scenario through the scenario CLI's ``run_one`` (host
    code); the report validated and the switch's conservation law held."""
    spec = get_scenario(name, **params)
    pkts = len(build_traces(spec, arrays=True))
    t0 = time.perf_counter()
    rep = scenario_cli.run_one(name, "sim", params)
    wall = time.perf_counter() - t0
    rep.validate()
    fl = rep.extras["fleet"]
    sw = fl["switch"]
    lhs = sum(sw["injected"]) + sum(sw["replayed"])
    rhs = sum(sw["delivered"]) + sw["drops_total"] + sw["inflight"]
    log(f"fleet {name} {params}: nics={fl['num_nics']} epochs={fl['epochs']} "
        f"migrations={fl['migrations_total']} switch drops="
        f"{sw['drops_total']} jain_fleet={fl['jain_fleet']!r} "
        f"injected+replayed={lhs} delivered+drops+inflight={rhs}; host "
        f"wall {wall:.4f} s on the card's machine ({smi}), {pkts} packets, "
        f"{pkts / wall:.1f} packets/s")
    if lhs != rhs:
        raise AssertionError(f"fleet {name}: the switch lost packets "
                             f"({lhs} != {rhs})")
    return rep


def fleet_leg(smi: str) -> None:
    """Phase 24 (a): the fleet plane at its published sizes, host code."""
    from repro_torch.fleet import FleetSpec, run_fleet
    from repro_torch.telemetry.export import schema_lines
    reps = {}
    for name in FLEET:
        for dp in ("event", "batched"):
            reps[name, dp] = fleet_run(name, {"datapath": dp}, smi)
        if (fleet_drift_free(reps[name, "event"])
                != fleet_drift_free(reps[name, "batched"])):
            raise AssertionError(f"fleet {name}: the event and batched "
                                 "datapaths' reports differ")
    log("check: every fleet report's drift-free projection is equal on the "
        "event and batched datapaths")
    # the incast: output 0 saturates, the quiet pair stays flat
    rep = reps["fleet_incast", "event"]
    n, sw = rep.spec["num_nics"], rep.extras["fleet"]["switch"]
    util, lat = sw["link_utilization"], np.asarray(sw["pair_latency_mean"])
    quiet = rep.spec["tenants"][-1]["arrival"]["size"]
    ideal = quiet * 8.0 / rep.spec["link_gbps"] + rep.spec["prop_delay_ns"]
    hot, flat = float(lat[:n - 1, 0].mean()), float(lat[n - 1, n - 1])
    log(f"check fleet_incast: output 0 utilization {util[0]!r}, quiet "
        f"output {util[-1]!r}; quiet pair latency {flat!r} ns "
        f"(ideal {ideal!r}), hot pairs' mean {hot!r} ns")
    if not (util[0] > 0.9 and util[-1] < 0.1
            and 0.0 < flat < 3.0 * ideal and hot > 10.0 * flat):
        raise AssertionError("fleet_incast: VOQ isolation does not hold")
    # the migration: the victim moves, its p99 beats the control arm's
    mig = reps["fleet_migrate", "event"]
    ctl = fleet_run("fleet_migrate", {"migrate": False}, smi)
    a, b = mig.extras["fleet"], ctl.extras["fleet"]
    kinds = [e["kind"] for e in mig.events]
    m0 = a["migrations"][0] if a["migrations"] else {}
    log(f"check fleet_migrate: migrations {a['migrations']}, victim sojourn "
        f"p99 {a['sojourn_p99'][2]!r} ns against the control arm's "
        f"{b['sojourn_p99'][2]!r} (target "
        f"{mig.spec['tenants'][2]['p99_target']!r}), jain_fleet "
        f"{a['jain_fleet']!r} against {b['jain_fleet']!r}")
    if not (a["migrations_total"] >= 1 and b["migrations_total"] == 0
            and (m0.get("tenant"), m0.get("src"), m0.get("dst")) == (2, 0, 1)
            and "migrate_start" in kinds and "migrate_done" in kinds
            and a["sojourn_p99"][2] < 0.5 * b["sojourn_p99"][2]
            and a["sojourn_p99"][2] < mig.spec["tenants"][2]["p99_target"]
            and a["jain_fleet"] >= b["jain_fleet"] - 0.05):
        raise AssertionError("fleet_migrate: the migration checks failed")
    # N = 1 over the ideal fabric is the single NIC, byte for byte
    base = get_scenario("qos_closed_loop")
    fs = FleetSpec(**{f.name: getattr(base, f.name)
                      for f in dataclasses.fields(ScenarioSpec)},
                   num_nics=1, link_gbps=0.0, prop_delay_ns=0.0)
    for dp in ("event", "batched"):
        one = run_fleet(fs.replace(datapath=dp))
        single = run_scenario(fs.plain().replace(datapath=dp))
        if (json.dumps(one.extras["fleet"]["per_nic"][0], sort_keys=True)
                != json.dumps(single.to_dict(), sort_keys=True)):
            raise AssertionError(f"N = 1 fleet ({dp}) != the single NIC")
    log("check: an N = 1 ideal-fabric fleet of qos_closed_loop equals "
        "run_scenario(spec.plain()) byte for byte on both datapaths")
    out = ROOT / "build" / "chip_smoke_fleet_export"
    shutil.rmtree(out, ignore_errors=True)
    scenario_cli.run_one("fleet_fabric", "sim", {}, fast=True,
                         export_dir=str(out))
    got = schema_lines((out / "fleet_fabric.sim.om.txt").read_text())
    if got != GOLDEN_FLEET.read_text().splitlines():
        raise AssertionError("fleet_fabric --fast --export: the OpenMetrics "
                             "schema differs from the fleet golden")
    log("check: fleet_fabric --fast --export matches "
        "tests/data/openmetrics_schema.fleet.golden")


def twins_leg(smi: str) -> int:
    """Phase 24 (b): the fleets' single-NIC twins (``FleetSpec.plain()``)
    through the card's sweep, held against the port's host
    ``BatchedSimulator``; ``fleet_migrate``'s twin must be refused.
    Returns the sweeps' ``sweep_scan`` launches."""
    launches = 0
    for name in ("fleet_fabric", "fleet_incast"):
        twin = get_scenario(name).plain().replace(record_timeline=False)
        sweep = SweepSpec(name=f"{name}.plain", base=twin,
                          seeds=tuple(range(TWIN_SEEDS)))
        rows, leg, wall, _ = run_sweep_leg(f"{name} twin (T "
                                           f"{len(twin.tenants)})", sweep)
        launches += leg["sweep_scan"]
        specs = sweep.specs()
        ops.reset_launches()
        card = DP.run_sweep_specs(specs, record_completions=True,
                                  device="cuda")
        if ops.LAUNCHES["sweep_scan"] != 1 or ops.LAUNCHES["wlbvt_select"]:
            raise AssertionError(f"{name} twin: {dict(ops.LAUNCHES)}")
        if [d.summary_row(k) for (k, _), d in
                zip(sweep.replicas(), card)] != rows:
            raise AssertionError(f"{name} twin: the recorded run's rows "
                                 "differ from run_sweep's")
        host_s = 0.0
        for i, (spec, d) in enumerate(zip(specs, card)):
            h, hw = host_run(spec, "batched")
            host_s += hw
            check_card_against_host(f"{name} twin seed {i}", spec, h, d)
        pkts = sum(len(build_traces(s, arrays=True)) for s in specs)
        log(f"time {name} twin, {TWIN_SEEDS} seeds ({smi}): card sweep "
            f"{wall:.4f} s ({pkts / wall:.1f} packets/s), host "
            f"BatchedSimulator {host_s:.4f} s ({pkts / host_s:.1f} "
            "packets/s); host clocks")
    twin = get_scenario("fleet_migrate").plain().replace(
        record_timeline=False)
    try:
        run_sweep(SweepSpec(name="fleet_migrate.plain", base=twin),
                  device="cuda")
    except DP.DevicePathError as e:
        if "QoS controller" not in str(e):
            raise
        log(f"check: fleet_migrate's twin is refused: {e}")
    else:
        raise AssertionError("fleet_migrate's twin ran on the card")
    return launches


class TwinExecutor(ModelExecutor):
    """A ``ModelExecutor`` under the kernels with a ``chunked`` twin on
    the same weights, run call for call: the twin gets the same tokens,
    lengths, valid counts and slot resets, so its cache follows the
    kernel path's.  Each prefill's tokens must be equal (no kernel runs
    there); each decode step's logits are held against the twin's on the
    active rows (``steps``: max |diff| / max |twin logit|, greedy tokens
    equal, rows compared; ``launched``: the decode kernel's launches on
    the kernel path and on the twin's).  The engine is served the kernel
    path's tokens."""

    def __init__(self, model_cfg, ecfg, **kw):
        super().__init__(model_cfg, ecfg, **kw)
        self.plain_cfg = dataclasses.replace(model_cfg, attn_impl="chunked")
        self.twin = ModelExecutor(self.plain_cfg, ecfg, params=self.params,
                                  device=self.device)
        self.steps, self.prefills_equal = [], []
        self.launched = [0, 0]

    @contextlib.contextmanager
    def as_plain(self):
        """The shared module runs as the twin's config while inside."""
        served, self.params.cfg = self.params.cfg, self.plain_cfg
        try:
            yield
        finally:
            self.params.cfg = served

    def prefill(self, tokens, lengths, valid_n):
        nxt = super().prefill(tokens, lengths, valid_n)
        with self.as_plain():
            twin = self.twin.prefill(tokens, lengths, valid_n)
        self.prefills_equal.append(bool(np.array_equal(nxt, twin)))
        return nxt

    def _logits(self, ex, tokens, lengths, active):
        """``ex``'s decode step, as ``serve_step``'s ``decode`` runs it,
        returning the logits (B, V)."""
        with torch.no_grad():
            logits, ex.cache = ex.fns.model.decode_step(
                self.params, ex._dev(tokens)[:, None], ex.cache,
                ex._dev(lengths), valid=ex._dev(active).bool()[:, None])
        return logits[:, -1]

    def decode(self, tokens, lengths, active):
        n0 = ops.LAUNCHES["decode_attention"]
        got = self._logits(self, tokens, lengths, active)
        n1 = ops.LAUNCHES["decode_attention"]
        with self.as_plain():
            want = self._logits(self.twin, tokens, lengths, active)
        self.launched[0] += n1 - n0
        self.launched[1] += ops.LAUNCHES["decode_attention"] - n1
        rows = torch.as_tensor(active, device=self.device).bool()
        g, w = got[rows].float(), want[rows].float()
        self.steps.append((((g - w).abs().max() / w.abs().max()).item(),
                           int((g.argmax(-1) == w.argmax(-1)).sum()),
                           int(rows.sum())))
        return sample(got).cpu().numpy()

    def reset(self, keep):
        super().reset(keep)
        self.twin.reset(keep)


# The examples' legs against the plain (chunked) path on the same bf16
# inputs, as max |diff| over max |plain|.  Rounding alone gives up to ~0.04
# at these shapes; a wrong kernel gives 0.15-1.9 (tried on the plain
# versions: a fill off by one, the scale off by 25 %, values shifted a
# slot, no causal mask, dv off by 10 %, dq zero).
SERVE_LOGIT_TOL = 0.1
TRAIN_LOGIT_TOL = 0.1
TRAIN_GRAD_TOL = 0.1


def check_served_against_chunked(label: str, example, run):
    """``run()`` (its prints dropped) serves through ``example``'s
    ``ModelExecutor`` replaced by a ``TwinExecutor``: every decode step's
    logits of the kernel path within ``SERVE_LOGIT_TOL`` of the chunked
    twin's, and every prefill's tokens equal.  Returns what ``run()``
    returns."""
    made = []

    class Twin(TwinExecutor):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)
    served = example.ModelExecutor
    example.ModelExecutor = Twin
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            out = run()
    finally:
        example.ModelExecutor = served
    (ex,) = made
    steps, prefills = ex.steps, ex.prefills_equal
    worst = max(s[0] for s in steps)
    agree, rows = sum(s[1] for s in steps), sum(s[2] for s in steps)
    want = [ex.params.cfg.num_layers * len(steps), 0]
    log(f"check {label}: kernel path against a chunked twin on the same "
        f"weights and inputs, {len(steps)} decode steps: max |logit diff| "
        f"/ max |logit| {worst:.3e} (tol {SERVE_LOGIT_TOL:g}), greedy "
        f"tokens equal {agree}/{rows}; {len(prefills)} prefills' tokens "
        f"equal {sum(prefills)}/{len(prefills)}; decode kernel launches, "
        f"kernel path / twin, {ex.launched} (want {want})")
    if worst > SERVE_LOGIT_TOL or not all(prefills) or ex.launched != want:
        raise AssertionError(f"{label}: the kernel path's decode logits "
                             "disagree with the chunked twin's")
    return out


def check_train_against_chunked(label: str, cfg, batch) -> None:
    """A training leg's first micro-batch ``batch`` at the leg's own shape
    and dtype, from the leg's initial weights (``init_state(0)``): the
    loss, the logits and every parameter's gradient through the flash
    kernels (forward and backward, under the config's remat) against
    those through ``chunked`` attention."""
    from repro_torch.training.trainer import build_trainer, cross_entropy
    trainer = build_trainer(cfg, device="cuda")
    module = trainer.init_state(0).params
    legs, launched = {}, {}
    for impl in ("pallas", "chunked"):
        module.cfg = dataclasses.replace(cfg, attn_impl=impl)
        module.zero_grad(set_to_none=True)
        ops.reset_launches()
        logits, _ = trainer.model.forward(module, batch)
        loss_sum, n_tok = cross_entropy(logits, batch["labels"])
        loss = loss_sum / torch.clamp(n_tok, min=1).to(loss_sum.dtype)
        loss.backward()
        legs[impl] = (loss.item(), logits.detach().float(),
                      {n: p.grad.float() for n, p in
                       module.named_parameters()})
        launched[impl] = (ops.LAUNCHES["flash_attention"],
                          ops.LAUNCHES["flash_attention_bwd"])
    module.cfg = cfg
    (kl, kx, kg), (pl, px, pg) = legs["pallas"], legs["chunked"]
    lerr = ((kx - px).abs().max() / px.abs().max()).item()
    gerr = {n: ((kg[n] - g).abs().max() / g.abs().max()).item()
            for n, g in pg.items()}
    worst = max(gerr, key=gerr.get)
    norm = math.sqrt(sum(float(g.square().sum()) for g in kg.values()))
    pnorm = math.sqrt(sum(float(g.square().sum()) for g in pg.values()))
    log(f"check {label}: a micro-batch {tuple(batch['tokens'].shape)} "
        f"through the flash kernels against chunked, {cfg.dtype}, remat "
        f"{cfg.remat}: loss {kl!r} vs {pl!r}; logits max |diff| / max "
        f"|logit| {lerr:.3e} (tol {TRAIN_LOGIT_TOL:g}); gradients, worst "
        f"of {len(gerr)} parameters {gerr[worst]:.3e} ({worst}; tol "
        f"{TRAIN_GRAD_TOL:g}), global norm {norm!r} vs {pnorm!r}; flash "
        f"forward / backward launches {launched}")
    passes = 2 if cfg.remat != "none" else 1
    if not (math.isfinite(kl) and lerr <= TRAIN_LOGIT_TOL
            and gerr[worst] <= TRAIN_GRAD_TOL
            and launched == dict(pallas=(passes * cfg.num_layers,
                                         cfg.num_layers), chunked=(0, 0))):
        raise AssertionError(f"{label}: the flash kernels' logits or "
                             "gradients disagree with chunked")


def example_kernel_cases(qcfg, mcfg, mspec, tcfg, targs) -> None:
    """The decode and flash kernels against their plain versions at the
    examples' own shapes, in bf16 (the configs' dtype) and fp32: decode
    over quickstart's 4 x 128 cache and ``serve_three_class``'s slots
    (ragged fills, 0 and full among them), the flash pair at quickstart's
    and train_100m's micro-batches (causal)."""
    ecfgs = (("quickstart_decode", qcfg, 4, 128),
             ("mts_decode", mcfg, mspec.serve.max_slots,
              mspec.serve.max_len))
    flash = (("quickstart_train", qcfg, 4, 64),
             ("train_100m", tcfg, targs.global_batch // targs.grad_accum,
              targs.seq_len))
    for i, dtype in enumerate((torch.bfloat16, torch.float32)):
        for j, (name, cfg, B, T) in enumerate(ecfgs):
            lengths = [(0, 1, T, T - 1, 17, T // 2)[b % 6] for b in range(B)]
            shp = dict(B=B, T=T, Hq=cfg.num_heads, Hkv=cfg.num_kv_heads,
                       D=cfg.head_dim)
            check_decode_case(name, shp, lengths, 0, 0.0, False, None,
                              dtype=dtype, seed=SEED + 40 + 2 * j + i)
        for j, (name, cfg, B, S) in enumerate(flash):
            case = (B, S, S, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                    0, 0.0, True)
            check_flash_case(name, case, dtype, SEED + 50 + 2 * j + i)


def examples_leg(smi: str) -> dict:
    """Phase 24 (c): the five examples.  The two host ones run as a user
    runs them (``python -m``; ``fairness_demo --exp all`` in a process of
    its own, started once the timed legs are done); the three model ones
    on the card, timed and counted, then held against the plain paths:
    each kernel against its plain version at the legs' shapes, the
    served decode logits against a chunked twin, the training logits
    and gradients against chunked attention.  Returns their launches."""
    from repro_torch.examples import (multi_tenant_serving, quickstart,
                                      train_100m)
    from repro_torch.training import checkpoint as CKPT
    from repro_torch.training.data import make_pipeline
    from repro_torch.training.trainer import build_trainer
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def example(name, *argv):
        return [sys.executable, "-m", f"repro_torch.examples.{name}", *argv]

    def first_batch(cfg, seq_len, global_batch, rows):
        batch = next(make_pipeline(cfg, seq_len, global_batch))
        return {k: torch.from_numpy(v[:rows]).to("cuda")
                for k, v in batch.items()}
    t0 = time.perf_counter()
    qos = subprocess.run(example("qos_controller_demo"), cwd=ROOT, env=env,
                         capture_output=True, text=True)
    qos_s = time.perf_counter() - t0
    for line in qos.stdout.strip().splitlines():
        log(f"qos_controller_demo: {line}")
    if qos.returncode or qos.stdout.count("victim p99 FCT") != 2:
        raise AssertionError(f"qos_controller_demo: rc {qos.returncode}"
                             f"\n{qos.stderr}")

    # quickstart: 3 training steps and a two-tenant serve on the card
    qcfg = quickstart.model_config()
    ops.reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        (hist, eng), q_s = sync_time(lambda: quickstart.run("cuda"))
    q_launch = dict(ops.LAUNCHES)
    for line in buf.getvalue().strip().splitlines():
        log(f"quickstart: {line}")
    losses = [float(m["loss"]) for m in hist]
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want["decode_attention"] = qcfg.num_layers * eng.decode_steps
    want["flash_attention"] = want["flash_attention_bwd"] = \
        3 * qcfg.num_layers     # remat "none" in the smoke config
    log(f"quickstart ({smi}): losses {losses}, decode steps "
        f"{eng.decode_steps}, launches {q_launch}, wall {q_s:.3f} s")
    if (len(losses) != 3 or not all(map(math.isfinite, losses))
            or len(eng.done) != 2
            or any(r.status != RequestStatus.DONE or len(r.generated)
                   != 8 for r in eng.done) or q_launch != want):
        raise AssertionError(
            f"quickstart: losses {losses}, requests "
            f"{[(r.status, r.generated) for r in eng.done]}, launches "
            f"{q_launch}, want {want}")
    del hist, eng

    # multi_tenant_serving: every request done, one decode launch a layer
    # a step; the RunReport under chunked (no EOS stop: the same schedule)
    mcfg = dataclasses.replace(smoke_config("qwen3-8b"), attn_impl="pallas")
    mspec = get_scenario("serve_three_class")
    ops.reset_launches()
    rep, m_s = sync_time(lambda: multi_tenant_serving.run(device="cuda"))
    m_launch = dict(ops.LAUNCHES)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        multi_tenant_serving.show(rep)
    for line in buf.getvalue().strip().splitlines():
        log(f"multi_tenant_serving: {line}")
    plain = multi_tenant_serving.run(
        cfg=dataclasses.replace(mcfg, attn_impl="chunked"), device="cuda")
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want["decode_attention"] = mcfg.num_layers * rep.extras["decode_steps"]
    requests = sum(t.arrival.requests for t in mspec.tenants)
    done = sum(t.completed for t in rep.tenants.values())
    log(f"multi_tenant_serving ({smi}): done {done}/{requests}, decode "
        f"steps {rep.extras['decode_steps']}, launches {m_launch}, wall "
        f"{m_s:.3f} s; the RunReport under chunked is "
        f"{'equal' if plain.to_json() == rep.to_json() else 'DIFFERENT'}")
    if (done != requests or m_launch != want
            or plain.to_json() != rep.to_json()):
        raise AssertionError(f"multi_tenant_serving: done {done}/"
                             f"{requests}, launches {m_launch}, want "
                             f"{want}, or the chunked report differs")
    del rep, plain

    # train_100m: accumulation, checkpoint of step 100, one profile
    ckpt = ROOT / "build" / "chip_smoke_100m_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    args = train_100m.parse_args(["--steps", str(TRAIN_100M_STEPS),
                                  "--ckpt-dir", str(ckpt),
                                  "--device", "cuda"])
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = train_100m.train(args)
    t_launch = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for line in buf.getvalue().strip().splitlines():
        log(f"train_100m: {line}")
    cfg, state, losses = res["cfg"], res["state"], res["losses"]
    remat = 2 if cfg.remat != "none" else 1
    per_step = dict(flash_attention=args.grad_accum * cfg.num_layers * remat,
                    flash_attention_bwd=args.grad_accum * cfg.num_layers)
    want = dict.fromkeys(ops.LAUNCHES, 0)
    for k, v in per_step.items():
        want[k] = v * args.steps
    tokens = args.steps * args.global_batch * args.seq_len
    n_params = sum(p.numel() for p in state.params.parameters())
    # the checkpoint against the live state, before the profile's steps
    fresh = build_trainer(cfg, device="cuda").init_state(SEED + 1)
    loaded, extra = CKPT.load(str(ckpt), fresh)
    live = CKPT.state_leaves(state)
    same = all(torch.equal(t, live[k])
               for k, t in CKPT.state_leaves(loaded).items())
    del fresh, loaded, live
    shutil.rmtree(ckpt)
    prof = profile_train_step(cfg, state, seq_len=args.seq_len,
                              batch=args.global_batch,
                              grad_accum=args.grad_accum, label="train_100m")
    log(f"train_100m ({smi}): params={n_params} layers={cfg.num_layers} "
        f"d_model={cfg.d_model} heads={cfg.num_heads}/{cfg.num_kv_heads}x"
        f"{cfg.head_dim} vocab={cfg.vocab_size} remat={cfg.remat} "
        f"grad_accum={args.grad_accum} batch {args.global_batch}x"
        f"{args.seq_len}; {args.steps} steps in {res['wall_s']:.3f} s (host "
        f"clock): step wall {res['wall_s'] / args.steps * 1e3:.3f} ms, "
        f"tokens_per_s={tokens / res['wall_s']:.1f}; first loss "
        f"{losses[0]!r}, last {losses[-1]!r}; checkpoint save stalls "
        f"{res['ckpt_stall_s']} s; profiled step device "
        f"{prof['device_ms']:.3f} ms, wall {prof['wall_ms']:.3f} ms, idle "
        f"{prof['idle']:.3f}; max_memory_allocated={peak}; launches "
        f"{t_launch} (a step {per_step})")
    if not all(map(math.isfinite, losses)) or t_launch != want:
        raise AssertionError(f"train_100m: losses finite "
                             f"{all(map(math.isfinite, losses))}, launches "
                             f"{t_launch}, want {want}")
    del state, res

    # the timed legs are done: the host demo runs beside the checks below
    t_fair = time.perf_counter()
    fair = subprocess.Popen(example("fairness_demo", "--exp", "all"),
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        ln_v = math.log(cfg.vocab_size)
        want_first = ln_v + cfg.d_model * 0.02 ** 2 / 2
        log(f"check train_100m: first loss {losses[0]!r} (ln V + d_model * "
            f"0.02^2 / 2 = {want_first:.4f}, tol 0.25); checkpoint of step "
            f"{extra.get('step')} loads "
            f"{'bit for bit' if same else 'DIFFERENT'}")
        if (abs(losses[0] - want_first) > 0.25 or not same
                or extra.get("step") != args.steps):
            raise AssertionError(f"train_100m: first loss {losses[0]}, "
                                 f"checkpoint equal {same}")
        # the kernels at the legs' shapes, then the legs against chunked
        example_kernel_cases(qcfg, mcfg, mspec, cfg, args)
        check_served_against_chunked(
            "quickstart serve", quickstart,
            lambda: quickstart.serve(qcfg, "cuda"))
        check_served_against_chunked(
            "multi_tenant_serving", multi_tenant_serving,
            lambda: multi_tenant_serving.run(device="cuda"))
        check_train_against_chunked("quickstart train", qcfg,
                                    first_batch(qcfg, 64, 4, 4))
        check_train_against_chunked(
            "train_100m", cfg,
            first_batch(cfg, args.seq_len, args.global_batch,
                        args.global_batch // args.grad_accum))
        torch.cuda.empty_cache()
    except BaseException:
        fair.kill()
        fair.communicate()
        raise
    out, err = fair.communicate()
    fair_s = time.perf_counter() - t_fair
    for line in out.strip().splitlines():
        log(f"fairness_demo: {line}")
    if fair.returncode or any(f"Fig {k}" not in out
                              for k in (9, 10, 12, 13)):
        raise AssertionError(f"fairness_demo --exp all: rc "
                             f"{fair.returncode}\n{err}")
    log(f"time examples (host clocks on the card's machine, {smi}): "
        f"qos_controller_demo {qos_s:.3f} s, quickstart {q_s:.3f} s, "
        f"multi_tenant_serving {m_s:.3f} s (each alone), fairness_demo "
        f"--exp all {fair_s:.3f} s (its own process, beside the checks "
        f"that follow the timed legs)")
    return {k: q_launch[k] + m_launch[k] + t_launch[k] for k in ops.LAUNCHES}


def fleet_phase(smi: str) -> dict:
    """Phase 24: (a) the fleet plane, (b) its twins on the card, (c) the
    examples.  Returns the launches of the main paths."""
    t0 = time.perf_counter()
    fleet_leg(smi)
    scans = twins_leg(smi)
    launches = examples_leg(smi)
    launches["sweep_scan"] += scans
    log(f"phase 24: {time.perf_counter() - t0:.1f} s")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    logs, build_s = sync_time(kbuild.build)
    for name, text in logs.items():
        log(f"build {name}: nvcc -Xptxas -v")
        for line in text.strip().splitlines():
            log(f"  {line}")
    log(f"build: {len(kbuild.sources())} sources in {build_s:.1f} s")
    dry = start_dryrun()
    for lib, fn, regs, st, ld in ptxas_report(logs, r"Li256E"):
        log(f"build {lib}: head dim 256 {fn}: {regs} registers, {st} bytes "
            f"spill stores, {ld} bytes spill loads")
    check_tensor_cores()

    err = check_decode_attention()
    timings = [time_decode_attention(256, 100),
               time_decode_attention(256, 100, shape=RG_DECODE, window=2048,
                                     ring=True),
               time_decode_attention(4096, 20),
               time_decode_attention(2048, 50, shape=RG_DECODE, window=2048,
                                     ring=True, lengths=RG_RING_LENGTHS)]
    timings += [time_decode_attention(256, 100, shape=shp, window=win,
                                      ring=ring, cap=cap, scale=sc)
                for _, shp, win, cap, sc, ring in NEW_DECODE]
    for t in timings:
        log("time decode_attention bf16 (ms, library_ms: CUDA-graph "
            "replays; eager_ms, library_eager_ms, plain_ms: launched from "
            "Python) " + fields(t))
    # Qwen3: GQA with G = 2 on the smoke config's 4 KV heads
    check_small("qwen3-8b", 16, 4, num_heads=8)

    cfg = dataclasses.replace(get_config("qwen3-8b"), attn_impl="pallas")
    rt, rep, launches = serve(cfg, SEED)
    done = rt.engine.done
    decode_steps = rep.extras["decode_steps"]
    generated = sum(len(r.generated) for r in done)
    peak = torch.cuda.max_memory_allocated()
    log(f"serve qwen3-8b: layers={cfg.num_layers} d_model={cfg.d_model} "
        f"steps={int(rep.duration)} "
        f"prefill_chunks={rep.extras['prefill_chunks']} "
        f"decode_steps={decode_steps} generated_tokens={generated} "
        f"max_memory_allocated={peak}")
    log(rep.summary())
    if len(done) != 12 or any(r.status != RequestStatus.DONE for r in done):
        raise AssertionError("not every request ended done: " + str(
            [(r.rid, r.status.value) for r in done]))
    if launches["decode_attention"] != cfg.num_layers * decode_steps:
        raise AssertionError(f"decode_attention launches "
                             f"{launches['decode_attention']} != "
                             f"{cfg.num_layers} x {decode_steps}")
    p5 = dict(json=rep.to_json(), snap=rt.engine.tel.snapshot())
    ex = rt.engine.exe
    check_full_width(ex.params, cfg)
    decode_device_ms = profile_decode(ex)
    del rt, ex
    torch.cuda.empty_cache()

    ssd_err = check_ssd_scan()
    ssd_t = time_ssd_scan(SSD_SERVE, True, 200, 10)
    ssd_cf = time_ssd_scan(dict(SSD_CASES)["cache_free"], False, 10, 2)
    for t in (ssd_t, ssd_cf):
        log("time ssd_scan bf16 (ms, plain_ms: CUDA-graph replays; "
            "eager_ms: launched from Python) " + fields(t))
    ssd_phases()
    rg_err = check_rglru_scan()
    rg_t = time_rglru_scan(RGLRU_SERVE, 200)
    rg_free_t = time_rglru_scan(RGLRU_FREE, 20)
    for t in (rg_t, rg_free_t):
        log("time rglru_scan fp32 (ms, plain_ms: CUDA-graph replays; "
            "eager_ms: launched from Python) " + fields(t))
    # a ragged second SSD chunk (16 + 8), decode past the 32-entry ring
    for arch in ("mamba2-370m", "recurrentgemma-2b"):
        check_small(arch, 24, 16)
    mamba = serve_recurrent("mamba2-370m")
    rgemma = serve_recurrent("recurrentgemma-2b")
    rg_free = rg_cache_free_phase()

    sel_err = check_wlbvt_select()
    sel_times = [time_wlbvt_select(256, 8, 1, torch.float64, 5000),
                 time_wlbvt_select(256, 8, 1, torch.float32, 5000),
                 time_wlbvt_select(4096, 128, 32, torch.float32, 500)]
    for st in sel_times:
        log("time wlbvt_select (ms: CUDA-graph replays; eager_ms: launched "
            "from Python) " + fields(st))
    sweep_launches = sweep_phase()
    sel_launches = sweep_launches["wlbvt_select"]
    scan_launches = sweep_launches["sweep_scan"]
    scan_err = check_sweep_scan()
    scan_t = time_sweep_scan()
    log("time sweep_scan (ms, r1_ms, fig9_*_ms: CUDA events around one "
        "launch, median of 5; plain_s, old_step_s: host clock around the "
        "whole graph-replayed run of the plain step and of the step with "
        "the wlbvt_select kernel) " + fields(scan_t))
    cli = cli_phase(mamba)
    planes = planes_phase(p5, decode_device_ms, smi)
    families = {arch: serve_family(arch, depth, smi)
                for arch, depth in NEW_FAMILIES}
    whisper = whisper_phase(smi)
    fleet = fleet_phase(smi)
    w_launches = {k: whisper["serve"][k] + whisper["encoder"][k]
                  + whisper["train"][k] for k in ops.LAUNCHES}

    flash_err = check_flash_attention()
    ft = time_flash_attention(20)
    log("time flash_attention bf16 B=4 S=T=1024 Hq=32 Hkv=8 D=128 causal "
        + fields(ft))
    frg = time_flash_attention(10, RG_FLASH)
    log("time flash_attention bf16 B=1 S=T=4096 Hq=10 Hkv=1 D=256 causal "
        "window=2048 " + fields(frg))
    tr = train_phase()
    for h in tr["hist"]:
        log(f"train step {h['step']}: loss={h['loss']:.6f} "
            f"grad_norm={h['grad_norm']:.6f} step_s={h['step_s']:.4f} "
            f"tokens_per_s={h['tokens_per_s']:.1f}")
    sh = sharded_phase(tr, smi)
    sv = sharded_serve_phase(p5, decode_device_ms, dry, smi)
    tp = tp_train_phase(tr, sh, smi)
    fam = family_tp_phase({"mamba2-370m": mamba, "recurrentgemma-2b": rgemma,
                           "deepseek-v2-lite-16b":
                           families["deepseek-v2-lite-16b"],
                           WHISPER: whisper}, whisper["train_hist"], smi)
    fl = fam["launches"]
    analysis_phase()
    gm = gemma_train_phase(smi)["launches"]

    t = timings[0]
    st = sel_times[0]
    log(json.dumps({"kernels": [{
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:23",
        "launches": launches["decode_attention"]
        + rgemma["launches"]["decode_attention"]
        + planes["launches"]["decode_attention"]
        + sum(f["launches"]["decode_attention"] for f in families.values())
        + w_launches["decode_attention"] + fleet["decode_attention"]
        + sv["launches"]["decode_attention"] + fl["decode_attention"],
        "max_abs_err": err,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"]}, {
        "name": "wlbvt_select", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wlbvt_select.cu",
        "replaces": "src/repro/kernels/wlbvt_select.py:114",
        "launches": sel_launches, "max_abs_err": sel_err,
        "ms": st["ms"], "plain_ms": st["plain_ms"],
        "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
        "library_ms": None}, {
        "name": "sweep_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sweep_scan.cu",
        "replaces": "src/repro/kernels/wlbvt_select.py:114 (inlined in "
                    "the scan of src/repro/sim/devicepath.py:285)",
        "launches": scan_launches + cli["launches"]["sweep_scan"]
        + fleet["sweep_scan"],
        "max_abs_err": scan_err,
        "ms": scan_t["ms"], "plain_ms": scan_t["plain_ms"],
        "bound_ms": scan_t["bound_ms"], "bound_by": scan_t["bound_by"],
        "library_ms": None}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:28",
        "launches": tr["launches"]["flash_attention"]
        + w_launches["flash_attention"] + fleet["flash_attention"]
        + sh["launches"]["flash_attention"]
        + tp["launches"]["flash_attention"] + fl["flash_attention"]
        + gm["flash_attention"],
        "max_abs_err": flash_err["fwd_err"], "ms": ft["fwd_ms"],
        "plain_ms": ft["plain_fwd_ms"], "bound_ms": ft["fwd_bound_ms"],
        "bound_by": ft["fwd_bound_by"], "library_ms": ft["library_fwd_ms"]}, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:28 (its "
                    "gradient; no Pallas backward)",
        "launches": tr["launches"]["flash_attention_bwd"]
        + w_launches["flash_attention_bwd"] + fleet["flash_attention_bwd"]
        + sh["launches"]["flash_attention_bwd"]
        + tp["launches"]["flash_attention_bwd"] + fl["flash_attention_bwd"]
        + gm["flash_attention_bwd"],
        "max_abs_err": flash_err["bwd_err"], "ms": ft["bwd_ms"],
        "plain_ms": ft["plain_bwd_ms"], "bound_ms": ft["bwd_bound_ms"],
        "bound_by": ft["bwd_bound_by"],
        "library_ms": ft["library_bwd_ms"]}, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:22",
        "launches": mamba["launches"]["ssd_scan"]
        + cli["launches"]["ssd_scan"] + fl["ssd_scan"],
        "max_abs_err": ssd_err,
        "ms": ssd_t["ms"], "plain_ms": ssd_t["plain_ms"],
        "bound_ms": ssd_t["bound_ms"], "bound_by": ssd_t["bound_by"],
        "library_ms": None}, {
        "name": "rglru_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:20",
        "launches": rgemma["launches"]["rglru_scan"] + fl["rglru_scan"],
        "max_abs_err": rg_err,
        "ms": rg_t["ms"], "plain_ms": rg_t["plain_ms"],
        "bound_ms": rg_t["bound_ms"], "bound_by": rg_t["bound_by"],
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
