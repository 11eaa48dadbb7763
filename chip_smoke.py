#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py
    python3 chip_smoke.py --sharded-resume-layers 24   # phase 16 (a) alone
    python3 chip_smoke.py --fsdp                       # phase 17 alone
    python3 chip_smoke.py --parallel                   # phases 13 and 14 alone

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit.  It imports nothing of JAX or of the JAX package, and fails
(non-zero exit, no result line) without a card or outside a checkout.

Phases, each fatal on failure (each one's seconds printed as it ends, as
``[time] phase N``):

1. build — ``nvcc`` compiles the four CUDA sources for sm_90a, one process
   per source, all at once: ``adaptive_update.cu``, ``flash_attention.cu``,
   ``rg_lru.cu`` and ``selective_scan.cu``; prints ``ptxas -v`` (registers,
   shared memory and spills of every kernel).
2. kernels — every adaptive_update kernel's wrapper against its plain
   PyTorch version on the card, at the full-width shapes of stablelm-1.6b
   (N = 1,438,846,976 f32 params, K = 8 ring slots, W = 8 workers): the tick
   for sgd / momentum / adam with f32 and bf16 rings, the chain, the combine
   and fused_update.  The chain (each body) and fused_update must equal
   their plain versions bit for bit, at N and at N - 5 (N % 8 = 3: the
   vector body and a scalar tail); the tick and the combine within
   |kernel - plain| <= 1e-6 + 1e-6 |plain| (1e-5 with a bf16 ring: the
   slot-folded sum differs from the worker-by-worker one in rounding); the
   ring's bits and the live mask exactly equal.  The momentum / bf16 tick
   runs again with NaN in ring slots 5 and 7, which no worker maps to at
   step 11: p and v must come out finite and match the plain version (the
   tick reads only live slots).
   Prints each kernel's time, the plain version's, the byte bound at
   3.35 TB/s (the tick moves exactly those bytes) and the errors, and for
   the chain and fused_update the time of PyTorch's fused optimizer step
   on the same (N,) f32 tensor (``SGD(momentum, fused=True)``,
   ``Adam(fused=True)``: the same bytes and update), their library time,
   with the kernel's achieved TB/s and its ratio to the library (20
   launches each after a warm-up).
3. main path — ``run(RunSpec(mode="async", fuse=True, ...))`` on full-width
   stablelm-1.6b (24 layers, momentum, W = 8, ring 8 in bf16, batch 4 x seq
   512, refresh every 5) for 12 ticks, launch counts zeroed just before and
   read just after; checks finite losses, one fused_tick launch per tick, a
   refresh that rewrote the alpha table in place, and prints peak memory and,
   per tick, the ring slots the tick read (replayed from that tick's taus)
   and so its bytes.
   Then the same fused async run on reduced stablelm on the card against the
   plain CPU path on the same params, batches and uniforms.
4. other paths — sync (fused_chain), clip (fused_combine + fused_chain) and
   ``fused_apply`` (fused_update) at full width and 2 layers, each with its
   counts zeroed before and read after.
5. serving kernels — the flash-attention kernel against its plain version at
   the recurrentgemma-9b local-layer shape (B 4, S = T = 4096, Nq 16, Nkv 1,
   H 256, window 2048, causal, bf16, and the same in f32 at B 1), the
   stablelm-1.6b shape (B 4, S 512, Nq = Nkv = 32, H 64, causal, bf16), a
   gemma2-27b-like shape the serving path does not reach (Nq 32, Nkv 16,
   H 128, window 64, softcap 50, S = 1000, f32 and bf16, causal and not) and
   S != T (S 77, T 150, H 256, window 40, non-causal, bf16), so every bf16
   head width of the tensor-core body runs, and the three model shapes
   phase 6 adds: whisper-large-v3's encoder (B 4, S = T = 1500 = 23 x 64 +
   28 keys, Nq = Nkv = 20, H 64, non-causal: the last key tile's 28 keys
   are masked by k < T, not by a band), qwen2-moe-a2.7b's prefill (B 4,
   S 512, 16 x 16 heads of 128, causal) and internvl2-2b's (B 4, S 256 +
   512, 16 query over 8 KV heads of 128, causal), all bf16; the RG-LRU kernel at B 4,
   S 4096, W 4096.  Tolerance |kernel - plain| <= 3e-5 +
   3e-5 |plain| in f32, the reference's; in bf16 1e-4 + 1e-2 |plain|, one
   bf16 rounding of the output (both sides compute in f32 and round once),
   tighter than the reference's 3e-2, which at S = 4096 is as large as a
   typical output and would pass a band edge one key tile off.  Prints each
   time, the plain version's, the bound (the larger of bytes / 3.35 TB/s and
   the band's QK^T + PV FLOPs over the peak for the input type: 989 TFLOP/s
   bf16, 67 TFLOP/s f32) and, for attention, the achieved TFLOP/s of band
   work, the share of the bound and ``scaled_dot_product_attention``'s time
   at the same shape (timed only).
   The selective-scan kernel at the falcon-mamba-7b shape (B 4, S 4096,
   D 8192, N 16, u in bf16) with the model's A = -(1..N) and with A drawn
   per (d, n) as -exp(randn), and at odd sizes with u in f32 (B 2, S 1000,
   D 1000): y and the final state within 3e-5 + 3e-5 |plain|, the
   reference's tolerance; its bound is the largest of the bytes over
   3.35 TB/s, the exponentials over the SFU rate (16 a clock per SM, 132
   SMs, 1.98 GHz) and 6 f32 operations per (b, t, d, n) over 67 TFLOP/s;
   prints the exponentials per second it reached beside that SFU peak.
6. serving — the training state freed, full-width recurrentgemma-9b (38
   layers, 9.4e9 f32 params) through ``repro_torch.launch.serve``: batch 4,
   prompt 4096, 32 greedy steps, with the counts zeroed just before and read
   just after: 12 flash and 26 RG-LRU launches (one per recurrent layer:
   its output and its cache come from one recurrence), finite logits,
   ids in range.  Then full-width stablelm-1.6b: batch 4, prompt 512, 32
   steps, 24 flash launches.  Then full-width falcon-mamba-7b (64 Mamba
   layers, 7.27e9 f32 params): batch 4, prompt 4096, 32 steps, 64
   selective-scan launches (one per layer: its output and its cache come
   from one scan).  Then full-width qwen2-moe-a2.7b (24 MoE layers, 60
   routed experts padded to 64, top-4, a shared expert: 15.15e9 f32 params,
   60.59 GB) at prompt 512, 24 flash launches, its peak memory printed
   before the prefill (params resident) and after the serve, both under the
   card's 80 GB; full-width internvl2-2b at 256 vision-prefix embeddings +
   prompt 512 (the cache holds 256 + 512 + 32 positions, decoding starts at
   768), 24 flash launches; full-width whisper-large-v3 (32 encoder + 32
   decoder layers) over 1500 encoder frames, 32 flash launches, all in the
   encoder (as the reference's launcher, no decoder prefill: the steps start
   from the first prompt token at position 0).  Every serve counts all three
   serving kernels.  Prints prefill s, decode ms per step, tok/s and peak
   memory.  Then reduced recurrentgemma, falcon-mamba, qwen2-moe,
   internvl2, whisper and gemma2-27b served on the card (the kernels)
   against the plain CPU path, same params: prompt 160, 4 steps, logits
   within 1e-4, ids equal; for qwen2-moe also the first MoE layer's top-k
   expert ids over the prefill, exactly equal, with the smallest router
   margins printed beside them.  gemma2-27b, gemma3-27b (~108 GB in f32)
   and qwen3-moe-235b-a22b (~940 GB) do not fit one card and run reduced
   only.

7. resume — the configuration of phase 3 with 6 ticks and a refresh every 2:
   run A uninterrupted, checkpointing at step 3 (``CheckpointHook``; its
   histogram is partial) into a temporary directory under ``build/``; run B,
   a fresh pipeline and adapt, ``run(spec, resume_from=dir,
   resume_step=3)``, crossing the step-4 refresh.  B's losses must equal A's
   steps 4-6 and every leaf of B's final state (params, momentum, ring bits,
   ring step, adapt tables and histogram, step, generator state) A's, bit for
   bit; the host estimators must agree; fused_tick launches 6 + 3.  Prints
   the checkpoint's GB on disk, save and restore seconds, the disk's free
   space and peak memory.  The directory is removed at the end of the phase.
8. exact simulator — the paper's Fig.-3 problem (noisy quadratic, d 16,
   m 16, T 3000; constant and eq.-26 geometric-momentum tables) through
   ``async_engine.exact`` on the card and on the CPU: taus and alphas
   exactly equal, losses and x within 1e-5 relative (max |d| / max |CPU|),
   and the adaptive table at loss 1.5 in no more commits than the constant
   one.  Prints both commit counts and the phase's seconds.
9. sharded async — ``run(RunSpec(mode="sharded_async", fuse=True, ...))`` on
   full-width stablelm-1.6b: momentum, W = 2 workers of K = 4 bf16 ring
   slots each (worker 0 draws from a geometric CDF, worker 1 replays an
   event-simulator trace), the eq.-26 table, batch 4 x seq 512, 6 ticks, a
   refresh every 3; counts zeroed just before and read just after.  Checks
   6 ``fused_chain`` launches and no ``fused_tick``, finite losses, a
   refresh that rewrote the alpha table in place, and that each refresh
   drained a merged histogram of exactly W x 3 taus.  Prints the median
   tick, peak memory and the ring's GB.  Then the same fused sharded run on
   reduced stablelm (W 2 and 4) on the card against the plain CPU path (same
   params, batches and uniforms): with an f32 ring, as phase 3's reduced
   check, max |dp| <= 1e-5; with a bf16 ring the difference is printed
   (a bf16 rounding flip moves p by up to 2^-8 of a step); histograms and
   tables equal in both.
10. the paper's CNN — the Fig.-1 CNN at 32x32x3, batch 16, m 16, the
   constant table at alpha 0.01, through the exact simulator on the card and
   on the CPU over the first 100 commits of the heterogeneous event order:
   taus and alphas exactly equal; in float64 the losses within 1e-4
   relative (max |d| / max |CPU|); in f32 the same bound over the commits
   before the CPU's own f32 run leaves its f64 run by 1e-5 relative (the
   trajectory amplifies round-off; the horizon is measured in this run).
   Then ``experiments.convergence`` at m 16, one repeat, T 2500, printing its
   row (not gated on speedup: the paper's claim is a trend), and the CNN
   example's constant and MindTheStep runs at 600 commits, printing both
   iterations-to-threshold and seconds.
11. live parameter server — ``run(RunSpec(mode="distributed", fuse=True,
   transport="inproc", num_workers=2, ...))`` on full-width stablelm-1.6b:
   two worker threads compute real gradients on the card and the server
   applies each push with one ``fused_chain`` launch (momentum, the eq.-26
   table, batch 4 x seq 512, 8 ticks, a refresh every 4, the trace under
   ``build/``); counts zeroed just before and read just after.  Checks 8
   ``fused_chain`` launches = 8 applies and no other kernel, 8 trace records
   whose taus are the version at each push less the version at its pull
   (read from the records' own pull and push stamps), finite losses, and a
   refresh that rewrote the alpha table in place.  Prints the median tick, the server's host time
   per apply (the enqueue; the card runs it asynchronously), the median gap
   between applies, the ``fused_chain`` time at this path's buffers (timed
   alone after the run), the tau histogram and peak memory.  Then reduced
   stablelm: a W = 1 live run on the card against the serial
   pull/grad/apply loop on the CPU (same params and batches), max |dp| <=
   1e-5 and every tau 0; and a W = 2 run over the socket transport, its
   workers spawned processes on the card: it completes, the server's
   ``fused_chain`` launches equal its applies and the taus agree with the
   stamps.  W - 1 bounds the batches in flight, not tau: a slow worker is
   lapped (a spawned worker's first gradient carries its CUDA start-up).
12. planner — ``repro_torch.launch.dryrun`` plans the three configurations
   the card ran, on shape-only tensors: phase 3's run and phase 9's
   (``plan_run``: the engine's own state template and step) and phase 6's
   qwen2-moe-a2.7b serve (``plan_serve``: params and the f32 decode cache
   of 512 + 32 positions).  Gate: the planned state bytes on one card
   equal the bytes of the state that phase built on the card.  Printed
   beside it: the allocator's bytes, the planned peak against the phase's
   measured peak, and the planned FLOPs against 6 N D (training) or 2 N D
   (prefill).
13. expert parallelism — full-width qwen2-moe-a2.7b (64 padded experts,
   d_model 2048, top-4, the 5632-wide shared expert, 16 heads of 128) at
   depth 4, in f32 activations (the one-process and the sharded runs sum
   the experts in other orders, which bf16 would round differently), with
   ``use_pallas=True`` (flash at H 128).  One process serves it
   (``launch/serve.py::serve``: batch 4, prompt 512, 8 greedy steps); then
   2 spawned processes on the one card form a gloo group, data 1 x model 2,
   each holding its blocks (32 of the experts, 8 of the 16 heads, half the
   shared expert's d_ff and of the vocab; router and norms replicated), and
   serve the same params (drawn from the same seed, sliced) and prompts under
   ``use_sharding_rules``; each process serves once untimed first.  Gates:
   every rank's logits (its vocab block) within 1e-4 + 1e-4 |one process|,
   greedy ids and every router call's top-k ids equal, 4 flash launches in
   each, and the bytes each rank handed to all-reduce equal to the plan
   (``launch.analysis.port_collective_bytes``).  Then 4 processes (data 2 x model 2) run one
   full-width MoE block weights-stationary (d_ff over data too) at the
   decode shape (B 4, S 1) and at B 4 x S 512, each rank its two rows:
   out and aux within 3e-4 of the one-process block (the reference's
   bound).  The same 4 ranks then train full-width qwen2-moe-a2.7b
   weights-stationary (expert stacks over model x d_ff over data, never
   gathered; the other weights in the FSDP storage over data) at depth 2 of
   24 (N = 1,832,663,040: params, momentum, f32 ring and gradient about
   36.7 GB over the 4 ranks), f32 activations, async fused momentum, W = K
   = 2, batch 4 x 512, 3 ticks: gates, finite losses equal on every rank, 3
   ``au_fused_tick`` launches a rank (on its ``N_local``) and no other
   adaptive_update kernel, each rank's state bytes equal to ``plan_run``
   and its collective bytes to ``port_collective_bytes``; and at depth 1
   one tick against one process on the card on the same global batch (its
   params cut to each rank's blocks and handed to the rank): loss within
   1e-6 relative, params within 1e-5 of max |p|.  Prints each path's ms,
   each rank's tick seconds, the peak memory per process and the bytes its
   collectives took.  A rank that fails, or the group past 300 s, fails the
   phase (every rank is stopped).
14. tensor parallelism — Megatron-style over ``model``, data parallelism
   over ``data``, as gloo processes sharing the one card (NCCL refuses two
   ranks on one card), each under ``use_sharding_rules`` with its blocks.
   First 2 ranks (data 1 x model 2): phase 3's run on full-width
   stablelm-1.6b for 4 ticks, a refresh every 2 (gates: 4 ``fused_tick``
   launches a rank and no other adaptive_update kernel, finite losses,
   losses, taus, tables, CDFs and histograms bitwise equal across ranks, a
   refresh that rewrote the table in place, each rank's state bytes equal
   to ``plan_run`` for the layout and its all-reduce bytes to
   ``port_collective_bytes``); then full width at depth 2 in f32 without
   remat against one process (loss within 1e-5 relative, the gradient
   within 1e-4 of max |g|, and after 3 fused ticks with the same uniforms
   and an f32 ring the params within 1e-5; one process's gradient and
   params cut to each rank's blocks and handed to the rank, which holds
   its own to them); the same again with ``sequence_parallel`` (Megatron
   sequence parallelism: the residual stream the rank's half of the
   sequence, the layers' inputs gathered and their outputs
   reduce-scattered over model; the same params and state layout), its
   loss, gradient and params held to the same bounds against one process
   and against the ranks' run without it, its bytes to the plan; then the
   full-depth f32 serve on the flash kernel (batch 4, prompt 512, 8 greedy
   steps) against one process: logits within 1e-4 + 1e-4 |one process|,
   ids equal, 24 flash launches a rank, bytes equal to the plan; then the
   depth-2 f32 serve without and with ``sequence_parallel``: prefill logits
   within 1e-4 + 1e-4 |without|, ids equal, 2 flash launches a rank each
   (with it, on the rank's heads over the gathered sequence), bytes equal
   to the plan; then what sequence parallelism saves: one gradient of
   batch 1 x 4096 at 4 layers in the config's own dtypes, without and with
   it, each without and with remat, each rank's peak above its params
   printed (finite losses gated).  Then 4
   ranks (data 2 x model 2, in the FSDP storage over data of phase 17)
   train depth 2 of 24 for 3 ticks: 3 ``fused_tick`` launches a rank,
   collective bytes (the FSDP gathers and reduce-scatters and the
   all-reduce of the leaves whole over data included) and each rank's
   state bytes equal to the plan, and the data replicas' blocks of the
   leaves whole over data (params, momentum and ring) bitwise equal
   (SHA-256).  Prints ticks, prefill and decode times,
   peaks and bytes; a rank that fails, or a group past 300 s, fails the
   phase.  ``--parallel`` builds the adaptive_update and flash kernels and
   runs phases 13 and 14 alone, printing their rows and the card, and no
   result line.
15. tensor parallelism of the other families — 2 gloo ranks (data 1 x
   model 2) sharing the card, each under ``use_sharding_rules`` with its
   blocks, f32 activations, ``use_pallas=True``, each arch at full width
   and cut in depth, against one process serving the same params (drawn
   from seed 0; the ranks slice theirs) and prompts on the kernels' plain
   versions (``use_pallas=False``: so each rank's kernels are held against
   plain code at the shapes this path gives them), batch 4, 8 greedy
   steps: falcon-mamba-7b at 8 of 64 layers, prompt 1024 (8
   ``selective_scan`` launches, each rank on its 4096 of the 8192 inner
   channels); recurrentgemma-9b at 6 of 38 layers, prompt 1024 (4 ``rg_lru``
   launches on 2048 of the 4096 channels, 2 flash on 8 of the 16 heads);
   whisper-large-v3 at 4 of 32 encoder and 4 of 32 decoder layers over 1500
   frames (4 flash launches, non-causal on 10 of the 20 heads); internvl2-2b
   at 4 of 24 layers, 256 prefix embeddings + prompt 512 (4 flash; its
   vocab of 92,553 is odd, so its logits are whole on every rank).  Gates:
   logits within 1e-4 + 1e-4 |one process| (the rank's vocab block), ids
   equal, each rank's launches as listed and the one process's 0,
   all-reduce bytes equal to ``port_collective_bytes``.  Then the same
   ranks serve recurrentgemma-9b (6 layers) again at batch 4, prompt 4096,
   8 steps, without and then with the reference's ``seq_shard_cache``
   decode layout (``SPEC_OPTIONS["seq_shard_cache"]``): its one kv head
   does not split over model, so each local layer's ring of 2048 slots
   does, 1024 a rank (every kv head), the query heads gathered over model
   each step and each rank's partial softmax combined (``kv_gather`` /
   ``kv_combine``); against one process on the plain versions, each with
   the same gates (2 flash and 4 RG-LRU launches a serve), and every leaf
   of each rank's decode cache of the shape the reference's
   ``cache_spec_for`` gives it; prints each rank's k / v bytes, peak and
   decode ms a step without and with.  Then falcon-mamba-7b at full width,
   depth 4 of 64: phase 3's run for 3 ticks (gates: 3 ``fused_tick``
   launches a rank and no other adaptive_update kernel, losses, taus,
   tables and histograms bitwise equal across ranks, state bytes equal to
   ``plan_run``, all-reduce bytes to the plan), and at depth 2 in f32 the
   loss (1e-5 relative) and the gathered gradient (1e-4 of max |g|) against
   one process, bytes to the plan.  Prints prefill s, decode ms a step,
   peaks and bytes; a rank that fails, or the group past 300 s, fails the
   phase.
16. checkpoint and resume of multi-process training states — gloo ranks
   sharing the card, each under ``use_sharding_rules`` with its blocks.
   (a) 2 ranks (data 1 x model 2) run phase 7's run (phase 3's config, 6
   ticks, a refresh every 2) at full width and 2 of 24 layers, saving once
   at step 3 through ``CheckpointHook`` (rank 0 writes the one
   checkpoint); a fresh group resumes it with ``resume_step=3``.  Gates:
   each rank's resumed losses and every leaf (SHA-256 of its bits) those of
   the run that was not interrupted, fused_tick 6 + 3 a rank, every member
   of the checkpoint of the shape and stored dtype a one-process save
   writes, each rank's peak in the save and in the restore within 1 GB of
   its training peak.  (b) 4 ranks (data 2 x model 2, FSDP storage over
   data) at full width and 1 layer, f32 activations and an f32 ring of W =
   K = 2 (so the layouts differ by f32 round-off alone), save at step 3,
   and restore it back at 2 x 2, each rank held bit for bit to the state
   it saved; 2
   ranks (data 1 x model 2) restore it, each held bit for bit to
   ``specs.localize`` of the whole leaves, and one process restores it,
   held to the file's bits; both run 3 more ticks, the gathered params
   within 1e-5 of one process's.  The depths are cut for the disk (the
   whole script is held to 45 GiB of disk writes, deleted files included,
   and phase 7 writes 34.53 GB; (a) writes 7.40 GB and (b) 4.11 GB).
   (b)'s groups run on a thread beside (a)'s (6 ranks on the card at
   once), so their save and restore seconds share the host.
   Prints save and restore seconds, GB on
   disk, the disk's free space and the peaks; each directory is removed at
   the end of its part; a rank that fails, or a group past 300 s, fails
   the phase.  ``--sharded-resume-layers L`` builds the adaptive_update
   kernels and runs (a) alone at L layers (24: full depth, a 34.53 GB
   checkpoint), with the same gates; it prints (a)'s row and the card, and
   no result line.
17. FSDP storage over data — the reference's layout: each rank stores its
   block over ``data`` of every weight (its params, momentum and ring are
   ``N / 2`` long for the leaves that split), gathers a layer's weights
   over ``data`` just before the layer runs and reduce-scatters their
   gradient; 2 gloo ranks (data 2 x model 1) share the card.  (a) Phase 3's
   run at full width and depth for 3 ticks, a refresh every 2: finite
   losses; losses, taus, tables, CDFs and histograms equal on both ranks;
   one ``au_fused_tick`` launch a tick on each rank (on its ``N_local``)
   and no other adaptive_update kernel; each rank's state bytes equal to
   ``plan_run(spec, mesh=(2, 1))`` and its collective bytes by purpose to
   ``port_collective_bytes``, exactly.  Prints each rank's peak beside
   phase 3's one-process peak and the planned peak, and the tick a rank.
   (b) Depth 2, f32 activations, no remat, an f32 ring, 3 ticks with the
   same uniforms: the FSDP run and the same run on the same ranks under
   ``replicate_params_over_data`` bitwise equal (each rank's blocks of the
   params, momentum and ring, and the losses: with two data ranks every
   gradient element is ``a + b`` in both), and against one process the
   losses within 1e-6 relative and the gathered params within 1e-5; bytes
   equal to the plan.  (c) Depth 2 in f32 served on the flash kernel
   (batch 4, prompt 512, 4 greedy steps; each rank its 2 rows): 2 flash
   launches a rank, ids equal to one process's, logits within 1e-4 +
   1e-4 |one process|, bytes equal to the plan.  (d) gemma2-27b at full
   width and 2 of 46 layers (one local layer, window 4096, and one
   global), f32, softcap 50, on the flash kernel, batch 1, prompt 8192, 8
   steps, in the serving layout (params replicated over data: FSDP's
   gathers would move its 9.25 GB through gloo every step), without and
   then with ``seq_shard_cache``: batch 1 leaves the data axis idle, so
   each cache's capacity splits over data (the global cache 4100 of 8200
   positions a rank, the local ring 2048 of 4096); the gates of phase
   15's serve, 2 flash launches a serve.  Writes no checkpoint.
   ``--fsdp`` builds the adaptive_update and flash kernels and runs phase
   17 alone, printing its row and the card, and no result line.

The script's time: phase 17 is paid for by one depth cut, never a width
cut (phase 14's data 2 x model 2 run from 6 layers to 2), by planning
phases 14, 15 and 17 on a thread while their ranks run, and by running
phase 16 (b) beside (a).

Then one JSON object with every kernel (launches on its path, max_abs_err,
ms, plain_ms, bound_ms, library_ms, ...), the card's name and power limit,
and as the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
SM_CLOCK_HZ = 1.98e9  # H100 SXM maximum SM clock (NVIDIA data sheet)
SFU_EXP_PER_S = 16 * 132 * SM_CLOCK_HZ  # exponentials: 16 a clock per SM, 132 SMs
PEAK_FLOPS = {  # H100 SXM peaks by input type (NVIDIA data sheet)
    "bfloat16": 989e12,  # dense bf16 tensor cores
    "float32": 67e12,  # f32 outside the tensor cores
}
SOURCE = "src/repro_torch/kernels/adaptive_update/csrc/adaptive_update.cu"
SOURCES = {
    "flash_attention": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
    "rg_lru": "src/repro_torch/kernels/rg_lru/csrc/rg_lru.cu",
    "selective_scan": "src/repro_torch/kernels/selective_scan/csrc/selective_scan.cu",
}
REPLACES = {
    "fused_tick": "src/repro/kernels/adaptive_update/fused.py:301",
    "fused_chain": "src/repro/kernels/adaptive_update/fused.py:137",
    "fused_combine": "src/repro/kernels/adaptive_update/fused.py:349",
    "fused_update": "src/repro/kernels/adaptive_update/kernel.py:46",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:94",
    "rg_lru": "src/repro/kernels/rg_lru/kernel.py:46",
    "selective_scan": "src/repro/kernels/selective_scan/kernel.py:57",
}
K_RING, W_WORKERS, STEP = 8, 8, 11
TAUS = [0, 2, 5, 2, 9, 1, 3, 7]  # two workers share a slot; tau 9 >= K is dead
CHUNK = 1 << 26


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Fail(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise Fail(msg)


# ---------------------------------------------------------------------------
# Phase 2 helpers
# ---------------------------------------------------------------------------

def cuda_ms(fn, iters=5, warmup=1):
    import torch

    for _ in range(warmup):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def stash(t):
    """An untouched copy of ``t``: on the card when it fits, else on the host."""
    import torch

    free, _ = torch.cuda.mem_get_info()
    if free > t.numel() * t.element_size() + (6 << 30):
        return t.clone()
    return t.cpu()


def slot_checksums(ring):
    import torch

    bits = ring.view(torch.int16 if ring.dtype == torch.bfloat16 else torch.int32)
    n = ring.shape[1]
    return [sum(int(bits[k, lo:lo + CHUNK].sum(dtype=torch.int64)) for lo in range(0, n, CHUNK))
            for k in range(ring.shape[0])]


def live_slots(step, taus, weights, K):
    """Ring slots the tick must read (live worker, nonzero folded weight,
    not the slot the fresh gradient replaces) — this run's data."""
    w_slot = [0.0] * K
    for tau, w in zip(taus, weights):
        src = step - tau
        if src >= 0 and tau < K:
            w_slot[src % K] += w
    return sum(1 for k in range(K) if w_slot[k] != 0.0 and k != step % K)


def tick_bytes(kind, n, ring_item, step, taus, weights, K):
    state = {"sgd": 0, "momentum": 1, "adam": 2}[kind]
    return n * (8 + 4 + 8 * state + ring_item * (1 + live_slots(step, taus, weights, K)))


def kernel_scalars(kind):
    import torch

    s = {"f_stale": 1.3, "f_keep": 1.0, "f_clip": 0.7, "m_scale": -0.05, "mu": 0.9,
         "b1": 0.9, "omb1": 0.1, "b2": 0.999, "omb2": 0.001, "eps": 1e-8, "c1": 10.0, "c2": 1000.0}
    from repro_torch.kernels.adaptive_update.ref import SCALAR_ORDER

    return {k: torch.tensor(s[k], dtype=torch.float32) for k in SCALAR_ORDER[kind]}


def make_state(kind, n, gen, dev):
    """Random optimizer state.  Adam's second moment is kept away from 0 (in
    [0.1, 1.1); tests/test_fuse.py uses 0.2): as v -> 0 the adam body
    divides by sqrt(v) and amplifies the combine's one-ulp association
    difference without bound, which would test conditioning, not the kernel."""
    import torch

    if kind == "sgd":
        return ()
    if kind == "momentum":
        return torch.randn(n, generator=gen, device=dev)
    return {"m": torch.randn(n, generator=gen, device=dev),
            "v": torch.rand(n, generator=gen, device=dev) + 0.1}


def state_list(kind, bufs):
    return [] if kind == "sgd" else ([bufs] if kind == "momentum" else [bufs["m"], bufs["v"]])


def bits_update(errs, got, want):
    """Track max |got - want| and fail unless every bit agrees (int32 views)."""
    import torch

    errs["max_abs_err"] = max(errs["max_abs_err"], float((got - want).abs().max()))
    bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    check(bad == 0, f"{bad} elements differ in their bits from the plain version")


def err_update(errs, got, want, tol):
    """Track max |got - want| and fail past |d| <= tol + tol |want|."""
    d = (got - want).abs()
    errs["max_abs_err"] = max(errs["max_abs_err"], float(d.max()))
    bad = int((d > tol + tol * want.abs()).sum())
    check(bad == 0, f"{bad} elements past tolerance {tol}")


DEAD_SLOTS = (5, 7)  # no worker's source slot at STEP with TAUS


def check_tick(kind, ring_dtype, n, dev, *, nan_dead=False):
    """Tick kernel vs plain at full width; returns the numbers for the JSON.
    ``nan_dead`` fills the slots no worker maps to with NaN: a tick that read
    them would turn p and the state to NaN (0 * NaN); it is not timed."""
    import torch

    from repro_torch.kernels.adaptive_update import cuda as C
    from repro_torch.kernels.adaptive_update import ref

    gen = torch.Generator(device=dev).manual_seed(1)
    p = torch.randn(n, generator=gen, device=dev)
    g = torch.randn(n, generator=gen, device=dev)
    bufs = make_state(kind, n, gen, dev)
    ring = torch.randn(K_RING, n, generator=gen, device=dev, dtype=ring_dtype)
    if nan_dead:
        for k in DEAD_SLOTS:
            ring[k] = float("nan")
    step = torch.tensor(STEP, dtype=torch.int32, device=dev)
    taus = torch.tensor(TAUS, dtype=torch.int32, device=dev)
    weights = torch.rand(W_WORKERS, generator=gen, device=dev) + 0.1
    s = kernel_scalars(kind)
    p0, bufs0 = stash(p), [stash(b) for b in state_list(kind, bufs)]
    sums0 = slot_checksums(ring)
    live = C.fused_tick(kind, p, g, bufs, s, ring, step, taus, weights)
    torch.cuda.synchronize()
    for x in [p] + state_list(kind, bufs):
        check(all(bool(torch.isfinite(x[lo:lo + CHUNK]).all()) for lo in range(0, n, CHUNK)),
              "the tick produced non-finite values" + (" (it read a dead slot)" if nan_dead else ""))
    sums1 = slot_checksums(ring)
    push = STEP % K_RING
    check(all(a == b for k, (a, b) in enumerate(zip(sums0, sums1)) if k != push),
          "tick kernel wrote a ring slot other than the pushed one")
    tol = 1e-5 if ring_dtype == torch.bfloat16 else 1e-6
    errs = {"max_abs_err": 0.0}
    plain_ms = 0.0
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for lo in range(0, n, CHUNK):
        hi = min(n, lo + CHUNK)
        pc = p0[lo:hi].to(dev)
        bc = [x[lo:hi].to(dev) for x in bufs0]
        bufs_c = () if kind == "sgd" else (bc[0] if kind == "momentum" else {"m": bc[0], "v": bc[1]})
        rc = ring[:, lo:hi].contiguous()
        a.record()
        pr, br, rr, lr = ref.fused_tick_ref(kind, pc, g[lo:hi], bufs_c, s, rc, step, taus, weights)
        b.record()
        torch.cuda.synchronize()
        plain_ms += a.elapsed_time(b)
        err_update(errs, p[lo:hi], pr, tol)
        for got, want in zip([x[lo:hi] for x in state_list(kind, bufs)], state_list(kind, br)):
            err_update(errs, got, want, tol)
        check(torch.equal(ring[push, lo:hi], rr[push]), "pushed ring slot differs from the plain push")
        check(torch.equal(live, lr), "live mask differs")
        del pc, bc, bufs_c, rc, pr, br, rr
    del p0, bufs0
    item = ring.element_size()
    nbytes = tick_bytes(kind, n, item, STEP, TAUS, weights.tolist(), K_RING)
    if nan_dead:
        return dict(max_abs_err=errs["max_abs_err"], plain_ms=plain_ms, bytes=nbytes)
    ms = cuda_ms(lambda: C.fused_tick(kind, p, g, bufs, s, ring, step, taus, weights))
    # the kernel reads only the live slots: it moves exactly the bound's bytes
    return dict(max_abs_err=errs["max_abs_err"], ms=ms, plain_ms=plain_ms,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes, kernel_bytes=nbytes)


def check_chain(kind, n, dev, *, timed=True):
    """Chain kernel vs plain, bitwise, chunk by chunk; ``timed``: also its
    time and the library call's (20 launches each after a warm-up)."""
    import torch

    from repro_torch.kernels.adaptive_update import cuda as C
    from repro_torch.kernels.adaptive_update import ref

    gen = torch.Generator(device=dev).manual_seed(2)
    p = torch.randn(n, generator=gen, device=dev)
    g = torch.randn(n, generator=gen, device=dev)
    bufs = make_state(kind, n, gen, dev)
    s = kernel_scalars(kind)
    p0, bufs0 = stash(p), [stash(b) for b in state_list(kind, bufs)]
    C.fused_chain(kind, p, g, bufs, s)
    torch.cuda.synchronize()
    errs, plain_ms = {"max_abs_err": 0.0}, 0.0
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for lo in range(0, n, CHUNK):
        hi = min(n, lo + CHUNK)
        pc = p0[lo:hi].to(dev)
        bc = [x[lo:hi].to(dev) for x in bufs0]
        bufs_c = () if kind == "sgd" else (bc[0] if kind == "momentum" else {"m": bc[0], "v": bc[1]})
        a.record()
        pr, br = ref.fused_chain_ref(kind, pc, g[lo:hi], bufs_c, s)
        b.record()
        torch.cuda.synchronize()
        plain_ms += a.elapsed_time(b)
        bits_update(errs, p[lo:hi], pr)
        for got, want in zip([x[lo:hi] for x in state_list(kind, bufs)], state_list(kind, br)):
            bits_update(errs, got, want)
    del p0, bufs0
    if not timed:
        return dict(max_abs_err=errs["max_abs_err"], plain_ms=plain_ms)
    ms = cuda_ms(lambda: C.fused_chain(kind, p, g, bufs, s), iters=20)
    nbytes = n * (8 + 4 + 8 * len(state_list(kind, bufs)))
    del bufs
    library_ms, call = library_step(kind, p, g)
    return dict(max_abs_err=errs["max_abs_err"], ms=ms, plain_ms=plain_ms,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes, library_ms=library_ms,
                library_call=call)


def library_step(kind, p, g):
    """One step of PyTorch's fused optimizer on the ``(N,)`` f32 tensor ``p``
    with gradient ``g`` (the kernel's buffers, reused: their values no longer
    matter), timed only: ``SGD(momentum=mu, fused=True)`` (the momentum body
    and the fused_apply link; plain SGD for the sgd body) or
    ``Adam(fused=True)``.  It moves the same bytes as the kernel (each of p,
    g and the state read once, p and the state written once) and computes
    the same update up to the scale the velocity carries."""
    import torch

    q = p.detach()
    q.grad = g
    if kind == "adam":
        opt, call = torch.optim.Adam([q], lr=0.05, fused=True), "torch.optim.Adam(fused=True).step()"
    else:
        mu = 0.9 if kind == "momentum" else 0.0
        opt = torch.optim.SGD([q], lr=0.05, momentum=mu, fused=True)
        call = f"torch.optim.SGD(momentum={mu}, fused=True).step()"
    ms = cuda_ms(opt.step, iters=20)
    del opt
    q.grad = None
    free_cuda()
    return ms, call


def check_combine(n, dev):
    import torch

    from repro_torch.kernels.adaptive_update import cuda as C
    from repro_torch.kernels.adaptive_update import ref

    gen = torch.Generator(device=dev).manual_seed(3)
    g = torch.randn(n, generator=gen, device=dev)
    ring = torch.randn(K_RING, n, generator=gen, device=dev, dtype=torch.bfloat16)
    step = torch.tensor(STEP, dtype=torch.int32, device=dev)
    taus = torch.tensor(TAUS, dtype=torch.int32, device=dev)
    weights = torch.rand(W_WORKERS, generator=gen, device=dev) + 0.1
    sums0 = slot_checksums(ring)
    g_eff, live = C.fused_combine(g, ring, step, taus, weights)
    torch.cuda.synchronize()
    push = STEP % K_RING
    check(all(a == b for k, (a, b) in enumerate(zip(sums0, slot_checksums(ring))) if k != push),
          "combine kernel wrote a ring slot other than the pushed one")
    errs, plain_ms = {"max_abs_err": 0.0}, 0.0
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for lo in range(0, n, CHUNK):
        hi = min(n, lo + CHUNK)
        rc = ring[:, lo:hi].contiguous()
        a.record()
        gr, lr, rr = ref.fused_combine_ref(g[lo:hi], rc, step, taus, weights)
        b.record()
        torch.cuda.synchronize()
        plain_ms += a.elapsed_time(b)
        err_update(errs, g_eff[lo:hi], gr, 1e-5)
        check(torch.equal(ring[push, lo:hi], rr[push]), "pushed ring slot differs")
        check(torch.equal(live, lr), "live mask differs")
    ms = cuda_ms(lambda: C.fused_combine(g, ring, step, taus, weights))
    nbytes = n * (4 + 4 + 2 * (1 + live_slots(STEP, TAUS, weights.tolist(), K_RING)))
    return dict(max_abs_err=errs["max_abs_err"], ms=ms, plain_ms=plain_ms,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes)


def check_update(n, dev, *, timed=True):
    """fused_update vs plain, bitwise, chunk by chunk; ``timed`` as
    :func:`check_chain`."""
    import torch

    from repro_torch.kernels.adaptive_update import cuda as C
    from repro_torch.kernels.adaptive_update import ref

    gen = torch.Generator(device=dev).manual_seed(4)
    p, g, v = (torch.randn(n, generator=gen, device=dev) for _ in range(3))
    alpha, mu = torch.tensor(0.05), torch.tensor(0.9)
    p0, v0 = stash(p), stash(v)
    C.fused_update(p, g, v, alpha, mu)
    torch.cuda.synchronize()
    errs, plain_ms = {"max_abs_err": 0.0}, 0.0
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for lo in range(0, n, CHUNK):
        hi = min(n, lo + CHUNK)
        pc, vc = p0[lo:hi].to(dev), v0[lo:hi].to(dev)
        a.record()
        pr, vr = ref.adaptive_update_ref(pc, g[lo:hi], vc, alpha, mu)
        b.record()
        torch.cuda.synchronize()
        plain_ms += a.elapsed_time(b)
        bits_update(errs, p[lo:hi], pr)
        bits_update(errs, v[lo:hi], vr)
    del p0, v0
    if not timed:
        return dict(max_abs_err=errs["max_abs_err"], plain_ms=plain_ms)
    ms = cuda_ms(lambda: C.fused_update(p, g, v, alpha, mu), iters=20)
    nbytes = n * 20
    del v
    library_ms, call = library_step("momentum", p, g)
    return dict(max_abs_err=errs["max_abs_err"], ms=ms, plain_ms=plain_ms,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes, library_ms=library_ms,
                library_call=call)


def stream_line(r) -> str:
    """Achieved TB/s of the bytes moved and the ratio to the library call."""
    return (f"{r['bytes'] / r['ms'] / 1e9:.3f} TB/s ({100 * r['bound_ms'] / r['ms']:.1f} % of the "
            f"bound), {r['ms'] / r['library_ms']:.3f}x the library")


def free_cuda():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phases 3 and 4: the paths, through the port's entry points
# ---------------------------------------------------------------------------

class TickLog:
    """Per-tick host line (synchronizes to time each tick: measurement only).

    With ``replay`` (the fused async main path) it also replays each tick's
    taus: it keeps the workers' generator state and the tables in force
    before the tick, draws the same uniforms again and looks them up, so it
    can count the ring slots the tick kernel read (``live_slots``) and so
    its bytes."""

    def __init__(self, name, workers=W_WORKERS, replay=False):
        import torch

        self.name, self.rows, self._torch, self.workers = name, [], torch, workers
        self._t = None
        self._snap = None
        self._replay_on = replay

    def _snapshot(self, state):
        if not self._replay_on or state.adapt is None or state.delayed is None:
            self._snap = None
            return
        self._snap = (state.rng.get_state(), state.adapt.tau_cdf.clone(),
                      state.adapt.alpha_table.clone(), int(state.delayed.step))

    def _replay(self, ctx):
        """(taus, slots read) of the tick just run, from the snapshot."""
        from repro_torch.training.adapt import sample_taus

        torch = self._torch
        rng_state, cdf, table, step = self._snap
        dev = cdf.device
        gen = torch.Generator(device=dev)
        gen.set_state(rng_state)
        taus = sample_taus(torch.rand(self.workers, generator=gen, device=dev), cdf)
        alphas = table[taus.long().clamp(0, table.shape[0] - 1)]
        check(abs(float(taus.float().mean()) - float(ctx.metrics["tau_mean"])) == 0.0,
              f"[{self.name}] the replayed taus disagree with the tick's tau_mean")
        K = _leaves(ctx.state.delayed.ring)[0].shape[0]
        return taus.tolist(), live_slots(step, taus.tolist(), alphas.tolist(), K)

    def on_start(self, ctx):
        self._snapshot(ctx.state)
        self._torch.cuda.synchronize()
        self._t = time.perf_counter()
        adapt = ctx.state.adapt
        self.table_ptr = adapt.alpha_table.data_ptr() if adapt is not None else None

    def on_refresh(self, ctx):
        pass

    def on_tick(self, ctx):
        self._torch.cuda.synchronize()
        now = time.perf_counter()
        m = {k: v.item() for k, v in ctx.metrics.items()}
        adapt = ctx.state.adapt
        row = dict(step=ctx.step, ms=(now - self._t) * 1e3, loss=m["loss"],
                   tau_mean=m.get("tau_mean"), alpha_mean=m.get("alpha_mean"),
                   table=adapt.alpha_table.clone() if adapt is not None else None,
                   cdf=adapt.tau_cdf.clone() if adapt is not None else None,
                   hist=adapt.hist.clone() if adapt is not None else None)
        self._t = now
        t0 = time.perf_counter()
        if self._snap is not None:
            row["taus"], row["slots_read"] = self._replay(ctx)
        self._snapshot(ctx.state)
        self._torch.cuda.synchronize()
        self._t += time.perf_counter() - t0  # the replay is not the next tick's time
        self.rows.append(row)
        extra = "" if row["tau_mean"] is None else (
            f"  tau_mean {row['tau_mean']:.3f}  alpha_mean {row['alpha_mean']:.6f}")
        if "slots_read" in row:
            extra += f"  taus {row['taus']}  ring slots read {row['slots_read']}"
        log(f"[{self.name}] tick {ctx.step:3d}  loss {row['loss']:.4f}{extra}  {row['ms']:.1f} ms")

    def on_end(self, ctx):
        pass


def lm_pipeline(lr, workers, ring, *, clip=None, fused_apply=False, async_mode=True):
    """The launcher's MindTheStep chain (momentum 0.9) and its AdaptState,
    built on the host; the engine moves the tables to the run's device."""
    from repro_torch.optim import transform as T
    from repro_torch.training import default_adapt_setup

    base = (T.fused_apply(lr, 0.9),) if fused_apply else (T.scale(-lr), T.trace(0.9))
    if clip is not None:
        base = (T.clip_by_global_norm(clip),) + base
    if not async_mode:
        return T.chain(*base), None
    sched, _, adapt = default_adapt_setup(lr, workers, ring, device="cpu")
    link = T.scale_by_staleness(sched, lr, m=workers, tau_max=adapt.tau_max)
    return T.chain(link, *base), adapt


def state_bytes(tree) -> int:
    """Bytes of every tensor of a state (a generator holds no device memory)."""
    from repro_torch.sharding.specs import leaf_paths

    return sum(t.numel() * t.element_size() for _, t in leaf_paths(tree) if hasattr(t, "numel"))


def main_spec(cfg, device="cuda"):
    """Phase 3's run: full-width async fused training, W = K = 8, bf16 ring."""
    from repro_torch.run import RunSpec

    pipe, adapt = lm_pipeline(0.01, W_WORKERS, K_RING)
    return RunSpec(cfg=cfg, pipeline=pipe, mode="async", num_steps=12, batch_size=4, seq_len=512,
                   num_workers=W_WORKERS, ring=K_RING, ring_dtype="bfloat16", adapt=adapt,
                   fuse=True, refresh_every=5, seed=0, device=device)


def main_path(cfg, n_expected):
    import torch

    from repro_torch.kernels.adaptive_update import cuda as C
    from repro_torch.run import run

    spec = main_spec(cfg)
    hook = TickLog("main", replay=True)
    torch.cuda.reset_peak_memory_stats()
    C.reset_launches()
    t0 = time.perf_counter()
    result = run(spec, hooks=[hook])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(C.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    state = result.state
    n = state.params.numel()
    log(f"[main] N={n} params  ring {tuple(state.delayed.ring.shape)} {state.delayed.ring.dtype}  "
        f"wall {wall:.2f}s  peak memory {peak / 1e9:.2f} GB  launches {counts}")
    check(n == n_expected, f"unexpected parameter count {n}")
    check(all(math.isfinite(r["loss"]) for r in hook.rows), "non-finite loss on the main path")
    check(counts["fused_tick"] == spec.num_steps, f"fused_tick launched {counts['fused_tick']} times")
    check(counts["fused_chain"] == counts["fused_combine"] == counts["fused_update"] == 0,
          "the clip-less fused async tick launched another kernel")
    check(state.adapt.alpha_table.data_ptr() == hook.table_ptr,
          "the refresh replaced the alpha table tensor instead of writing into it")
    check(not torch.equal(hook.rows[4]["table"], hook.rows[3]["table"])
          or not torch.equal(hook.rows[9]["table"], hook.rows[8]["table"]),
          "no refresh changed the alpha table")
    steady = [r["ms"] for r in hook.rows[1:]]
    ring_item = state.delayed.ring.element_size()
    tick_gb = [n * (8 + 4 + 8 + ring_item * (1 + r["slots_read"])) / 1e9 for r in hook.rows]
    log(f"[main] ring slots read per tick {[r['slots_read'] for r in hook.rows]}; tick kernel "
        f"bytes per tick (GB) {[round(b, 3) for b in tick_gb]}, {sum(tick_gb):.2f} GB over "
        f"{len(tick_gb)} ticks, {sum(tick_gb) / HBM_BYTES_PER_S * 1e12:.3f} ms at 3.35 TB/s")
    summary = dict(ticks=spec.num_steps, first_tick_ms=hook.rows[0]["ms"],
                   median_tick_ms=sorted(steady)[len(steady) // 2], peak_gb=peak / 1e9,
                   losses=[r["loss"] for r in hook.rows], launches=counts,
                   slots_read=[r["slots_read"] for r in hook.rows], tick_kernel_gb=tick_gb,
                   state_bytes=state_bytes(state), allocated_bytes=torch.cuda.memory_allocated())
    return summary, counts


def other_paths(cfg):
    import torch

    from repro_torch.kernels.adaptive_update import cuda as C
    from repro_torch.run import RunSpec, run

    paths = {
        "sync_fuse": (dict(mode="sync", fuse=True), dict(async_mode=False), ("fused_chain",)),
        "async_fuse_clip": (dict(mode="async", fuse=True), dict(clip=1.0),
                            ("fused_combine", "fused_chain")),
        "async_fused_apply": (dict(mode="async", fuse=False), dict(fused_apply=True),
                              ("fused_update",)),
    }
    out = {}
    for name, (kw, pkw, expect) in paths.items():
        pipe, adapt = lm_pipeline(0.01, W_WORKERS, K_RING, **pkw)
        spec = RunSpec(cfg=cfg, pipeline=pipe, num_steps=3, batch_size=4, seq_len=512,
                       num_workers=W_WORKERS, ring=K_RING if kw["mode"] == "async" else 0,
                       ring_dtype="bfloat16", adapt=adapt, seed=0, device="cuda", **kw)
        hook = TickLog(name)
        C.reset_launches()
        run(spec, hooks=[hook])
        torch.cuda.synchronize()
        counts = dict(C.LAUNCHES)
        log(f"[{name}] launches {counts}")
        check(all(math.isfinite(r["loss"]) for r in hook.rows), f"non-finite loss on {name}")
        for k in expect:
            check(counts[k] == 3, f"{name}: {k} launched {counts[k]} times, expected 3")
        out[name] = counts
        del spec, hook, pipe, adapt
        free_cuda()
    return out


def small_agreement():
    """Reduced stablelm, 4 fused async ticks: the card (kernels) against the
    CPU (plain versions) on the same params, batches and uniforms."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.run import RunSpec, run
    from repro_torch.training import init_params
    from repro_torch.optim import transform as T

    cfg = reduced(get_config("stablelm-1.6b"))
    flat = T.pack_flat(init_params(0, cfg, "cpu"))
    draws = np.random.default_rng(0).random((4, 4)).astype(np.float32)
    finals = {}
    for device in ("cpu", "cuda"):
        it = iter(draws)
        pipe, adapt = lm_pipeline(0.05, 4, 4)
        spec = RunSpec(cfg=cfg, pipeline=pipe, mode="async", num_steps=4, batch_size=2,
                       seq_len=64, num_workers=4, ring=4, adapt=adapt, fuse=True, params=flat,
                       refresh_every=2, seed=0, device=device,
                       tau_source=lambda: torch.from_numpy(next(it)))
        finals[device] = run(spec).state.params.cpu()
    d = (finals["cuda"] - finals["cpu"]).abs().max().item()
    log(f"[agreement] reduced stablelm, 4 fused async ticks: card vs CPU max |dp| = {d:.3e}")
    check(d <= 1e-5, f"card and CPU disagree by {d}")
    return d


# ---------------------------------------------------------------------------
# Phases 5 and 6: serving
# ---------------------------------------------------------------------------

def band_pairs(S, T, causal, window):
    """(query, key) pairs inside the causal / window band — this run's work."""
    total = 0
    for q in range(S):
        lo = max(0, q - window + 1) if window else 0
        hi = min(T, q + 1) if causal else T
        total += max(0, hi - lo)
    return total


def band_mask(S, T, causal, window, dev):
    import torch

    q = torch.arange(S, device=dev)[:, None]
    k = torch.arange(T, device=dev)[None, :]
    valid = torch.ones((S, T), dtype=torch.bool, device=dev)
    if causal:
        valid &= k <= q
    if window:
        valid &= (q - k) < window
    return valid


def check_flash(B, S, T, Nq, Nkv, H, causal, window, softcap, dtype, dev):
    """Flash kernel vs its plain version; SDPA timed beside it where one call
    computes the same function (no softcap)."""
    import torch

    from repro_torch.kernels.flash_attention import cuda as FA

    gen = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn(B, S, Nq, H, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, T, Nkv, H, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, T, Nkv, H, generator=gen, device=dev).to(dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out = FA.flash_attention(q, k, v, **kw)
    want = FA.attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    err = float((out.float() - want.float()).abs().max())
    # f32: the reference's 3e-5; bf16: one rounding of the output (rtol, atol)
    rtol, atol = (3e-5, 3e-5) if dtype == torch.float32 else (1e-2, 1e-4)
    tol = f"{atol} + {rtol}|plain|"
    bad = int(((out.float() - want.float()).abs() > atol + rtol * want.float().abs()).sum())
    check(bad == 0, f"flash {B, S, T, Nq, Nkv, H, causal, window, softcap, dtype}: "
                    f"{bad} elements past {tol} (max |d| {err})")
    del out, want
    ms = cuda_ms(lambda: FA.flash_attention(q, k, v, **kw))
    plain_ms = cuda_ms(lambda: FA.attention_ref(q, k, v, **kw), iters=2)
    library_ms = None
    if softcap is None:
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if window is None:
            sdpa_kw = dict(is_causal=causal)
        else:
            sdpa_kw = dict(attn_mask=band_mask(S, T, causal, window, dev))
        library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True, **sdpa_kw))
    pairs = band_pairs(S, T, causal, window)
    flops = 4 * H * pairs * B * Nq
    nbytes = q.element_size() * (2 * B * S * Nq * H + 2 * B * T * Nkv * H)
    t_ops = flops / PEAK_FLOPS[str(dtype).split(".")[-1]]
    bound_ms = max(nbytes / HBM_BYTES_PER_S, t_ops) * 1e3
    by = "operations" if t_ops >= nbytes / HBM_BYTES_PER_S else "bytes"
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=by, flops=flops, bytes=nbytes, tol=tol,
                tflops=flops / ms / 1e9)


def check_rg_lru(B, S, W, dev):
    import torch

    from repro_torch.kernels.rg_lru import cuda as RG

    gen = torch.Generator(device=dev).manual_seed(6)
    log_a = -torch.nn.functional.softplus(torch.randn(B, S, W, generator=gen, device=dev))
    x = torch.randn(B, S, W, generator=gen, device=dev)
    y = RG.rg_lru(log_a, x)
    want = RG.rg_lru_ref(log_a, x)
    torch.cuda.synchronize()
    err = float((y - want).abs().max())
    check(bool(((y - want).abs() <= 3e-5 + 3e-5 * want.abs()).all()),
          f"rg_lru past 3e-5 (max |d| {err})")
    del y, want
    ms = cuda_ms(lambda: RG.rg_lru(log_a, x), iters=20)
    plain_ms = cuda_ms(lambda: RG.rg_lru_ref(log_a, x), iters=2)
    nbytes = 12 * B * S * W
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", bytes=nbytes)


def check_selective_scan(B, S, D, N, u_dtype, dev, a_init="model"):
    """The selective-scan kernel against its plain version: y and hT.
    ``a_init``: "model" is the init's A = -(1..N) on every row, "random" A
    drawn per (d, n) as -exp(randn)."""
    import torch

    from repro_torch.kernels.selective_scan import cuda as SS

    gen = torch.Generator(device=dev).manual_seed(7)
    u = torch.randn(B, S, D, generator=gen, device=dev).to(u_dtype)
    delta = torch.nn.functional.softplus(torch.randn(B, S, D, generator=gen, device=dev) - 2.0)
    if a_init == "model":
        A = -torch.arange(1, N + 1, dtype=torch.float32, device=dev).repeat(D, 1)
    else:
        A = -torch.exp(torch.randn(D, N, generator=gen, device=dev))
    Bm = torch.randn(B, S, N, generator=gen, device=dev)
    Cm = torch.randn(B, S, N, generator=gen, device=dev)
    args = (u, delta, A, Bm, Cm)
    y, hT = SS.selective_scan(*args)
    want_y, want_h = SS.selective_scan_ref(*args)
    torch.cuda.synchronize()
    err = max(float((y - want_y).abs().max()), float((hT - want_h).abs().max()))
    for got, want, what in ((y, want_y, "y"), (hT, want_h, "hT")):
        bad = int(((got - want).abs() > 3e-5 + 3e-5 * want.abs()).sum())
        check(bad == 0, f"selective_scan {B, S, D, N, u_dtype} {what}: {bad} elements past 3e-5 "
                        f"(max |d| {err})")
    if a_init == "random":
        scan_witness(f"{B, S, D, N, u_dtype}", args, y, hT, want_y, want_h)
    del y, hT, want_y, want_h
    ms = cuda_ms(lambda: SS.selective_scan(*args), iters=20)
    plain_ms = cuda_ms(lambda: SS.selective_scan_ref(*args), iters=2)
    nbytes = (u.element_size() + 4 + 4) * B * S * D + 4 * D * N + 8 * B * S * N + 4 * B * D * N
    exps = B * S * D * N
    flops = 6 * exps  # delta*A, the h update (3: mul, mul, add), y (2)
    times = {"bytes": nbytes / HBM_BYTES_PER_S, "exponentials": exps / SFU_EXP_PER_S,
             "f32 operations": flops / PEAK_FLOPS["float32"]}
    what = max(times, key=times.get)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=times[what] * 1e3, bound_by="bytes" if what == "bytes" else "operations",
                bound_set_by=what, bound_terms_ms={k: v * 1e3 for k, v in times.items()},
                bytes=nbytes, exps=exps, flops=flops, sm_clock_hz=SM_CLOCK_HZ,
                exps_per_s=exps / (ms * 1e-3))


def scan_witness(tag, args, y, hT, want_y, want_h):
    """The kernel's and the f32 plain version's y and hT, each against the
    plain scan in f64, a witness of the f32 rounding: elements past 3e-5 +
    3e-5 |f64| and the largest |d| / (3e-5 + 3e-5 |f64|).  A reading, not a
    gate: where y cancels, the f32 plain version misses it too."""
    import torch

    from repro_torch.kernels.selective_scan import cuda as SS

    exact = dict(zip(("y", "hT"), SS.selective_scan_ref(*args, dtype=torch.float64)))
    parts = []
    for what, got, want in (("y", y, want_y), ("hT", hT, want_h)):
        tol = 3e-5 + 3e-5 * exact[what].abs()
        for who, v in (("kernel", got), ("f32 plain", want)):
            d = (v.double() - exact[what]).abs()
            parts.append(f"{what} {who} {int((d > tol).sum())} past, max |d|/tol "
                         f"{float((d / tol).max()):.3f}")
            del d
    log(f"[witness] selective_scan {tag} against the f64 plain scan: " + "; ".join(parts))


def witness_delta_ranges(dev):
    """``scan_witness`` over 3000 steps with A = -exp(randn) and delta near
    30 (decays underflow, y cancels 16 terms) or log-uniform from 1e-4 to 30,
    as the card test ``test_selective_scan_kernel_holds_over_delta_ranges``."""
    import torch

    from repro_torch.kernels.selective_scan import cuda as SS

    B, S, D, N = 1, 3000, 64, 16
    for rng in ("large", "mixed"):
        for u_dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=dev).manual_seed(11)
            u = torch.randn(B, S, D, generator=gen, device=dev).to(u_dtype)
            A = -torch.exp(torch.randn(D, N, generator=gen, device=dev))
            Bm = torch.randn(B, S, N, generator=gen, device=dev)
            Cm = torch.randn(B, S, N, generator=gen, device=dev)
            r = torch.rand(B, S, D, generator=gen, device=dev)
            delta = 20.0 + 10.0 * r if rng == "large" else torch.exp(-9.2 + 12.6 * r)
            args = (u, delta, A, Bm, Cm)
            y, hT = SS.selective_scan(*args)
            scan_witness(f"{B, S, D, N, u_dtype} delta {rng}", args, y, hT,
                         *SS.selective_scan_ref(*args))


CARD_BYTES = 80e9  # the H100's device memory


def serve_full(arch, batch, prompt, gen, expect):
    """Serve ``arch`` at full width through the launcher, counts zeroed just
    before and read just after; check them against ``expect``.  Peak memory
    is read when the launcher starts serving (params and batch resident)
    and after the serve; both must fit the card."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import cuda as FA
    from repro_torch.kernels.rg_lru import cuda as RG
    from repro_torch.kernels.selective_scan import cuda as SS
    from repro_torch.launch import serve

    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    FA.reset_launches()
    RG.reset_launches()
    SS.reset_launches()
    before = {}
    inner = serve.serve

    def serve_and_read_peak(*args, **kw):
        torch.cuda.synchronize()
        before["peak"] = torch.cuda.max_memory_allocated()
        return inner(*args, **kw)

    def prefill_and_keep_state(params, *args, **kw):
        # a reference only: the bytes are summed after the timed serve (the
        # decode writes this cache in place, so it holds no extra memory)
        logits, cache = inner_prefill(params, *args, **kw)
        before["state"] = (params, cache)
        return logits, cache

    serve.serve = serve_and_read_peak
    inner_prefill = serve.M.prefill
    serve.M.prefill = prefill_and_keep_state
    try:
        result = serve.main(["--arch", arch, "--batch", str(batch), "--prompt_len", str(prompt),
                             "--gen", str(gen), "--device", "cuda"])
    finally:
        serve.serve = inner
        serve.M.prefill = inner_prefill
    torch.cuda.synchronize()
    if "state" in before:  # whisper runs no decoder prefill
        before["state_bytes"] = sum(state_bytes(t) for t in before.pop("state"))
    counts = {"flash_attention": FA.LAUNCHES["flash_attention"], "rg_lru": RG.LAUNCHES["rg_lru"],
              "selective_scan": SS.LAUNCHES["selective_scan"]}
    peak = torch.cuda.max_memory_allocated()
    cfg = get_config(arch)
    if cfg.is_encoder_decoder:  # no decoder prefill, as in the reference's launcher
        check(result["prefill_logits"] is None, f"{arch}: a decoder prefill ran")
    else:
        check(bool(torch.isfinite(result["prefill_logits"]).all()), f"{arch}: non-finite logits")
    check(bool(torch.isfinite(result["logits"]).all()), f"{arch}: non-finite logits")
    toks = result["tokens"]
    check(tuple(toks.shape) == (batch, gen), f"{arch}: generated ids of shape {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), f"{arch}: generated ids out of range")
    check(counts == expect, f"{arch}: launches {counts}, expected {expect} per prefill")
    check(peak < CARD_BYTES, f"{arch}: peak {peak / 1e9:.2f} GB does not fit the card")
    row = dict(arch=arch, batch=batch, prompt=prompt, gen=gen, prefill_s=result["prefill_s"],
               decode_ms_per_step=result["decode_s"] / gen * 1e3, tok_per_s=result["tok_per_s"],
               peak_gb=peak / 1e9, peak_before_prefill_gb=before["peak"] / 1e9,
               n_prefix=cfg.num_prefix_embeddings if cfg.frontend == "vision" else 0,
               encoder_frames=cfg.encoder_positions if cfg.is_encoder_decoder else 0,
               launches=counts, state_bytes=before.get("state_bytes"))
    log(f"[serve] {json.dumps(row)}")
    del result
    free_cuda()
    return row


def serve_agreement(arch):
    """Reduced ``arch`` served on the card (the kernels) against the plain
    CPU path, same params and prompts; for an MoE config also the first MoE
    layer's top-k expert ids over the prefill, exactly equal."""
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.data import make_batch_for
    from repro_torch.launch.serve import serve
    from repro_torch.models import moe as MOE
    from repro_torch.training import init_params
    from repro_torch.tree import tree_map

    cfg = reduced(get_config(arch))
    params = init_params(0, cfg, "cpu")
    batch = make_batch_for(cfg, batch=2, seq=160, seed=0)
    routes = []  # per serve: the router's output at its first call (layer 0, prefill)
    inner = MOE.route

    def serve_on(device, c):
        kept = []

        def keep_first(*args):
            out = inner(*args)
            if not kept:
                kept.append(tuple(t.cpu() for t in out))
            return out

        MOE.route = keep_first
        try:
            res = serve(c, tree_map(lambda t: t.to(device), params),
                        {k: v.to(device) for k, v in batch.items()}, gen=4)
        finally:
            MOE.route = inner
        routes.append(kept[0] if kept else None)
        return res

    want = serve_on("cpu", cfg)
    got = serve_on("cuda", dataclasses.replace(cfg, use_pallas=True))
    d = float((got["logits"].cpu() - want["logits"]).abs().max())
    if want["prefill_logits"] is not None:  # whisper has no decoder prefill
        d = max(d, float((got["prefill_logits"].cpu() - want["prefill_logits"]).abs().max()))
    row = dict(arch=arch, max_abs_dlogits=d)
    msg = ""
    if cfg.num_experts:
        (probs, _, want_ids), (_, _, got_ids) = routes
        top = torch.topk(probs, min(cfg.top_k + 1, cfg.experts_padded), dim=-1).values
        k = cfg.top_k - 1
        row.update(route_ids_equal=bool(torch.equal(got_ids, want_ids)),
                   route_flips=int((got_ids != want_ids).any(-1).sum()),
                   min_top1_minus_topk=float((top[:, 0] - top[:, k]).min()),
                   min_topk_minus_next=(float((top[:, k] - top[:, k + 1]).min())
                                        if top.shape[1] > cfg.top_k else None))
        nxt = row["min_topk_minus_next"]
        msg = (f", first MoE layer's top-{cfg.top_k} ids over {want_ids.shape[0]} tokens "
               f"{'equal' if row['route_ids_equal'] else 'DIFFER'} ({row['route_flips']} tokens "
               f"flipped), smallest margins p1 - p{cfg.top_k} {row['min_top1_minus_topk']:.3e}, "
               f"p{cfg.top_k} - p{cfg.top_k + 1} {'none' if nxt is None else f'{nxt:.3e}'}")
    log(f"[agreement] reduced {arch}, prefill 160 + 4 steps: card vs CPU max |dlogits| "
        f"= {d:.3e}, ids {got['tokens'][0].tolist()}{msg}")
    check(d <= 1e-4, f"{arch}: served logits: card and CPU disagree by {d}")
    check(torch.equal(got["tokens"].cpu(), want["tokens"]),
          f"{arch}: served ids differ between card and CPU")
    if cfg.num_experts:
        check(row["route_ids_equal"], f"{arch}: the first MoE layer routes differently on the card")
    return row


# ---------------------------------------------------------------------------
# Phase 7: checkpoint and resume on the main path; phase 8: the exact simulator
# ---------------------------------------------------------------------------

def _bits(t):
    import torch

    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def same_bits(host, dev_leaf):
    """``host`` (a CPU copy) and the card's ``dev_leaf`` hold the same bits,
    compared on the card a chunk at a time."""
    import torch

    if isinstance(dev_leaf, torch.Generator):
        return torch.equal(host, dev_leaf.get_state())
    a, b = host.reshape(-1), dev_leaf.reshape(-1)
    if a.dtype != b.dtype or a.numel() != b.numel():
        return False
    return all(torch.equal(_bits(a[i:i + CHUNK].to(b.device)), _bits(b[i:i + CHUNK]))
               for i in range(0, a.numel(), CHUNK))


def resume_path(cfg, n_expected, ckpt_root):
    """Run A: 6 uninterrupted fused async ticks (refresh every 2) with a
    checkpoint at step 3, whose histogram is partial.  Run B: a fresh
    pipeline and adapt resumed from it at step 3, crossing the step-4
    refresh.  B's losses and every leaf of B's final state must equal A's
    bit for bit, and the host estimators must agree."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint import key_paths
    from repro_torch.kernels.adaptive_update import cuda as C
    from repro_torch.optim import transform as T
    from repro_torch.run import CheckpointHook, Hook, RunSpec, run

    class Losses(Hook):
        def __init__(self):
            self.losses, self.t_start = [], None

        def on_start(self, ctx):
            torch.cuda.synchronize()
            self.t_start = time.perf_counter()

        def on_tick(self, ctx):
            self.losses.append(ctx.metrics["loss"].item())

    class TimedCheckpoint(CheckpointHook):
        """``CheckpointHook(every=3)`` timed, and stopped after its first save:
        a save at step 6 would write another 34.5 GB that nothing reads."""

        def _save(self, ctx):
            if self.saved_steps:
                return
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super()._save(ctx)
            self.seconds = time.perf_counter() - t0

    def spec():
        pipe, adapt = lm_pipeline(0.01, W_WORKERS, K_RING)
        return RunSpec(cfg=cfg, pipeline=pipe, mode="async", num_steps=6, batch_size=4,
                       seq_len=512, num_workers=W_WORKERS, ring=K_RING, ring_dtype="bfloat16",
                       adapt=adapt, fuse=True, refresh_every=2, seed=0, device="cuda")

    with tempfile.TemporaryDirectory(dir=ckpt_root) as d:
        free_disk = shutil.disk_usage(d).free
        torch.cuda.reset_peak_memory_stats()
        spec_a, track_a, saver = spec(), Losses(), TimedCheckpoint(d, every=3)
        C.reset_launches()
        res_a = run(spec_a, hooks=[track_a, saver])
        torch.cuda.synchronize()
        launches_a = C.LAUNCHES["fused_tick"]
        check(saver.saved_steps == [3], f"checkpoints at {saver.saved_steps}")
        n = res_a.state.params.numel()
        check(n == n_expected, f"unexpected parameter count {n}")
        files = [f for f in os.listdir(d) if f.startswith("step_00000003")]
        ckpt_bytes = sum(os.path.getsize(os.path.join(d, f)) for f in files)
        hist = np.load(os.path.join(d, "step_00000003.npz"))[".adapt.hist"]
        check(int(hist.sum()) > 0, "the step-3 checkpoint holds no partial histogram")
        # run A's final state leaves the card (34.5 GB beside run B's 46 GB would not fit)
        final_a = {k: (v.get_state() if isinstance(v, torch.Generator) else v.cpu())
                   for k, v in key_paths(res_a.state)}
        est_a = T.staleness_link(spec_a.pipeline).estimator
        del res_a
        free_cuda()

        spec_b, track_b = spec(), Losses()
        C.reset_launches()
        t0 = time.perf_counter()
        res_b = run(spec_b, hooks=[track_b], resume_from=d, resume_step=3)
        restore_s = track_b.t_start - t0
        torch.cuda.synchronize()
        launches_b = C.LAUNCHES["fused_tick"]
        peak = torch.cuda.max_memory_allocated()
        final_b = dict(key_paths(res_b.state))
        check(res_b.start_step == 3, f"resumed at {res_b.start_step}")
        check(track_b.losses == track_a.losses[3:],
              f"resumed losses {track_b.losses} != uninterrupted {track_a.losses[3:]}")
        check(sorted(final_a) == sorted(final_b), "the final states' leaves differ in name")
        differ = [k for k in final_a if not same_bits(final_a[k], final_b[k])]
        check(not differ, f"resumed state differs from the uninterrupted one in {differ}")
        est_b = T.staleness_link(spec_b.pipeline).estimator
        check(est_a.n_seen == est_b.n_seen and np.array_equal(est_a.counts, est_b.counts),
              "the host estimators differ after the resume")
        check(launches_a == 6 and launches_b == 3,
              f"fused_tick launched {launches_a} + {launches_b} times, expected 6 + 3")
        row = dict(n_params=n, leaves=sorted(final_a), checkpoint_gb=ckpt_bytes / 1e9,
                   save_s=saver.seconds, restore_s=restore_s, free_disk_gb=free_disk / 1e9,
                   peak_gb=peak / 1e9, losses=track_a.losses, launches=[launches_a, launches_b],
                   est_n_seen=est_b.n_seen)
        log(f"[resume] full-width stablelm-1.6b, fused async, checkpoint at 3 of 6 (refresh "
            f"every 2): checkpoint {row['checkpoint_gb']:.2f} GB on disk ({free_disk / 1e9:.1f} "
            f"GB free before it), save {saver.seconds:.2f} s, restore {restore_s:.2f} s, peak "
            f"memory {peak / 1e9:.2f} GB; resumed losses {track_b.losses} equal run A's steps "
            f"4-6; {len(final_a)} leaves bitwise equal ({', '.join(sorted(final_a))}); "
            f"estimator n_seen {est_b.n_seen} equal; fused_tick launches {launches_a} + "
            f"{launches_b}")
        del res_b, final_a, final_b
    free_cuda()
    return row


def exact_simulator():
    """The paper's Fig.-3 problem through the exact simulator: a noisy
    quadratic, d 16, m 16, T 3000, the constant table and the eq.-26
    normalised geometric-momentum table, on the card and on the CPU."""
    import numpy as np
    import torch

    from repro_torch.async_engine import simulate_async_sgd, uniform_commit_order
    from repro_torch.core import staleness as S
    from repro_torch.core import step_size as SS

    d, m, T, alpha_c, eps = 16, 16, 3000, 0.05, 1.5
    rng = np.random.default_rng(0)
    batches = (0.3 * rng.standard_normal((T, d))).astype(np.float32)
    eig = np.linspace(0.5, 3.0, d).astype(np.float32)
    order = uniform_commit_order(T, m, seed=3)

    def iters_to(losses):
        idx = np.nonzero(losses < eps)[0]
        return int(idx[0]) if idx.size else T + 1

    def on(device):
        e = torch.from_numpy(eig).to(device)

        def loss(x, b):
            return 0.5 * torch.sum(e * (x - b) ** 2)

        x0 = torch.full((d,), 2.0, device=device)
        bt = torch.from_numpy(batches).to(device)
        probe = simulate_async_sgd(loss, x0, bt, order, np.full(256, alpha_c, np.float32), m)
        pmf = S.empirical_pmf(probe.taus.cpu().numpy(), tau_max=255)
        adaptive = SS.make_schedule("geometric_momentum", alpha_c,
                                    S.Geometric(p=max(float(pmf[0]), 1e-3)), mu_star=0.0,
                                    tau_max=255, normalize_pmf=pmf)
        out = {}
        for name, sched in (("constant", SS.constant(alpha_c, tau_max=255)),
                            ("adaptive", adaptive)):
            tr = simulate_async_sgd(loss, x0, bt, order, sched.table, m)
            out[name] = {k: getattr(tr, k).cpu().numpy()
                         for k in ("params", "taus", "losses", "alphas")}
        return out

    t0 = time.perf_counter()
    card = on("cuda")
    card_s = time.perf_counter() - t0
    cpu = on("cpu")
    row = {"card_s": card_s, "phase_s": time.perf_counter() - t0}
    for name in ("constant", "adaptive"):
        a, b = card[name], cpu[name]
        check(np.array_equal(a["taus"], b["taus"]) and np.array_equal(a["alphas"], b["alphas"]),
              f"exact simulator ({name}): taus or alphas differ between card and CPU")
        for k in ("losses", "params"):
            rel = float(np.abs(a[k] - b[k]).max() / np.abs(b[k]).max())
            check(rel <= 1e-5, f"exact simulator ({name}): {k} differ by {rel:.3e} relative")
            row[f"{name}_{k}_rel"] = rel
        row[f"{name}_iters"] = iters_to(a["losses"])
    check(row["adaptive_iters"] <= row["constant_iters"],
          f"adaptive table reached eps {eps} after {row['adaptive_iters']} commits, "
          f"constant after {row['constant_iters']}")
    log(f"[exact] Fig.-3 quadratic d {d}, m {m}, T {T}: iterations to loss < {eps}: adaptive "
        f"{row['adaptive_iters']}, constant {row['constant_iters']}; card vs CPU taus and alphas "
        f"equal, losses / x within {max(v for k, v in row.items() if k.endswith('_rel')):.3e} "
        f"relative; card {card_s:.2f} s, phase {row['phase_s']:.2f} s")
    return row



# ---------------------------------------------------------------------------
# Phase 9: the sharded async engine; phase 10: the paper's CNN
# ---------------------------------------------------------------------------

SHARDED_W, SHARDED_K = 2, 4


def sharded_setup(lr, W, K, device):
    """The eq.-26 MindTheStep chain (momentum 0.9) and a WorkerAdaptState
    with heterogeneous workers: worker 0 a geometric CDF, worker 1 an
    event-simulator trace, any further ones Poisson CDFs."""
    from repro_torch.async_engine import EventSimConfig, simulate_staleness_trace
    from repro_torch.core.staleness import Geometric, Poisson
    from repro_torch.optim import transform as T
    from repro_torch.training import default_adapt_setup, make_worker_adapt

    sched, _, adapt = default_adapt_setup(lr, W, K, device="cpu")
    samplers = [Geometric(p=1.0 / (1.0 + W)),
                simulate_staleness_trace(EventSimConfig(m=W), num_updates=64, seed=0)]
    samplers += [Poisson(float(W))] * (W - 2)
    wadapt = make_worker_adapt(sched.table[:adapt.tau_max + 1], samplers, cdf_support=K,
                               device=device)
    link = T.scale_by_staleness(sched, lr, m=W, tau_max=adapt.tau_max)
    return T.chain(link, T.scale(-lr), T.trace(0.9)), wadapt


def sharded_spec(cfg, device="cuda"):
    """Phase 9's run: full-width sharded fused training, W 2 x K 4 bf16 rings."""
    from repro_torch.run import RunSpec

    pipe, adapt = sharded_setup(0.01, SHARDED_W, SHARDED_K, "cpu")
    return RunSpec(cfg=cfg, pipeline=pipe, mode="sharded_async", num_steps=6, batch_size=4,
                   seq_len=512, ring=SHARDED_K, ring_dtype="bfloat16", adapt=adapt, fuse=True,
                   refresh_every=3, seed=0, device=device)


def sharded_path(cfg, n_expected):
    import torch

    from repro_torch.kernels.adaptive_update import cuda as C
    from repro_torch.optim import transform as T
    from repro_torch.run import Hook, run
    from repro_torch.training import merge_worker_hist

    W, K = SHARDED_W, SHARDED_K
    spec = sharded_spec(cfg)
    est = T.staleness_link(spec.pipeline).estimator

    class Drains(Hook):
        """Per tick (measurement only, it waits for the device): the merged
        histogram's count; per refresh, the taus the estimator took in."""

        def __init__(self):
            self.hist, self.drained, self._seen = [], [], 0

        def on_refresh(self, ctx):
            self.drained.append(est.n_seen - self._seen)
            self._seen = est.n_seen

        def on_tick(self, ctx):
            self.hist.append(int(merge_worker_hist(ctx.state.adapt).sum()))

    hook, drains = TickLog("sharded", workers=W), Drains()
    torch.cuda.reset_peak_memory_stats()
    C.reset_launches()
    t0 = time.perf_counter()
    result = run(spec, hooks=[hook, drains])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(C.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    state = result.state
    n = state.params.numel()
    ring = state.delayed.ring
    ring_gb = ring.numel() * ring.element_size() / 1e9
    log(f"[sharded] N={n} params  ring {tuple(ring.shape)} {ring.dtype} ({ring_gb:.2f} GB)  "
        f"wall {wall:.2f}s  peak memory {peak / 1e9:.2f} GB  launches {counts}")
    check(n == n_expected, f"unexpected parameter count {n}")
    check(tuple(ring.shape[:2]) == (W, K), f"ring shape {tuple(ring.shape)}")
    check(all(math.isfinite(r["loss"]) for r in hook.rows), "non-finite loss on the sharded path")
    check(counts["fused_chain"] == spec.num_steps and counts["fused_tick"] == 0,
          f"sharded path launched fused_chain {counts['fused_chain']} and fused_tick "
          f"{counts['fused_tick']} times, expected {spec.num_steps} and 0")
    check(counts["fused_combine"] == counts["fused_update"] == 0,
          "the sharded path launched the combine or update kernel")
    check(state.adapt.alpha_table.data_ptr() == hook.table_ptr,
          "the refresh replaced the alpha table tensor instead of writing into it")
    check(not torch.equal(hook.rows[2]["table"], hook.rows[1]["table"])
          or not torch.equal(hook.rows[5]["table"], hook.rows[4]["table"]),
          "no refresh changed the alpha table")
    check(drains.drained == [W * 3, W * 3],
          f"the refreshes drained {drains.drained} taus, expected {W * 3} each")
    check(drains.hist == [W, 2 * W, 0, W, 2 * W, 0],
          f"merged histogram counts per tick {drains.hist}")
    steady = [r["ms"] for r in hook.rows[1:]]
    summary = dict(ticks=spec.num_steps, first_tick_ms=hook.rows[0]["ms"],
                   median_tick_ms=sorted(steady)[len(steady) // 2], peak_gb=peak / 1e9,
                   ring_gb=ring_gb, losses=[r["loss"] for r in hook.rows], launches=counts,
                   drained=drains.drained, state_bytes=state_bytes(state),
                   allocated_bytes=torch.cuda.memory_allocated())
    log(f"[sharded] losses {summary['losses']}; median tick {summary['median_tick_ms']:.1f} ms "
        f"(first {summary['first_tick_ms']:.1f} ms); refreshes drained {drains.drained} taus")
    return summary, counts


def sharded_agreement(W):
    """Reduced stablelm, 4 fused sharded ticks (refresh every 2): the card
    against the CPU on the same params, batches and uniforms, with an f32
    ring (phase 3's reduced check and tolerance) and, printed, a bf16 one:
    there a 1e-7 difference in a gradient element can flip its bf16
    rounding (2^-8 of it), so the two devices part by up to
    lr x weight x |g| x 2^-8 a tick, which no f32 bound describes."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.optim import transform as T
    from repro_torch.run import RunSpec, run
    from repro_torch.training import init_params

    cfg = reduced(get_config("stablelm-1.6b"))
    flat = T.pack_flat(init_params(0, cfg, "cpu"))
    draws = np.random.default_rng(0).random((4, W)).astype(np.float32)
    out = {}
    for ring_dtype in (None, "bfloat16"):
        finals = {}
        for device in ("cpu", "cuda"):
            it = iter(draws)
            pipe, adapt = sharded_setup(0.05, W, 4, "cpu")
            spec = RunSpec(cfg=cfg, pipeline=pipe, mode="sharded_async", num_steps=4,
                           batch_size=2, seq_len=64, ring=4, ring_dtype=ring_dtype, adapt=adapt,
                           fuse=True, params=flat, refresh_every=2, seed=0, device=device,
                           tau_source=lambda: torch.from_numpy(next(it)))
            s = run(spec).state
            finals[device] = (s.params.cpu(), s.adapt.hist.cpu(), s.adapt.alpha_table.cpu())
        d = (finals["cuda"][0] - finals["cpu"][0]).abs().max().item()
        check(torch.equal(finals["cuda"][1], finals["cpu"][1])
              and torch.equal(finals["cuda"][2], finals["cpu"][2]),
              f"histograms or alpha tables differ between card and CPU (ring {ring_dtype})")
        out[ring_dtype or "float32"] = d
    log(f"[sharded agreement] reduced stablelm, W {W}, 4 fused sharded ticks: card vs CPU "
        f"max |dp| = {out['float32']:.3e} with an f32 ring (gate 1e-5), {out['bfloat16']:.3e} "
        f"with a bf16 ring (not gated); histograms and tables equal")
    check(out["float32"] <= 1e-5, f"card and CPU disagree by {out['float32']}")
    return out


def cnn_agreement():
    """The Fig.-1 CNN at 32x32x3, batch 16, m 16, through the exact simulator
    on the card and on the CPU, over the first 100 commits, in f64 and f32."""
    import numpy as np
    import torch

    from repro_torch.async_engine import simulate_async_sgd
    from repro_torch.experiments.async_vs_sync_cnn import cnn_batches
    from repro_torch.experiments.common import event_order
    from repro_torch.models.cnn import cnn_loss, init_cnn
    from repro_torch.tree import tree_map

    T_, m, alpha = 100, 16, 0.01
    _, order = event_order(m, T_, seed=1)
    params = init_cnn(torch.Generator().manual_seed(0), image=32, device="cpu")
    batches = cnn_batches(T_, 16, 32, "cpu")
    table = np.full(256, alpha, np.float32)
    out, secs = {}, {}
    for dtype in (torch.float64, torch.float32):
        for device in ("cuda", "cpu"):
            p = tree_map(lambda t: t.to(device, dtype), params)
            b = {"images": batches["images"].to(device, dtype), "labels": batches["labels"].to(device)}
            t0 = time.perf_counter()
            tr = simulate_async_sgd(cnn_loss, p, b, order, table, m)
            out[dtype, device] = {k: getattr(tr, k).cpu().numpy()
                                  for k in ("taus", "alphas", "losses")}
            secs[dtype, device] = time.perf_counter() - t0

    def rel(a, b):
        return np.abs(a - b) / np.abs(b).max()

    row = {}
    for dtype in (torch.float64, torch.float32):
        a, b = out[dtype, "cuda"], out[dtype, "cpu"]
        check(np.array_equal(a["taus"], b["taus"]) and np.array_equal(a["alphas"], b["alphas"]),
              f"CNN ({dtype}): taus or alphas differ between card and CPU")
        check(np.isfinite(a["losses"]).all(), f"CNN ({dtype}): non-finite loss on the card")
        row[str(dtype).split(".")[-1]] = rel(a["losses"], b["losses"])
    f64, f32 = row["float64"], row["float32"]
    check(f64.max() <= 1e-4, f"CNN f64 losses differ card vs CPU by {f64.max():.3e} relative")
    drift = rel(out[torch.float32, "cpu"]["losses"], out[torch.float64, "cpu"]["losses"])
    past = np.nonzero(drift > 1e-5)[0]
    horizon = int(past[0]) if past.size else T_
    check(horizon > 0 and f32[:horizon].max() <= 1e-4,
          f"CNN f32 losses differ card vs CPU by {f32[:horizon].max():.3e} relative within the "
          f"first {horizon} commits")
    f32_past = np.nonzero(f32 > 1e-4)[0]
    res = dict(commits=T_, alpha=alpha, f64_max_rel=float(f64.max()),
               f32_max_rel_within_horizon=float(f32[:horizon].max()), horizon=horizon,
               f32_max_rel=float(f32.max()),
               f32_first_past_1e4=int(f32_past[0]) if f32_past.size else None,
               seconds={f"{str(k[0]).split('.')[-1]}/{k[1]}": v for k, v in secs.items()},
               commits_per_s={f"{str(k[0]).split('.')[-1]}/{k[1]}": T_ / v for k, v in secs.items()})
    log(f"[cnn] Fig.-1 CNN 32x32x3, batch 16, m 16, alpha {alpha}, {T_} commits: card vs CPU "
        f"taus and alphas equal; f64 losses within {res['f64_max_rel']:.3e} relative; f32 "
        f"within {res['f32_max_rel_within_horizon']:.3e} over the first {horizon} commits (the "
        f"CPU's f32 run leaves its f64 run by 1e-5 at commit {horizon}), {res['f32_max_rel']:.3e} "
        f"over all; commits/s " + ", ".join(f"{k} {v:.1f}" for k, v in res["commits_per_s"].items()))
    return res


def cnn_experiments():
    import torch

    from repro_torch.experiments import async_vs_sync_cnn, convergence

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    conv = convergence.run(T=2500, repeats=1, workers=(16,), device="cuda")
    torch.cuda.synchronize()
    conv_s = time.perf_counter() - t0
    convergence.print_table(conv, logger=log)
    row = {k: v for k, v in conv["rows"][0].items() if k != "losses"}
    log(f"[convergence] m 16, T 2500, one repeat, 5 strategies: {conv_s:.2f} s on the card "
        f"({5 * 2500 / conv_s:.1f} commits/s)")
    ex = async_vs_sync_cnn.run(steps=600, device="cuda")
    async_vs_sync_cnn.print_report(ex, logger=log)
    example = {tag: {k: v for k, v in ex[tag].items() if k != "losses"}
               for tag in ("const", "mindthestep")}
    for tag in ("const", "mindthestep"):
        check(math.isfinite(example[tag]["final_smoothed"]), f"CNN example ({tag}): non-finite loss")
    return dict(convergence=row, convergence_s=conv_s, example=example)


# ---------------------------------------------------------------------------
# Phase 11: the live parameter server
# ---------------------------------------------------------------------------

LIVE_W = 2


class LiveLog:
    """Per-tick host line of the live run (synchronizes to time each tick:
    measurement only): loss, measured tau, the alpha table after the tick."""

    def __init__(self):
        import torch

        self._torch, self.rows, self._t = torch, [], None

    def on_start(self, ctx):
        self._torch.cuda.synchronize()
        self._t = time.perf_counter()
        self.table_ptr = ctx.state.adapt.alpha_table.data_ptr()

    def on_refresh(self, ctx):
        pass

    def on_tick(self, ctx):
        self._torch.cuda.synchronize()
        now = time.perf_counter()
        m = {k: v.item() for k, v in ctx.metrics.items()}
        row = dict(step=ctx.step, ms=(now - self._t) * 1e3, loss=m["loss"], tau=m["tau"],
                   table=ctx.state.adapt.alpha_table.clone())
        self._t = now
        self.rows.append(row)
        log(f"[live] tick {ctx.step:3d}  loss {row['loss']:.4f}  last tau {row['tau']:.0f}  "
            f"{row['ms']:.1f} ms")

    def on_end(self, ctx):
        pass


def check_stamps(taus, t_pull, t_push, what):
    """Each trace record's tau is the version at its push less the version
    at its pull.  Record k is applied at version k; the version at its pull
    is the number of applies stamped before its dispatch (one server thread
    stamps both, applies in order).  W - 1 does not bound tau: the engine
    bounds the batches in flight, and a slow worker can be lapped."""
    import numpy as np

    pulled_at = np.searchsorted(t_push, t_pull, side="left")
    want = np.arange(len(taus)) - pulled_at
    check(bool(np.all(np.diff(t_push) >= 0)), f"{what}: applies stamped out of order")
    check(bool(np.all(t_push >= t_pull)), f"{what}: a record was pushed before its pull")
    check(taus.tolist() == want.tolist(),
          f"{what}: taus {taus.tolist()}, but the stamps give {want.tolist()}")


def live_path(cfg, n_expected, trace_root):
    """Full-width stablelm-1.6b through ``run(RunSpec(mode="distributed",
    fuse=True, transport="inproc", num_workers=2))``: 8 ticks, a refresh
    every 4; counts zeroed just before and read just after."""
    import numpy as np
    import torch

    from repro_torch.async_engine.events import load_trace
    from repro_torch.distributed import server as S
    from repro_torch.kernels.adaptive_update import cuda as C
    from repro_torch.optim import transform as T
    from repro_torch.optim.fuse import flat_chain_step, plan_fusion
    from repro_torch.run import RunSpec, run

    pipe, adapt = lm_pipeline(0.01, LIVE_W, K_RING)
    trace_path = str(trace_root / "live_phase11.trace")
    spec = RunSpec(cfg=cfg, pipeline=pipe, mode="distributed", num_steps=8, batch_size=4,
                   seq_len=512, num_workers=LIVE_W, adapt=adapt, fuse=True, refresh_every=4,
                   transport="inproc", trace_path=trace_path, seed=0, device="cuda")
    hook = LiveLog()
    apply_host_ms = []
    inner = S.ParameterServer._apply

    def timed_apply(self, g_flat, tau):  # host time of one apply (the card runs it async)
        t0 = time.perf_counter()
        out = inner(self, g_flat, tau)
        apply_host_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    S.ParameterServer._apply = timed_apply
    torch.cuda.reset_peak_memory_stats()
    C.reset_launches()
    t0 = time.perf_counter()
    try:
        result = run(spec, hooks=[hook])
    finally:
        S.ParameterServer._apply = inner
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(C.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    state = result.state
    n = state.params.numel()
    applies = int(state.step)
    taus, who, t_pull, t_push = load_trace(trace_path, return_workers=True, return_times=True)
    hist = np.bincount(taus, minlength=LIVE_W).tolist()
    log(f"[live] N={n} params  W={LIVE_W}  wall {wall:.2f}s  peak memory {peak / 1e9:.2f} GB  "
        f"applies {applies}  launches {counts}")
    check(n == n_expected, f"unexpected parameter count {n}")
    check(all(math.isfinite(r["loss"]) for r in hook.rows), "non-finite loss on the live path")
    check(counts["fused_chain"] == applies == spec.num_steps,
          f"live path: {counts['fused_chain']} fused_chain launches for {applies} applies, "
          f"expected {spec.num_steps} of each")
    check(counts["fused_tick"] == counts["fused_combine"] == counts["fused_update"] == 0,
          "the live path launched a kernel other than fused_chain")
    check(len(taus) == spec.num_steps, f"{len(taus)} trace records for {spec.num_steps} applies")
    check_stamps(taus, t_pull, t_push, "live path")
    check(state.adapt.alpha_table.data_ptr() == hook.table_ptr,
          "the refresh replaced the alpha table tensor instead of writing into it")
    check(not torch.equal(hook.rows[3]["table"], hook.rows[2]["table"])
          or not torch.equal(hook.rows[7]["table"], hook.rows[6]["table"]),
          "no refresh changed the alpha table")
    check(bool(torch.isfinite(state.params).all()), "non-finite params after the live run")
    # the chain kernel at this path's buffers (the run's final p and momentum),
    # timed alone after the run; its launches above are the path's
    plan = plan_fusion(pipe)
    g = torch.full_like(state.params, 1e-6)
    ctx = T.StepContext(tau=torch.zeros((), dtype=torch.int32, device="cuda"), adapt=state.adapt)
    chain_ms = cuda_ms(lambda: flat_chain_step(plan, g, state.opt_state["bufs"], state.params,
                                               ctx))
    del g
    steady = [r["ms"] for r in hook.rows[1:]]
    gaps = np.diff(t_push) * 1e3
    summary = dict(workers=LIVE_W, ticks=spec.num_steps, applies=applies,
                   first_tick_ms=hook.rows[0]["ms"],
                   median_tick_ms=sorted(steady)[len(steady) // 2],
                   apply_host_ms_median=sorted(apply_host_ms)[len(apply_host_ms) // 2],
                   apply_interval_ms_median=float(np.median(gaps)) if len(gaps) else None,
                   fused_chain_ms=chain_ms, tau_hist=hist, taus=taus.tolist(),
                   workers_seen=sorted(set(who.tolist())), peak_gb=peak / 1e9,
                   losses=[r["loss"] for r in hook.rows], launches=counts)
    log(f"[live] losses {summary['losses']}; taus {summary['taus']} (histogram {hist}); "
        f"median tick {summary['median_tick_ms']:.1f} ms (first {summary['first_tick_ms']:.1f} "
        f"ms); server apply {summary['apply_host_ms_median']:.3f} ms host (median, enqueue), "
        f"applies every {summary['apply_interval_ms_median']:.1f} ms (median t_push gap); "
        f"fused_chain {chain_ms:.3f} ms at this path's buffers; peak {peak / 1e9:.2f} GB")
    return summary, counts


def live_serial_oracle(cfg, flat, batch_fn, steps, device):
    """The serial pull/grad/apply loop of one worker (the live W = 1 run's
    oracle): the fused pipeline at tau 0 on ``device``."""
    import dataclasses

    import torch

    from repro_torch.distributed import make_grad_fn
    from repro_torch.optim import transform as T
    from repro_torch.optim.fuse import fuse_pipeline
    from repro_torch.training import init_train_state
    from repro_torch.training.adapt import record_taus

    pipe, adapt = lm_pipeline(0.05, 1, 4)
    fused = fuse_pipeline(pipe)
    state = init_train_state(cfg, pipe, device=device, adapt=adapt.to(device),
                             params=flat.to(device, copy=True), fuse=True)
    grad_fn = make_grad_fn(cfg, device)
    for t in range(steps):
        _, g = grad_fn(state.params, batch_fn(t))
        tau = torch.zeros(1, dtype=torch.int32, device=device)
        record_taus(state.adapt, tau)
        ctx = T.StepContext(tau=tau[0], adapt=state.adapt, staleness_applied=False)
        with torch.no_grad():
            params, opt = T.run_pipeline(fused, g, state.opt_state, state.params, ctx)
        state = dataclasses.replace(state, params=params, opt_state=opt, step=state.step + 1)
    return state


def live_agreement(trace_root):
    """Reduced stablelm: a W = 1 live run on the card against the serial
    oracle on the CPU (same params, same batches), max |dp| <= 1e-5 and all
    taus 0; then W = 2 spawned socket workers on the card."""
    import torch

    from repro_torch.async_engine.events import load_trace
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import make_batch_for
    from repro_torch.kernels.adaptive_update import cuda as C
    from repro_torch.optim import transform as T
    from repro_torch.run import RunSpec, run
    from repro_torch.training import init_params

    cfg = reduced(get_config("stablelm-1.6b"))
    flat = T.pack_flat(init_params(0, cfg, "cpu"))
    steps = 4
    out = {}
    path = str(trace_root / "live_w1.trace")
    pipe, adapt = lm_pipeline(0.05, 1, 4)
    spec = RunSpec(cfg=cfg, pipeline=pipe, mode="distributed", num_steps=steps, num_workers=1,
                   batch_fn=lambda t: make_batch_for(cfg, batch=2, seq=64, seed=100 + t,
                                                     device="cuda"),
                   adapt=adapt, fuse=True, params=flat, trace_path=path, seed=0, device="cuda")
    C.reset_launches()
    card = run(spec).state
    check(C.LAUNCHES["fused_chain"] == steps, f"W=1 live run: {C.LAUNCHES['fused_chain']} "
          f"fused_chain launches for {steps} applies")
    taus = load_trace(path)
    check(taus.tolist() == [0] * steps, f"W=1 live taus {taus.tolist()}")
    cpu = live_serial_oracle(cfg, flat, lambda t: make_batch_for(cfg, batch=2, seq=64,
                                                                 seed=100 + t), steps, "cpu")
    d = (card.params.cpu() - cpu.params).abs().max().item()
    out["w1_card_vs_cpu_max_dp"] = d
    log(f"[live agreement] reduced stablelm, W=1 live on the card vs the serial CPU oracle, "
        f"{steps} applies: max |dp| = {d:.3e} (gate 1e-5); taus {taus.tolist()}")
    check(d <= 1e-5, f"card and CPU disagree by {d}")
    check(torch.equal(card.adapt.hist.cpu(), cpu.adapt.hist), "histograms differ")

    path = str(trace_root / "live_socket.trace")
    pipe, adapt = lm_pipeline(0.05, 2, 4)
    spec = RunSpec(cfg=cfg, pipeline=pipe, mode="distributed", num_steps=6, num_workers=2,
                   batch_size=2, seq_len=64, adapt=adapt, fuse=True, params=flat,
                   transport="socket", trace_path=path, seed=0, device="cuda")
    C.reset_launches()
    t0 = time.perf_counter()
    res = run(spec)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    applies = int(res.state.step)
    taus, who, t_pull, t_push = load_trace(path, return_workers=True, return_times=True)
    log(f"[live socket] reduced stablelm, W=2 spawned workers on the card: {applies} applies, "
        f"{C.LAUNCHES['fused_chain']} fused_chain launches, taus {taus.tolist()}, workers "
        f"{who.tolist()}, {secs:.2f} s")
    check(applies == spec.num_steps == C.LAUNCHES["fused_chain"],
          f"socket run: {applies} applies, {C.LAUNCHES['fused_chain']} fused_chain launches")
    check(len(taus) == applies, f"socket run: {len(taus)} trace records for {applies} applies")
    check_stamps(taus, t_pull, t_push, "socket run")
    check(bool(torch.isfinite(res.state.params).all()), "non-finite params after the socket run")
    out.update(socket_applies=applies, socket_taus=taus.tolist(), socket_s=secs)
    return out


# ---------------------------------------------------------------------------
# Phase 12: the planner against the card
# ---------------------------------------------------------------------------

def plan_against_card(full, main, qwen_row, sharded):
    """Plan the three configurations the card ran (phases 3, 6 and 9) with
    ``repro_torch.launch.dryrun`` on shape-only tensors; gate: the planned
    state bytes on one card equal the bytes of the state that phase built
    on the card.  Printed beside it: the allocator's bytes, the planned
    peak against the measured one and the planned FLOPs against 6 N D
    (training) or 2 N D (prefill)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D

    t0 = time.perf_counter()
    qwen = get_config("qwen2-moe-a2.7b")
    plans = {
        "main (phase 3)": (D.plan_run(main_spec(full, device="cpu")), main, 6 * 4 * 512),
        "serve qwen2-moe-a2.7b (phase 6)": (
            D.plan_serve(qwen, batch=4, prompt=512, gen=32), qwen_row, 2 * 4 * 512),
        "sharded (phase 9)": (D.plan_run(sharded_spec(full, device="cpu")), sharded, 6 * 4 * 512),
    }
    rows = {}
    for name, (rec, measured, nd) in plans.items():
        planned, held = rec["memory"]["argument_bytes"], measured["state_bytes"]
        n_active = rec["active_params"]
        row = dict(planned_state_bytes=planned, card_state_bytes=held,
                   allocated_bytes=measured.get("allocated_bytes"),
                   planned_peak_gb=rec["memory"]["peak_bytes"] / 1e9,
                   measured_peak_gb=measured["peak_gb"], planned_flops=rec["cost"]["flops"],
                   model_flops=nd * n_active, planned_hbm_bytes_upper=rec["cost"]["hbm_bytes"],
                   roofline=rec["roofline"], plan_s=rec["plan_s"])
        rows[name] = row
        alloc = "n/a" if row["allocated_bytes"] is None else f"{row['allocated_bytes'] / 1e9:.3f}"
        log(f"[plan] {name}: planned state {planned / 1e9:.6f} GB, the card's "
            f"{held / 1e9:.6f} GB ({'equal' if planned == held else 'DIFFER'}); allocated "
            f"{alloc} GB; planned peak {row['planned_peak_gb']:.2f} GB, measured "
            f"{row['measured_peak_gb']:.2f} GB; planned {row['planned_flops']:.4e} FLOPs against "
            f"{'6' if nd == 6 * 4 * 512 else '2'} N D = {row['model_flops']:.4e} "
            f"({row['planned_flops'] / row['model_flops']:.3f}x); dominant "
            f"{rec['roofline']['dominant']}; planned in {rec['plan_s']:.1f} s")
        check(planned == held, f"{name}: planned state bytes {planned} != the card's {held}")
    log(f"[plan] phase 12 took {time.perf_counter() - t0:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# Phase 13: expert parallelism on the card
# ---------------------------------------------------------------------------

EP_LAYERS, EP_PROMPT, EP_GEN = 4, 512, 8
EP_TIMEOUT_S = 300  # a rank, or a collective, that takes longer fails the phase
# The weights-stationary MoE trained on the block's 4 ranks: depth 2 (N =
# 1,832,663,040; params, momentum, f32 ring and gradient about 36.7 GB over
# the 4 ranks: depth 4 would not leave room for 4 CUDA contexts and the
# gathered layers), W = K = 2, 3 ticks; and depth 1 for one tick against
# one process.
WS_LAYERS, WS_AGREE_LAYERS, WS_TICKS, WS_WK = 2, 1, 3, 2


def ep_config(**upd):
    """Full-width qwen2-moe-a2.7b at depth 4, in f32 (the one-process and
    the sharded run sum the experts in other orders, which bf16 would round
    differently), on the kernels (flash at H 128)."""
    from repro_torch.configs import get_config

    cfg = get_config("qwen2-moe-a2.7b")
    return dataclasses.replace(cfg, num_layers=EP_LAYERS, activation_dtype="float32",
                               use_pallas=True, **upd)


def ws_spec(layers, device="cuda", **upd):
    """Full-width qwen2-moe-a2.7b, weights-stationary, at ``layers`` layers,
    f32 activations without remat (the one process and the ranks sum the
    experts in other orders, which bf16 would round apart), async fused
    momentum, W = K = 2 with an f32 ring, batch 4 x 512, ``WS_TICKS`` ticks
    and a refresh every 2."""
    from repro_torch.configs import get_config
    from repro_torch.run import RunSpec

    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"), num_layers=layers,
                              activation_dtype="float32", remat=False,
                              moe_weights_stationary=True)
    pipe, adapt = lm_pipeline(0.01, WS_WK, WS_WK)
    spec = RunSpec(cfg=cfg, pipeline=pipe, mode="async", num_steps=WS_TICKS, batch_size=4,
                   seq_len=EP_PROMPT, num_workers=WS_WK, ring=WS_WK, adapt=adapt, fuse=True,
                   refresh_every=2, seed=0, device=device)
    return dataclasses.replace(spec, **upd)


def ws_one_process():
    """One process's tick of :func:`ws_spec` at ``WS_AGREE_LAYERS`` layers
    -> (its loss, the max |p| after it, each of the 4 ranks' blocks of the
    params after it, as host arrays)."""
    from repro_torch.run import run

    spec = ws_spec(WS_AGREE_LAYERS, num_steps=1)
    hook = TickLog("ws one process")
    params = run(spec, hooks=[hook]).state.params.cpu()
    free_cuda()
    return hook.rows[0]["loss"], float(params.abs().max()), rank_blocks(params, spec.cfg, (2, 2))


def rank_blocks(flat, cfg, shape) -> list:
    """Each rank's flat blocks (``specs.localize``, the FSDP storage) of one
    process's flat ``(N,)`` host buffer, as host arrays, for the ``shape``
    (data, model) layout."""
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import transform as T
    from repro_torch.sharding.specs import localize
    from repro_torch.training.steps import param_view

    flat = torch.as_tensor(flat)
    grid = make_mesh(shape, ("data", "model"), device="meta")
    return [T.pack_flat(localize(param_view(flat, cfg), cfg, grid.at(r))).numpy()
            for r in range(math.prod(shape))]


def serve_with_routes(cfg, params, batch):
    """``launch.serve.serve`` with every router call's top-k ids kept."""
    from repro_torch.launch.serve import serve
    from repro_torch.models import moe as MOE

    routes, inner = [], MOE.route

    def keep(*args):
        out = inner(*args)
        routes.append(out[2])
        return out

    MOE.route = keep
    try:
        res = serve(cfg, params, batch, gen=EP_GEN)
    finally:
        MOE.route = inner
    return res, routes


def serve_warm_up(cfg, params, batch):
    """One untimed prefill and decode step (the process's first GEMMs,
    kernel loads and allocations), so the timed serve is warm."""
    from repro_torch.launch.serve import serve

    serve(cfg, params, batch, gen=1)


def ep_rank(rank, world, data, model, what, store, out_dir, given=None):
    """One rank of phase 13 (a spawned process): gloo over the one card.
    ``given`` (the block's ranks): this rank's blocks of one process's
    params after the weights-stationary depth-1 tick."""
    import datetime

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist

    import repro_torch  # noqa: F401  (sets TF32 off)
    from repro_torch.kernels.flash_attention import cuda as FA
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as MOE
    from repro_torch.sharding import use_sharding_rules

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=EP_TIMEOUT_S))
    mesh = make_mesh((data, model), ("data", "model"), device="cuda")
    torch.cuda.set_device(mesh.device)
    out = {}
    if what == "serve":
        from repro_torch.data import make_batch_for
        from repro_torch.training import init_params

        cfg = ep_config()
        with use_sharding_rules(mesh):
            # the rank's blocks: its experts, query / kv heads, shared-expert
            # d_ff and vocab (drawn whole from the seed, sliced, freed)
            params = init_params(0, cfg, mesh.device)
        pos0 = params["stack"]["pos0"]
        free_cuda()
        batch = make_batch_for(cfg, batch=4, seq=EP_PROMPT, seed=0, device=mesh.device)
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad(), use_sharding_rules(mesh):
            serve_warm_up(cfg, params, batch)
            MOE.reset_collective_bytes()
            FA.reset_launches()
            dist.barrier()
            res, routes = serve_with_routes(cfg, params, batch)
        torch.cuda.synchronize()
        out.update(prefill_logits=res["prefill_logits"].cpu().numpy(),
                   logits=res["logits"].cpu().numpy(), tokens=res["tokens"].cpu().numpy(),
                   routes=np.stack([r.cpu().numpy() for r in routes[:EP_LAYERS]]),
                   decode_routes=np.stack([r.cpu().numpy() for r in routes[EP_LAYERS:]]),
                   prefill_s=res["prefill_s"], decode_s=res["decode_s"],
                   flash=FA.LAUNCHES["flash_attention"],
                   expert_shape=np.array(pos0["moe"]["w_up_e"].shape),
                   head_shape=np.array(pos0["attn"]["wq"].shape),
                   shared_shape=np.array(pos0["moe"]["shared"]["w_up"].shape))
    else:
        cfg = ep_config(moe_weights_stationary=True)
        p, x = ep_block_inputs(cfg, mesh.device)
        p = MOE.local_expert_params(p, cfg, mesh)
        free_cuda()
        torch.cuda.reset_peak_memory_stats()
        MOE.reset_collective_bytes()
        d = mesh.index("data")
        for S in (1, EP_PROMPT):
            rows = x[S].shape[0] // data
            xl = x[S][d * rows:(d + 1) * rows]
            with torch.no_grad(), use_sharding_rules(mesh):
                MOE.apply_moe(p, xl, cfg)  # warm-up
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                o, a = MOE.apply_moe(p, xl, cfg)
                torch.cuda.synchronize()
                out[f"ms_{S}"] = (time.perf_counter() - t0) * 1e3
            out[f"out_{S}"], out[f"aux_{S}"] = o.cpu().numpy(), float(a)
        out["expert_shape"] = np.array(p["w_up_e"].shape)
        out.update(peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   collective_bytes=json.dumps(counted_bytes()))
        del p, x
        # the weights-stationary MoE trained over data: depth 2, then depth
        # 1 for one tick against one process
        state = train_rank(ws_spec(WS_LAYERS), "ws", out, mesh, f"ws train rank {rank}",
                           replay=False)
        del state
        state = train_rank(ws_spec(WS_AGREE_LAYERS, num_steps=1), "wsa", out, mesh,
                           f"ws agree rank {rank}", replay=False)
        want = torch.from_numpy(given).to(state.params.device)
        out["wsa_params_max_abs"] = float((state.params - want).abs().max())
        del state, want
    out.setdefault("peak_gb", torch.cuda.max_memory_allocated() / 1e9)
    out.setdefault("collective_bytes", json.dumps(counted_bytes()))
    out.update(data=mesh.index("data"), model=mesh.index("model"))
    np.savez(f"{out_dir}/{what}_{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


def counted_bytes() -> dict:
    """The byte counter's non-zero entries: the bytes this process handed to
    all-reduce, by purpose (``repro_torch.sharding.collectives``)."""
    from repro_torch.sharding.collectives import COLLECTIVE_BYTES

    return {k: v for k, v in COLLECTIVE_BYTES.items() if v}


def bytes_by_key(saved) -> dict:
    """A rank's :func:`counted_bytes`, as it saved them (a JSON string)."""
    return json.loads(str(saved))


def serve_plan(cfg, batch, prompt, gen, shape, **options) -> dict:
    """The all-reduce bytes a rank of the ``shape`` (data, model) layout
    hands over in one serve (a prefill and ``gen`` greedy steps), by
    purpose: ``launch.analysis.port_collective_bytes``, planned under the
    ``SPEC_OPTIONS`` given in ``options`` (set for the call alone: call it
    while no plan runs on a thread)."""
    from repro_torch.launch.analysis import port_collective_bytes
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(shape, ("data", "model"), device="meta")
    capacity = (cfg.num_prefix_embeddings if cfg.frontend == "vision" else 0) + prompt + gen
    with spec_options(**options):
        pre = port_collective_bytes(cfg, "prefill", batch, prompt, mesh)["counted"]
        dec = port_collective_bytes(cfg, "decode", batch, prompt, mesh,
                                    capacity=capacity)["counted"]
    out = {k: pre[k] + gen * dec[k] for k in pre}
    return {k: v for k, v in out.items() if v}


@contextlib.contextmanager
def spec_options(**options):
    """``repro_torch.sharding.specs.SPEC_OPTIONS`` set to ``options`` inside,
    restored after (in a spawned rank: before it builds anything the
    options lay out)."""
    from repro_torch.sharding.specs import SPEC_OPTIONS

    old = dict(SPEC_OPTIONS)
    SPEC_OPTIONS.update(options)
    try:
        yield
    finally:
        SPEC_OPTIONS.update(old)


def train_plan(cfg, batch, seq, ticks, shape) -> dict:
    """The all-reduce bytes a rank of the ``shape`` layout hands over in
    ``ticks`` training ticks, by purpose."""
    from repro_torch.launch.analysis import port_collective_bytes
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(shape, ("data", "model"), device="meta")
    one = port_collective_bytes(cfg, "train", batch, seq, mesh)["counted"]
    return {k: ticks * v for k, v in one.items() if v}


def ep_block_inputs(cfg, device):
    """One full-width MoE block's params (all 64 experts) and x at the
    decode shape (4, 1, D) and at (4, 512, D), from seeds."""
    import torch

    from repro_torch.models import moe as MOE

    gen = torch.Generator(device=device).manual_seed(1)
    p = MOE.init_moe(gen, cfg, device)
    x = {S: torch.randn((4, S, cfg.d_model), generator=gen, device=device) for S in (1, EP_PROMPT)}
    return p, x


def alongside(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` started on a thread of its own (a plan: host
    work on ``meta`` tensors; or phase 16 (b)'s groups of ranks), so that it
    runs while spawned ranks do; the future's ``result()`` waits for it and
    raises what it raised.  The caller reads a plan right after the ranks
    have ended, before it touches anything a plan patches (the kernel
    wrappers)."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=1)
    try:
        return pool.submit(fn, *args, **kwargs)
    finally:
        pool.shutdown(wait=False)


def run_ranks(world, data, model, what, out_dir, target=None, timeout_s=EP_TIMEOUT_S,
              given=None):
    """Spawn ``world`` ranks of ``target`` (default :func:`ep_rank`) and wait
    for them; a rank that fails, or the group past ``timeout_s``, fails the
    phase (every rank is stopped).  ``given[r]`` (host arrays: one
    process's results cut to rank r's blocks) is handed to rank r as its
    last argument, through the pipe that starts it (no file)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    store = out_dir / f"store_{what}"
    procs = [ctx.Process(target=target or ep_rank,
                         args=(r, world, data, model, what, str(store), str(out_dir))
                         + (() if given is None else (given[r],)), daemon=True)
             for r in range(world)]
    t0 = time.perf_counter()
    for pr in procs:
        pr.start()
    try:
        for pr in procs:
            pr.join(max(1.0, timeout_s - (time.perf_counter() - t0)))
        alive = [i for i, pr in enumerate(procs) if pr.is_alive()]
        check(not alive, f"{what}: ranks {alive} still running after {timeout_s} s")
        codes = [pr.exitcode for pr in procs]
        check(all(c == 0 for c in codes), f"{what}: ranks exited with {codes}")
    finally:
        for pr in procs:
            if pr.is_alive():
                pr.kill()
                pr.join(10)
    return time.perf_counter() - t0


def expert_parallel(root):
    """Phase 13 (module docstring): the expert-parallel serve on 2 ranks and
    the weights-stationary block on 4, each against one process."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.data import make_batch_for
    from repro_torch.kernels.flash_attention import cuda as FA
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as MOE
    from repro_torch.training import init_params

    t_phase = time.perf_counter()
    out_dir = root / "build" / "expert_parallel"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    # one process: the same model, params and prompts
    cfg = ep_config()
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(0, cfg, "cuda")
    batch = make_batch_for(cfg, batch=4, seq=EP_PROMPT, seed=0, device="cuda")
    serve_warm_up(cfg, params, batch)
    FA.reset_launches()
    ref, ref_routes = serve_with_routes(cfg, params, batch)
    ref_flash = FA.LAUNCHES["flash_attention"]
    one = dict(prefill_s=ref["prefill_s"], decode_ms_per_step=ref["decode_s"] / EP_GEN * 1e3,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9, flash=ref_flash)
    ref = {k: (v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in ref.items()}
    ref_routes = [r.cpu() for r in ref_routes]
    del params, batch
    free_cuda()

    wall = run_ranks(2, 1, 2, "serve", out_dir)
    ranks = [dict(np.load(out_dir / f"serve_{r}.npz")) for r in range(2)]
    for r in ranks[1:]:
        for k in ("tokens", "routes", "decode_routes"):
            check(np.array_equal(r[k], ranks[0][k]), f"expert-parallel ranks disagree on {k}")
    got = ranks[0]
    # each rank's logits are its vocab block: held to that slice of one process's
    want_pre, want = ref["prefill_logits"].numpy(), ref["logits"].numpy()
    d_pre = d_dec = 0.0
    for r in ranks:
        v = r["logits"].shape[-1]
        sl = slice(int(r["model"]) * v, (int(r["model"]) + 1) * v)
        d_pre = max(d_pre, float(np.max(np.abs(r["prefill_logits"] - want_pre[..., sl])
                                        / (1e-4 + 1e-4 * np.abs(want_pre[..., sl])))))
        d_dec = max(d_dec, float(np.max(np.abs(r["logits"] - want[..., sl])
                                        / (1e-4 + 1e-4 * np.abs(want[..., sl])))))
    plan = serve_plan(ep_config(), 4, EP_PROMPT, EP_GEN, (1, 2))
    routes_equal = (np.array_equal(got["routes"], np.stack([r.numpy() for r in ref_routes[:EP_LAYERS]]))
                    and np.array_equal(got["decode_routes"],
                                       np.stack([r.numpy() for r in ref_routes[EP_LAYERS:]])))
    ids_equal = np.array_equal(got["tokens"], ref["tokens"].numpy())
    serve_row = dict(
        layers=EP_LAYERS, batch=4, prompt=EP_PROMPT, gen=EP_GEN, experts_per_rank=int(
            got["expert_shape"][1]), one_process=one,
        two_ranks=dict(prefill_s=[float(r["prefill_s"]) for r in ranks],
                       decode_ms_per_step=[float(r["decode_s"]) / EP_GEN * 1e3 for r in ranks],
                       peak_gb=[float(r["peak_gb"]) for r in ranks],
                       collective_bytes=[bytes_by_key(r["collective_bytes"]) for r in ranks],
                       planned_bytes=plan, flash=[int(r["flash"]) for r in ranks],
                       head_shape=got["head_shape"].tolist(),
                       shared_shape=got["shared_shape"].tolist(), wall_s=wall),
        logits_err_over_bound=max(d_pre, d_dec), ids_equal=ids_equal, routes_equal=routes_equal)
    log(f"[ep] serve {json.dumps(serve_row)}")
    check(max(d_pre, d_dec) <= 1.0, f"expert-parallel logits miss 1e-4 + 1e-4|ref| "
          f"({max(d_pre, d_dec):.3f} of the bound)")
    check(ids_equal, "expert-parallel greedy ids differ from one process")
    check(routes_equal, "expert-parallel routes differ from one process")
    check(one["flash"] == EP_LAYERS and all(int(r["flash"]) == EP_LAYERS for r in ranks),
          f"flash launches: one process {one['flash']}, ranks {[int(r['flash']) for r in ranks]}")
    check(int(got["expert_shape"][1]) == 32, f"a rank holds {got['expert_shape']} experts")
    check(int(got["head_shape"][-2]) == 8 and int(got["shared_shape"][-1]) == 5632 // 2,
          f"a rank holds heads {got['head_shape']} and shared expert {got['shared_shape']}")
    for r in ranks:
        check(bytes_by_key(r["collective_bytes"]) == plan,
              f"expert-parallel serve: all-reduce bytes {bytes_by_key(r['collective_bytes'])} "
              f"!= the plan {plan}")

    # weights-stationary block, data 2 x model 2, against one process
    wcfg = ep_config(moe_weights_stationary=True)
    p, x = ep_block_inputs(wcfg, "cuda")
    block = {}
    with torch.no_grad():
        for S in (1, EP_PROMPT):
            MOE.apply_moe(p, x[S], wcfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o, a = MOE.apply_moe(p, x[S], wcfg)
            torch.cuda.synchronize()
            block[S] = (o.cpu().numpy(), float(a), (time.perf_counter() - t0) * 1e3)
    del p, x
    free_cuda()
    # one process: the weights-stationary training's depth-1 tick; then the
    # plans (on a thread beside the ranks: no kernel runs here meanwhile)
    t0 = time.perf_counter()
    ws_loss, ws_max_p, ws_blocks = ws_one_process()
    t_ws_one = time.perf_counter() - t0
    wspec = ws_spec(WS_LAYERS, device="cpu")
    grid = make_mesh((2, 2), ("data", "model"), device="meta")
    planning = alongside(D.plan_run, wspec, mesh=grid)
    plan_ws = train_plan(wspec.cfg, 4, EP_PROMPT, WS_TICKS, (2, 2))
    plan_wsa = train_plan(ws_spec(WS_AGREE_LAYERS).cfg, 4, EP_PROMPT, 1, (2, 2))
    wall = run_ranks(4, 2, 2, "block", out_dir, given=ws_blocks)
    planned_ws = planning.result()
    del ws_blocks
    ranks = [dict(np.load(out_dir / f"block_{r}.npz")) for r in range(4)]
    ws_row = dict(one_process_ms={S: block[S][2] for S in block}, wall_s=wall,
                  ms={S: [float(r[f"ms_{S}"]) for r in ranks] for S in block},
                  peak_gb=[float(r["peak_gb"]) for r in ranks],
                  collective_bytes=[bytes_by_key(r["collective_bytes"]) for r in ranks],
                  expert_shape=ranks[0]["expert_shape"].tolist())
    for S, (want_o, want_a, _) in block.items():
        rows = want_o.shape[0] // 2
        d_out = max(float(np.max(np.abs(r[f"out_{S}"] - want_o[int(r["data"]) * rows:
                                                          (int(r["data"]) + 1) * rows])))
                    for r in ranks)
        d_aux = max(abs(float(r[f"aux_{S}"]) - want_a) for r in ranks)
        ws_row[f"max_abs_dout_{S}"], ws_row[f"max_abs_daux_{S}"] = d_out, d_aux
        check(d_out <= 3e-4 and d_aux <= 3e-4,
              f"weights-stationary block at S {S}: out {d_out:.3e}, aux {d_aux:.3e} past 3e-4")
    log(f"[ep] weights-stationary block {json.dumps(ws_row)}")

    # the weights-stationary MoE trained over data, full width
    for r in ranks:
        for tag, ticks, plan in (("ws", WS_TICKS, plan_ws), ("wsa", 1, plan_wsa)):
            launches = json.loads(str(r[f"{tag}_launches"]))
            check(launches["fused_tick"] == ticks and launches["fused_chain"] ==
                  launches["fused_combine"] == launches["fused_update"] == 0,
                  f"ws training ({tag}): launches {launches}, expected {ticks} fused_tick alone")
            check(bool(np.isfinite(r[f"{tag}_losses"]).all()),
                  f"ws training ({tag}): a non-finite loss")
            check(bytes_by_key(r[f"{tag}_bytes"]) == plan,
                  f"ws training ({tag}): collective bytes {bytes_by_key(r[f'{tag}_bytes'])} != "
                  f"the plan {plan}")
        check(int(r["ws_state_bytes"]) == planned_ws["memory"]["argument_bytes"],
              f"ws training: state bytes {int(r['ws_state_bytes'])} != the plan's "
              f"{planned_ws['memory']['argument_bytes']}")
        for k in ("ws_losses", "ws_tables", "ws_hists"):
            check(np.array_equal(r[k], ranks[0][k]), f"ws training: ranks disagree on {k}")
    d_loss = max(abs(float(r["wsa_losses"][0]) - ws_loss) / abs(ws_loss) for r in ranks)
    d_params = max(float(r["wsa_params_max_abs"]) for r in ranks) / ws_max_p
    train_row = dict(
        layout="data 2 x model 2, weights-stationary", layers=WS_LAYERS, ticks=WS_TICKS,
        n_local=[int(r["ws_n_local"]) for r in ranks],
        state_bytes=[int(r["ws_state_bytes"]) for r in ranks],
        planned_state_bytes=planned_ws["memory"]["argument_bytes"],
        median_tick_s=[float(r["ws_median_ms"]) / 1e3 for r in ranks],
        peak_gb=[float(r["ws_peak_gb"]) for r in ranks],
        fused_tick=[json.loads(str(r["ws_launches"]))["fused_tick"] for r in ranks],
        losses=ranks[0]["ws_losses"].tolist(), collective_bytes=bytes_by_key(ranks[0]["ws_bytes"]),
        agree=dict(layers=WS_AGREE_LAYERS, loss_rel=d_loss, params_over_max=d_params,
                   one_process_loss=ws_loss, one_process_s=t_ws_one), wall_s=wall)
    log(f"[ep] weights-stationary training {json.dumps(train_row)}")
    check(d_loss <= 1e-6, f"ws training: loss {d_loss:.3e} relative to one process past 1e-6")
    check(d_params <= 1e-5, f"ws training: params {d_params:.3e} of max |p| past 1e-5")
    shutil.rmtree(out_dir, ignore_errors=True)
    log(f"[ep] phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return {"serve": serve_row, "weights_stationary": ws_row, "ws_training": train_row}


# ---------------------------------------------------------------------------
# Phase 14: dense tensor parallelism on the card
# ---------------------------------------------------------------------------

TP_TIMEOUT_S = 300  # a rank, or a collective, that takes longer fails the phase
TP_TICKS, TP_AGREE_TICKS, TP_DXM_TICKS = 4, 3, 3
TP_AGREE_LAYERS, TP_DXM_LAYERS, TP_GEN = 2, 2, 8
# the sequence-parallel memory probe: one gradient of batch 1 x 4096 at 4
# layers, in the config's own activation dtype
SP_MEM_LAYERS, SP_MEM_SEQ = 4, 4096


def tp_train_spec(cfg, device="cuda", **upd):
    """Phase 3's run (momentum, W = K = 8, bf16 ring, batch 4 x seq 512) for
    ``TP_TICKS`` ticks and a refresh every 2."""
    return dataclasses.replace(main_spec(cfg, device),
                               **{"num_steps": TP_TICKS, "refresh_every": 2, **upd})


def tp_agree_config(full):
    """Full width at depth 2, f32 activations, no remat: the one-process and
    the sharded run sum in other orders, which bf16 would round apart."""
    return dataclasses.replace(full, num_layers=TP_AGREE_LAYERS, activation_dtype="float32",
                               remat=False)


def tp_agree_spec(cfg, draws, device="cuda"):
    """``TP_AGREE_TICKS`` fused async ticks with an f32 ring and the uniforms
    handed in."""
    import torch

    it = iter(draws)
    return dataclasses.replace(
        main_spec(cfg, device), num_steps=TP_AGREE_TICKS, refresh_every=2, ring_dtype=None,
        tau_source=lambda: torch.from_numpy(next(it)))


def tp_serve_config(full):
    """Full-width stablelm-1.6b in f32 activations on the kernels (flash at
    H 64 on 32 / model heads)."""
    return dataclasses.replace(full, activation_dtype="float32", use_pallas=True)


def sp_memory(full, mesh) -> dict:
    """One rank's gradient of one batch of 1 x ``SP_MEM_SEQ`` tokens at
    ``SP_MEM_LAYERS`` layers of ``full``, without and with sequence
    parallelism, each without and with remat -> {tag: the peak allocated
    above the params (GB; the activations and the flat gradient), seconds,
    loss}."""
    import torch

    from repro_torch.data import make_batch_for
    from repro_torch.models import model as M
    from repro_torch.optim import transform as T
    from repro_torch.sharding import use_sharding_rules
    from repro_torch.training import init_params
    from repro_torch.training.steps import param_view

    rows = {}
    for remat in (False, True):
        for sp in (False, True):
            cfg = dataclasses.replace(full, num_layers=SP_MEM_LAYERS, remat=remat,
                                      sequence_parallel=sp)
            batch = {k: v.to(mesh.device)
                     for k, v in make_batch_for(cfg, batch=1, seq=SP_MEM_SEQ, seed=0).items()}
            with use_sharding_rules(mesh):
                leaf = T.pack_flat(init_params(0, cfg, mesh.device)).requires_grad_()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                loss, _ = M.loss_fn(param_view(leaf, cfg), batch, cfg)
                (g,) = torch.autograd.grad(loss, leaf)
                torch.cuda.synchronize()
                rows[f"remat={remat},sp={sp}"] = dict(
                    peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9,
                    s=time.perf_counter() - t0, loss=loss.item())
            del leaf, g, loss, batch
            free_cuda()
    return rows


def tp_gradient(cfg, device, mesh=None):
    """(loss, flat gradient) of the first batch of the run's stream at the
    params drawn from seed 0 (the rank's blocks under the rules)."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.optim import transform as T
    from repro_torch.training import init_params
    from repro_torch.training.steps import param_view

    spec = main_spec(cfg, device)
    batch = next(spec.batch_stream())
    flat = T.pack_flat(init_params(0, cfg, device))
    leaf = flat.requires_grad_()
    if mesh is not None:
        from repro_torch.sharding import collectives as COL

        batch = COL.local_rows(batch, mesh)
    loss, _ = M.loss_fn(param_view(leaf, cfg), batch, cfg)
    (g,) = torch.autograd.grad(loss, leaf)
    return loss.detach(), g


def digest(t) -> str:
    """SHA-256 of a tensor's bytes (its bits: replicas compared exactly)."""
    import hashlib

    import torch

    return hashlib.sha256(t.detach().contiguous().view(torch.uint8).cpu().numpy()).hexdigest()


def replicated_digest(t, cfg, mesh) -> str:
    """:func:`digest` of the parts of a rank's flat buffer ``t`` (..., N_local)
    that hold the leaves the storage layout keeps whole over ``data``: what
    every data replica holds the same."""
    import torch

    from repro_torch.sharding import collectives as COL

    runs = COL.data_layout(cfg, mesh).whole_runs()
    return digest(torch.cat([t[..., a:a + n] for a, n in runs], dim=-1))


def seeded_serve(cfg, prompt, gen, device, mesh=None):
    """Params from seed 0 (under the rules, the rank's blocks) and 4 prompts
    of ``prompt`` tokens, then :func:`counted_serve`; the peak counts from
    before the params."""
    import torch

    from repro_torch.data import make_batch_for
    from repro_torch.training import init_params

    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        params = init_params(0, cfg, device)
        free_cuda()
        batch = make_batch_for(cfg, batch=4, seq=prompt, seed=0, device=device)
        out = counted_serve(cfg, params, batch, gen, mesh)
        del params, batch
    free_cuda()
    return out


def counted_serve(cfg, params, batch, gen, mesh=None) -> dict:
    """A warm serve of ``batch`` (``launch/serve.py::serve``), the kernels'
    launches and the collective bytes counted from zero just before it
    (after a barrier, with ``mesh``) and read just after: its logits, ids,
    times, launches, bytes, the peak so far and its decode cache's leaves
    (each one's shape and bytes: the cache the prefill, or whisper's
    ``init_decode_state``, built)."""
    import torch

    from repro_torch.kernels.flash_attention import cuda as FA
    from repro_torch.kernels.rg_lru import cuda as RG
    from repro_torch.kernels.selective_scan import cuda as SS
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M
    from repro_torch.sharding import collectives as COL
    from repro_torch.sharding.specs import leaf_paths

    serve_warm_up(cfg, params, batch)
    for k in (FA, RG, SS):
        k.reset_launches()
    COL.reset_collective_bytes()
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier()
    kept, inner = [], (M.prefill, M.init_decode_state)

    def prefill(*args, **kwargs):
        logits, cache = inner[0](*args, **kwargs)
        kept.append(cache)
        return logits, cache

    def init_decode_state(*args, **kwargs):
        kept.append(inner[1](*args, **kwargs))
        return kept[-1]

    M.prefill, M.init_decode_state = prefill, init_decode_state
    try:
        res = serve(cfg, params, batch, gen=gen)
    finally:
        M.prefill, M.init_decode_state = inner
    torch.cuda.synchronize()
    leaves = leaf_paths(kept.pop())
    launches = {"flash_attention": FA.LAUNCHES["flash_attention"], "rg_lru": RG.LAUNCHES["rg_lru"],
                "selective_scan": SS.LAUNCHES["selective_scan"]}
    out = dict(logits=res["logits"].cpu().numpy(), tokens=res["tokens"].cpu().numpy(),
               prefill_s=res["prefill_s"], decode_ms_per_step=res["decode_s"] / gen * 1e3,
               launches=launches, bytes=counted_bytes(),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               cache_shapes={p: list(t.shape) for p, t in leaves},
               cache_bytes={p: t.numel() * t.element_size() for p, t in leaves})
    if res["prefill_logits"] is not None:  # whisper runs no decoder prefill
        out["prefill"] = res["prefill_logits"].cpu().numpy()
    del res, leaves
    return out


def saved(got: dict) -> dict:
    """A :func:`seeded_serve` result as a rank saves it (dicts as JSON)."""
    return {k: json.dumps(v) if isinstance(v, dict) else v for k, v in got.items()}


def train_rank(spec, tag, out, mesh, name, replay=True):
    """``run(spec)`` on this rank under the rules, counts zeroed just before
    (after a barrier) and read just after; its ticks, launches, all-reduce
    bytes, tables, peak and state bytes go into ``out`` under ``tag``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.kernels.adaptive_update import cuda as C
    from repro_torch.run import run
    from repro_torch.sharding import collectives as COL
    from repro_torch.sharding import use_sharding_rules

    hook = TickLog(name, replay=replay)
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    C.reset_launches()
    COL.reset_collective_bytes()
    dist.barrier()
    with use_sharding_rules(mesh):
        result = run(spec, hooks=[hook])
    torch.cuda.synchronize()
    state = result.state
    steady = [r["ms"] for r in hook.rows[1:]]
    out.update({
        f"{tag}_launches": json.dumps(dict(C.LAUNCHES)),
        f"{tag}_bytes": json.dumps(counted_bytes()),
        f"{tag}_losses": np.array([r["loss"] for r in hook.rows]),
        f"{tag}_tables": torch.stack([r["table"] for r in hook.rows]).cpu().numpy(),
        f"{tag}_cdfs": torch.stack([r["cdf"] for r in hook.rows]).cpu().numpy(),
        f"{tag}_hists": torch.stack([r["hist"] for r in hook.rows]).cpu().numpy(),
        f"{tag}_median_ms": sorted(steady)[len(steady) // 2] if steady else hook.rows[0]["ms"],
        f"{tag}_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        f"{tag}_state_bytes": state_bytes(state),
        f"{tag}_n_local": state.params.numel(),
        f"{tag}_table_in_place": state.adapt.alpha_table.data_ptr() == hook.table_ptr,
    })
    if replay:
        out[f"{tag}_taus"] = np.array([r["taus"] for r in hook.rows])
    return state


def tp_rank(rank, world, data, model, what, store, out_dir, given=None):
    """One rank of phase 14 (a spawned process): gloo over the one card.
    ``what`` is ``"tp"`` (data 1 x model 2: the full-width training, the
    depth-2 agreement without and with sequence parallelism, the serve, the
    depth-2 serve without and with it and the sequence-parallel memory
    probe, in turn) or ``"dxm"`` (data 2 x model 2: depth 2 training).
    ``given`` (``"tp"``): this rank's blocks of one process's depth-2
    gradient and of its params after the agreement ticks, which both
    agreements are held to here."""
    import datetime

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist

    import repro_torch  # noqa: F401  (sets TF32 off)
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import use_sharding_rules

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    mesh = make_mesh((data, model), ("data", "model"), device="cuda")
    torch.cuda.set_device(mesh.device)
    full = get_config("stablelm-1.6b")
    out = {"data": mesh.index("data"), "model": mesh.index("model")}

    if what == "tp":
        # full width and depth, phase 3's configuration
        state = train_rank(tp_train_spec(full), "train", out, mesh, f"tp train rank {rank}")
        del state
        # depth 2, f32: loss, gradient and 3 ticks against one process
        cfg = tp_agree_config(full)
        free_cuda()
        one_grad, one_params = (torch.from_numpy(t) for t in given)
        draws = np.load(f"{out_dir}/tp_draws.npy")
        grads, params = {}, {}
        # without, then with Megatron sequence parallelism: the same params
        # and state template, the residual stream the rank's half of the
        # sequence; what is compared is kept on the host, so that the two
        # runs' peaks on the card hold the same
        for tag, sp in (("agree", False), ("sp_agree", True)):
            acfg = dataclasses.replace(cfg, sequence_parallel=sp)
            with use_sharding_rules(mesh):
                loss, g = tp_gradient(acfg, "cuda", mesh)
            grads[tag] = g.cpu()
            del g
            state = train_rank(tp_agree_spec(acfg, draws), tag, out, mesh,
                               f"tp {tag} rank {rank}", replay=False)
            params[tag] = state.params.cpu()
            del state
            out.update({f"{tag}_loss": loss.item(),
                        f"{tag}_grad_vs_one": float((grads[tag] - one_grad).abs().max()),
                        f"{tag}_params_vs_one": float((params[tag] - one_params).abs().max())})
        out.update(sp_grad_vs_tp=float((grads["sp_agree"] - grads["agree"]).abs().max()),
                   sp_params_vs_tp=float((params["sp_agree"] - params["agree"]).abs().max()))
        del one_grad, one_params, grads, params
        # serving at full width and depth, f32, on the flash kernel
        with use_sharding_rules(mesh):
            got = seeded_serve(tp_serve_config(full), EP_PROMPT, TP_GEN, mesh.device, mesh)
        out.update({f"serve_{k}": v for k, v in saved(got).items()})
        del got
        # serving at depth 2 without and with sequence parallelism
        for tag, sp in (("serve2", False), ("sp_serve2", True)):
            scfg = dataclasses.replace(tp_serve_config(full), num_layers=TP_AGREE_LAYERS,
                                       sequence_parallel=sp)
            with use_sharding_rules(mesh):
                got = seeded_serve(scfg, EP_PROMPT, TP_GEN, mesh.device, mesh)
            out.update({f"{tag}_{k}": v for k, v in saved(got).items()})
            del got
        out["sp_memory"] = json.dumps(sp_memory(full, mesh))
    else:
        cfg = dataclasses.replace(full, num_layers=TP_DXM_LAYERS)
        state = train_rank(tp_train_spec(cfg, num_steps=TP_DXM_TICKS), "dxm", out, mesh,
                           f"tp dxm rank {rank}", replay=False)
        out["dxm_digests"] = json.dumps([replicated_digest(t, cfg, mesh) for t in (
            state.params, state.opt_state["bufs"], state.delayed.ring)])
        del state
    np.savez(f"{out_dir}/{what}_{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


def tensor_parallel(root, full, main_summary):
    """Phase 14 (module docstring): data 1 x model 2 training, agreement and
    serving on 2 ranks, data 2 x model 2 training on 4, each against one
    process or the plan."""
    import shutil

    import numpy as np

    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.run import run

    t_phase = time.perf_counter()
    out_dir = root / "build" / "tensor_parallel"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    free_cuda()

    # one process: the depth-2 f32 agreement run and the full-depth f32 serve
    acfg = tp_agree_config(full)
    draws = np.random.default_rng(0).random((TP_AGREE_TICKS, W_WORKERS)).astype(np.float32)
    np.save(out_dir / "tp_draws.npy", draws)
    loss1, g1 = tp_gradient(acfg, "cuda")
    one_loss, one_grad = loss1.item(), g1.cpu().numpy()
    del loss1, g1
    one_params = run(tp_agree_spec(acfg, draws)).state.params.cpu().numpy()
    free_cuda()
    scfg = tp_serve_config(full)
    one_serve = seeded_serve(scfg, EP_PROMPT, TP_GEN, "cuda")
    one_flash = one_serve["launches"]["flash_attention"]
    t_one = time.perf_counter() - t_phase

    # the plans: per-rank state bytes and all-reduce bytes
    mesh12 = make_mesh((1, 2), ("data", "model"), device="meta")
    planning = alongside(D.plan_run, tp_train_spec(full, device="cpu"), mesh=mesh12)
    plan_train = train_plan(full, 4, 512, TP_TICKS, (1, 2))
    plan_agree = train_plan(acfg, 4, 512, TP_AGREE_TICKS, (1, 2))
    dcfg = dataclasses.replace(full, num_layers=TP_DXM_LAYERS)
    plan_dxm = train_plan(dcfg, 4, 512, TP_DXM_TICKS, (2, 2))
    plan_serve = serve_plan(scfg, 4, EP_PROMPT, TP_GEN, (1, 2))
    spc = dataclasses.replace(acfg, sequence_parallel=True)
    plan_sp_agree = train_plan(spc, 4, 512, TP_AGREE_TICKS, (1, 2))
    s2cfg = dataclasses.replace(scfg, num_layers=TP_AGREE_LAYERS)
    plan_serve2 = {sp: serve_plan(dataclasses.replace(s2cfg, sequence_parallel=sp), 4, EP_PROMPT,
                                  TP_GEN, (1, 2)) for sp in (False, True)}
    given = list(zip(rank_blocks(one_grad, acfg, (1, 2)), rank_blocks(one_params, acfg, (1, 2))))
    one_max_grad = float(np.abs(one_grad).max())
    del one_grad, one_params

    wall_tp = run_ranks(2, 1, 2, "tp", out_dir, target=tp_rank, timeout_s=TP_TIMEOUT_S,
                        given=given)
    del given
    planned_state = planning.result()
    ranks = [dict(np.load(out_dir / f"tp_{r}.npz")) for r in range(2)]
    rows = {}

    # -- training, full width and depth --------------------------------------
    for r in ranks:
        launches = json.loads(str(r["train_launches"]))
        check(launches["fused_tick"] == TP_TICKS and launches["fused_chain"] ==
              launches["fused_combine"] == launches["fused_update"] == 0,
              f"tp training: launches {launches}, expected {TP_TICKS} fused_tick alone")
        check(bool(np.isfinite(r["train_losses"]).all()), "tp training: a non-finite loss")
        check(bool(r["train_table_in_place"]), "tp training: the refresh replaced the table")
        check(int(r["train_state_bytes"]) == planned_state["memory"]["argument_bytes"],
              f"tp training: state bytes {int(r['train_state_bytes'])} != the plan's "
              f"{planned_state['memory']['argument_bytes']}")
        check(bytes_by_key(r["train_bytes"]) == plan_train,
              f"tp training: all-reduce bytes {bytes_by_key(r['train_bytes'])} != the plan "
              f"{plan_train}")
    for k in ("train_losses", "train_taus", "train_tables", "train_cdfs", "train_hists"):
        check(np.array_equal(ranks[0][k], ranks[1][k]), f"tp training: ranks disagree on {k}")
    tables = ranks[0]["train_tables"]
    check(not np.array_equal(tables[1], tables[0]) or not np.array_equal(tables[3], tables[2]),
          "tp training: no refresh changed the alpha table")
    rows["train"] = dict(
        layout="data 1 x model 2", ticks=TP_TICKS,
        median_tick_ms=[float(r["train_median_ms"]) for r in ranks],
        peak_gb=[float(r["train_peak_gb"]) for r in ranks],
        state_bytes=int(ranks[0]["train_state_bytes"]), n_local=int(ranks[0]["train_n_local"]),
        fused_tick=[json.loads(str(r["train_launches"]))["fused_tick"] for r in ranks],
        losses=ranks[0]["train_losses"].tolist(),
        phase3_first_losses=main_summary["losses"][:TP_TICKS],
        taus=ranks[0]["train_taus"].tolist(), all_reduce_bytes=bytes_by_key(ranks[0]["train_bytes"]))
    log(f"[tp] training {json.dumps(rows['train'])}")

    # -- agreement at depth 2 in f32 -----------------------------------------
    d_loss = max(abs(float(r["agree_loss"]) - one_loss) / abs(one_loss) for r in ranks)
    d_grad = max(float(r["agree_grad_vs_one"]) for r in ranks) / one_max_grad
    d_params = max(float(r["agree_params_vs_one"]) for r in ranks)
    for r in ranks:
        check(bytes_by_key(r["agree_bytes"]) == plan_agree,
              f"tp agreement: all-reduce bytes {bytes_by_key(r['agree_bytes'])} != {plan_agree}")
    rows["agree"] = dict(layers=TP_AGREE_LAYERS, loss_rel=d_loss, grad_over_max=d_grad,
                         params_max_abs=d_params, one_process_s=t_one)
    log(f"[tp] agreement {json.dumps(rows['agree'])}")
    check(d_loss <= 1e-5, f"tp agreement: loss {d_loss:.3e} relative past 1e-5")
    check(d_grad <= 1e-4, f"tp agreement: gradient {d_grad:.3e} of max |g| past 1e-4")
    check(d_params <= 1e-5, f"tp agreement: params {d_params:.3e} past 1e-5 after "
          f"{TP_AGREE_TICKS} ticks")

    # -- the same with sequence parallelism, against one process and the ranks
    sp_row = dict(
        loss_rel=max(abs(float(r["sp_agree_loss"]) - one_loss) / abs(one_loss) for r in ranks),
        loss_rel_vs_tp=max(abs(float(r["sp_agree_loss"]) - float(r["agree_loss"]))
                           / abs(one_loss) for r in ranks),
        grad_over_max=max(float(r["sp_agree_grad_vs_one"]) for r in ranks) / one_max_grad,
        grad_over_max_vs_tp=max(float(r["sp_grad_vs_tp"]) for r in ranks) / one_max_grad,
        params_max_abs=max(float(r["sp_agree_params_vs_one"]) for r in ranks),
        params_max_abs_vs_tp=max(float(r["sp_params_vs_tp"]) for r in ranks),
        median_tick_ms=[float(r["sp_agree_median_ms"]) for r in ranks],
        median_tick_ms_without=[float(r["agree_median_ms"]) for r in ranks],
        fused_tick=[json.loads(str(r["sp_agree_launches"]))["fused_tick"] for r in ranks],
        peak_gb=[float(r["sp_agree_peak_gb"]) for r in ranks],
        peak_gb_without=[float(r["agree_peak_gb"]) for r in ranks],
        collective_bytes=bytes_by_key(ranks[0]["sp_agree_bytes"]))
    for r in ranks:
        check(bytes_by_key(r["sp_agree_bytes"]) == plan_sp_agree,
              f"tp sp agreement: bytes {bytes_by_key(r['sp_agree_bytes'])} != {plan_sp_agree}")
        check(json.loads(str(r["sp_agree_launches"]))["fused_tick"] == TP_AGREE_TICKS,
              "tp sp agreement: fused_tick launches")
    log(f"[tp] sequence-parallel agreement {json.dumps(sp_row)}")
    check(max(sp_row["loss_rel"], sp_row["loss_rel_vs_tp"]) <= 1e-5,
          f"tp sp agreement: loss past 1e-5 relative ({sp_row})")
    check(max(sp_row["grad_over_max"], sp_row["grad_over_max_vs_tp"]) <= 1e-4,
          f"tp sp agreement: gradient past 1e-4 of max |g| ({sp_row})")
    check(max(sp_row["params_max_abs"], sp_row["params_max_abs_vs_tp"]) <= 1e-5,
          f"tp sp agreement: params past 1e-5 ({sp_row})")
    rows["sp_agree"] = sp_row

    # -- serving at full width and depth, f32 ---------------------------------
    d_pre = d_dec = 0.0
    for r in ranks:
        v = r["serve_logits"].shape[-1]
        sl = slice(int(r["model"]) * v, (int(r["model"]) + 1) * v)
        for got, want in ((r["serve_prefill"], one_serve["prefill"][..., sl]),
                          (r["serve_logits"], one_serve["logits"][..., sl])):
            err = float(np.max(np.abs(got - want) / (1e-4 + 1e-4 * np.abs(want))))
            if got.ndim == 2:
                d_pre = max(d_pre, err)
            else:
                d_dec = max(d_dec, err)
        check(np.array_equal(r["serve_tokens"], one_serve["tokens"]),
              "tp serve: greedy ids differ from one process")
        flash = json.loads(str(r["serve_launches"]))["flash_attention"]
        check(flash == full.num_layers,
              f"tp serve: {flash} flash launches, expected {full.num_layers}")
        check(bytes_by_key(r["serve_bytes"]) == plan_serve,
              f"tp serve: all-reduce bytes {bytes_by_key(r['serve_bytes'])} != {plan_serve}")
    rows["serve"] = dict(
        layout="data 1 x model 2", batch=4, prompt=EP_PROMPT, gen=TP_GEN,
        one_process=dict(prefill_s=one_serve["prefill_s"],
                         decode_ms_per_step=one_serve["decode_ms_per_step"], flash=one_flash),
        prefill_s=[float(r["serve_prefill_s"]) for r in ranks],
        decode_ms_per_step=[float(r["serve_decode_ms_per_step"]) for r in ranks],
        peak_gb=[float(r["serve_peak_gb"]) for r in ranks],
        flash=[json.loads(str(r["serve_launches"]))["flash_attention"] for r in ranks],
        all_reduce_bytes=bytes_by_key(ranks[0]["serve_bytes"]),
        logits_err_over_bound=max(d_pre, d_dec))
    log(f"[tp] serve {json.dumps(rows['serve'])}")
    check(max(d_pre, d_dec) <= 1.0, f"tp serve: logits miss 1e-4 + 1e-4|ref| "
          f"({max(d_pre, d_dec):.3f} of the bound)")
    check(one_flash == full.num_layers, f"one-process serve: {one_flash} flash")

    # -- serving at depth 2 with sequence parallelism against without --------
    d_pre = 0.0
    for r in ranks:
        want = r["serve2_prefill"]
        d_pre = max(d_pre, float(np.max(np.abs(r["sp_serve2_prefill"] - want)
                                        / (1e-4 + 1e-4 * np.abs(want)))))
        check(np.array_equal(r["sp_serve2_tokens"], r["serve2_tokens"]),
              "tp sp serve: greedy ids differ from the serve without sequence parallelism")
        for tag, sp in (("serve2", False), ("sp_serve2", True)):
            flash = json.loads(str(r[f"{tag}_launches"]))["flash_attention"]
            check(flash == TP_AGREE_LAYERS,
                  f"tp {tag}: {flash} flash launches, expected {TP_AGREE_LAYERS}")
            check(bytes_by_key(r[f"{tag}_bytes"]) == plan_serve2[sp],
                  f"tp {tag}: bytes {bytes_by_key(r[f'{tag}_bytes'])} != {plan_serve2[sp]}")
    rows["sp_serve"] = dict(
        layers=TP_AGREE_LAYERS, prefill_err_over_bound=d_pre,
        prefill_s=[float(r["sp_serve2_prefill_s"]) for r in ranks],
        prefill_s_without=[float(r["serve2_prefill_s"]) for r in ranks],
        decode_ms_per_step=[float(r["sp_serve2_decode_ms_per_step"]) for r in ranks],
        peak_gb=[float(r["sp_serve2_peak_gb"]) for r in ranks],
        peak_gb_without=[float(r["serve2_peak_gb"]) for r in ranks],
        flash=[json.loads(str(r["sp_serve2_launches"]))["flash_attention"] for r in ranks],
        collective_bytes=bytes_by_key(ranks[0]["sp_serve2_bytes"]))
    log(f"[tp] sequence-parallel serve {json.dumps(rows['sp_serve'])}")
    check(d_pre <= 1.0, f"tp sp serve: prefill logits miss 1e-4 + 1e-4|without| "
          f"({d_pre:.3f} of the bound)")

    # -- what sequence parallelism saves: a long sequence's gradient peak ----
    rows["sp_memory"] = [json.loads(str(r["sp_memory"])) for r in ranks]
    log(f"[tp] sequence-parallel memory (batch 1 x {SP_MEM_SEQ}, {SP_MEM_LAYERS} layers; the peak "
        f"above the params, each rank) {json.dumps(rows['sp_memory'])}")
    for mem in rows["sp_memory"]:
        check(all(math.isfinite(v["loss"]) for v in mem.values()),
              "tp sp memory: a non-finite loss")

    # -- data 2 x model 2, depth 6 --------------------------------------------
    planning = alongside(D.plan_run, tp_train_spec(dcfg, device="cpu", num_steps=TP_DXM_TICKS),
                         mesh=make_mesh((2, 2), ("data", "model"), device="meta"))
    wall_dxm = run_ranks(4, 2, 2, "dxm", out_dir, target=tp_rank, timeout_s=TP_TIMEOUT_S)
    planned_dxm = planning.result()
    dxm = [dict(np.load(out_dir / f"dxm_{r}.npz")) for r in range(4)]
    for r in dxm:
        launches = json.loads(str(r["dxm_launches"]))
        check(launches["fused_tick"] == TP_DXM_TICKS,
              f"tp data x model: fused_tick launched {launches['fused_tick']} times")
        check(bool(np.isfinite(r["dxm_losses"]).all()), "tp data x model: a non-finite loss")
        check(bytes_by_key(r["dxm_bytes"]) == plan_dxm,
              f"tp data x model: collective bytes {bytes_by_key(r['dxm_bytes'])} != {plan_dxm}")
        check(int(r["dxm_state_bytes"]) == planned_dxm["memory"]["argument_bytes"],
              f"tp data x model: state bytes {int(r['dxm_state_bytes'])} != the plan's "
              f"{planned_dxm['memory']['argument_bytes']}")
        twins = [o for o in dxm if int(o["model"]) == int(r["model"])]
        for o in twins:
            check(str(o["dxm_digests"]) == str(r["dxm_digests"]),
                  "tp data x model: the data replicas' leaves whole over data differ (params, "
                  "momentum or ring)")
        for k in ("dxm_losses", "dxm_tables", "dxm_hists"):
            check(np.array_equal(r[k], dxm[0][k]), f"tp data x model: ranks disagree on {k}")
    rows["data_x_model"] = dict(
        layout="data 2 x model 2", layers=TP_DXM_LAYERS, ticks=TP_DXM_TICKS,
        median_tick_ms=[float(r["dxm_median_ms"]) for r in dxm],
        peak_gb=[float(r["dxm_peak_gb"]) for r in dxm],
        state_bytes=[int(r["dxm_state_bytes"]) for r in dxm],
        fused_tick=[json.loads(str(r["dxm_launches"]))["fused_tick"] for r in dxm],
        losses=dxm[0]["dxm_losses"].tolist(), all_reduce_bytes=bytes_by_key(dxm[0]["dxm_bytes"]),
        wall_s=wall_dxm)
    log(f"[tp] data x model {json.dumps(rows['data_x_model'])}")
    rows["wall_s"] = wall_tp
    shutil.rmtree(out_dir, ignore_errors=True)
    rows["phase_s"] = time.perf_counter() - t_phase
    log(f"[tp] phase 14 took {rows['phase_s']:.1f} s")
    return rows


# Phases 15 and 17: the reference's seq_shard_cache decode layout
# ---------------------------------------------------------------------------

SSC_GEN = 8
SSC_SERVES = {  # arch: (layers, batch, prompt, layout (data, model), launches a serve)
    # branch (a): one kv head, so the local rings' capacity splits over model
    "recurrentgemma-9b": (6, 4, 4096, (1, 2),
                          {"flash_attention": 2, "rg_lru": 4, "selective_scan": 0}),
    # branch (b): batch 1, so the capacity splits over data
    "gemma2-27b": (2, 1, 8192, (2, 1),
                   {"flash_attention": 2, "rg_lru": 0, "selective_scan": 0}),
}


def ssc_config(arch, use_pallas=True):
    """``arch`` at full width cut to its ``SSC_SERVES`` depth, f32
    activations, on the kernels or, with ``use_pallas`` off, on their plain
    versions."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), num_layers=SSC_SERVES[arch][0],
                               activation_dtype="float32", use_pallas=use_pallas)


def ssc_serves(arch, device, mesh=None, use_pallas=True) -> dict:
    """``arch``'s ``SSC_SERVES`` serve (params from seed 0, under the rules
    the rank's blocks; ``SSC_GEN`` greedy steps), through
    :func:`counted_serve`: with ``mesh`` twice on the same params, without
    and then with ``SPEC_OPTIONS["seq_shard_cache"]`` (``"off"`` / ``"on"``),
    else once (one process's caches are whole either way); each serve's
    peak counts from the resident params.  The seconds this costs the
    phase: ``params_s`` (params and prompts, in ``"off"``) and each serve's
    ``wall_s`` (its warm-up included)."""
    import torch

    from repro_torch.data import make_batch_for
    from repro_torch.training import init_params

    _, batch_size, prompt, _, _ = SSC_SERVES[arch]
    cfg = ssc_config(arch, use_pallas)
    free_cuda()
    out = {}
    t0 = time.perf_counter()
    with torch.no_grad():
        params = init_params(0, cfg, device)
        batch = make_batch_for(cfg, batch=batch_size, seq=prompt, seed=0, device=device)
        torch.cuda.synchronize()
        params_s = time.perf_counter() - t0
        for tag in ("off", "on") if mesh is not None else ("off",):
            t0 = time.perf_counter()
            free_cuda()
            torch.cuda.reset_peak_memory_stats()
            with spec_options(seq_shard_cache=tag == "on"):
                out[tag] = counted_serve(cfg, params, batch, SSC_GEN, mesh)
            out[tag]["wall_s"] = time.perf_counter() - t0
        del params, batch
    free_cuda()
    out["off"]["params_s"] = params_s
    return out


def ssc_plans(arch, **options) -> dict:
    """``arch``'s ``SSC_SERVES`` serve planned by :func:`serve_plan` without
    and with ``seq_shard_cache``, under the other ``options``."""
    _, batch, prompt, shape, _ = SSC_SERVES[arch]
    return {tag: serve_plan(ssc_config(arch), batch, prompt, SSC_GEN, shape,
                            seq_shard_cache=tag == "on", **options) for tag in ("off", "on")}


def ssc_shapes(whole: dict, arch, on: bool) -> dict:
    """The shape of every leaf a rank of ``arch``'s ``SSC_SERVES`` layout
    holds of one process's decode cache (``whole``: path -> shape), by the
    reference's rule (``specs.cache_spec_for`` and ``local_shape``), with
    ``seq_shard_cache`` ``on`` or off."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.specs import cache_spec_for, local_shape

    _, batch, _, shape, _ = SSC_SERVES[arch]
    mesh = make_mesh(shape, ("data", "model"), device="meta")
    with spec_options(seq_shard_cache=on):
        return {p: list(local_shape(tuple(s), cache_spec_for(p, tuple(s), mesh, batch), mesh))
                for p, s in whole.items()}


def ssc_check(what, arch, ranks, one, plans) -> dict:
    """Gates of the ranks' :func:`ssc_serves` (saved under ``ssc_off_`` /
    ``ssc_on_``) against one process's plain serve ``one``: ids equal,
    logits (the rank's rows and vocab block) within 1e-4 + 1e-4 |one
    process|, the launches of ``SSC_SERVES``, every cache leaf of the
    shape the spec gives it, collective bytes equal to ``plans``, and with
    the option less cache than without.  Returns the row to print."""
    import numpy as np

    _, batch, prompt, (data, _), expect = SSC_SERVES[arch]
    check(not any(one["launches"].values()), f"{what} seq_shard_cache {arch}: the plain "
          f"one-process serve launched {one['launches']}")
    rows = batch // data if batch % data == 0 else 0  # batch 1 is whole on every rank
    row = {"arch": arch, "layers": SSC_SERVES[arch][0], "batch": batch, "prompt": prompt,
           "gen": SSC_GEN, "one_process_plain": {k: one[k] for k in (
               "prefill_s", "decode_ms_per_step", "peak_gb")}}
    for tag in ("off", "on"):
        key = f"ssc_{tag}_"
        want_shapes = ssc_shapes(one["cache_shapes"], arch, tag == "on")
        err = 0.0
        for i, r in enumerate(ranks):
            name = f"{what} seq_shard_cache {arch} ({tag}), rank {i}"
            launches = json.loads(str(r[key + "launches"]))
            check(launches == expect, f"{name}: launched {launches}, expected {expect}")
            got_bytes = bytes_by_key(r[key + "bytes"])
            check(got_bytes == plans[tag], f"{name}: collective bytes {got_bytes} != the plan "
                  f"{plans[tag]}")
            shapes = json.loads(str(r[key + "cache_shapes"]))
            check(shapes == want_shapes, f"{name}: cache leaves {shapes}, the spec's "
                  f"{want_shapes}")
            first = int(r["data"]) * rows
            sl = slice(first, first + rows) if rows else slice(None)
            check(np.array_equal(r[key + "tokens"], one["tokens"][sl]),
                  f"{name}: greedy ids differ from one process")
            for part in ("prefill", "logits"):
                got, ref = r[key + part], one[part][sl]
                if got.shape[-1] != ref.shape[-1]:  # the rank's vocab block
                    v = got.shape[-1]
                    ref = ref[..., int(r["model"]) * v:(int(r["model"]) + 1) * v]
                err = max(err, float(np.max(np.abs(got - ref) / (1e-4 + 1e-4 * np.abs(ref)))))
        kv = {p: b for p, b in json.loads(str(ranks[0][key + "cache_bytes"])).items()
              if p.rsplit("/", 1)[-1] in ("k", "v")}
        row[tag] = dict(
            prefill_s=[float(r[key + "prefill_s"]) for r in ranks],
            decode_ms_per_step=[float(r[key + "decode_ms_per_step"]) for r in ranks],
            peak_gb=[float(r[key + "peak_gb"]) for r in ranks],
            launches=[json.loads(str(r[key + "launches"])) for r in ranks],
            kv_cache_bytes=kv, collective_bytes=bytes_by_key(ranks[0][key + "bytes"]),
            logits_err_over_bound=err)
        check(err <= 1.0, f"{what} seq_shard_cache {arch} ({tag}): logits miss 1e-4 + "
              f"1e-4|ref| ({err:.3f} of the bound)")
    check(sum(row["on"]["kv_cache_bytes"].values()) < sum(row["off"]["kv_cache_bytes"].values()),
          f"{what} seq_shard_cache {arch}: the option split no cache leaf")
    # what these serves add to the phase: one process's, then the ranks'
    # (side by side, so the slower rank's)
    row["added_s"] = one["params_s"] + one["wall_s"] + max(
        float(r["ssc_off_params_s"]) + float(r["ssc_off_wall_s"]) + float(r["ssc_on_wall_s"])
        for r in ranks)
    log(f"[{what}] seq_shard_cache {json.dumps(row)}")
    return row


def ssc_saved(got: dict) -> dict:
    """:func:`ssc_serves`'s result as a rank saves it."""
    return {f"ssc_{tag}_{k}": v for tag, r in got.items() for k, v in saved(r).items()}


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# Phase 15: tensor parallelism of the other families on the card
# ---------------------------------------------------------------------------

OF_TIMEOUT_S = 300  # a rank, or a collective, that takes longer fails the phase
OF_SERVES = {  # arch: depth (whisper: encoder and decoder each), prompt, launches a serve
    "falcon-mamba-7b": (8, 1024, {"flash_attention": 0, "rg_lru": 0, "selective_scan": 8}),
    "recurrentgemma-9b": (6, 1024, {"flash_attention": 2, "rg_lru": 4, "selective_scan": 0}),
    "whisper-large-v3": (4, 32, {"flash_attention": 4, "rg_lru": 0, "selective_scan": 0}),
    "internvl2-2b": (4, 512, {"flash_attention": 4, "rg_lru": 0, "selective_scan": 0}),
}
OF_GEN, OF_TRAIN_LAYERS, OF_TRAIN_TICKS, OF_AGREE_LAYERS = 8, 4, 3, 2


def of_serve_config(arch, use_pallas=True):
    """``arch`` at full width cut to its ``OF_SERVES`` depth, f32
    activations (the one-process and the sharded serve sum in other orders,
    which bf16 would round apart), on the kernels or, with ``use_pallas``
    off, on their plain versions."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    layers = OF_SERVES[arch][0]
    upd = {"num_encoder_layers": layers} if cfg.is_encoder_decoder else {}
    return dataclasses.replace(cfg, num_layers=layers, activation_dtype="float32",
                               use_pallas=use_pallas, **upd)


def of_train_config():
    """Full-width falcon-mamba-7b at depth 4, phase 3's dtypes (bf16
    activations, remat; the scan's plain loop, which carries a gradient)."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("falcon-mamba-7b"), num_layers=OF_TRAIN_LAYERS)


def of_rank(rank, world, data, model, what, store, out_dir):
    """One rank of phase 15 (a spawned process): gloo over the one card.
    The four serves, then falcon-mamba-7b's training at depth 4 and its
    depth-2 gradient."""
    import datetime

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist

    import repro_torch  # noqa: F401  (sets TF32 off)
    from repro_torch.bridge import gather_params
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import collectives as COL
    from repro_torch.sharding import use_sharding_rules

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=OF_TIMEOUT_S))
    mesh = make_mesh((data, model), ("data", "model"), device="cuda")
    torch.cuda.set_device(mesh.device)
    out = {"data": mesh.index("data"), "model": mesh.index("model")}
    for arch, (_, prompt, _) in OF_SERVES.items():
        with use_sharding_rules(mesh):
            got = seeded_serve(of_serve_config(arch), prompt, OF_GEN, mesh.device, mesh)
        out.update({f"{arch}_{k}": v for k, v in saved(got).items()})
    # recurrentgemma-9b again at 4 x 4096, without and with seq_shard_cache
    with use_sharding_rules(mesh):
        out.update(ssc_saved(ssc_serves("recurrentgemma-9b", mesh.device, mesh)))
    # full width, depth 4: phase 3's run for 3 ticks
    tcfg = of_train_config()
    spec = dataclasses.replace(main_spec(tcfg), num_steps=OF_TRAIN_TICKS, refresh_every=2)
    state = train_rank(spec, "train", out, mesh, f"families train rank {rank}")
    del state
    # depth 2, f32: loss and gradient against one process
    acfg = tp_agree_config(dataclasses.replace(tcfg, num_layers=OF_AGREE_LAYERS))
    free_cuda()
    COL.reset_collective_bytes()
    with use_sharding_rules(mesh):
        loss, g = tp_gradient(acfg, "cuda", mesh)
        g_all = gather_params(g, acfg, mesh)
    out["agree_loss"] = loss.item()
    out["agree_bytes"] = json.dumps(counted_bytes())
    if rank == 0:
        np.save(f"{out_dir}/families_grad.npy", g_all.cpu().numpy())
    del g, g_all
    np.savez(f"{out_dir}/{what}_{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


def other_families(root):
    """Phase 15 (module docstring): the Mamba, RG-LRU, whisper and
    vision-prefix archs served by 2 ranks against one process, and
    falcon-mamba-7b trained by 2 ranks."""
    import shutil

    import numpy as np

    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_mesh

    t_phase = time.perf_counter()
    out_dir = root / "build" / "tp_families"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    free_cuda()

    # one process: the same params and prompts on the kernels' plain
    # versions (so the ranks' kernels are held against plain code at the
    # shapes this path gives them), and the depth-2 gradient
    one = {arch: seeded_serve(of_serve_config(arch, use_pallas=False), prompt, OF_GEN, "cuda")
           for arch, (_, prompt, _) in OF_SERVES.items()}
    one_ssc = ssc_serves("recurrentgemma-9b", "cuda", use_pallas=False)["off"]
    tcfg = of_train_config()
    acfg = tp_agree_config(dataclasses.replace(tcfg, num_layers=OF_AGREE_LAYERS))
    loss1, g1 = tp_gradient(acfg, "cuda")
    one_loss, one_grad = loss1.item(), g1.cpu().numpy()
    del loss1, g1
    free_cuda()
    t_one = time.perf_counter() - t_phase

    # the plans: per-rank state bytes and all-reduce bytes
    plan_ssc = ssc_plans("recurrentgemma-9b")  # before the plan on a thread: it sets options
    spec = dataclasses.replace(main_spec(tcfg, device="cpu"), num_steps=OF_TRAIN_TICKS,
                               refresh_every=2)
    planning = alongside(D.plan_run, spec,
                         mesh=make_mesh((1, 2), ("data", "model"), device="meta"))
    plan_train = train_plan(tcfg, 4, 512, OF_TRAIN_TICKS, (1, 2))
    plan_agree = train_plan(acfg, 4, 512, 1, (1, 2))
    plan_serve = {arch: serve_plan(of_serve_config(arch), 4, OF_SERVES[arch][1], OF_GEN, (1, 2))
                  for arch in OF_SERVES}

    wall = run_ranks(2, 1, 2, "families", out_dir, target=of_rank, timeout_s=OF_TIMEOUT_S)
    planned_state = planning.result()
    ranks = [dict(np.load(out_dir / f"families_{r}.npz")) for r in range(2)]
    rows = {"one_process_s": t_one, "wall_s": wall}

    # -- the four serves ----------------------------------------------------------
    for arch, (_, _, expect) in OF_SERVES.items():
        want = one[arch]
        check(not any(want["launches"].values()), f"families {arch}: the plain one-process "
              f"serve launched {want['launches']}")
        err = 0.0
        for r in ranks:
            got_launches = json.loads(str(r[f"{arch}_launches"]))
            check(got_launches == expect, f"families {arch}: rank launched {got_launches}, "
                  f"expected {expect}")
            check(json.loads(str(r[f"{arch}_bytes"])) == plan_serve[arch],
                  f"families {arch}: all-reduce bytes {str(r[f'{arch}_bytes'])} != the plan "
                  f"{plan_serve[arch]}")
            check(np.array_equal(r[f"{arch}_tokens"], want["tokens"]),
                  f"families {arch}: greedy ids differ from one process")
            for key in ("prefill", "logits"):
                if key not in want:
                    continue
                got, ref = r[f"{arch}_{key}"], want[key]
                if got.shape[-1] != ref.shape[-1]:  # the rank's vocab block
                    v = got.shape[-1]
                    ref = ref[..., int(r["model"]) * v:(int(r["model"]) + 1) * v]
                err = max(err, float(np.max(np.abs(got - ref) / (1e-4 + 1e-4 * np.abs(ref)))))
        rows[arch] = dict(
            layers=OF_SERVES[arch][0], batch=4, prompt=OF_SERVES[arch][1], gen=OF_GEN,
            one_process_plain={k: want[k] for k in ("prefill_s", "decode_ms_per_step",
                                                     "peak_gb")},
            prefill_s=[float(r[f"{arch}_prefill_s"]) for r in ranks],
            decode_ms_per_step=[float(r[f"{arch}_decode_ms_per_step"]) for r in ranks],
            peak_gb=[float(r[f"{arch}_peak_gb"]) for r in ranks],
            launches=[json.loads(str(r[f"{arch}_launches"])) for r in ranks],
            vocab_split=ranks[0][f"{arch}_logits"].shape[-1] != want["logits"].shape[-1],
            all_reduce_bytes=json.loads(str(ranks[0][f"{arch}_bytes"])),
            logits_err_over_bound=err)
        log(f"[families] serve {arch} {json.dumps(rows[arch])}")
        check(err <= 1.0, f"families {arch}: logits miss 1e-4 + 1e-4|ref| ({err:.3f} of the bound)")

    rows["seq_shard_cache"] = ssc_check("families", "recurrentgemma-9b", ranks, one_ssc,
                                        plan_ssc)

    # -- training, full width at depth 4 ---------------------------------------------
    for r in ranks:
        launches = json.loads(str(r["train_launches"]))
        check(launches["fused_tick"] == OF_TRAIN_TICKS and launches["fused_chain"] ==
              launches["fused_combine"] == launches["fused_update"] == 0,
              f"families training: launches {launches}, expected {OF_TRAIN_TICKS} fused_tick")
        check(bool(np.isfinite(r["train_losses"]).all()), "families training: a non-finite loss")
        check(int(r["train_state_bytes"]) == planned_state["memory"]["argument_bytes"],
              f"families training: state bytes {int(r['train_state_bytes'])} != the plan's "
              f"{planned_state['memory']['argument_bytes']}")
        check(json.loads(str(r["train_bytes"])) == plan_train,
              f"families training: all-reduce bytes {str(r['train_bytes'])} != {plan_train}")
    for k in ("train_losses", "train_taus", "train_tables", "train_hists"):
        check(np.array_equal(ranks[0][k], ranks[1][k]), f"families training: ranks disagree on {k}")
    rows["train"] = dict(
        arch="falcon-mamba-7b", layers=OF_TRAIN_LAYERS, layout="data 1 x model 2",
        ticks=OF_TRAIN_TICKS, median_tick_ms=[float(r["train_median_ms"]) for r in ranks],
        peak_gb=[float(r["train_peak_gb"]) for r in ranks],
        state_bytes=int(ranks[0]["train_state_bytes"]), n_local=int(ranks[0]["train_n_local"]),
        fused_tick=[json.loads(str(r["train_launches"]))["fused_tick"] for r in ranks],
        losses=ranks[0]["train_losses"].tolist(), taus=ranks[0]["train_taus"].tolist(),
        all_reduce_bytes=json.loads(str(ranks[0]["train_bytes"])))
    log(f"[families] training {json.dumps(rows['train'])}")

    # -- agreement at depth 2 in f32 -------------------------------------------------
    got_grad = np.load(out_dir / "families_grad.npy")
    d_loss = max(abs(float(r["agree_loss"]) - one_loss) / abs(one_loss) for r in ranks)
    d_grad = float(np.abs(got_grad - one_grad).max() / np.abs(one_grad).max())
    for r in ranks:
        check(json.loads(str(r["agree_bytes"])) == plan_agree,
              f"families agreement: all-reduce bytes {str(r['agree_bytes'])} != {plan_agree}")
    rows["agree"] = dict(layers=OF_AGREE_LAYERS, loss_rel=d_loss, grad_over_max=d_grad)
    log(f"[families] agreement {json.dumps(rows['agree'])}")
    check(d_loss <= 1e-5, f"families agreement: loss {d_loss:.3e} relative past 1e-5")
    check(d_grad <= 1e-4, f"families agreement: gradient {d_grad:.3e} of max |g| past 1e-4")
    shutil.rmtree(out_dir, ignore_errors=True)
    rows["phase_s"] = time.perf_counter() - t_phase
    log(f"[families] phase 15 took {rows['phase_s']:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# Phase 16: checkpoint and resume of multi-process training states
# ---------------------------------------------------------------------------

SR_TIMEOUT_S = 300  # a rank, or a collective, that takes longer fails the phase
SR_TICKS, SR_SAVE = 6, 3
# Depths, cut for the disk: the whole script is held to 45 GiB of disk
# writes, deleted files included, and phase 7 writes 34.53 GB of it.  (a)
# at 2 layers writes 7.40 GB, (b) at 1 layer 4.11 GB.
SR_LAYERS, SR_DXM_LAYERS, SR_DXM_WK = 2, 1, 2
SR_SLACK_BYTES = 1 << 30  # a rank's peak in a save or a restore over its training peak


def sr_spec(full, device="cuda", layers=SR_LAYERS, **upd):
    """(a)'s run: phase 7's (phase 3's config, 6 ticks, a refresh every 2)
    at full width and ``layers`` layers."""
    cfg = dataclasses.replace(full, num_layers=layers)
    return dataclasses.replace(main_spec(cfg, device),
                               **{"num_steps": SR_TICKS, "refresh_every": 2, **upd})


def sr_dxm_spec(full, device="cuda", **upd):
    """(b)'s run: full width at ``SR_DXM_LAYERS`` layers, f32 activations
    without remat and an f32 ring of W = K = 2 (so the layouts' continued
    ticks differ by f32 round-off alone: phase 14's agreement dtypes), a
    refresh every 2, saved at the end of tick 3."""
    from repro_torch.run import RunSpec

    cfg = dataclasses.replace(tp_agree_config(full), num_layers=SR_DXM_LAYERS)
    pipe, adapt = lm_pipeline(0.01, SR_DXM_WK, SR_DXM_WK)
    spec = RunSpec(cfg=cfg, pipeline=pipe, mode="async", num_steps=SR_SAVE, batch_size=4,
                   seq_len=512, num_workers=SR_DXM_WK, ring=SR_DXM_WK, adapt=adapt, fuse=True,
                   refresh_every=2, seed=0, device=device)
    return dataclasses.replace(spec, **upd)


def leaf_digests(state) -> dict:
    """SHA-256 of every leaf's bits, streamed to the host a chunk at a time."""
    import hashlib

    import torch

    from repro_torch.checkpoint import key_paths

    out = {}
    for k, v in key_paths(state):
        h = hashlib.sha256()
        t = v.get_state() if isinstance(v, torch.Generator) else v.detach().reshape(-1)
        for lo in range(0, t.numel(), CHUNK):
            h.update(_bits(t[lo:lo + CHUNK]).contiguous().cpu().numpy().tobytes())
        out[k] = h.hexdigest()
    return out


def member_rows(path, key):
    """The rows of a checkpoint leaf (its leading dims), streamed from the
    npz member one at a time as numpy arrays of the stored dtype."""
    import zipfile

    import numpy as np

    with zipfile.ZipFile(path) as zf, zf.open(key + ".npy") as f:
        np.lib.format.read_magic(f)
        shape, _, dtype = np.lib.format.read_array_header_1_0(f)
        row = shape[-1] if shape else 1
        for _ in range(math.prod(shape[:-1]) if shape else 1):
            yield np.frombuffer(f.read(row * dtype.itemsize), dtype=dtype)


def file_layout(path) -> dict:
    """``{key: (shape, stored dtype)}`` of every member of a checkpoint's
    npz, read from the members' headers."""
    import zipfile

    import numpy as np

    out = {}
    with zipfile.ZipFile(path) as zf:
        for name in zf.namelist():
            with zf.open(name) as f:
                np.lib.format.read_magic(f)
                shape, _, dtype = np.lib.format.read_array_header_1_0(f)
            out[name[:-len(".npy")]] = (tuple(shape), str(dtype))
    return out


def one_process_layout(template) -> dict:
    """What :func:`file_layout` reads from a one-process save of a state of
    this template (bf16 stored as uint16, a generator's state as uint8)."""
    import numpy as np
    import torch

    from repro_torch.checkpoint import key_paths
    from repro_torch.checkpoint.store import _np_dtype

    out = {}
    for k, v in key_paths(template):
        if isinstance(v, torch.Generator):
            out[k] = (tuple(v.get_state().shape), str(np.dtype(np.uint8)))
        else:
            out[k] = (tuple(v.shape), str(_np_dtype(v.dtype)[0]))
    return out


def restored_differ(directory, state, cfg, mesh=None) -> list:
    """The leaves of a restored ``state`` that are not, bit for bit, the
    checkpoint's whole leaves (one process) or ``specs.localize`` of them
    (a rank of ``mesh``: flat leaves row by row of their leading dims,
    replicated leaves whole)."""
    import numpy as np
    import torch

    from repro_torch.checkpoint import key_paths
    from repro_torch.optim import transform as T
    from repro_torch.sharding.specs import localize
    from repro_torch.training.steps import param_template

    path = os.path.join(directory, f"step_{SR_SAVE:08d}.npz")
    template = param_template(cfg)
    n = sum(math.prod(shape) for shape, _ in _leaves(template))
    bad = []
    for key, leaf in key_paths(state):
        mine = leaf.get_state() if isinstance(leaf, torch.Generator) else leaf
        rows = mine.reshape(-1, mine.shape[-1]) if mine.dim() else mine.reshape(1, 1)
        for i, whole in enumerate(member_rows(path, key)):
            t = torch.from_numpy(whole.copy())
            if whole.dtype == np.uint16:  # bf16 bits
                t = t.view(torch.int16).view(mine.dtype)
            if mesh is not None and t.numel() == n and mine.shape[-1] != n:
                t = T.pack_flat(localize(T.flat_view(t, template), cfg, mesh), dtype=t.dtype)
            if not torch.equal(_bits(t.to(mine.device)), _bits(rows[i])):
                bad.append(key)
                break
    return bad


def sr_rank(rank, world, data, model, what, store, out_dir):
    """One rank of phase 16 (a spawned process): gloo over the one card.
    ``what``: ``"a"`` (data 1 x model 2: 6 ticks, a timed save at 3),
    ``"b"`` (the same layout resumed at 3), ``"dxm"`` (data 2 x model 2: 3
    ticks and a save), ``"dxm_12"`` (that checkpoint restored at data 1 x
    model 2, held to ``localize`` of the whole, 3 more ticks; then rank 0
    alone restores it as one process, held to the file, and runs the same
    3 ticks)."""
    import datetime

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch
    import torch.distributed as dist

    import repro_torch  # noqa: F401  (sets TF32 off)
    from repro_torch.bridge import gather_params
    from repro_torch.configs import get_config
    from repro_torch.kernels.adaptive_update import cuda as C
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.run import CheckpointHook, Hook, run
    from repro_torch.run.ckpt import restore_checkpoint
    from repro_torch.run.engine import make_engine
    from repro_torch.sharding import use_sharding_rules
    from repro_torch.sharding.ctx import rules_in_force

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=SR_TIMEOUT_S))
    mesh = make_mesh((data, model), ("data", "model"), device="cuda")
    torch.cuda.set_device(mesh.device)
    full = get_config("stablelm-1.6b")
    dxm = what.startswith("dxm")
    with open(f"{out_dir}/layers.json") as f:
        layers = json.load(f)  # (a)'s
    directory = f"{out_dir}/ckpt_{'dxm' if dxm else 'a'}"
    out = {}

    class Losses(Hook):
        def __init__(self):
            self.losses, self.t_start, self.start_peak = [], None, None

        def on_start(self, ctx):
            torch.cuda.synchronize()
            self.t_start = time.perf_counter()
            self.start_peak = torch.cuda.max_memory_allocated()

        def on_tick(self, ctx):
            self.losses.append(ctx.metrics["loss"].item())

    class TimedCheckpoint(CheckpointHook):
        """The hook's save at step 3, timed, with the peak before it (the
        training peak) and during it; stopped after it, as phase 7's: a save
        at step 6 would write a second checkpoint that nothing reads."""

        def _save(self, ctx):
            if self.saved_steps:
                return
            torch.cuda.synchronize()
            self.train_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            super()._save(ctx)
            torch.cuda.synchronize()
            self.seconds = time.perf_counter() - t0
            self.save_peak = torch.cuda.max_memory_allocated()

    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    C.reset_launches()
    hook = Losses()
    dist.barrier()
    t0 = time.perf_counter()
    if what in ("a", "dxm"):
        spec = sr_dxm_spec(full) if dxm else sr_spec(full, layers=layers)
        saver = TimedCheckpoint(directory, every=SR_SAVE)
        with use_sharding_rules(mesh):
            state = run(spec, hooks=[hook, saver]).state
            torch.cuda.synchronize()
            out.update(save_s=saver.seconds, train_peak=saver.train_peak,
                       save_peak=saver.save_peak)
            if dxm:
                # back at data 2 x model 2: the FSDP blocks restored, held to
                # the state that was saved
                engine = make_engine(spec)
                held, _ = restore_checkpoint(directory, engine.build_template(), spec.pipeline,
                                             step=SR_SAVE, device="cuda",
                                             layout=engine.checkpoint_layout())
                want = leaf_digests(state)
                out["same_state_differ"] = [k for k, v in leaf_digests(held).items()
                                            if v != want[k]]
                del held, engine
    else:
        spec = sr_dxm_spec(full, num_steps=SR_SAVE + 3) if dxm else sr_spec(full, layers=layers)
        with use_sharding_rules(mesh):
            if dxm:
                engine = make_engine(spec)
                held, _ = restore_checkpoint(directory, engine.build_template(), spec.pipeline,
                                             step=SR_SAVE, device="cuda",
                                             layout=engine.checkpoint_layout())
                out["localize_differ"] = restored_differ(directory, held, spec.cfg, mesh)
                del held, engine
                free_cuda()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
            state = run(spec, hooks=[hook], resume_from=directory, resume_step=SR_SAVE).state
            torch.cuda.synchronize()
            p_all = gather_params(state.params, spec.cfg, mesh) if dxm else None
        out.update(restore_s=hook.t_start - t0, restore_peak=hook.start_peak)
    out.update(losses=hook.losses, launches=dict(C.LAUNCHES), digests=leaf_digests(state),
               end_peak=torch.cuda.max_memory_allocated())
    del state
    if what == "dxm_12" and rank == 0:
        # one process: the same checkpoint, held to the file's bits, and the same ticks
        free_cuda()
        one_spec = sr_dxm_spec(full, num_steps=SR_SAVE + 3)
        with rules_in_force(None):
            engine = make_engine(one_spec)
            t1 = time.perf_counter()
            held, _ = restore_checkpoint(directory, engine.build_template(), one_spec.pipeline,
                                         step=SR_SAVE, device="cuda")
            torch.cuda.synchronize()
            out["one_restore_s"] = time.perf_counter() - t1
            out["one_differ"] = restored_differ(directory, held, one_spec.cfg)
            del held, engine
            free_cuda()
            one = run(one_spec, resume_from=directory, resume_step=SR_SAVE).state.params
        out["params_max_abs"] = float((p_all - one).abs().max())
        del one
    with open(f"{out_dir}/{what}_{rank}.json", "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def sharded_resume(root, full, layers=SR_LAYERS, across=True):
    """Phase 16 (module docstring): (a) a same-layout resume at data 1 x
    model 2 at ``layers`` layers; with ``across``, (b) a data 2 x model 2
    save restored at data 1 x model 2 and in one process."""
    import shutil

    from repro_torch.run.engine import make_engine

    t_phase = time.perf_counter()
    out_dir = root / "build" / "sharded_resume"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    with open(out_dir / "layers.json", "w") as f:
        json.dump(layers, f)
    free_cuda()
    rows = {}

    def ranks(what, world):
        recs = []
        for r in range(world):
            with open(out_dir / f"{what}_{r}.json") as f:
                recs.append(json.load(f))
        return recs

    def on_disk(ck, spec):
        """The checkpoint's bytes, after holding the directory to one
        checkpoint and its members' shapes and stored dtypes to a
        one-process save's (the template's generator on the card, as the
        run's)."""
        base = f"step_{SR_SAVE:08d}"
        files = sorted(os.listdir(ck))
        check(files == sorted(["latest", f"{base}.json", f"{base}.npz", f"{base}_host.npz"]),
              f"sharded resume: the checkpoint directory holds {files}")
        npz = ck / f"{base}.npz"
        want = one_process_layout(make_engine(spec).build_template())
        got = file_layout(npz)
        check(list(got) == list(want) and got == want,
              f"sharded resume: the checkpoint holds {got}, one process saves {want}")
        return sum(os.path.getsize(ck / f) for f in os.listdir(ck)
                   if f.startswith(f"step_{SR_SAVE:08d}"))

    def across_layouts():
        """(b)'s two groups, which share nothing with (a)'s."""
        wall_dxm = run_ranks(4, 2, 2, "dxm", out_dir, target=sr_rank, timeout_s=SR_TIMEOUT_S)
        dxm_bytes = on_disk(out_dir / "ckpt_dxm", sr_dxm_spec(full))
        wall_12 = run_ranks(2, 1, 2, "dxm_12", out_dir, target=sr_rank, timeout_s=SR_TIMEOUT_S)
        return wall_dxm, dxm_bytes, wall_12

    # -- (a) same layout, with (b) beside it ------------------------------------
    free_disk = shutil.disk_usage(out_dir).free
    beside = alongside(across_layouts) if across else None
    wall_a = run_ranks(2, 1, 2, "a", out_dir, target=sr_rank, timeout_s=SR_TIMEOUT_S)
    ckpt_bytes = on_disk(out_dir / "ckpt_a", sr_spec(full, layers=layers))
    wall_b = run_ranks(2, 1, 2, "b", out_dir, target=sr_rank, timeout_s=SR_TIMEOUT_S)
    a, b = ranks("a", 2), ranks("b", 2)
    for ra, rb in zip(a, b):
        check(rb["losses"] == ra["losses"][SR_SAVE:],
              f"sharded resume (a): resumed losses {rb['losses']} != {ra['losses'][SR_SAVE:]}")
        differ = [k for k in ra["digests"] if ra["digests"][k] != rb["digests"][k]]
        check(not differ, f"sharded resume (a): the resumed state differs in {differ}")
        check((ra["launches"]["fused_tick"], rb["launches"]["fused_tick"]) == (SR_TICKS, SR_SAVE),
              f"sharded resume (a): fused_tick {ra['launches']} + {rb['launches']}")
        for what, peak in (("save", ra["save_peak"]), ("restore", rb["restore_peak"])):
            check(peak <= ra["train_peak"] + SR_SLACK_BYTES,
                  f"sharded resume (a): {what} peak {peak} B over the training peak "
                  f"{ra['train_peak']} B by more than 1 GB")
    rows["same_layout"] = dict(
        layout="data 1 x model 2", layers=layers, checkpoint_gb=ckpt_bytes / 1e9,
        free_disk_gb=free_disk / 1e9, save_s=[r["save_s"] for r in a],
        restore_s=[r["restore_s"] for r in b], train_peak_gb=[r["train_peak"] / 1e9 for r in a],
        save_peak_gb=[r["save_peak"] / 1e9 for r in a],
        restore_peak_gb=[r["restore_peak"] / 1e9 for r in b],
        fused_tick=[[ra["launches"]["fused_tick"], rb["launches"]["fused_tick"]]
                    for ra, rb in zip(a, b)],
        losses=a[0]["losses"], leaves=len(a[0]["digests"]), group_s=[wall_a, wall_b])
    log(f"[resume16] (a) {json.dumps(rows['same_layout'])}")
    shutil.rmtree(out_dir / "ckpt_a", ignore_errors=True)
    if not across:
        shutil.rmtree(out_dir, ignore_errors=True)
        return rows

    # -- (b) across layouts -----------------------------------------------------
    wall_dxm, dxm_bytes, wall_12 = beside.result()
    dxm, r12 = ranks("dxm", 4), ranks("dxm_12", 2)
    for r in r12:
        check(not r["localize_differ"], f"sharded resume (b): data 1 x model 2 restored "
              f"{r['localize_differ']} other than localize of the whole")
        check(r["launches"]["fused_tick"] == 3, f"sharded resume (b): {r['launches']}")
    for r in dxm:
        check(r["launches"]["fused_tick"] == SR_SAVE, f"sharded resume (b): {r['launches']}")
        check(not r["same_state_differ"], f"sharded resume (b): restored back at data 2 x "
              f"model 2, {r['same_state_differ']} differ from the state saved")
    check(not r12[0]["one_differ"], f"sharded resume (b): one process restored "
          f"{r12[0]['one_differ']} other than the whole")
    d_params = r12[0]["params_max_abs"]
    check(d_params <= 1e-5, f"sharded resume (b): the continued ticks' params {d_params:.3e} "
          "past 1e-5 of one process's")
    rows["across_layouts"] = dict(
        save_layout="data 2 x model 2, FSDP",
        restore_layouts=["data 2 x model 2, FSDP", "data 1 x model 2", "one process"],
        layers=SR_DXM_LAYERS, checkpoint_gb=dxm_bytes / 1e9,
        save_s=[r["save_s"] for r in dxm], restore_s=[r["restore_s"] for r in r12],
        one_process_restore_s=r12[0]["one_restore_s"],
        train_peak_gb=[r["train_peak"] / 1e9 for r in dxm],
        save_peak_gb=[r["save_peak"] / 1e9 for r in dxm],
        restore_peak_gb=[r["restore_peak"] / 1e9 for r in r12],
        fused_tick=[r["launches"]["fused_tick"] for r in dxm + r12],
        params_max_abs=d_params, group_s=[wall_dxm, wall_12])
    log(f"[resume16] (b) {json.dumps(rows['across_layouts'])}")
    shutil.rmtree(out_dir, ignore_errors=True)
    rows["phase_s"] = time.perf_counter() - t_phase
    log(f"[resume16] phase 16 took {rows['phase_s']:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# Phase 17: the reference's FSDP storage over data on the card
# ---------------------------------------------------------------------------

FS_TIMEOUT_S = 400  # a rank, or a collective, that takes longer fails the phase
FS_TICKS, FS_AGREE_LAYERS, FS_SERVE_LAYERS, FS_GEN = 3, 2, 2, 4


def fs_train_spec(cfg, device="cuda"):
    """(a)'s run: phase 3's (momentum, W = K = 8, bf16 ring, batch 4 x seq
    512) for ``FS_TICKS`` ticks and a refresh every 2."""
    return dataclasses.replace(main_spec(cfg, device), num_steps=FS_TICKS, refresh_every=2)


def fs_agree_config(full):
    """(b)'s model: full width at ``FS_AGREE_LAYERS`` layers, f32 activations
    and no remat (phase 14's agreement dtypes)."""
    return dataclasses.replace(tp_agree_config(full), num_layers=FS_AGREE_LAYERS)


def fs_serve_config(full):
    """(c)'s model: full width at ``FS_SERVE_LAYERS`` layers in f32 on the
    kernels (flash at H 64 on all 32 heads)."""
    return dataclasses.replace(tp_serve_config(full), num_layers=FS_SERVE_LAYERS)


def fsdp_cut(t, cfg, mesh):
    """The FSDP blocks of ``t`` (..., N), a tensor over the whole packed
    param tree row by row of its leading dims, packed as a rank of
    ``mesh`` packs its flat buffers (``specs.localize`` under the FSDP
    layout)."""
    import torch

    from repro_torch.optim import transform as T
    from repro_torch.sharding.specs import SPEC_OPTIONS, localize
    from repro_torch.training.steps import param_template

    assert not SPEC_OPTIONS["replicate_params_over_data"]
    template = param_template(cfg)
    rows = [T.pack_flat(localize(T.flat_view(r, template), cfg, mesh), dtype=r.dtype)
            for r in t.reshape(-1, t.shape[-1])]
    return torch.stack(rows).reshape(tuple(t.shape[:-1]) + (-1,))


def fs_rank(rank, world, data, model, what, store, out_dir):
    """One rank of phase 17 (a spawned process), data 2 x model 1 over gloo
    on the one card: (a) full-width training, (b) the depth-2 agreement run
    in the FSDP layout and then in the replicated one, (c) the depth-2
    serve, in turn."""
    import datetime

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist

    import repro_torch  # noqa: F401  (sets TF32 off)
    from repro_torch.bridge import gather_params
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import use_sharding_rules
    from repro_torch.sharding.specs import SPEC_OPTIONS

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=FS_TIMEOUT_S))
    mesh = make_mesh((data, model), ("data", "model"), device="cuda")
    torch.cuda.set_device(mesh.device)
    full = get_config("stablelm-1.6b")
    out = {"data": mesh.index("data"), "model": mesh.index("model")}

    # (a) the slice at full width and depth
    state = train_rank(fs_train_spec(full), "train", out, mesh, f"fsdp train rank {rank}")
    del state
    free_cuda()

    # (b) depth 2, f32: the FSDP run, then the same run in the replicated layout
    cfg = fs_agree_config(full)
    draws = np.load(f"{out_dir}/fs_draws.npy")
    state = train_rank(tp_agree_spec(cfg, draws), "agree", out, mesh, f"fsdp agree rank {rank}",
                       replay=False)
    fsdp = [state.params, state.opt_state["bufs"], state.delayed.ring]
    out["agree_digests"] = json.dumps([digest(t) for t in fsdp])
    with use_sharding_rules(mesh):
        p_all = gather_params(state.params, cfg, mesh)
    if rank == 0:
        np.save(f"{out_dir}/fs_params.npy", p_all.cpu().numpy())
    del state, p_all, fsdp
    free_cuda()
    SPEC_OPTIONS["replicate_params_over_data"] = True
    try:
        state = train_rank(tp_agree_spec(cfg, draws), "repl", out, mesh,
                           f"replicated agree rank {rank}", replay=False)
    finally:
        SPEC_OPTIONS["replicate_params_over_data"] = False
    out["repl_digests"] = json.dumps([digest(fsdp_cut(t, cfg, mesh)) for t in (
        state.params, state.opt_state["bufs"], state.delayed.ring)])
    del state
    free_cuda()

    # (c) serving at depth 2, f32, on the flash kernel
    with use_sharding_rules(mesh):
        got = seeded_serve(fs_serve_config(full), EP_PROMPT, FS_GEN, mesh.device, mesh)
    out.update({f"serve_{k}": v for k, v in saved(got).items()})
    del got

    # (d) gemma2-27b at batch 1, without and with seq_shard_cache, in the
    # serving layout (params replicated over data: no per-step gathers)
    with spec_options(replicate_params_over_data=True), use_sharding_rules(mesh):
        out.update(ssc_saved(ssc_serves("gemma2-27b", mesh.device, mesh)))
    np.savez(f"{out_dir}/{what}_{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


def fsdp_storage(root, full, main_summary=None):
    """Phase 17 (module docstring): FSDP storage over data on 2 ranks, data
    2 x model 1, against the plan, the replicated layout and one process."""
    import shutil

    import numpy as np

    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.run import run

    t_phase = time.perf_counter()
    out_dir = root / "build" / "fsdp"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    free_cuda()

    # one process: the depth-2 f32 run and the depth-2 f32 serve
    acfg = fs_agree_config(full)
    draws = np.random.default_rng(0).random((TP_AGREE_TICKS, W_WORKERS)).astype(np.float32)
    np.save(out_dir / "fs_draws.npy", draws)
    one_hook = TickLog("fsdp one process", replay=False)
    one_params = run(tp_agree_spec(acfg, draws), hooks=[one_hook]).state.params.cpu().numpy()
    one_losses = [r["loss"] for r in one_hook.rows]
    free_cuda()
    scfg = fs_serve_config(full)
    one_serve = seeded_serve(scfg, EP_PROMPT, FS_GEN, "cuda")
    one_ssc = ssc_serves("gemma2-27b", "cuda", use_pallas=False)["off"]

    # the plans: a rank's state bytes and peak, and its collective bytes
    # (seq_shard_cache's first: they set options, which the plan on a
    # thread reads)
    plan_ssc = ssc_plans("gemma2-27b", replicate_params_over_data=True)
    mesh21 = make_mesh((2, 1), ("data", "model"), device="meta")
    planning = alongside(D.plan_run, fs_train_spec(full, device="cpu"), mesh=mesh21)
    plan_train = train_plan(full, 4, 512, FS_TICKS, (2, 1))
    plan_agree = train_plan(acfg, 4, 512, TP_AGREE_TICKS, (2, 1))
    plan_serve = serve_plan(scfg, 4, EP_PROMPT, FS_GEN, (2, 1))

    wall = run_ranks(2, 2, 1, "fsdp", out_dir, target=fs_rank, timeout_s=FS_TIMEOUT_S)
    planned = planning.result()
    ranks = [dict(np.load(out_dir / f"fsdp_{r}.npz")) for r in range(2)]
    rows = {}

    # -- (a) training at full width and depth ----------------------------------
    for r in ranks:
        launches = json.loads(str(r["train_launches"]))
        check(launches["fused_tick"] == FS_TICKS and launches["fused_chain"] ==
              launches["fused_combine"] == launches["fused_update"] == 0,
              f"fsdp training: launches {launches}, expected {FS_TICKS} fused_tick alone")
        check(bool(np.isfinite(r["train_losses"]).all()), "fsdp training: a non-finite loss")
        check(bool(r["train_table_in_place"]), "fsdp training: the refresh replaced the table")
        check(int(r["train_state_bytes"]) == planned["memory"]["argument_bytes"],
              f"fsdp training: state bytes {int(r['train_state_bytes'])} != the plan's "
              f"{planned['memory']['argument_bytes']}")
        check(bytes_by_key(r["train_bytes"]) == plan_train,
              f"fsdp training: collective bytes {bytes_by_key(r['train_bytes'])} != the plan "
              f"{plan_train}")
    for k in ("train_losses", "train_taus", "train_tables", "train_cdfs", "train_hists"):
        check(np.array_equal(ranks[0][k], ranks[1][k]), f"fsdp training: ranks disagree on {k}")
    tables = ranks[0]["train_tables"]
    check(not np.array_equal(tables[1], tables[0]), "fsdp training: the refresh at tick 2 left "
          "the alpha table as it was")
    rows["train"] = dict(
        layout="data 2 x model 1, FSDP", ticks=FS_TICKS,
        median_tick_ms=[float(r["train_median_ms"]) for r in ranks],
        peak_gb=[float(r["train_peak_gb"]) for r in ranks],
        phase3_peak_gb=None if main_summary is None else main_summary["peak_gb"],
        planned_peak_gb=planned["memory"]["peak_bytes_per_card"] / 1e9,
        state_bytes=int(ranks[0]["train_state_bytes"]),
        phase3_state_bytes=None if main_summary is None else main_summary["state_bytes"],
        n_local=int(ranks[0]["train_n_local"]),
        fused_tick=[json.loads(str(r["train_launches"]))["fused_tick"] for r in ranks],
        losses=ranks[0]["train_losses"].tolist(), taus=ranks[0]["train_taus"].tolist(),
        collective_bytes=bytes_by_key(ranks[0]["train_bytes"]))
    log(f"[fsdp] (a) training {json.dumps(rows['train'])}")

    # -- (b) agreement at depth 2, f32 ------------------------------------------
    for r in ranks:
        check(str(r["agree_digests"]) == str(r["repl_digests"]),
              "fsdp agreement: the FSDP run's params, momentum or ring bits differ from the "
              "replicated run's blocks")
        check(np.array_equal(r["agree_losses"], r["repl_losses"]),
              f"fsdp agreement: losses {r['agree_losses']} != replicated {r['repl_losses']}")
        check(bytes_by_key(r["agree_bytes"]) == plan_agree,
              f"fsdp agreement: collective bytes {bytes_by_key(r['agree_bytes'])} != {plan_agree}")
        check(int(r["repl_n_local"]) == one_params.shape[0] > int(r["agree_n_local"]),
              f"fsdp agreement: replicated N_local {int(r['repl_n_local'])}, FSDP "
              f"{int(r['agree_n_local'])}, one process {one_params.shape[0]}")
    got_params = np.load(out_dir / "fs_params.npy")
    d_loss = max(float(np.max(np.abs(r["agree_losses"] - one_losses) / np.abs(one_losses)))
                 for r in ranks)
    d_params = float(np.abs(got_params - one_params).max())
    rows["agree"] = dict(layers=FS_AGREE_LAYERS, ticks=TP_AGREE_TICKS,
                         bitwise_equal_to_replicated=True, loss_rel=d_loss,
                         params_max_abs=d_params,
                         n_local=[int(ranks[0]["agree_n_local"]), int(ranks[0]["repl_n_local"])])
    log(f"[fsdp] (b) agreement {json.dumps(rows['agree'])}")
    check(d_loss <= 1e-6, f"fsdp agreement: loss {d_loss:.3e} relative past 1e-6")
    check(d_params <= 1e-5, f"fsdp agreement: params {d_params:.3e} past 1e-5 after "
          f"{TP_AGREE_TICKS} ticks")
    del got_params, one_params

    # -- (c) serving at depth 2, f32 ---------------------------------------------
    d_pre = d_dec = 0.0
    rows_per_rank = 4 // 2
    for r in ranks:
        sl = slice(int(r["data"]) * rows_per_rank, (int(r["data"]) + 1) * rows_per_rank)
        for got, want in ((r["serve_prefill"], one_serve["prefill"][sl]),
                          (r["serve_logits"], one_serve["logits"][sl])):
            err = float(np.max(np.abs(got - want) / (1e-4 + 1e-4 * np.abs(want))))
            if got.ndim == 2:
                d_pre = max(d_pre, err)
            else:
                d_dec = max(d_dec, err)
        check(np.array_equal(r["serve_tokens"], one_serve["tokens"][sl]),
              "fsdp serve: greedy ids differ from one process")
        flash = json.loads(str(r["serve_launches"]))["flash_attention"]
        check(flash == FS_SERVE_LAYERS,
              f"fsdp serve: {flash} flash launches, expected {FS_SERVE_LAYERS}")
        check(bytes_by_key(r["serve_bytes"]) == plan_serve,
              f"fsdp serve: collective bytes {bytes_by_key(r['serve_bytes'])} != {plan_serve}")
    rows["serve"] = dict(
        layout="data 2 x model 1, FSDP", layers=FS_SERVE_LAYERS, batch=4, prompt=EP_PROMPT,
        gen=FS_GEN, one_process=dict(prefill_s=one_serve["prefill_s"],
                                     decode_ms_per_step=one_serve["decode_ms_per_step"]),
        prefill_s=[float(r["serve_prefill_s"]) for r in ranks],
        decode_ms_per_step=[float(r["serve_decode_ms_per_step"]) for r in ranks],
        flash=[json.loads(str(r["serve_launches"]))["flash_attention"] for r in ranks],
        collective_bytes=bytes_by_key(ranks[0]["serve_bytes"]),
        logits_err_over_bound=max(d_pre, d_dec))
    log(f"[fsdp] (c) serve {json.dumps(rows['serve'])}")
    check(max(d_pre, d_dec) <= 1.0, f"fsdp serve: logits miss 1e-4 + 1e-4|ref| "
          f"({max(d_pre, d_dec):.3f} of the bound)")

    # -- (d) seq_shard_cache over data ----------------------------------------------
    rows["seq_shard_cache"] = ssc_check("fsdp", "gemma2-27b", ranks, one_ssc, plan_ssc)
    rows["wall_s"] = wall
    shutil.rmtree(out_dir, ignore_errors=True)
    rows["phase_s"] = time.perf_counter() - t_phase
    log(f"[fsdp] phase 17 took {rows['phase_s']:.1f} s")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs on the card only", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    import repro_torch  # noqa: F401  (sets TF32 off)
    from repro_torch.configs import get_config
    from repro_torch.kernels.adaptive_update import cuda as C
    from repro_torch.kernels.flash_attention import cuda as FA
    from repro_torch.kernels.nvcc import compile_libraries
    from repro_torch.kernels.rg_lru import cuda as RG
    from repro_torch.kernels.selective_scan import cuda as SS
    from repro_torch.training import param_template

    dev = torch.device("cuda")
    smi = nvidia_smi()
    log(f"card: {smi}  torch {torch.__version__} cuda {torch.version.cuda}")
    if sys.argv[1:2] == ["--fsdp"]:
        # phase 17 alone
        compile_libraries([C.SOURCE, FA.SOURCE], force=True, verbose=True)
        rows = fsdp_storage(root, get_config("stablelm-1.6b"))
        log(json.dumps({"fsdp": rows}))
        print(nvidia_smi())
        return 0
    if sys.argv[1:2] == ["--parallel"]:
        # phases 13 and 14 alone
        compile_libraries([C.SOURCE, FA.SOURCE], force=True, verbose=True)
        t0 = time.perf_counter()
        rows = {"expert_parallel": expert_parallel(root)}
        free_cuda()
        log(f"[time] phase 13: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        rows["tensor_parallel"] = tensor_parallel(root, get_config("stablelm-1.6b"),
                                                  {"losses": []})
        log(f"[time] phase 14: {time.perf_counter() - t0:.1f} s")
        log(json.dumps(rows))
        print(nvidia_smi())
        return 0
    if sys.argv[1:2] == ["--sharded-resume-layers"]:
        # phase 16 (a) alone, at the depth asked for
        compile_libraries([C.SOURCE], force=True, verbose=True)
        rows = sharded_resume(root, get_config("stablelm-1.6b"), layers=int(sys.argv[2]),
                              across=False)
        log(json.dumps({"sharded_checkpoints": rows}))
        print(nvidia_smi())
        return 0

    seconds = {}
    t_last = [time.perf_counter()]

    def took(phase):
        now = time.perf_counter()
        seconds[phase] = now - t_last[0]
        t_last[0] = now
        log(f"[time] phase {phase}: {seconds[phase]:.1f} s")

    # -- phase 1: build (one nvcc per source, all at once) -----------------------
    t0 = time.perf_counter()
    libs = compile_libraries([C.SOURCE, FA.SOURCE, RG.SOURCE, SS.SOURCE], force=True, verbose=True)
    log(f"[build] nvcc sm_90a {time.perf_counter() - t0:.1f}s -> "
        + ", ".join(str(lib.relative_to(root)) for lib in libs))
    took(1)

    # -- phase 2: each kernel against its plain version, full-width shapes ----
    n = sum(math.prod(shape) for shape, _ in _leaves(param_template(get_config("stablelm-1.6b"))))
    check(n == 1_438_846_976, f"full-width N is {n}")
    results = {}
    for kind in ("sgd", "momentum", "adam"):
        for ring_dtype in (torch.float32, torch.bfloat16):
            r = check_tick(kind, ring_dtype, n, dev)
            tag = f"fused_tick/{kind}/{str(ring_dtype).split('.')[-1]}"
            results[tag] = r
            log(f"[kernel] {tag}: max_abs_err {r['max_abs_err']:.3e}  {r['ms']:.3f} ms  plain "
                f"{r['plain_ms']:.3f} ms  bound {r['bound_ms']:.3f} ms ({r['bytes'] / 1e9:.2f} GB)")
            free_cuda()
    r = check_tick("momentum", torch.bfloat16, n, dev, nan_dead=True)
    results["fused_tick/momentum/bfloat16/nan-dead-slots"] = r
    log(f"[kernel] fused_tick/momentum/bfloat16 with NaN in dead slots {DEAD_SLOTS}: p and v "
        f"finite, max_abs_err {r['max_abs_err']:.3e} against the plain version")
    free_cuda()
    for kind in ("sgd", "momentum", "adam"):
        r = check_chain(kind, n, dev)
        results[f"fused_chain/{kind}"] = r
        log(f"[kernel] fused_chain/{kind}: bitwise equal (max_abs_err {r['max_abs_err']:.3e})  "
            f"{r['ms']:.3f} ms  plain {r['plain_ms']:.3f} ms  bound {r['bound_ms']:.3f} ms  library "
            f"{r['library_ms']:.3f} ms ({r['library_call']})  {stream_line(r)}")
        free_cuda()
    n_odd = n - 5  # n % 8 == 3: the vector body and a scalar tail of n % 4 = 3
    results["fused_chain/momentum/n-5"] = r = check_chain("momentum", n_odd, dev, timed=False)
    log(f"[kernel] fused_chain/momentum at N = {n_odd} (N % 8 = {n_odd % 8}): bitwise equal")
    free_cuda()
    results["fused_combine/bfloat16"] = r = check_combine(n, dev)
    log(f"[kernel] fused_combine/bfloat16: max_abs_err {r['max_abs_err']:.3e}  {r['ms']:.3f} ms  "
        f"plain {r['plain_ms']:.3f} ms  bound {r['bound_ms']:.3f} ms")
    free_cuda()
    results["fused_update"] = r = check_update(n, dev)
    log(f"[kernel] fused_update: bitwise equal (max_abs_err {r['max_abs_err']:.3e})  "
        f"{r['ms']:.3f} ms  plain {r['plain_ms']:.3f} ms  bound {r['bound_ms']:.3f} ms  library "
        f"{r['library_ms']:.3f} ms ({r['library_call']})  {stream_line(r)}")
    free_cuda()
    results["fused_update/n-5"] = check_update(n_odd, dev, timed=False)
    log(f"[kernel] fused_update at N = {n_odd}: bitwise equal")
    log("[kernel] fused_tick and fused_combine: library null (no one PyTorch call pushes a ring "
        "and combines W weighted rows)")
    free_cuda()
    log(f"[kernels] all {len(results)} variants hold against their plain versions")
    took(2)

    # -- phase 3: the main path, full width -------------------------------------
    full = get_config("stablelm-1.6b")
    check(full.num_layers == 24 and full.d_model == 2048, "not the full-width config")
    summary, main_counts = main_path(full, n)
    log("[main] " + json.dumps({k: v for k, v in summary.items() if k != "losses"}))
    free_cuda()
    small_agreement()
    free_cuda()
    took(3)

    # -- phase 4: the other kernels through their own paths ---------------------
    path_counts = other_paths(dataclasses.replace(full, num_layers=2))
    free_cuda()
    took(4)

    # -- phase 5: the serving kernels against their plain versions --------------
    flash_shapes = {  # B, S, T, Nq, Nkv, H, causal, window, softcap, dtype
        "flash_attention/recurrentgemma-9b": (4, 4096, 4096, 16, 1, 256, True, 2048, None,
                                              torch.bfloat16),
        "flash_attention/recurrentgemma-9b/f32": (1, 4096, 4096, 16, 1, 256, True, 2048, None,
                                                  torch.float32),
        "flash_attention/stablelm-1.6b": (4, 512, 512, 32, 32, 64, True, None, None,
                                          torch.bfloat16),
        "flash_attention/gemma2-like/causal": (2, 1000, 1000, 32, 16, 128, True, 64, 50.0,
                                               torch.float32),
        "flash_attention/gemma2-like/noncausal": (2, 1000, 1000, 32, 16, 128, False, 64, 50.0,
                                                  torch.float32),
        "flash_attention/gemma2-like/causal/bf16": (2, 1000, 1000, 32, 16, 128, True, 64, 50.0,
                                                    torch.bfloat16),
        "flash_attention/gemma2-like/noncausal/bf16": (2, 1000, 1000, 32, 16, 128, False, 64,
                                                       50.0, torch.bfloat16),
        "flash_attention/s-ne-t/bf16": (1, 77, 150, 4, 4, 256, False, 40, None, torch.bfloat16),
        "flash_attention/whisper-large-v3/encoder": (4, 1500, 1500, 20, 20, 64, False, None, None,
                                                     torch.bfloat16),
        "flash_attention/qwen2-moe-a2.7b": (4, 512, 512, 16, 16, 128, True, None, None,
                                            torch.bfloat16),
        "flash_attention/internvl2-2b": (4, 768, 768, 16, 8, 128, True, None, None,
                                         torch.bfloat16),
    }
    for tag, shape in flash_shapes.items():
        results[tag] = r = check_flash(*shape, dev)
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.3f} ms"
        log(f"[kernel] {tag}: max_abs_err {r['max_abs_err']:.3e} (tol {r['tol']})  "
            f"{r['ms']:.3f} ms  plain {r['plain_ms']:.3f} ms  bound {r['bound_ms']:.3f} ms "
            f"({r['bound_by']}: {r['flops'] / 1e9:.1f} GFLOP, {r['bytes'] / 1e6:.1f} MB)  "
            f"{r['tflops']:.1f} TFLOP/s of band work, {100 * r['bound_ms'] / r['ms']:.1f} % of "
            f"the bound  sdpa {lib}")
        free_cuda()
    log("[kernel] flash_attention/recurrentgemma-9b: the earlier CUDA-core bf16 body took "
        "36.978 ms at this shape (PERF.md section 6, row 5; not measured in this run)")
    results["rg_lru"] = r = check_rg_lru(4, 4096, 4096, dev)
    log(f"[kernel] rg_lru: max_abs_err {r['max_abs_err']:.3e}  {r['ms']:.3f} ms  plain "
        f"{r['plain_ms']:.3f} ms  bound {r['bound_ms']:.3f} ms ({r['bytes'] / 1e6:.1f} MB)")
    free_cuda()
    scan_shapes = {  # B, S, D, N, u dtype
        "selective_scan/falcon-mamba-7b": (4, 4096, 8192, 16, torch.bfloat16, "model"),
        "selective_scan/falcon-mamba-7b/random-A": (4, 4096, 8192, 16, torch.bfloat16, "random"),
        "selective_scan/odd/f32": (2, 1000, 1000, 16, torch.float32, "model"),
    }
    for tag, (*shape, a_init) in scan_shapes.items():
        results[tag] = r = check_selective_scan(*shape, dev, a_init=a_init)
        terms = ", ".join(f"{k} {v:.3f} ms" for k, v in r["bound_terms_ms"].items())
        log(f"[kernel] {tag}: max_abs_err {r['max_abs_err']:.3e} (tol 3e-5 + 3e-5|plain|)  "
            f"{r['ms']:.3f} ms  plain {r['plain_ms']:.3f} ms  bound {r['bound_ms']:.3f} ms, set "
            f"by the {r['bound_set_by']} ({terms}; SM clock {SM_CLOCK_HZ / 1e9:.2f} GHz)  "
            f"{r['exps_per_s'] / 1e12:.3f} T exponentials/s of the SFU's "
            f"{SFU_EXP_PER_S / 1e12:.3f} T/s ({100 * r['exps_per_s'] / SFU_EXP_PER_S:.1f} %)")
        free_cuda()
    witness_delta_ranges(dev)
    took(5)

    # -- phase 6: serving at full width, through the launcher --------------------
    serving = [
        serve_full("recurrentgemma-9b", 4, 4096, 32,
                   {"flash_attention": 12, "rg_lru": 26, "selective_scan": 0}),
        serve_full("stablelm-1.6b", 4, 512, 32,
                   {"flash_attention": 24, "rg_lru": 0, "selective_scan": 0}),
        serve_full("falcon-mamba-7b", 4, 4096, 32,
                   {"flash_attention": 0, "rg_lru": 0, "selective_scan": 64}),
        serve_full("qwen2-moe-a2.7b", 4, 512, 32,
                   {"flash_attention": 24, "rg_lru": 0, "selective_scan": 0}),
        serve_full("internvl2-2b", 4, 512, 32,
                   {"flash_attention": 24, "rg_lru": 0, "selective_scan": 0}),
        serve_full("whisper-large-v3", 4, 32, 32,
                   {"flash_attention": 32, "rg_lru": 0, "selective_scan": 0}),
    ]
    agreement = {}
    for arch in ("recurrentgemma-9b", "falcon-mamba-7b", "qwen2-moe-a2.7b", "internvl2-2b",
                 "whisper-large-v3", "gemma2-27b"):
        agreement[arch] = serve_agreement(arch)
        free_cuda()
    took(6)

    # -- phase 7: checkpoint and resume on the main path, full width ------------
    (root / "build").mkdir(exist_ok=True)
    resume = resume_path(full, n, root / "build")
    took(7)

    # -- phase 8: the exact simulator on the card against the CPU ----------------
    exact = exact_simulator()
    took(8)

    # -- phase 9: the sharded async engine at full width --------------------------
    free_cuda()
    sharded, sharded_counts = sharded_path(full, n)
    log("[sharded] " + json.dumps({k: v for k, v in sharded.items() if k != "losses"}))
    free_cuda()
    sharded["agreement"] = {W: sharded_agreement(W) for W in (2, 4)}
    free_cuda()
    took(9)

    # -- phase 10: the paper's CNN and its experiments ----------------------------
    cnn = cnn_agreement()
    cnn.update(cnn_experiments())
    free_cuda()
    took(10)

    # -- phase 11: the live parameter server ----------------------------------------
    live, live_counts = live_path(full, n, root / "build")
    log("[live] " + json.dumps({k: v for k, v in live.items() if k != "losses"}))
    free_cuda()
    live["agreement"] = live_agreement(root / "build")
    free_cuda()
    took(11)

    # -- phase 12: the planner against the card -----------------------------------
    plan = plan_against_card(full, summary, serving[3], sharded)
    took(12)

    # -- phase 13: expert parallelism on the card ---------------------------------
    ep = expert_parallel(root)
    free_cuda()
    took(13)

    # -- phase 14: dense tensor parallelism on the card ----------------------------
    tp = tensor_parallel(root, full, summary)
    free_cuda()
    took(14)

    # -- phase 15: tensor parallelism of the other families ------------------------
    families = other_families(root)
    free_cuda()
    took(15)

    # -- phase 16: checkpoint and resume of multi-process training states ----------
    sharded_ckpt = sharded_resume(root, full)
    free_cuda()
    took(16)

    # -- phase 17: FSDP storage over data -------------------------------------------
    fsdp = fsdp_storage(root, full, summary)
    free_cuda()
    took(17)
    log(f"[time] phases {json.dumps({k: round(v, 1) for k, v in seconds.items()})}, "
        f"{sum(seconds.values()):.1f} s in all")

    launches = {
        "fused_tick": ("main", main_counts["fused_tick"]),
        "fused_chain": ("sharded_async (phase 9)", sharded_counts["fused_chain"]),
        "fused_combine": ("async_fuse_clip", path_counts["async_fuse_clip"]["fused_combine"]),
        "fused_update": ("async_fused_apply", path_counts["async_fused_apply"]["fused_update"]),
    }
    on_path = {
        "fused_tick": "fused_tick/momentum/bfloat16",
        "fused_chain": "fused_chain/momentum",
        "fused_combine": "fused_combine/bfloat16",
        "fused_update": "fused_update",
    }
    rg_path = "serve recurrentgemma-9b (one prefill)"
    launches.update({
        "flash_attention": (rg_path, serving[0]["launches"]["flash_attention"]),
        "rg_lru": (rg_path, serving[0]["launches"]["rg_lru"]),
    })
    on_path.update({"flash_attention": "flash_attention/recurrentgemma-9b", "rg_lru": "rg_lru"})
    launches["selective_scan"] = ("serve falcon-mamba-7b (one prefill)",
                                  serving[2]["launches"]["selective_scan"])
    on_path["selective_scan"] = "selective_scan/falcon-mamba-7b"
    kernels = []
    for name, key in on_path.items():
        r = results[key]
        path, count = launches[name]
        check(count > 0, f"{name} was never launched on its path")
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES.get(name, SOURCE), replaces=REPLACES[name],
            launches=count, max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r.get("bound_by", "bytes"),
            bound_set_by=r.get("bound_set_by", r.get("bound_by", "bytes")),
            library_ms=r.get("library_ms"), variant=key, path=path,
        ))
    flash_paths = {f"serve {row['arch']} (one prefill)": row["launches"]["flash_attention"]
                   for row in serving if row["launches"]["flash_attention"]}
    flash_paths["expert-parallel serve, qwen2-moe-a2.7b at 4 layers (each of 2 ranks)"] = \
        ep["serve"]["two_ranks"]["flash"][0]
    flash_paths["tensor-parallel serve, stablelm-1.6b, data 1 x model 2 (each of 2 ranks)"] = \
        tp["serve"]["flash"][0]
    flash_paths[f"FSDP serve, stablelm-1.6b at {FS_SERVE_LAYERS} layers, data 2 x model 1 (each "
                "of 2 ranks)"] = fsdp["serve"]["flash"][0]
    flash_paths[f"sequence-parallel serve, stablelm-1.6b at {TP_AGREE_LAYERS} layers, data 1 x "
                "model 2 (each of 2 ranks)"] = tp["sp_serve"]["flash"][0]
    by_path = {name: {} for name in ("flash_attention", "rg_lru", "selective_scan")}
    for arch in OF_SERVES:
        where = (f"tensor-parallel serve, {arch} at {OF_SERVES[arch][0]} layers, data 1 x model 2 "
                 "(each of 2 ranks)")
        for name, count in families[arch]["launches"][0].items():
            if count:
                by_path[name][where] = count
    for arch, row in (("recurrentgemma-9b", families["seq_shard_cache"]),
                      ("gemma2-27b", fsdp["seq_shard_cache"])):
        layers, batch, prompt, (data, model), _ = SSC_SERVES[arch]
        where = (f"seq_shard_cache serve, {arch} at {layers} layers, {batch} x {prompt}, data "
                 f"{data} x model {model} (each of 2 ranks)")
        for name, count in row["on"]["launches"][0].items():
            if count:
                by_path[name][where] = count
    flash_paths.update(by_path["flash_attention"])
    kernels[[k["name"] for k in kernels].index("flash_attention")]["launches_by_path"] = \
        flash_paths
    for name in ("rg_lru", "selective_scan"):
        kernels[[k["name"] for k in kernels].index(name)]["launches_by_path"] = {
            launches[name][0]: launches[name][1], **by_path[name]}
    kernels[[k["name"] for k in kernels].index("fused_tick")]["launches_by_path"] = {
        "main (phase 3)": main_counts["fused_tick"],
        "tensor-parallel training, data 1 x model 2 (each of 2 ranks)": tp["train"]["fused_tick"][0],
        f"tensor-parallel training, data 2 x model 2, FSDP, {TP_DXM_LAYERS} layers (each of 4 "
        "ranks)": tp["data_x_model"]["fused_tick"][0],
        f"tensor-parallel training, falcon-mamba-7b at {OF_TRAIN_LAYERS} layers, data 1 x model 2 "
        "(each of 2 ranks)": families["train"]["fused_tick"][0],
        "tensor-parallel training saved at step 3 and resumed, data 1 x model 2 (phase 16, run "
        "A + run B, each of 2 ranks)": sum(sharded_ckpt["same_layout"]["fused_tick"][0]),
        "FSDP training, data 2 x model 1 (each of 2 ranks)": fsdp["train"]["fused_tick"][0],
        f"weights-stationary training, qwen2-moe-a2.7b at {WS_LAYERS} layers, data 2 x model 2 "
        "(each of 4 ranks)": ep["ws_training"]["fused_tick"][0],
        f"sequence-parallel training, stablelm-1.6b at {TP_AGREE_LAYERS} layers, data 1 x model 2 "
        "(each of 2 ranks)": tp["sp_agree"]["fused_tick"][0]}
    kernels[[k["name"] for k in kernels].index("fused_chain")]["launches_by_path"] = {
        "sharded_async": sharded_counts["fused_chain"],
        "sync_fuse": path_counts["sync_fuse"]["fused_chain"],
        "async_fuse_clip": path_counts["async_fuse_clip"]["fused_chain"],
        "distributed": live_counts["fused_chain"]}
    log(json.dumps({"variants": results, "main": summary, "serving": serving,
                    "agreement": agreement, "resume": resume,
                    "exact": exact, "sharded": sharded, "cnn": cnn, "live": live,
                    "plan": plan, "expert_parallel": ep, "tensor_parallel": tp,
                    "tensor_parallel_families": families, "sharded_checkpoints": sharded_ckpt,
                    "fsdp": fsdp, "seconds": seconds},
                   default=str))
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    from repro_torch.tree import tree_leaves

    return tree_leaves(tree)


if __name__ == "__main__":
    sys.exit(main())
