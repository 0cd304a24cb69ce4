#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--baseline DIR]

``--baseline DIR``: DIR holds sources of an earlier version of the port
(for instance ``git archive <commit> src/repro_torch/csrc | tar -x -C DIR
--strip-components=3``, then keep the ones to compare); whichever of
``rmsnorm.cu`` and ``quant_aggregate.cu`` with PR 13's C entry points and
``flash_attention.cu`` with PR 12's (the CUDA-core B3, up to PR 20) it
holds are built from it and timed beside this tree's, in turns (old, new,
new, old).

Phases, in order; any failure exits non-zero and prints no result:

1. device  — a CUDA card must be present; prints its name, count and power
   limit, and the TF32 flags the entry points set.
2. build   — compiles every kernel under ``src/repro_torch/csrc/`` with nvcc
   (all at once, with an empty kernel for the launch floor and the baseline's
   kernels) into ``build/repro_torch/``; prints the build seconds, the
   compiler's register/spill report, and the count of tensor-core
   instructions in the flash kernels' machine code (``HGMMA`` in the wgmma
   forward and in the backward, TF32 ``HMMA`` in the tf32x3 forward: none
   may be missing).
3. kernels — each kernel against its plain PyTorch version on the card:
   quant_aggregate bitwise at the shapes the FL path and the aggregation
   benchmark use, plus a ragged tail and a single client, with its launch
   plan and other tiles timed at the main shape; rmsnorm, flash
   attention and decode attention within ``tests/test_kernels.py``'s
   tolerances at its shapes (f32 and bf16: MHA, GQA, MQA with Sq != Sk and
   q_offset, Dk != Dv, full attention, a decode row of length 0, ragged
   lengths, decode lengths at the split boundaries) and at the serve path's
   shapes in bf16. Flash attention in bf16 with head dims that are
   multiples of 8 runs the wgmma kernel, f32 and the other bf16 dims the
   tf32x3 kernel (three TF32 passes on mma.sync), as
   ``flash_attention.launch_plan`` names it; the tf32x3 kernel is also
   run on the bf16 inputs of every wgmma check, and timed in bf16 at the
   serve shape beside wgmma. Then (slice 11) the tf32x3 kernel in f32 at
   the two shapes the f32 card-vs-CPU phases launch (reduced GQA and
   reduced MLA), and, kernel-level only, at yi-34b's serve shape and at
   MLA's absorbed dims, against its plain version and timed
   beside its bound at both rates (f32 CUDA cores; three TF32 passes on
   the tensor cores), SDPA in f32 and, with ``--baseline``, PR 12's
   kernel. Decode attention splits the cache over CTAs and
   combines the splits in the same call; it is also held to ``plain_split``,
   the PyTorch mirror of that split. Times with CUDA events
   (L2 flushed before every launch) beside the bound: device time with the
   host queued ahead, the kernel's time per call with the host's launch
   overhead in it, the plain version's time, and the one PyTorch call that
   computes the same function (a yardstick the port never calls). rmsnorm
   is timed at prefill's and decode's row counts (each with its launch
   plan), at decode also with x warm in L2 and with the other layouts forced,
   beside an empty kernel's time in the same harness (the launch floor).
4. FL path (slice 1) — the FL round loop at the full width of flsim-cnn
   through ``load_job`` -> ``Executor(...).scaffold().run()``, once with
   fedavg and once with int8 compression; losses finite and falling, the
   int8 kernel launched once per round on the int8 job and never on the
   fedavg job. Then one int8 round on the card against the same round on
   the CPU.
5. determinism — the int8 job again with one round per launch: bitwise the
   losses and params of the 3+3 chunking. Then one warm int8 round under
   ``torch.profiler``: device time by kernel and the device's idle share.
6. slice 5 — B1 at the shapes of its new call sites, bitwise against its
   plain version and timed beside the empty kernel: a FedBuff flush (10 x
   189,952), the same with zero rows and zero coefficients, packed FedAsync
   (1 x 189,952). The counter-based hash gives the same bits on the card as
   on the CPU. Then, at MAIN_JOB's width through ``load_job`` ->
   ``Executor``: every strategy and topology for 3 rounds (losses finite,
   falling where the JAX package's fall at test size; chunks of 1 bitwise
   chunks of 3 for scaffold, decentralized gossip and DP), temporal
   placement (fedavg and int8, B1 once per int8 round), FedBuff (buffer 10)
   and FedAsync on int8 under heterogeneity (B1 once per flush and once per
   event; chunks of 1 bitwise chunks of 2; events per second; one FedBuff
   round under ``torch.profiler``), the FedBuff
   identity with sync temporal FedAvg (20 clients, bitwise), and a run
   resumed from a checkpoint at round 2 of 4 (bitwise the uninterrupted one).
7. control plane (slice 6) — the draws consensus makes (normals, a digest
   projection, a poisoned flsim-cnn) equal on the card and the CPU; then at
   MAIN_JOB's width: int8 with majority_digest at W = 3 (one byzantine
   worker) and a hash-chain ledger, chunks of 3 and of 1; fedavg with median
   and with trimmed_mean at W = 4; temporal int8 with majority_digest at
   W = 3 (2 rounds): each bitwise its W = 1 twin, B1 once per int8 round, a
   verified chain with one block per chunk and the same final digest for
   both chunkings; a W = 2 tie that takes the poisoned aggregate; FedBuff
   int8 with a digest every 5 events, chunks of 1 and of 2: the same digest
   marks; the comms plane on == off bitwise for a spatial, a temporal and
   the FedBuff job (last comms rows printed); round_s beside the W = 1
   twins', the ledger's ms per chunk, one W = 3 round profiled; then
   ``repro_torch.launch.byzantine`` and ``repro_torch.launch.gossip``.
8. campaigns and observability (slice 7) — B1 over 4 lanes of 100 x
   189,952 in one launch, bitwise its plain version and four single
   launches, timed beside them and its bound; an int8 sweep {seed: [0, 1],
   client_lr: [0.05, 0.1]} through ``CampaignExecutor`` (3 rounds, chunks of
   3 and of 1 bitwise, one B1 launch per round for all lanes, each lane
   against its single run); a ``PlanExecutor`` over strategy x mode x seed
   (fedavg/fedprox, sync/FedBuff) with successive halving at round 2, and
   the same plan resumed from its checkpoint and decision journal; the
   flight recorder and the probes on == off bitwise for spatial, temporal
   and FedBuff int8, a ``torch.profiler`` trace of one launch holding B1,
   and the telemetry report.
9. streaming client plane (slice 8) — B1 at the ragged plane's shapes (C =
   25 and 128 slots of 189,952, lanes (4, 25, 189,952); pads at weight 0),
   bitwise its plain version and timed beside its bound; then at MAIN_JOB's
   width with ``max_cohort: 25`` and int8 without error feedback, resident
   and streaming, chunks of 3 and of 1 (6 rounds): all four bitwise, B1
   once a round; the stager's host plan and assembly seconds and the side
   stream's copy ms per chunk, the peak slab against full residency, and two
   warm streaming chunks under ``torch.profiler`` (do the slab copies run
   under the kernels?); a ``synthetic_population`` of 1,000,000
   CIFAR-shaped clients (98 GB if staged) streamed at cohort 100 of 128
   slots (4 rounds in chunks of 2; peak slab under 1 % of residency, losses
   falling); FedBuff and FedAsync int8 on the ragged plane, resident and
   streaming, each bitwise the dense run; a ragged sweep cohort [10, 20] x
   seed [0, 1] (one launch key, one (4, 25, N) B1 launch a round,
   streaming lanes == resident lanes, lanes near their single runs).
10. LM training path (slice 9) — B3 forward + the ported backward and B2
   forward + backward under autograd against autograd through their plain
   versions (B3 at the training shape 2 x 2048, 40/8 heads of 128, bf16; a
   ragged shape; f32; B2 at rows of 5120 and qk-norm rows of 128), and
   under ``vmap(grad)`` over a dim of 1 and 2 against the loop (one launch
   each per call); their times beside SDPA and F.rms_norm forward and
   forward + backward; B3's backward kernel at yi-34b's round shape (B 2,
   S 4,096, 56/8 heads of 128) and the training shape (B 2, S 2,048, 40/8):
   two calls bitwise, within GRAD_TOL of ``plain_bwd``, timed beside its
   five-product bound, ``plain_bwd`` and SDPA forward + backward; then
   ``repro_torch.launch.train_fl_lm``'s temporal
   FedAvgM rounds on qwen2.5-32b at its published width (d_model 5120,
   40/8 heads, d_ff 27648, vocab 152064, QKV bias), depth cut 64 -> 2,
   bf16: 4 clients, cohort 2, 2 local steps of 2 x 2048 tokens, 3 rounds on
   fixed client data; B2 and B3 launches per round asserted (each layer's
   twice a local step: the client's gradient is plain autograd with each
   layer recomputed in the backward), round_s, tokens/s, peak memory,
   losses finite, a second run bitwise, one warm round profiled, one local
   step's gradient memory (the remat'd autograd step beside
   ``torch.func.grad_and_value`` and the recorded un-remat'd peak); one
   round of reduced qwen2.5-32b and chameleon-34b in f32 on the card and
   the CPU (losses and params within 1e-4); and
   qwen2.5-32b and chameleon-34b served at full width (2 layers, bf16,
   batch 2 x prompt 128 + 8 new; launches asserted, qk-norm's too; tokens
   bitwise repeatable).
11. MLA and MoE (slice 10) — B3 at MLA's shapes, on the MLA layer's own
   inputs, against its plain version in bf16 and in f32 and timed beside
   its bound and SDPA (the backend it took named; SDPA's inputs prepared
   outside the timed call): the absorbed form (288, 256) at the serve shape
   (8 x 2048, 40 heads on one kv head) and the training shape (2 x 2048;
   the ported backward too) and the expanded form (96, 64) on the wgmma
   kernel (the expanded form also beside PR 12's kernel with
   ``--baseline``); B2 at each row width these paths give it
   (2560, 768, MLA's kv_norm 256 sliced from 288-wide rows, 2048, qk-norm
   128) at prefill, decode and training rows, and B4 at qwen3-moe's decode
   layer (8 x 2112 cache, 32 heads on 4 kv heads of 128, ragged lengths),
   each against its plain version and timed beside its bound and the
   PyTorch call; then minicpm3-4b (MLA, tied embeddings) served at full
   width, depth cut 62 -> 16 (phase 13 trains all 62; bf16, batch 8 x
   prompt 2048 + 64 new; B2 4 x 16 + 1 a forward, counted by width, B3 16
   on wgmma, no B4: MLA decodes with einsums; tokens bitwise repeatable)
   with layer 0's expanded form (``mla_seqsharded(absorbed=False)``, one
   wgmma launch) beside its absorbed form; qwen3-moe-30b-a3b (2 of 48 layers) trained as phase 10
   trains qwen2.5-32b (3 rounds, losses finite and falling, a second run
   bitwise, one round profiled); qwen3-moe-30b-a3b
   served (4 of 48 layers, 128 experts top-8, batch 8 x 2048 + 64 new;
   drop fraction per layer at prefill); reduced minicpm3-4b,
   qwen3-moe-30b-a3b and arctic-480b one f32 round and a served prompt on
   the card and the CPU.
12. the last three LM families (slice 12) — ``determinism.normal``'s two
   halves (``_log_u1``, ``_cos_2pi_u2``) bitwise card == CPU over all 2**24
   inputs each, beside the count of f64 ``torch.log``/``torch.cos`` values
   that differ (C7); B3, B4 and B2 at every new shape in bf16 against their
   plain versions, timed beside SDPA / ``F.rms_norm`` and the bound
   (whisper's encoder 8 x 1,500 full, cross-attention 187 over 1,500 full,
   decoder 187 causal, all 8/8 x 64; jamba's 8 x 2,048 causal, 64/8 x 128;
   B4 over whisper's self cache (251) and encoder cache (1,500) at G = 1 and
   jamba's 2,049 at G = 8; B2 at 768 and 8,192, prefill and decode rows);
   whisper-base at full width and depth (6 + 6 layers, bf16) served over
   1,500 frames, batch 8, a 187-token prompt and 64 greedy tokens (B3 18,
   B4 768, counted by shape; tokens bitwise repeatable) and its loss
   gradient at batch 8 under ``torch.func.grad_and_value`` (with the
   gradient memory lines of phase 10); xlstm-125m at full width and one
   sLSTM period (4 of 12 layers since slice 19) served (batch 8, prompt
   2,048, 64 new; B2 5 x 65 by rows), the sLSTM's launches a token (one
   layer profiled), one temporal
   FedAvgM round of ``train_fl_lm`` (4 local steps of 2 x 512, losses
   finite; B2 twice a period's norm, the recompute's); jamba-1.5-large-398b's
   attention sublayer and one Mamba mixer
   at full width (8 x 2,048 prefill and a decode step, counted and timed;
   a full-width period's ~77 GB of bf16 MoE weights exceed the card); the
   three reduced archs in f32 on the card against the CPU.
13. the rematerialized LM step and int8 LM sends (slice 13) — B1 at the
   int8 LM round's shape, (2, 2,193,689,088) (minicpm3-4b's packed delta at
   32 layers, past 2**31), bitwise its plain version over every column slice of 2**27
   and timed beside its bound; qwen3-moe-30b-a3b's MoE FFN at full width
   twice on one batch, outputs and routing bitwise (the backward's
   recompute routes as the forward did); B2 at minicpm3-4b's train rows
   (2 x 2048 of 2560, 768 and 256 sliced from 288); then minicpm3-4b at its
   published width and 32 of its 62 layers (2.19 B params, bf16; all 62
   until slice 19, cut for the script's time) through
   ``train_fl_lm.setup`` and ``run_rounds``, phase 10's temporal FedAvgM
   round (4 clients, cohort 2, 2 local steps of 2 x 2048, 3 rounds, fixed
   data), then with int8 sends (``strategy: compressed``) from the same
   initial params: B2 and B3 by shape, each layer's forward and its
   recompute (``train_launches``), B1 once a round at (2, N); round_s,
   tokens/s, peak memory; losses finite and falling; then minicpm3-4b at
   8 layers as phase 10 trains qwen2.5-32b (the cut depth: a second run
   bitwise, one round profiled, the gradient memory lines).
14. the mesh runtime (slice 14) — a world-1 rank over NCCL
   (``launch.mesh.spawn``): on a (1, 1) ``("data", "model")`` mesh on the
   card, MAIN_JOB's int8 round (100 clients, cohort 20) bound to the mesh
   for 3 rounds, client-server and hierarchical, bitwise the meshless
   ``build_spatial_round`` (losses, params, B1 once a round), round_s of
   both printed; ``Decentralized.mix`` on the card's mesh bitwise a (1, 1)
   CPU ``gloo`` mesh's; the round's NCCL ``all_reduce`` timed; the spatial
   train step (``launch.steps.make_train_step``) of xlstm-125m (8 x 2,048,
   one sLSTM period: 4 of 12 layers) and whisper-base (8 x 1,500 frames,
   187 decoder tokens, full depth) at published width, bf16, bitwise the
   meshless round on the same inputs (step seconds, tokens/s, peak memory, B2/B3 by shape). Then two
   lane ranks sharing the card (``gloo`` for host objects): phase 8's int8
   sweep at ``lane_devices = 2``, each rank's block bitwise a one-process
   campaign of its two lanes and within LANE_LOSS_RTOL of phase 8's S = 4
   campaign, ``campaign.csv`` written once, the checkpoint resumed in one
   process, the halving plan's drops the same as at 0. B1 at the block's
   (2, 100, 189,952) and B2/B3 at the LM steps' shapes against their plain
   versions, timed beside the bound and the PyTorch call.
15. the temporal placement on a mesh (slice 15) — a world-1 rank over NCCL
   on a (1, 1) ``("data", "model")`` mesh, yi-34b at published width in
   bf16 (weights drawn on the card): ``launch.steps.make_train_step``'s
   temporal step (4 of 60 layers, one FedAvg round of one local step of 2
   x 2,048 tokens over the whole vocab; per-layer ZeRO-3 gathers inside
   each layer's checkpoint, the sequence-sharded attention, the exact
   sharded embedding and loss, the gradient sync) bitwise the meshless
   ``build_temporal_round`` (loss and every new param; B2 and B3 counted:
   each layer's forward and recompute); ``make_prefill_step`` and 16
   ``make_decode_step`` steps with ``greedy_token`` (8 of 60 layers, batch
   8, prompt 2,048; B4 at ``combine=False`` then the shards' log-sum-exp
   combine) bitwise meshless ``Model.prefill``/``decode_step`` (every
   logits tensor, the tokens, the caches; B2-B4 counted). Then B2, B3 and
   B4 at every shape those runs launched, and, kernel-level, at one rank's
   shapes on a 4-rank model axis (B3 over 512 of 2,048 rows at q_offset 0
   and 1,536; B4 over a 512-key shard at lengths 0, 1, 300, 512), against
   their plain versions, timed beside the bound, the plain version and
   SDPA (the same mask) / ``F.rms_norm``.
15b. MLA and the MoE FFN's expert parallelism on a mesh (slice 16) — the
   world-1 NCCL rank on the (1, 1) mesh, bf16 at published width, weights
   drawn on the card: minicpm3-4b (MLA, tied embeddings: the gathered
   embedding, the latent rows gathered along the sequence, the shards'
   latent log-sum-exp combine) and qwen3-moe-30b-a3b (the experts'
   all-to-alls over ``model``), each's temporal train step (8 and 2
   layers, one local step of 2 x 2,048) and prefill of 8 x 2,048 with 16
   decode steps (16 and 4 layers), bitwise its meshless twin, B2-B4
   counted; one MoE layer of jamba-1.5-large-398b at published width (16
   experts of d_ff 24,576, ~19.3 GB) over 8 x 2,048 tokens through the
   grid ring, bitwise the meshless ``moe_ffn``, and ``quant_ring``'s
   accumulator within half an int8 step plus bf16 rounding. Then B2, B3 and
   B4 at every shape those runs launched, and, kernel-level, B3 at MLA's
   (288, 256) over 512 of 2,048 rows at q_offset 0 and 1,536 (B 8) and B4
   at qwen3-moe's heads over a 512-key shard with rows of length 0, against
   their plain versions, timed.
15c. The hybrid, ssm and encdec families on a mesh (slice 17) — the
   world-1 NCCL rank on the (1, 1) mesh, bf16 at published width, weights
   drawn on the card: whisper-base at full depth (the encoder and decoder
   sequence-sharded, the cross decode's B4 over the encoder cache shard and
   the shards' combine), a prefill of 8 x 1,500 frames (decoder prompt 187)
   and 16 decode steps; xlstm-125m at full depth, a prefill of 8 x 2,048
   and 8 decode steps; each through ``make_prefill_step`` /
   ``make_decode_step`` bitwise its meshless twin, B2-B4 counted.
   jamba-1.5-large-398b's period parts at published width over 8 x 2,048
   (a whole period's four MoE layers exceed the card; the grid ring runs in
   15b): one Mamba mixer through ``mamba_forward``'s sequence-sharded branch
   and its tensor-parallel decode, the attention sublayer through the mesh
   prefill and a tp decode step, each bitwise meshless. Then B2, B3 and B4
   at every shape those runs launched, and, kernel-level, at one rank's
   shapes on a 4-rank model axis (B3 at jamba's heads over 512 of 2,048
   rows at q_offset 0 and 1,536, whisper's encoder over 375 of 1,500
   frames; B4 over whisper's 375-key cross shard and jamba's 512-key shard
   with rows of length 0), against their plain versions, timed.
16. The dry run of production-mesh cells (slice 18) — ``python -m
   repro_torch.launch.dryrun --device cuda`` in a subprocess a cell (its
   fake process group must not meet the NCCL ranks of phases 14-15c), rank 0
   of the production mesh, bf16 at published width: yi-34b train_4k on
   16x16 and yi-34b decode_32k on 2x16x16 at 30 of 60 layers,
   jamba-1.5-large-398b long_500k on 2x16x16 at one period (8 layers). Each cell runs on the meta
   device (the prediction), on the card counted under ``op_cost.cost_scope``,
   and on the card timed and measured without a scope (compute only: the fake
   group moves no bytes); the meta and counted card records must give equal
   FLOPs, bytes, collective counts and bytes and kernel launches by shape, and
   the card's ``max_memory_allocated`` must be within 10% of the meta peak.
   Then B2, B3 and B4 at every shape those card runs launched, and B3
   kernel-level at the train cell's last model rank (q_offset 3,840), against
   their plain versions, timed, their bounds from the kernel modules'
   ``cost``.
17. Every strategy of the temporal round on a mesh (slice 19) — in phase
   15's world-1 NCCL rank (its process has paid the card's first uses), on
   the (1, 1) mesh, yi-34b at published width in bf16 (MESH_TRAIN's 4 of
   60 layers, weights drawn on the card):
   ``make_train_step``'s round with int8 sends (the rank's shards packed
   into one (1, N) row, one B1 launch), DP-FedAvg with noise (the whole
   delta's clip, noise at global flat indices), FedProx over two local steps
   (the whole model's term), and multi-worker consensus (majority digest
   and median, W = 3 with one byzantine worker), each bitwise the meshless
   ``build_temporal_round`` (loss and every new param; B1, B2 and B3
   counted). Then B1 at the int8 round's (1, N), past 2**31, and,
   kernel-level, at rank 0's packed shards of yi-34b train_4k on 16x16,
   each bitwise its plain version over column slices and timed beside its
   bound; B2 and B3 take phase 15's rows of the same shapes.
18. serve path (slice 2) — ``repro_torch.launch.serve.generate`` on yi-34b
   at full width (d_model 7168, 56 heads, 8 KV heads, d_ff 20480, vocab
   64000) with its depth cut from 60 to 8 layers, bf16 weights drawn on the
   card from a seed: batch 8, prompt 2048, 64 new tokens (cache 2112, not a
   whole number of 512-key blocks). Launch counts rmsnorm 17 x 65 (17 in
   the narrow row layout at prefill, 17 x 64 in the wide one at decode),
   flash 8 (all wgmma, no tf32x3), decode 8 x 64; a second run gives
   bitwise the same tokens, prefill and decode logits; prefill seconds, decode ms per token, tokens/s and peak
   memory. Then reduced yi-34b in f32 from the same weights on the card and
   on the CPU: one prefill and 4 greedy decode steps, logits within 1e-4,
   tokens equal, every B3 launch on the tf32x3 kernel (the f32 card-vs-CPU
   train rounds of phases 10 and 11 count theirs too).
19. summary — a ``kernels`` JSON line, one ``slice`` line per slice, the
   whole script's seconds, the card's ``name, power.limit`` line, and last
   the ``ok`` JSON line.

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

T_START = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet, at the 700 W limit
F32_FLOPS_PER_S = 67e12        # H100 SXM data sheet, f32 outside tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM data sheet, bf16 dense tensor cores
TF32_FLOPS_PER_S = 494.7e12    # H100 SXM data sheet, tf32 dense tensor cores
# B3 in f32 (slice 11): the tf32x3 kernel at every shape the f32
# card-vs-CPU serve and train phases launch (the reduced GQA configs,
# reduced minicpm3-4b's absorbed MLA, and reduced whisper-base's encoder,
# cross and decoder attention), and, on no path, at yi-34b's serve shape
# and at MLA's absorbed dims in f32; B, Sq, Sk, H, KV, Dk, Dv, causal, as
# B3's launches_by_shape keys them
F32_FLASH = {"reduced": (2, 64, 64, 4, 2, 16, 16, True),
             "mla_reduced": (2, 64, 64, 4, 1, 24, 16, True),
             "whisper_encoder_reduced": (2, 64, 64, 4, 4, 16, 16, False),
             "whisper_cross_reduced": (2, 8, 64, 4, 4, 16, 16, False),
             "whisper_decoder_reduced": (2, 8, 8, 4, 4, 16, 16, True),
             "serve": (8, 2048, 2048, 56, 8, 128, 128, True),
             "mla_absorbed": (2, 2048, 2048, 40, 1, 288, 256, True)}
KERNEL_SHAPES = [(100, 189_952, 256),     # main path: C=100 clients, flsim-cnn packed
                 (16, 1_048_576, 256),    # BENCH_agg shape
                 (7, 4_224, 128),         # ragged tail
                 (1, 189_952, 256)]       # single client
# serve path (slice 2): yi-34b at full width, depth cut to fit one card's
# time budget; batch 8 x prompt 2048 + 64 new tokens -> a cache of 2112
SERVE = {"arch": "yi-34b", "n_layers": 8, "batch": 8, "prompt_len": 2048,
         "max_new": 64, "seed": 0}
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}    # tests/test_kernels.py
# the PyTorch yardsticks (F.rms_norm, SDPA) round to bf16 at other points
# than the kernels (SDPA rounds p before its p.v product); this only shows
# they compute the same function, so that their times compare
YARDSTICK_TOL = 5e-2
RMS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
FLASH_CHECKS = [  # B, Sq, Sk, H, KV, Dk, Dv  (tests/test_kernels.py:34-39, then ragged)
    (2, 128, 128, 4, 4, 64, 64), (1, 256, 256, 8, 2, 64, 64),
    (2, 128, 256, 4, 1, 32, 32), (1, 128, 128, 4, 2, 96, 64),
    (2, 70, 200, 4, 1, 64, 64), (1, 300, 300, 56, 8, 128, 128),
    (1, 50, 50, 4, 2, 20, 20),     # rows not 16-byte aligned: the scalar loads
    (2, 70, 200, 4, 1, 128, 128),  # wgmma: ragged Sq and Sk, q_offset 130
    (1, 192, 192, 8, 2, 128, 64), (1, 192, 192, 8, 2, 64, 128),   # wgmma, Dk != Dv
    (1, 1, 333, 8, 2, 128, 128),   # one query row, q_offset 332
    # MLA (slice 10): absorbed (288, 256), 40 heads on one kv head (bf16:
    # wgmma, 64 keys a stage), ragged, q_offset, one row; expanded (96, 64)
    (1, 300, 300, 40, 1, 288, 256), (2, 70, 200, 8, 1, 288, 256),
    (1, 1, 333, 40, 1, 288, 256), (2, 100, 100, 40, 40, 96, 64),
    # slice 11: the reduced MLA dims, a single kv block, (288, 288) (bf16
    # on the tf32x3 kernel), GQA heads packed in one tile at Sq 1
    (2, 70, 200, 8, 1, 24, 16), (2, 32, 32, 4, 2, 64, 64), (1, 100, 100, 4, 1, 288, 288),
    (2, 1, 129, 40, 1, 24, 16)]
DECODE_CHECKS = [  # B, S, H, KV, D  (tests/test_kernels.py:91, then ragged, G = 7)
    (2, 256, 8, 2, 64), (1, 512, 4, 4, 128), (3, 128, 8, 1, 32), (4, 600, 14, 2, 16),
    (2, 90, 6, 3, 12)]
# the split kernel's boundaries: lengths 0, 1, chunk-1, chunk, chunk+1, S
DECODE_SPLIT_CHECKS = [(600, 14, 2, 128), (2112, 56, 8, 128)]   # S, H, KV, D
RMS_CHECKS = [(64, 128), (3, 40, 256), (130, 512), (5, 100)]
MAIN_JOB = {
    "name": "chip_smoke",
    "model": {"arch": "flsim-cnn"},              # config width: d_model 64, d_ff 128
    "dataset": {"dataset": "synthetic_vision", "n_items": 50_000,
                "distribution": {"partition": "dirichlet",
                                 "dirichlet_alpha": 0.5}},
    "strategy": {"strategy": "fedavg",
                 "train_params": {"n_clients": 100, "cohort": 20,
                                  "local_steps": 5, "batch_size": 32,
                                  "client_lr": 0.05, "rounds": 6,
                                  "rounds_per_launch": 3, "seed": 0}},
    "runtime": {"straggler_prob": 0.1, "straggler_overprovision": 1.25},
}

# slice 5: every strategy and topology on MAIN_JOB, 3 rounds each
SLICE5_STRATEGIES = {   # name: (strategy, train_params over MAIN_JOB's)
    "fedavgm": ("fedavgm", {}),
    "fedadam": ("fedadam", {"server_lr": 0.01}),
    "fedyogi": ("fedyogi", {"server_lr": 0.01}),
    "fedprox": ("fedprox", {"prox_mu": 0.01}),
    "scaffold": ("scaffold", {}),
    "moon": ("moon", {"moon_mu": 0.1}),
    "dp_fedavg": ("dp_fedavg", {"dp_clip": 1.0, "dp_noise": 0.001}),
    "topk": ("compressed", {"compression": "topk", "topk_ratio": 0.1}),
    "clustered": ("clustered", {"topology": "hierarchical"}),
    "gossip_1": ("gossip", {"topology": "decentralized", "gossip_steps": 1}),
    "gossip_2": ("gossip", {"topology": "decentralized", "gossip_steps": 2}),
    "int8_gossip": ("compressed", {"compression": "int8", "topology": "decentralized"}),
}
# the jobs whose JAX counterpart's loss falls at test size (src/repro at
# flsim-cnn d_model 8 / d_ff 16, 512 items, 10 clients, cohort 4, on the CPU):
# their loss must fall here too
SLICE5_MUST_FALL = ("fedavgm", "fedadam", "fedyogi", "fedprox", "dp_fedavg", "topk",
                    "clustered", "gossip_1", "gossip_2", "int8_gossip")
SLICE5_CHUNKED = ("scaffold", "gossip_2", "dp_fedavg")
# async under heterogeneity (runtime) with a staleness discount
ASYNC_RUNTIME = {"straggler_prob": 0.1, "duration_sigma": 0.25, "rate_spread": 0.5}
ASYNC_JOBS = {"fedbuff_int8": {"async_buffer": 10}, "fedasync_int8": {"async_buffer": 0}}
EQUAL_SPEEDS = {"straggler_prob": 0.0, "duration_sigma": 0.0, "rate_spread": 0.0,
                "availability": 1.0}


def log(*a):
    """Print and flush, so a cut run keeps what it printed."""
    print(*a, flush=True)


def job_dict(strategy: str, compression: str, rounds_per_launch: int, runtime=None,
             **train) -> dict:
    """The main-path job with one strategy, compression and chunking, and
    other train_params and runtime settings where given."""
    raw = json.loads(json.dumps(MAIN_JOB))
    raw["strategy"]["strategy"] = strategy
    tp = raw["strategy"]["train_params"]
    tp["compression"] = compression
    tp["rounds_per_launch"] = rounds_per_launch
    tp.update(train)
    if runtime is not None:
        raw["runtime"] = dict(runtime)
    return raw


def slice5_job(name: str, rounds_per_launch: int = 3) -> dict:
    """One of the slice-5 strategy jobs: MAIN_JOB with its strategy and
    settings, 3 rounds."""
    strategy, train = SLICE5_STRATEGIES[name]
    train = dict(train)
    return job_dict(strategy, train.pop("compression", "none"), rounds_per_launch,
                    rounds=3, **train)


def agg_inputs(C, N, qblock, seed, device):
    """Random int8 deltas, block scales and normalized client weights."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    q = torch.randint(-127, 128, (C, N), generator=g, device=device,
                      dtype=torch.int8)
    s = torch.rand((C, N // qblock), generator=g, device=device) * (1e-2 - 1e-4) + 1e-4
    w = torch.rand((C,), generator=g, device=device)
    return q, s, w / w.sum()


def _events(n):
    import torch
    return [(torch.cuda.Event(enable_timing=True),
             torch.cuda.Event(enable_timing=True)) for _ in range(n)]


def _median(pairs) -> float:
    import torch
    torch.cuda.synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in pairs)
    return ms[len(ms) // 2]


def time_call(fn, args, iters: int, flush) -> float:
    """Median ms per call as the caller sees it: each launch timed alone
    with CUDA events after overwriting a buffer larger than L2. The device
    idles while the host enqueues the call, so this includes the host's
    launch overhead."""
    for _ in range(5):
        fn(*args)
    pairs = _events(iters)
    for t0, t1 in pairs:
        if flush is not None:
            flush.zero_()
        t0.record()
        fn(*args)
        t1.record()
    return _median(pairs)


def time_device(fn, args, iters: int, flush, batch: int = 20) -> float:
    """Median device ms per call: as ``time_call``, but each batch of calls
    is queued behind a device-side sleep long enough for the host to
    enqueue the whole batch, so the events bracket device work only.
    ``flush`` None: no flush, the inputs stay warm in L2."""
    import torch
    for _ in range(5):
        fn(*args)
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn(*args)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3
    (s0, s1), = _events(1)
    s0.record()
    torch.cuda._sleep(10_000_000)
    s1.record()
    torch.cuda.synchronize()
    cycles_per_ms = 10_000_000 / s0.elapsed_time(s1)
    pairs = []
    for _ in range(0, iters, batch):
        torch.cuda._sleep(int(cycles_per_ms * (2 * batch * host_ms + 1)))
        for t0, t1 in _events(batch):
            if flush is not None:
                flush.zero_()
            t0.record()
            fn(*args)
            t1.record()
            pairs.append((t0, t1))
    return _median(pairs)


def in_turns(fa, fb, args, iters, flush, batch=20):
    """Median device ms of two functions of the same inputs, timed in turns
    a, b, b, a; each the mean of its two medians."""
    a1 = time_device(fa, args, iters, flush, batch)
    b1 = time_device(fb, args, iters, flush, batch)
    b2 = time_device(fb, args, iters, flush, batch)
    a2 = time_device(fa, args, iters, flush, batch)
    return (a1 + a2) / 2, (b1 + b2) / 2


EMPTY_CU = r"""// an empty kernel: the launch floor of the timing harness
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
"""


def build_extras(build, baseline):
    """The empty kernel (its source written under build/) and, with
    ``--baseline``, whichever of the earlier rmsnorm, quant_aggregate and
    flash_attention the directory holds, each group built together;
    returns {name: library path}."""
    extra = build.BUILD_DIR.parent / "chip_smoke"
    extra.mkdir(parents=True, exist_ok=True)
    (extra / "empty.cu").write_text(EMPTY_CU)
    libs = {}
    old = [n for n in ("rmsnorm", "quant_aggregate", "flash_attention")
           if baseline and (baseline / f"{n}.cu").exists()]
    todo = [(["empty"], extra)] + ([(old, baseline)] if old else [])
    for names, csrc in todo:
        for name, path in build.build(names, csrc).items():
            libs[name if csrc == extra else f"{name} (baseline)"] = path
    return libs


def bind_extras(torch, libs):
    """Python callables for the extra libraries: ``empty()`` and, where the
    baseline was built, ``rmsnorm(x, w)`` and ``quant_aggregate(q, s, w)``
    through PR 13's C entry points and ``flash_attention(q, k, v,
    q_offset=0, causal=True, scale=None) -> (out, lse)`` through PR 12's."""
    def stream():
        return torch.cuda.current_stream().cuda_stream

    def checked(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} launch failed: CUDA error {rc}")

    empty = ctypes.CDLL(str(libs["empty"])).empty_launch
    empty.argtypes, empty.restype = [ctypes.c_void_p], ctypes.c_int
    out = {"empty": lambda: checked(empty(stream()), "empty kernel")}
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if "rmsnorm (baseline)" in libs:
        rms = ctypes.CDLL(str(libs["rmsnorm (baseline)"])).rmsnorm_launch
        rms.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int, ctypes.c_float,
                                                ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        rms.restype = ctypes.c_int

        def old_rmsnorm(x, w):
            o = torch.empty_like(x)
            D = x.shape[-1]
            checked(rms(x.data_ptr(), w.data_ptr(), o.data_ptr(), x.numel() // D, D, 1e-6,
                        codes[x.dtype], codes[w.dtype], stream()), "baseline rmsnorm")
            return o
        out["rmsnorm"] = old_rmsnorm
    if "quant_aggregate (baseline)" in libs:
        agg = ctypes.CDLL(str(libs["quant_aggregate (baseline)"])).quant_aggregate_launch
        agg.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                                                ctypes.c_void_p]
        agg.restype = ctypes.c_int

        def old_quant_aggregate(q, s, w):
            o = torch.empty((q.shape[1],), dtype=torch.float32, device=q.device)
            checked(agg(q.data_ptr(), s.data_ptr(), w.data_ptr(), o.data_ptr(), q.shape[0],
                        q.shape[1], q.shape[1] // s.shape[1], stream()),
                    "baseline quant_aggregate")
            return o
        out["quant_aggregate"] = old_quant_aggregate
    if "flash_attention (baseline)" not in libs:
        return out
    fl = ctypes.CDLL(str(libs["flash_attention (baseline)"])).flash_attention_launch
    fl.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_int,
                                                               ctypes.c_void_p]
    fl.restype = ctypes.c_int

    def old_flash(q, k, v, q_offset=0, causal=True, scale=None):
        B, Sq, H, Dk = q.shape
        _, Sk, KV, Dv = v.shape
        o = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        checked(fl(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), B,
                   Sq, Sk, H, KV, Dk, Dv, int(q_offset), int(causal),
                   float(scale if scale is not None else Dk ** -0.5), codes[q.dtype],
                   stream()), "baseline flash_attention")
        return o, lse
    out["flash_attention"] = old_flash
    return out


def phase_kernels(torch, qa, extras):
    """Kernel vs plain version, bitwise, and both timed, at every shape;
    the baseline kernel beside it where there is one, and other tiles at
    the main shape."""
    dev = torch.device("cuda")
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for i, (C, N, qblock) in enumerate(KERNEL_SHAPES):
        q, s, w = agg_inputs(C, N, qblock, seed=i, device=dev)
        got = qa.quant_aggregate(q, s, w)
        want = qa.plain(q, s, w)
        torch.cuda.synchronize()
        if got.shape != (N,) or not torch.isfinite(got).all():
            raise AssertionError(f"quant_aggregate {C}x{N}: bad output")
        err = (got - want).abs().max().item()
        if not torch.equal(got, want):
            raise AssertionError(f"quant_aggregate {C}x{N}/{qblock}: not bitwise "
                                 f"equal to its plain version (max |diff| {err})")
        nbytes = C * N + 4 * C * (N // qblock) + 4 * C + 4 * N
        flops = 3 * C * N
        bound_ms, bound_by = bound(nbytes, flops, F32_FLOPS_PER_S)
        plan = qa.launch_plan(C, N, qblock, sm)
        kernel_ms = time_device(qa.quant_aggregate, (q, s, w), 200, flush)
        plain_ms = time_device(qa.plain, (q, s, w), 100, flush, batch=5)
        call_ms = time_call(qa.quant_aggregate, (q, s, w), 200, flush)
        row = {"C": C, "N": N, "qblock": qblock, "plan": plan._asdict(), "bitwise": True,
               "max_abs_err": err, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "kernel_call_ms": call_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
               "library_ms": None}
        if "quant_aggregate" in extras:
            old = extras["quant_aggregate"]
            if not torch.equal(old(q, s, w), want):
                raise AssertionError(f"baseline quant_aggregate {C}x{N}: not bitwise plain")
            row["baseline_ms"], row["new_ms_in_turns"] = in_turns(
                old, qa.quant_aggregate, (q, s, w), 200, flush)
        if i == 0:
            tiles = {}
            for tile in qa.TILES:
                p = qa.launch_plan(C, N, qblock, sm, tile=tile)
                if not torch.equal(qa._launch(q, s, w, qblock, p), want):
                    raise AssertionError(f"quant_aggregate tile {tile}: not bitwise plain")
                tiles[tile] = time_device(qa._launch, (q, s, w, qblock, p), 200, flush)
            row["ms_by_tile"] = tiles
        log("kernel quant_aggregate", json.dumps(row))
        rows.append(row)
    return rows


def run_job(torch, qa, load_job, Executor, strategy, compression, rpl):
    """One main-path job through the entry points; checks its losses."""
    job = load_job(job_dict(strategy, compression, rpl))
    torch.cuda.reset_peak_memory_stats()
    before = qa.quant_aggregate.launches
    t0 = time.perf_counter()
    ex = Executor(job).scaffold()
    scaffold_s = time.perf_counter() - t0
    state, logger = ex.run()
    launches = qa.quant_aggregate.launches - before
    losses = [r["loss"] for r in logger.rows]
    out = {"strategy": strategy, "compression": compression,
           "rounds_per_launch": rpl, "losses": losses,
           "round_s": [r["round_s"] for r in logger.rows],
           "scaffold_s": scaffold_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
           "agg_launches": launches}
    log("job", json.dumps(out))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{strategy}: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{strategy}: loss did not fall {losses}")
    params = {k: v.detach().clone() for k, v in state["params"].items()}
    del ex, state
    torch.cuda.empty_cache()
    return out, params


def phase_card_vs_cpu(torch):
    """One int8 round of the port on the card against the same round on
    the CPU, from the same numpy weights, batches and client weights."""
    import numpy as np
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.rounds import build_spatial_round, init_state
    from repro_torch.core.strategies import get_strategy
    from repro_torch.models import model_zoo

    fl = FLConfig(strategy="compressed", compression="int8", n_clients=8,
                  local_steps=2, client_lr=0.05)
    model = model_zoo.build("flsim-cnn")
    strategy = get_strategy(fl)
    rng = np.random.RandomState(7)
    x = rng.randn(8, 2, 16, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, (8, 2, 16))
    w = rng.rand(8).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        state = init_state(model, strategy, fl, 123, 8, device=dev)
        batch = {"x": torch.tensor(x, device=dev), "y": torch.tensor(y, device=dev)}
        new, m = build_spatial_round(model, strategy, fl)(
            state, batch, torch.tensor(w, device=dev), 0)
        out[dev] = (m["loss"].item(), {k: v.cpu() for k, v in new["params"].items()})
    dl = abs(out["cuda"][0] - out["cpu"][0])
    dp = max((out["cuda"][1][k] - out["cpu"][1][k]).abs().max().item()
             for k in out["cpu"][1])
    log(f"card vs cpu, one int8 round: |dloss| {dl:.3e}  max |dparam| {dp:.3e}")
    # tolerance: f32 convs/matmuls sum in another order on the card (~1e-6
    # relative); a delta that lands on an int8 rounding boundary can move by
    # one quantum (amax/127 of its block, ~1e-5 here) -> 1e-4 on params
    if dl > 1e-4 * abs(out["cpu"][0]) or dp > 1e-4:
        raise AssertionError(f"card and CPU rounds disagree: {dl} {dp}")
    return {"dloss": dl, "dparam": dp}


def profile_device(torch, fn, label, top=12):
    """Run ``fn`` once under ``torch.profiler``: device time by kernel name,
    the streams the kernels ran on, and the device's idle share of the wall
    time (the profiler's own host cost inflates the wall, so the idle share
    is an upper bound). Logs the top kernels; returns the summary and the
    {name: (ms, launches)} map."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # busy time is the union of the kernel intervals: kernels on several
    # streams can overlap, so it can be less than the sum of kernel times
    spans = {(e.name, e.time_range.start, e.time_range.end, e.device_resource_id)
             for e in prof.events() if e.device_type == DeviceType.CUDA}
    by_name = {}
    for name, a, b, _ in spans:
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (b - a) / 1e3, n + 1)
    busy_us, end = 0.0, float("-inf")
    for _, a, b, _ in sorted(spans, key=lambda sp: sp[1]):
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    busy_ms = busy_us / 1e3
    kernel_sum_ms = sum(ms for ms, _ in by_name.values())
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "kernel_sum_ms": kernel_sum_ms,
           "device_idle_share": 1 - busy_ms / wall_ms if by_name else None,
           "kernel_launches": len(spans),
           "streams": sorted({str(sp[3]) for sp in spans})}
    log(f"profile {label}", json.dumps(out))
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"  {ms:9.3f} ms {100 * ms / max(kernel_sum_ms, 1e-9):5.1f}% of kernel time"
            f"  x{n:<5d} {name[:90]}")
    if not by_name:
        log("  the profiler saw no device time")
    return out, by_name


def phase_profile(torch, load_job, Executor):
    """One warm int8 round of the FL path under ``torch.profiler``."""
    raw = job_dict("compressed", "int8", 1)
    raw["strategy"]["train_params"]["rounds"] = 2
    ex = Executor(load_job(raw)).scaffold()
    ex.run(1)
    out, by_name = profile_device(torch, lambda: ex.run(2), "one int8 round")
    qa_ms, qa_n = by_name.get(next((k for k in by_name if "quant_aggregate" in k), ""),
                              (0.0, 0))
    log(f"  quant_aggregate in this round: {qa_ms:.4f} ms x{qa_n}")
    del ex
    torch.cuda.empty_cache()
    return out


def check_hash(torch):
    """The counter-based draws (``core/determinism.py``) give the same bits
    on the card as on the CPU: keys, uniform bits and batch positions."""
    from repro_torch.core import determinism as det
    key = det.round_key(det.root_key(0), 7)
    out = {}
    for dev in ("cpu", "cuda"):
        ctr = torch.arange(1 << 20, dtype=torch.int64, device=dev)
        keys = det.client_keys(key, 100, dev)
        out[dev] = [keys, det.draw_bits(keys[:, None], ctr[None, :4096]),
                    det.uniform_index(keys[:, None], ctr[None, :160],
                                      torch.arange(1, 101, device=dev)[:, None]),
                    det.draw_bits(key, ctr)]
    for a, b in zip(out["cpu"], out["cuda"]):
        if not torch.equal(a, b.cpu()):
            raise AssertionError("the hash gives other bits on the card than on the CPU")
    log("hash: keys, bits and batch positions equal on the card and the CPU")


def phase_b1_slice5(torch, qa, extras):
    """B1 at slice 5's shapes, bitwise against its plain version and timed
    beside the empty kernel in the same harness: the FedBuff flush (K = 10
    rows of 189,952), the same buffer with zero rows and zero coefficients
    (slots of accepted zero-weight clients, an unfilled slot), and packed
    FedAsync's C = 1."""
    dev = torch.device("cuda")
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    N, qblock = 189_952, 256
    floor = {"warm_ms": time_device(extras["empty"], (), 200, None),
             "after_flush_ms": time_device(extras["empty"], (), 200, flush)}
    rows = {}
    for name, C, seed in (("fedbuff_flush", 10, 21), ("fedbuff_zero_rows", 10, 22),
                          ("fedasync_event", 1, 23)):
        q, s, w = agg_inputs(C, N, qblock, seed, dev)
        if name == "fedbuff_zero_rows":
            q[2].zero_()
            s[2].zero_()
            w[[2, 5, 8]] = 0.0
        got, want = qa.quant_aggregate(q, s, w), qa.plain(q, s, w)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"quant_aggregate {name}: not bitwise its plain version")
        nbytes = C * N + 4 * C * (N // qblock) + 4 * C + 4 * N
        bound_ms, bound_by = bound(nbytes, 3 * C * N, F32_FLOPS_PER_S)
        rows[name] = {"C": C, "N": N, "qblock": qblock, "bitwise": True, "max_abs_err": 0.0,
                      "plan": qa.launch_plan(C, N, qblock)._asdict(),
                      "kernel_ms": time_device(qa.quant_aggregate, (q, s, w), 200, flush),
                      "kernel_call_ms": time_call(qa.quant_aggregate, (q, s, w), 200, flush),
                      "plain_ms": time_device(qa.plain, (q, s, w), 50, flush, batch=10),
                      "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
                      "launch_floor_ms": floor["after_flush_ms"], "library_ms": None}
        log(f"kernel quant_aggregate {name}", json.dumps(rows[name]))
    log("launch floor (empty kernel) beside B1", json.dumps(floor))
    del flush
    return rows, floor


_DATA = {}


class _SharedData:
    """A job's dataset whose partitioned root set is made once per
    partition setting and shared by the phase's jobs (all draw MAIN_JOB's
    50,000 items from seed 0), so the host's data generation is paid once."""

    def __init__(self, dataset):
        self.dataset = dataset

    def distribute_into_chunks(self, kind, n_clients, alpha=0.5):
        key = (self.dataset.n_items, self.dataset.seed, kind, n_clients, alpha)
        if key not in _DATA:
            _DATA[key] = self.dataset.distribute_into_chunks(kind, n_clients, alpha)
        return _DATA[key]


def _flat(tree):
    """Every tensor of a state, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _flat(v)]
    return [tree]


def _same(torch, a, b) -> bool:
    a, b = _flat(a), _flat(b)
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def run_slice5(torch, qa, load_job, Executor, label, raw, ckpt_dir=None, rounds=None):
    """One slice-5 job through the entry points, scaffolded from the newest
    checkpoint in ``ckpt_dir`` if there is one; returns its summary and the
    executor. Losses must be finite."""
    job = load_job(raw)
    if not hasattr(job.dataset, "shard"):      # a population makes its shards itself
        job.dataset = _SharedData(job.dataset)
    torch.cuda.reset_peak_memory_stats()
    before = qa.quant_aggregate.launches
    t0 = time.perf_counter()
    ex = Executor(job, ckpt_dir=ckpt_dir).scaffold()
    scaffold_s = time.perf_counter() - t0
    state, logger = ex.run(rounds)
    rows = logger.rows
    out = {"job": label, "strategy": job.fl.strategy, "mode": job.fl.mode,
           "placement": ex.placement, "losses": [r["loss"] for r in rows],
           "round_s": [r["round_s"] for r in rows], "scaffold_s": scaffold_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
           "agg_launches": qa.quant_aggregate.launches - before}
    if job.fl.mode == "async":
        out.update({k: [r[k] for r in rows] for k in ("events_per_s", "staleness",
                                                       "applied", "vtime")})
    log("job", json.dumps(out))
    if not out["losses"] or not all(math.isfinite(v) for v in out["losses"]):
        raise AssertionError(f"{label}: non-finite loss {out['losses']}")
    return out, ex


def _profile_b1(torch, fn, label):
    """``fn`` under ``torch.profiler``: the device summary plus B1's ms and
    launches in it."""
    prof, by_name = profile_device(torch, fn, label, top=6)
    hits = [v for k, v in by_name.items() if "quant_aggregate" in k]
    prof["b1_ms"], prof["b1_launches"] = sum(h[0] for h in hits), sum(h[1] for h in hits)
    log(f"  quant_aggregate: {prof['b1_ms']:.4f} ms x{prof['b1_launches']}")
    return prof


def phase_slice5(torch, qa, load_job, Executor):
    """Every strategy, topology, placement and async server of the JAX
    package at MAIN_JOB's width (flsim-cnn, 189,952 packed params, 50,000
    items, 100 clients, 5 local steps of batch 32), through ``load_job`` ->
    ``Executor``:

    - strategies: the jobs of SLICE5_STRATEGIES, 3 rounds each; losses
      finite, and falling for the jobs in SLICE5_MUST_FALL (those whose JAX
      counterpart's loss falls at test size: all but scaffold and moon);
      none launches B1 (the int8 gossip job takes the unpacked round trip);
      chunks of 1 bitwise chunks of 3 for SLICE5_CHUNKED;
    - temporal placement: fedavg and int8, 2 rounds, losses falling, B1
      launched once per int8 round and never on fedavg;
    - async, under stragglers, jitter, rate spread and a staleness discount:
      FedBuff (buffer 10) and FedAsync on int8, 2 rounds each; B1 launched
      once per flush (FedBuff) and once per event (FedAsync); chunks of 1
      bitwise chunks of 2; FedAsync's loss falls (FedBuff's JAX counterpart's
      does not at test size); then FedBuff's third round under the profiler;
    - the FedBuff identity: buffer == cohort (20 clients), equal speeds, no
      discount: bitwise sync temporal FedAvg;
    - checkpoint: the int8 job resumed at round 2 of 4 from a checkpoint,
      bitwise the uninterrupted run.

    B1's counts are set to 0 just before each counted path and read just
    after. Returns the phase's summary."""
    jobs, by_path = {}, {}
    for name in SLICE5_STRATEGIES:
        out, ex = run_slice5(torch, qa, load_job, Executor, name, slice5_job(name))
        if name in SLICE5_MUST_FALL and not out["losses"][-1] < out["losses"][0]:
            raise AssertionError(f"{name}: loss did not fall {out['losses']}")
        if out["agg_launches"]:   # no server reduce through B1 (gossip: unpacked)
            raise AssertionError(f"{name}: {out['agg_launches']} B1 launches")
        if name in SLICE5_CHUNKED:
            one, ex1 = run_slice5(torch, qa, load_job, Executor, f"{name} (chunks of 1)",
                                  slice5_job(name, rounds_per_launch=1))
            if one["losses"] != out["losses"] or not _same(torch, ex.state, ex1.state):
                raise AssertionError(f"{name}: chunks of 1 != chunks of 3")
            out["chunked_bitwise"] = True
            del ex1
        jobs[name] = out
        del ex
        torch.cuda.empty_cache()
    log("slice 5 strategies: losses finite, falling where the JAX package's fall; "
        f"chunks of 1 == 3 bitwise for {list(SLICE5_CHUNKED)}")

    for comp in ("none", "int8"):
        name = f"temporal_{comp}"
        raw = job_dict("compressed" if comp == "int8" else "fedavg", comp, 1, rounds=2,
                       placement="temporal")
        qa.quant_aggregate.launches = 0
        out, ex = run_slice5(torch, qa, load_job, Executor, name, raw)
        by_path[name] = qa.quant_aggregate.launches
        if by_path[name] != (2 if comp == "int8" else 0):
            raise AssertionError(f"{name}: {by_path[name]} B1 launches in 2 rounds")
        if not out["losses"][-1] < out["losses"][0]:
            raise AssertionError(f"{name}: loss did not fall {out['losses']}")
        jobs[name] = out
        del ex

    for name, tp in ASYNC_JOBS.items():
        runs = []
        for rpl in (2, 1):
            # scaffolded for 3 rounds (the third is profiled), counted over 2
            raw = job_dict("compressed", "int8", rpl, runtime=ASYNC_RUNTIME, rounds=3,
                           mode="async", staleness_exponent=0.5, **tp)
            qa.quant_aggregate.launches = 0
            out, ex = run_slice5(torch, qa, load_job, Executor,
                                 f"{name} (chunks of {rpl})", raw, rounds=2)
            launches = qa.quant_aggregate.launches
            n_ev = 2 * ex.events_per_round
            want = int(ex.schedule.apply[:n_ev].sum()) if tp["async_buffer"] > 1 else n_ev
            if launches != want:
                raise AssertionError(f"{name}: {launches} B1 launches, want {want}")
            runs.append((out, ex, launches))
        (out, ex, launches), (one, ex1, _) = runs
        if one["losses"] != out["losses"] or not _same(torch, ex.state, ex1.state):
            raise AssertionError(f"{name}: chunks of 1 != chunks of 2")
        if name == "fedasync_int8" and not out["losses"][-1] < out["losses"][0]:
            raise AssertionError(f"{name}: loss did not fall {out['losses']}")
        out["chunked_bitwise"] = True
        by_path[name] = launches
        log(f"{name}: events_per_s {out['events_per_s']}, B1 launches {launches}")
        if name == "fedbuff_int8":
            # where the time goes: a third round's 10 events, profiled (the
            # temporal and FedAsync loops train one client per step the same
            # way; their 60-70 thousand launches a round take the profiler
            # tens of seconds)
            out["profile"] = _profile_b1(torch, lambda: ex.run(3), f"one {name} round "
                                         f"({ex.events_per_round} events)")
        jobs[name] = out
        del ex, ex1

    ident = {}
    for mode in ("sync", "async"):
        tp = ({"placement": "temporal"} if mode == "sync" else
              {"mode": "async", "async_buffer": 20, "staleness_exponent": 0.0})
        raw = job_dict("fedavg", "none", 2, runtime=EQUAL_SPEEDS, rounds=2, n_clients=20,
                       cohort=0, **tp)
        out, ex = run_slice5(torch, qa, load_job, Executor, f"identity {mode}", raw)
        ident[mode] = ex.state["params"]
        jobs[f"identity_{mode}"] = out
        del ex
    if not _same(torch, ident["sync"], ident["async"]):
        raise AssertionError("FedBuff (buffer == cohort, equal speeds) != sync temporal FedAvg")
    log("FedBuff identity: bitwise sync temporal FedAvg (20 clients, 2 rounds)")
    del ident

    ckpt_dir = ROOT / "build" / "chip_smoke" / "ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    raw = job_dict("compressed", "int8", 2, rounds=4, checkpoint_every=2)
    ref, ex_ref = run_slice5(torch, qa, load_job, Executor, "checkpoint reference", raw)
    _, ex = run_slice5(torch, qa, load_job, Executor, "checkpoint first half", raw,
                       ckpt_dir=str(ckpt_dir), rounds=2)
    out, ex2 = run_slice5(torch, qa, load_job, Executor, "checkpoint resumed", raw,
                          ckpt_dir=str(ckpt_dir))
    if ex2.round_idx != 4 or out["losses"] != ref["losses"][2:] or \
            not _same(torch, ex2.state, ex_ref.state):
        raise AssertionError("resumed at round 2 != the uninterrupted run")
    log("checkpoint: resumed at round 2 of 4, bitwise the uninterrupted run")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    del ex_ref, ex, ex2
    torch.cuda.empty_cache()
    return {"jobs": jobs, "b1_launches_by_path": by_path}


# phase 7 (slice 6): multi-worker consensus, the ledger and the comms plane on
# MAIN_JOB; honest majority: one byzantine worker out of W
CONSENSUS_JOBS = {   # name: (strategy, compression, W, consensus, placement)
    "int8_majority": ("compressed", "int8", 3, "majority_digest", "spatial"),
    "fedavg_median": ("fedavg", "none", 4, "median", "spatial"),
    "fedavg_trimmed_mean": ("fedavg", "none", 4, "trimmed_mean", "spatial"),
    "temporal_int8_majority": ("compressed", "int8", 3, "majority_digest", "temporal"),
}
TEMPORAL_ROUNDS = 2    # a temporal round at MAIN_JOB's width takes 2-3 s
COMMS_ON = {"enabled": True}


def control_job(strategy, compression, rpl, W=1, consensus="majority_digest",
                placement="spatial", comms=False, **train) -> dict:
    """MAIN_JOB for the control-plane phase: 3 rounds (temporal: 2), with W
    workers (one byzantine when W > 1) and the comms plane where asked."""
    rounds = train.pop("rounds", TEMPORAL_ROUNDS if placement == "temporal" else 3)
    if W > 1:
        train.update(n_workers=W, byzantine_workers=1, consensus=consensus)
    raw = job_dict(strategy, compression, rpl, rounds=rounds, placement=placement,
                   **train)
    if comms:
        raw["comms"] = dict(COMMS_ON)
    return raw


def check_control_plane_bits(torch):
    """The draws consensus makes give the same bits on the card as on the
    CPU: 4,194,304 normals (Box-Muller in f64, rounded once), a digest
    projection, and a poisoned copy of flsim-cnn's params."""
    from repro_torch.core import consensus
    from repro_torch.core import determinism as det
    from repro_torch.models.small import SmallModel
    from repro_torch.configs.base import get_config
    ctr = torch.arange(1 << 22, dtype=torch.int64)
    key = det.fold_in(det.round_key(det.root_key(0), 3), 1)
    if not torch.equal(det.normal(key, ctr.cuda()).cpu(), det.normal(key, ctr)):
        raise AssertionError("determinism.normal gives other bits on the card")

    def normal_f32(ctr):          # the same Box-Muller in f32 throughout
        bits = det.draw_bits(key, ctr)
        u1 = (det._srl(bits, 40) + 1).to(torch.float32) * 2.0 ** -24
        u2 = ((bits >> 16) & 0xFFFFFF).to(torch.float32) * 2.0 ** -24
        return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2 * math.pi) * u2)
    f32_differ = int((normal_f32(ctr.cuda()).cpu() != normal_f32(ctr)).sum())
    cpu = torch.device("cpu")
    if not torch.equal(consensus._projection(5, 128, 4, torch.device("cuda")).cpu(),
                       consensus._projection(5, 128, 4, cpu)):
        raise AssertionError("a digest projection differs on the card")
    params = SmallModel(get_config("flsim-cnn"), "cnn").init(torch.Generator())
    got = consensus.poison({k: v.cuda() for k, v in params.items()}, 3.0, key)
    want = consensus.poison(params, 3.0, key)
    if not all(torch.equal(got[k].cpu(), want[k]) for k in params):
        raise AssertionError("the poisoned aggregate differs on the card")
    log(f"control plane: {ctr.numel()} normals, a projection and a poisoned flsim-cnn "
        f"(188,810 params) equal on the card and the CPU; in f32 throughout "
        f"{f32_differ} of the normals would differ")
    return f32_differ


def _global_digests(ex):
    return [b.payload["digest"] for b in ex.job.ledger.blocks() if b.kind == "global"]


def _async_digests(ex):
    return [(b.payload["event"], b.payload["vtime"], b.payload["digest"])
            for b in ex.job.ledger.blocks() if b.kind == "async_digest"]


def phase_control_plane(torch, qa, load_job, Executor):
    """Multi-worker consensus, the hash-chain ledger, the control-plane
    store and the comms plane at MAIN_JOB's width (flsim-cnn, 189,952 packed
    params, 50,000 items, Dirichlet 0.5 over 100 clients, cohort 20 over-
    provisioned 1.25x, straggler_prob 0.1, 5 local steps of batch 32), 3
    rounds (temporal: 2), through ``load_job`` -> ``Executor``:

    - int8 with majority_digest at W = 3 and a hashchain ledger, chunks of 3
      and of 1: params and losses bitwise the W = 1 job's, B1 once per
      round, a verified chain, one global block per chunk, the same final
      digest for both chunkings (and the W = 1 job's);
    - fedavg with median and with trimmed_mean at W = 4: bitwise W = 1;
    - temporal int8 with majority_digest at W = 3: bitwise W = 1, B1 once
      per round;
    - a W = 2 tie, 1 round: the poisoned worker 0 wins (finite params, moved
      from W = 1's by the poison), then one more round's loss is logged;
    - FedBuff int8 (buffer 10) with a ledger and a digest every 5 events,
      chunks of 1 and of 2: the same marks, vtimes and final digest;
    - the comms plane on vs off for the spatial fedavg job, the temporal
      int8 job and the FedBuff job: params bitwise equal; each job's last
      comms row;
    - ``repro_torch.launch.byzantine`` and ``repro_torch.launch.gossip``.

    Prints each consensus job's round_s beside its W = 1 twin's, the
    ledger's host time per chunk, and one warm W = 3 int8 round under the
    profiler. B1's counts are set to 0 just before each counted path and
    read just after. Returns the phase's summary."""
    from repro_torch.core.blockchain import HashChainLedger, param_digest
    jobs, by_path, comms_rows = {}, {}, {}

    def run(label, raw, rounds=None):
        qa.quant_aggregate.launches = 0
        out, ex = run_slice5(torch, qa, load_job, Executor, label, raw, rounds=rounds)
        out["agg_launches"] = qa.quant_aggregate.launches
        jobs[label] = out
        return out, ex

    twins = {}
    for name, (strategy, comp, W, cons, placement) in CONSENSUS_JOBS.items():
        base = (strategy, comp, placement)
        if base not in twins:
            twins[base] = run(f"{strategy}_{comp}_{placement} W=1",
                              control_job(strategy, comp, 3, placement=placement))
        one, ex1 = twins[base]
        extra = {"blockchain": "hashchain"} if name == "int8_majority" else {}
        out, ex = run(name, control_job(strategy, comp, 3, W, cons, placement, **extra))
        if out["losses"] != one["losses"] or not _same(torch, ex.state["params"],
                                                       ex1.state["params"]):
            raise AssertionError(f"{name}: honest majority != W = 1")
        n_rounds = len(out["losses"])
        if comp == "int8":
            by_path[name] = out["agg_launches"]
            if out["agg_launches"] != n_rounds:
                raise AssertionError(f"{name}: {out['agg_launches']} B1 launches in "
                                     f"{n_rounds} rounds")
        out["round_s_w1"] = one["round_s"]
        log(f"{name}: bitwise W = 1; round_s {out['round_s']} vs W = 1 {one['round_s']}")
        if name == "int8_majority":
            chain = ex.job.ledger
            if not chain.verify() or len(_global_digests(ex)) != 1:
                raise AssertionError(f"{name}: ledger {len(chain.blocks())} blocks")
            one_by_one, ex_c1 = run(f"{name} (chunks of 1)",
                                    control_job(strategy, comp, 1, W, cons, **extra))
            d3, d1 = _global_digests(ex), _global_digests(ex_c1)
            if not ex_c1.job.ledger.verify() or len(d1) != 3 or d1[-1] != d3[-1] or \
                    d3[-1] != param_digest(ex1.state["params"]) or \
                    one_by_one["losses"] != one["losses"]:
                raise AssertionError(f"{name}: chunks of 1 != chunks of 3 on the ledger")
            if ex_c1.kv.get("global_digest/2") != d3[-1]:
                raise AssertionError(f"{name}: global_digest/2 not published")
            by_path[f"{name} (chunks of 1)"] = one_by_one["agg_launches"]
            # the ledger's host time per chunk: a device-to-host copy of the
            # params plus SHA-256, then the block (on a scratch chain)
            ex.job.ledger = HashChainLedger()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for r in range(20):
                ex._ledger_record(r)
            out["ledger_ms_per_chunk"] = (time.perf_counter() - t0) / 20 * 1e3
            log(f"{name}: ledger verified, one block per chunk, final digest "
                f"{d3[-1][:16]} for chunks of 3 and of 1; ledger "
                f"{out['ledger_ms_per_chunk']:.3f} ms per chunk")
            ex.run(4)                      # one more round, warm, then profiled
            out["profile"] = profile_device(torch, lambda: ex.run(5),
                                            "one W = 3 int8 majority_digest round",
                                            top=8)[0]
            del ex_c1
        del ex

    # the tie: worker 0, the poisoned one, wins. One round: the loss is W = 1's
    # (the clients train from the same weights), every param moved by the
    # poison (N(0, 9)); then one more round from the poisoned params, logged
    one1, ex1 = run("fedavg W=1 (1 round)", control_job("fedavg", "none", 1, rounds=1))
    tie, ex = run("fedavg_majority W=2 tie", control_job("fedavg", "none", 1, 2, rounds=1))
    p1, pt = ex1.state["params"], ex.state["params"]
    moved = max((pt[k] - p1[k]).abs().max().item() for k in p1)
    if tie["losses"] != one1["losses"] or moved < 1.0 or \
            not all(bool(torch.isfinite(t).all()) for t in pt.values()):
        raise AssertionError(f"W = 2 tie: losses {tie['losses']} vs {one1['losses']}, "
                             f"max |param - W = 1's| {moved}")
    ex.run(2)
    tie["next_loss"] = ex.logger.rows[-1]["loss"]
    log(f"W = 2 tie: the poisoned aggregate won (max |param - W = 1's| {moved:.3f}, "
        f"finite); the next round's loss from it: {tie['next_loss']}")
    del ex, ex1

    fedbuff = {"mode": "async", "async_buffer": 10, "staleness_exponent": 0.5,
               "blockchain": "hashchain", "digest_every_events": 5}
    blocks = {}
    for rpl in (2, 1):
        raw = job_dict("compressed", "int8", rpl, runtime=ASYNC_RUNTIME, rounds=2, **fedbuff)
        out, ex = run(f"fedbuff_int8_ledger (chunks of {rpl})", raw)
        blocks[rpl] = _async_digests(ex)
        if not ex.job.ledger.verify():
            raise AssertionError("FedBuff ledger does not verify")
        if rpl == 2:
            want = int(ex.schedule.apply[:2 * ex.events_per_round].sum())
            by_path["fedbuff_int8_ledger"] = out["agg_launches"]
            if out["agg_launches"] != want:
                raise AssertionError(f"FedBuff: {out['agg_launches']} B1 launches, want {want}")
            fedbuff_state = ex.state
        del ex
    # a block digests the state at the end of its chunk: the marks, their
    # vtimes and the last chunk's digests are the same for every chunking
    marks = {rpl: [(e, v) for e, v, _ in b] for rpl, b in blocks.items()}
    if marks[1] != marks[2] or [e for e, _ in marks[2]] != [5, 10, 15, 20] or \
            blocks[1][-1][2] != blocks[2][-1][2]:
        raise AssertionError(f"FedBuff digest blocks: {blocks}")
    log(f"FedBuff: async digest blocks (event, vtime) {marks[2]} and the final digest "
        "the same for chunks of 1 and of 2")

    for label, raw, off in (
            ("spatial fedavg", control_job("fedavg", "none", 3, comms=True),
             twins[("fedavg", "none", "spatial")][1].state),
            ("temporal int8", control_job("compressed", "int8", 3, placement="temporal",
                                          comms=True),
             twins[("compressed", "int8", "temporal")][1].state),
            ("fedbuff int8", job_dict("compressed", "int8", 2, runtime=ASYNC_RUNTIME,
                                      rounds=2, **fedbuff), fedbuff_state)):
        raw["comms"] = dict(COMMS_ON)
        out, ex = run(f"{label} comms on", raw)
        if not _same(torch, ex.state["params"], off["params"]):
            raise AssertionError(f"{label}: comms on != off")
        comms_rows[label] = ex.comms_rows[-1]
        log(f"{label}: comms on == off bitwise; last comms row {json.dumps(ex.comms_rows[-1])}")
        del ex
    twins.clear()
    del fedbuff_state

    from repro_torch.launch import byzantine, gossip
    losses, ledger = byzantine.main([])
    if not ledger.verify() or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"launch.byzantine: {losses}")
    g_losses, divs = gossip.main([])
    if not g_losses[-1] < g_losses[0]:
        raise AssertionError(f"launch.gossip: loss did not fall {g_losses}")
    torch.cuda.empty_cache()
    return {"jobs": jobs, "b1_launches_by_path": by_path, "comms_rows": comms_rows,
            "byzantine_losses": losses, "gossip_losses": g_losses}


def _randn(torch, shape, dtype, seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(dtype)


def close(torch, name, got, want, tol) -> float:
    """max |got - want|; raises unless the output is finite and every entry
    is within atol = rtol = tol of ``want``."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    diff = (got - want).abs()
    err = diff.max().item() if diff.numel() else 0.0
    if not bool((diff <= tol + tol * want.abs()).all()):
        raise AssertionError(f"{name}: max |diff| {err} beyond tolerance {tol}")
    return err


def bound(nbytes, flops, flops_per_s):
    """(least ms, what bounds it): bytes over the memory rate against
    operations over the peak rate for their type."""
    tb, to = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def _dt(t) -> str:
    return str(t.dtype).replace("torch.", "")


def check_lm_kernels(torch):
    """rmsnorm, flash and decode attention against their plain versions on
    the card at tests/test_kernels.py's shapes, in f32 and bf16."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    dev = torch.device("cuda")
    worst = {"rmsnorm": 0.0, "flash_attention_wgmma": 0.0, "flash_attention_tf32x3_f32": 0.0,
             "flash_attention_tf32x3_bf16": 0.0, "decode_attention": 0.0}
    for i, shape in enumerate(RMS_CHECKS):
        for dt in (torch.float32, torch.bfloat16):
            x = _randn(torch, shape, dt, i, dev)
            w = _randn(torch, shape[-1:], torch.float32, i + 100, dev)
            err = close(torch, f"rmsnorm {shape} {dt}", rms.rmsnorm(x, w), rms.plain(x, w),
                        RMS_TOL[_dt(x)])
            worst["rmsnorm"] = max(worst["rmsnorm"], err)
    for i, (B, Sq, Sk, H, KV, Dk, Dv) in enumerate(FLASH_CHECKS):
        for dt in (torch.float32, torch.bfloat16):
            q = _randn(torch, (B, Sq, H, Dk), dt, 3 * i, dev)
            k = _randn(torch, (B, Sk, KV, Dk), dt, 3 * i + 1, dev)
            v = _randn(torch, (B, Sk, KV, Dv), dt, 3 * i + 2, dev)
            for causal in (True, False):
                name = f"flash {(B, Sq, Sk, H, KV, Dk, Dv)} {_dt(q)} causal={causal}"
                out, lse = fa.flash_attention_fwd(q, k, v, Sk - Sq, causal)
                want, want_lse = fa.plain(q, k, v, Sk - Sq, causal)
                err = close(torch, name, out, want, ATTN_TOL[_dt(q)])
                close(torch, name + " lse", lse, want_lse, ATTN_TOL[_dt(q)])
                kernel = fa.launch_plan(dt, Dk, Dv).kernel
                key = (f"flash_attention_{kernel}" if kernel == "wgmma" else
                       f"flash_attention_tf32x3_{'f32' if dt == torch.float32 else 'bf16'}")
                worst[key] = max(worst[key], err)
                if kernel == "wgmma":   # the tf32x3 kernel on the same bf16 inputs
                    out, lse = fa._launch("tf32x3", q, k, v, Sk - Sq, causal, None)
                    err = close(torch, name + " tf32x3", out, want, ATTN_TOL[_dt(q)])
                    close(torch, name + " tf32x3 lse", lse, want_lse, ATTN_TOL[_dt(q)])
                    worst["flash_attention_tf32x3_bf16"] = max(
                        worst["flash_attention_tf32x3_bf16"], err)
    for i, (B, S, H, KV, D) in enumerate(DECODE_CHECKS):
        for dt in (torch.float32, torch.bfloat16):
            q = _randn(torch, (B, H, D), dt, 3 * i, dev)
            k = _randn(torch, (B, S, KV, D), dt, 3 * i + 1, dev)
            v = _randn(torch, (B, S, KV, D), dt, 3 * i + 2, dev)
            g = torch.Generator(device=dev)
            g.manual_seed(i)
            length = torch.randint(1, S + 1, (B,), generator=g, device=dev,
                                   dtype=torch.int32)
            if B > 1:
                length[0] = 0
            name = f"decode {(B, S, H, KV, D)} {_dt(q)}"
            o, m, l = da.decode_attention_fwd(q, k, v, length)
            po, pm, pl = da.plain(q, k, v, length)
            empty = length == 0
            if not ((m[empty] == -1e30).all() and (l[empty] == 0).all()
                    and (o[empty] == 0).all()):
                raise AssertionError(f"{name}: a length-0 row is not m=-1e30, l=0, o=0")
            tol = ATTN_TOL[_dt(q)]
            err = close(torch, name, o[~empty] / l[~empty][..., None],
                        po[~empty] / pl[~empty][..., None], tol)
            close(torch, name + " m", m, pm, tol)
            close(torch, name + " l", l, pl, tol)
            worst["decode_attention"] = max(worst["decode_attention"], err)
    c = da.CHUNK
    for i, (S, H, KV, D) in enumerate(DECODE_SPLIT_CHECKS):
        for dt in (torch.float32, torch.bfloat16):
            length = torch.tensor([0, 1, c - 1, c, c + 1, S], dtype=torch.int32, device=dev)
            B = length.numel()
            q = _randn(torch, (B, H, D), dt, 50 + 3 * i, dev)
            k = _randn(torch, (B, S, KV, D), dt, 51 + 3 * i, dev)
            v = _randn(torch, (B, S, KV, D), dt, 52 + 3 * i, dev)
            name = f"decode split {(B, S, H, KV, D)} {_dt(q)}"
            o, m, l = da.decode_attention_fwd(q, k, v, length)
            if not ((m[0] == -1e30).all() and (l[0] == 0).all() and (o[0] == 0).all()):
                raise AssertionError(f"{name}: the length-0 row is not m=-1e30, l=0, o=0")
            tol = ATTN_TOL[_dt(q)]
            for tag, (po, pm, pl) in (("plain", da.plain(q, k, v, length)),
                                      ("plain_split", da.plain_split(q, k, v, length))):
                err = close(torch, f"{name} vs {tag}", o[1:] / l[1:, :, None],
                            po[1:] / pl[1:, :, None], tol)
                close(torch, f"{name} m vs {tag}", m, pm, tol)
                close(torch, f"{name} l vs {tag}", l, pl, tol)
                worst["decode_attention"] = max(worst["decode_attention"], err)
    torch.cuda.synchronize()
    log("check lm kernels at tests/test_kernels.py shapes (f32 + bf16), worst max |diff|:",
        json.dumps(worst))
    return worst


def time_lm_kernels(torch, flush, extras):
    """B2-B4 at the serve path's shapes in bf16: kernel vs plain version,
    then device ms, call ms, plain ms, the PyTorch yardstick's ms, bound.
    B2 also beside the baseline kernel, its other layouts and the launch
    floor."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    B, S, new = SERVE["batch"], SERVE["prompt_len"], SERVE["max_new"]
    D, H, KV, HD = 7168, 56, 8, 128
    rows = {}

    torch_version = tuple(int(p) for p in torch.__version__.split("+")[0].split(".")[:2])
    # the yardsticks need F.rms_norm (torch 2.4) and SDPA's enable_gqa (2.5);
    # before 2.5 SDPA gets k and v with their heads repeated up front
    gqa = {"enable_gqa": True} if torch_version >= (2, 5) else {}

    def kv_heads(t):
        return t if gqa else t.repeat_interleave(H // KV, dim=1)

    def row(name, shape, err, fn, args, plain_fn, lib_fn, nbytes, flops, peak,
            iters, plain_iters, lib_err=None):
        kernel_ms = time_device(fn, args, iters, flush, batch=min(iters, 20))
        call_ms = time_call(fn, args, iters, flush)
        plain_ms = time_device(plain_fn, args, plain_iters, flush, batch=plain_iters)
        library_ms = (None if lib_fn is None else
                      time_device(lib_fn, args, iters, flush, batch=min(iters, 20)))
        bound_ms, bound_by = bound(nbytes, flops, peak)
        r = {"shape": shape, "dtype": "bfloat16", "max_abs_err": err, "kernel_ms": kernel_ms,
             "kernel_call_ms": call_ms, "plain_ms": plain_ms, "library_ms": library_ms,
             "library_max_abs_err": lib_err, "bound_ms": bound_ms, "bound_by": bound_by,
             "bytes": nbytes, "flops": flops}
        log(f"kernel {name}", json.dumps(r))
        return r

    # the launch floor: an empty kernel in the same harness
    floor_ms = time_device(extras["empty"], (), 200, None)
    floor_flushed_ms = time_device(extras["empty"], (), 200, flush)
    log("launch floor (empty kernel)", json.dumps({"warm_ms": floor_ms,
                                                   "after_flush_ms": floor_flushed_ms}))
    sm = torch.cuda.get_device_properties(dev).multi_processor_count

    # B2 rmsnorm: every prefill norm (B*S rows) and every decode norm (B rows)
    for tag, rows_shape in (("prefill", (B, S, D)), ("decode", (B, 1, D))):
        x = _randn(torch, rows_shape, bf16, 7, dev)
        w = _randn(torch, (D,), bf16, 8, dev)
        got = rms.rmsnorm(x, w)
        err = close(torch, f"rmsnorm {tag}", got, rms.plain(x, w), RMS_TOL["bfloat16"])
        lib = (lambda x, w: F.rms_norm(x, (D,), w, 1e-6)) if hasattr(F, "rms_norm") else None
        lib_err = None if lib is None else close(torch, "F.rms_norm", lib(x, w), got,
                                                 YARDSTICK_TOL)
        R = x.numel() // D
        plan = rms.launch_plan(R, D, bf16, sm)
        log(f"rmsnorm {tag}: {R} rows on {sm} SMs -> {plan.layout} layout, {plan}")
        r = row(f"rmsnorm {tag}", list(rows_shape), err, rms.rmsnorm, (x, w), rms.plain,
                lib, 2 * R * D * 2 + D * 2, 4 * R * D, F32_FLOPS_PER_S, 200, 20, lib_err)
        r["plan"] = plan._asdict()
        r["layout"] = plan.layout
        r["launch_floor_ms"] = floor_ms
        log(f"rmsnorm {tag}: launch floor {floor_ms:.6f} ms (empty kernel, same harness) "
            f"beside the bound {r['bound_ms']:.6f} ms")
        if "rmsnorm" in extras:
            old = extras["rmsnorm"]
            close(torch, f"baseline rmsnorm {tag}", old(x, w), rms.plain(x, w),
                  RMS_TOL["bfloat16"])
            r["baseline_ms"], r["new_ms_in_turns"] = in_turns(old, rms.rmsnorm, (x, w),
                                                              200, flush)
        if tag == "decode":
            # x warm in L2, as the decode step finds it (written by the op before)
            r["kernel_warm_ms"] = time_device(rms.rmsnorm, (x, w), 200, None)
            if "rmsnorm" in extras:
                r["baseline_warm_ms"], r["new_warm_ms_in_turns"] = in_turns(
                    extras["rmsnorm"], rms.rmsnorm, (x, w), 200, None)
            # the other layouts, forced: the row split over clusters of 8
            # and 16 CTAs, one CTA per row of 896 threads of one vector
            alts = {f"cluster K={k}": rms.launch_plan(R, D, bf16, sm, K=k) for k in (8, 16)}
            alts["wide_row 896x1"] = plan._replace(threads=896, vpt=1)
            out = torch.empty_like(x)
            timed = {}
            for name, p in alts.items():
                close(torch, f"rmsnorm decode {name}", rms._launch(x, w, out, 1e-6, p),
                      rms.plain(x, w), RMS_TOL["bfloat16"])
                args = (x, w, out, 1e-6, p)
                timed[name] = {"plan": p._asdict(),
                               "flushed_ms": time_device(rms._launch, args, 200, flush),
                               "warm_ms": time_device(rms._launch, args, 200, None)}
            r["alternatives"] = timed
        log(f"kernel rmsnorm {tag} (detail)", json.dumps(r))
        rows[f"rmsnorm_{tag}"] = r
        del x, w, got

    # B3 flash attention: one prefill layer, causal, q_offset 0
    q = _randn(torch, (B, S, H, HD), bf16, 9, dev)
    k = _randn(torch, (B, S, KV, HD), bf16, 10, dev)
    v = _randn(torch, (B, S, KV, HD), bf16, 11, dev)
    out, lse = fa.flash_attention_fwd(q, k, v, 0, True)
    want, want_lse = fa.plain(q, k, v, 0, True)
    err = close(torch, "flash prefill", out, want, ATTN_TOL["bfloat16"])
    close(torch, "flash prefill lse", lse, want_lse, ATTN_TOL["bfloat16"])

    kt, vt = kv_heads(k.transpose(1, 2)), kv_heads(v.transpose(1, 2))

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q.transpose(1, 2), kt, vt, is_causal=True,
                                              **gqa)
    lib_err = close(torch, "sdpa prefill", sdpa(q, k, v).transpose(1, 2), out,
                    YARDSTICK_TOL)
    pairs = S * (S + 1) // 2
    if fa.launch_plan(q.dtype, HD, HD).kernel != "wgmma":
        raise AssertionError("the serve shape does not take the wgmma flash kernel")
    nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * 2 + lse.numel() * 4
    flops = 2 * B * H * pairs * (HD + HD)
    rows["flash_attention"] = row(
        "flash_attention prefill (wgmma)", [B, S, S, H, KV, HD, HD], err,
        lambda q, k, v: fa.flash_attention_fwd(q, k, v, 0, True), (q, k, v),
        lambda q, k, v: fa.plain(q, k, v, 0, True), sdpa, nbytes, flops,
        BF16_FLOPS_PER_S, 50, 5, lib_err)
    # the tf32x3 kernel (the f32 path) in bf16 on the same inputs, beside wgmma
    def tf32x3(q, k, v):
        return fa._launch("tf32x3", q, k, v, 0, True, None)
    s_out, s_lse = tf32x3(q, k, v)
    s_err = close(torch, "flash prefill tf32x3", s_out, want, ATTN_TOL["bfloat16"])
    close(torch, "flash prefill tf32x3 lse", s_lse, want_lse, ATTN_TOL["bfloat16"])
    # same function and inputs: the bound, plain and SDPA times carry over
    r = dict(rows["flash_attention"], max_abs_err=s_err,
             kernel_ms=time_device(tf32x3, (q, k, v), 10, flush, batch=10),
             kernel_call_ms=time_call(tf32x3, (q, k, v), 10, flush))
    log("kernel flash_attention prefill (tf32x3, bf16)", json.dumps(r))
    rows["flash_attention_tf32x3_bf16"] = r
    del q, k, v, kt, vt, out, lse, want, want_lse, s_out, s_lse

    # B4 decode attention: one decode layer at the last step (full 2112 cache)
    Sc = S + new
    q = _randn(torch, (B, H, HD), bf16, 12, dev)
    k = _randn(torch, (B, Sc, KV, HD), bf16, 13, dev)
    v = _randn(torch, (B, Sc, KV, HD), bf16, 14, dev)
    length = torch.full((B,), Sc, dtype=torch.int32, device=dev)
    o, m, l = da.decode_attention_fwd(q, k, v, length)
    po, pm, pl = da.plain(q, k, v, length)
    err = close(torch, "decode serve", o / l[..., None], po / pl[..., None],
                ATTN_TOL["bfloat16"])
    close(torch, "decode serve m", m, pm, ATTN_TOL["bfloat16"])
    mask = (torch.arange(Sc, device=dev)[None] < length[:, None])[:, None, None, :]

    kt, vt = kv_heads(k.transpose(1, 2)), kv_heads(v.transpose(1, 2))

    def sdpa_decode(q, k, v, length):
        return F.scaled_dot_product_attention(q[:, :, None], kt, vt, attn_mask=mask, **gqa)
    lib_err = close(torch, "sdpa decode", sdpa_decode(q, k, v, length)[:, :, 0],
                    o / l[..., None], YARDSTICK_TOL)
    keys = int(torch.clamp(length, max=Sc).sum().item())
    rows["decode_attention"] = row(
        "decode_attention step", [B, Sc, H, KV, HD], err, da.decode_attention_fwd,
        (q, k, v, length), da.plain, sdpa_decode,
        keys * KV * (HD + HD) * 2 + q.numel() * 2 + (o.numel() + 2 * m.numel() + B) * 4,
        2 * keys * H * (HD + HD), BF16_FLOPS_PER_S, 200, 20, lib_err)
    del q, k, v, kt, vt, o, m, l, po, pm, pl
    torch.cuda.empty_cache()
    return rows


def time_f32_flash(torch, flush, extras):
    """B3 in f32 on the tf32x3 kernel (slice 11) at F32_FLASH's shapes
    (a causal one with its last query on the last key, as the paths call
    it): against its plain version (2e-5), then its device
    ms beside the plain version's, SDPA's in f32 (the backend it took
    named; TF32 off, as the entry points set it), the PR 12 kernel's (with
    ``--baseline``, causal at Sq = Sk only, in turns: old, new, new, old)
    and the bound at both
    rates: the products over the f32 CUDA cores' rate
    (``bound_f32_cores_ms``), and their three TF32 passes over the tensor
    cores' (``bound_ms``: the kernel's own operations)."""
    from repro_torch.kernels import flash_attention as fa
    dev, f32 = torch.device("cuda"), torch.float32
    rows = {}
    for i, (name, (B, Sq, Sk, H, KV, Dk, Dv, causal)) in enumerate(F32_FLASH.items()):
        q = _randn(torch, (B, Sq, H, Dk), f32, 200 + 3 * i, dev)
        k = _randn(torch, (B, Sk, KV, Dk), f32, 201 + 3 * i, dev)
        v = _randn(torch, (B, Sk, KV, Dv), f32, 202 + 3 * i, dev)
        off = Sk - Sq if causal else 0
        plan = fa.launch_plan(f32, Dk, Dv)
        before = fa.flash_attention_fwd.launches_by_kernel["tf32x3"]
        out, lse = fa.flash_attention_fwd(q, k, v, off, causal)
        torch.cuda.synchronize()
        if plan.kernel != "tf32x3" or \
                fa.flash_attention_fwd.launches_by_kernel["tf32x3"] != before + 1:
            raise AssertionError(f"flash f32 {name}: not launched on the tf32x3 kernel")
        want, want_lse = fa.plain(q, k, v, off, causal)
        err = close(torch, f"flash f32 {name}", out, want, ATTN_TOL["float32"])
        close(torch, f"flash f32 {name} lse", lse, want_lse, ATTN_TOL["float32"])
        lib, lib_args, _, backend = sdpa_yardstick(torch, q, k, v, Dk ** -0.5, causal)
        lib_err = close(torch, f"sdpa f32 {name} ({backend})",
                        lib(*lib_args).transpose(1, 2), out, YARDSTICK_TOL)
        pairs = Sq * (Sq + 1) // 2 + Sq * off if causal else Sq * Sk
        nbytes = (q.numel() + k.numel() + v.numel() + out.numel() + lse.numel()) * 4
        flops = 2 * B * H * pairs * (Dk + Dv)
        big = Sk > 64
        it, pit = (20, 2) if big else (200, 20)

        def ours(q, k, v, off=off, causal=causal):
            return fa.flash_attention_fwd(q, k, v, off, causal)
        r = {"shape": [B, Sq, Sk, H, KV, Dk, Dv], "causal": causal, "dtype": "float32",
             "plan": plan._asdict(),
             "max_abs_err": err, "kernel_ms": time_device(ours, (q, k, v), it, flush,
                                                          batch=min(it, 10)),
             "kernel_call_ms": time_call(ours, (q, k, v), it, flush),
             "plain_ms": time_device(lambda q, k, v: fa.plain(q, k, v, off, causal), (q, k, v),
                                     pit, flush, batch=min(pit, 10)),
             "library_ms": time_device(lib, lib_args, it // 2, flush, batch=min(it // 2, 10)),
             "library_backend": backend, "library_max_abs_err": lib_err,
             "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                      "cudnn": torch.backends.cudnn.allow_tf32},
             "bytes": nbytes, "flops": flops, "tf32_flops": 3 * flops}
        r["bound_ms"], r["bound_by"] = bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)
        r["bound_f32_cores_ms"], r["bound_f32_cores_by"] = bound(nbytes, flops,
                                                                 F32_FLOPS_PER_S)
        if "flash_attention" in extras and causal and Sq == Sk:
            # the PR 12 kernel on the same inputs
            old = extras["flash_attention"]
            r["baseline_max_abs_err"] = close(torch, f"baseline flash f32 {name}",
                                              old(q, k, v)[0], want, ATTN_TOL["float32"])
            r["baseline_ms"], r["new_ms_in_turns"] = in_turns(
                old, ours, (q, k, v), 4 if big else 100, flush, batch=2 if big else 20)
        log(f"kernel flash_attention f32 {name} (tf32x3)", json.dumps(r))
        rows[name] = r
        del q, k, v, out, lse, want, want_lse, lib_args
        torch.cuda.empty_cache()
    return rows


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _zero_counts(kernels):
    """Every kernel's launch count and its counts by shape to 0, B2's by
    layout and B3's by kernel, and B3's backward's (``flash_attention_bwd``,
    counted apart from ``kernels``: the paths that read its counts read them
    by name)."""
    from repro_torch.kernels import flash_attention as fa
    for fn in (*kernels.values(), fa.flash_attention_bwd):
        fn.launches = 0
        fn.launches_by_shape = {}
    kernels["rmsnorm"].launches_by_layout = {k: 0 for k in
                                             kernels["rmsnorm"].launches_by_layout}
    for fn in (kernels["flash_attention"], fa.flash_attention_bwd):
        fn.launches_by_kernel = {k: 0 for k in fn.launches_by_kernel}


def shape_name(key) -> str:
    """A ``launches_by_shape`` key as text: its sizes joined by x, and B3's
    causal flag as causal or full."""
    if isinstance(key[-1], bool):
        return "x".join(map(str, key[:-1])) + (" causal" if key[-1] else " full")
    return "x".join(map(str, key))


def named(counts) -> dict:
    """{shape key: launches} with the keys as ``shape_name`` gives them."""
    return {shape_name(k): n for k, n in counts.items()}


def launches_by_shape(kernels) -> dict:
    """Each kernel's launches by shape since its counts were zeroed, as the
    wrappers counted them where they launch."""
    return {name: named(fn.launches_by_shape) for name, fn in kernels.items()}


def phase_serve(torch, kernels):
    """The serve path at yi-34b's full width: one counted run of
    ``generate``, a second for determinism and its wall time, then prefill
    and decode steps on their own for their times and bitwise logits."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import model_zoo
    from repro_torch.models.transformer import pad_caches
    dev = torch.device("cuda")
    cfg = get_config(SERVE["arch"]).replace(n_layers=SERVE["n_layers"])
    model = model_zoo.build(cfg)
    B, S, new, L = SERVE["batch"], SERVE["prompt_len"], SERVE["max_new"], cfg.n_layers
    g = torch.Generator(device=dev)
    g.manual_seed(SERVE["seed"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(g, dtype=torch.bfloat16)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"serve: {cfg.name} d_model {cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} "
        f"d_ff {cfg.d_ff} vocab {cfg.padded_vocab}, {L} of 60 layers, bf16: "
        f"{n_params} params ({n_params * 2 / 1e9:.2f} GB) drawn in {init_s:.2f}s")

    # the serve path; counts zeroed just before it and read just after
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(kernels)
    flash, norm = kernels["flash_attention"], kernels["rmsnorm"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = generate(model, params, prompts, new)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    flash_by_kernel = dict(flash.launches_by_kernel)
    norm_by_layout = dict(norm.launches_by_layout)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {"quant_aggregate": 0, "rmsnorm": (2 * L + 1) * (1 + new),
            "flash_attention": L, "decode_attention": L * new}
    log(f"serve launches {json.dumps(launches)} (want {json.dumps(want)}); flash by "
        f"kernel {json.dumps(flash_by_kernel)}; rmsnorm by layout "
        f"{json.dumps(norm_by_layout)}")
    if launches != want:
        raise AssertionError(f"serve path launches {launches}, want {want}")
    # prefill's B*S rows take the narrow CTA per row, decode's B rows the wide one
    want_layout = {"row": 2 * L + 1, "wide_row": (2 * L + 1) * new, "cluster": 0}
    if norm_by_layout != want_layout:
        raise AssertionError(f"serve path rmsnorm launches by layout {norm_by_layout}, "
                             f"want {want_layout}")
    if flash_by_kernel != {"wgmma": L, "tf32x3": 0}:
        raise AssertionError(f"serve path flash launches {flash_by_kernel}, want all "
                             f"{L} on the wgmma kernel")
    if toks.shape != (B, new) or toks.min() < 0 or toks.max() >= cfg.padded_vocab:
        raise AssertionError(f"serve: bad tokens {tuple(toks.shape)}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks2 = generate(model, params, prompts, new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    if not torch.equal(toks, toks2):
        raise AssertionError("serve: a second generate gave other tokens")

    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        caches, logits, _ = model.prefill(params, {"tokens": prompts})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        caches2, logits2, _ = model.prefill(params, {"tokens": prompts})
        if not torch.equal(logits, logits2) or not torch.equal(caches.k, caches2.k):
            raise AssertionError("serve: two prefills gave other logits or caches")
        if not torch.isfinite(logits).all() or \
                not torch.equal(model.greedy_token(logits), toks[:, 0]):
            raise AssertionError("serve: prefill logits do not give generate's token 0")
        caches, caches2 = pad_caches(caches, new), pad_caches(caches2, new)
        length = torch.full((B,), S, dtype=torch.int32, device=dev)
        step_ms = []
        n_steps = min(8, new - 1)
        for i in range(n_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dl, caches = model.decode_step(params, toks[:, i], caches, length + i)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                dl2, caches2 = model.decode_step(params, toks[:, 0], caches2, length)
                if not torch.equal(dl, dl2):
                    raise AssertionError("serve: two decode steps gave other logits")
            if not torch.equal(model.greedy_token(dl), toks[:, i + 1]):
                raise AssertionError(f"serve: decode step {i} does not give generate's "
                                     f"token {i + 1}")
        # where the time goes: one prefill and one decode step, profiled
        prof_prefill, by_prefill = profile_device(
            torch, lambda: model.prefill(params, {"tokens": prompts}), "serve prefill")
        prof_decode, by_decode = profile_device(
            torch, lambda: model.decode_step(params, toks[:, n_steps], caches,
                                             length + n_steps), "serve decode step")
        for label, prof, by_name in (("prefill", prof_prefill, by_prefill),
                                     ("decode step", prof_decode, by_decode)):
            for tag in ("flash_wgmma", "decode_mma", "decode_combine", "rmsnorm"):
                hits = [v for k, v in by_name.items() if tag in k]
                ms, n = sum(h[0] for h in hits), sum(h[1] for h in hits)
                prof[f"{tag}_ms"] = ms
                log(f"  {label}: {tag} {ms:.4f} ms x{n} "
                    f"({100 * ms / max(prof['kernel_sum_ms'], 1e-9):.1f}% of kernel time)")
    out = {"arch": cfg.name, "n_layers": L, "batch": B, "prompt_len": S, "max_new": new,
           "cache_len": S + new, "params": n_params, "init_s": init_s,
           "first_generate_s": first_s, "generate_s": gen_s, "prefill_s": prefill_s,
           "decode_ms_per_token": (gen_s - prefill_s) / new * 1e3,
           "decode_step_ms": sorted(step_ms)[len(step_ms) // 2],
           "generated_tokens_per_s": B * new / gen_s,
           "peak_mem_gb": peak_gb, "launches": launches, "flash_by_kernel": flash_by_kernel,
           "rmsnorm_by_layout": norm_by_layout,
           "bitwise_repeat": True, "tokens_head": toks[0, :8].tolist(),
           "profile_prefill": prof_prefill, "profile_decode_step": prof_decode}
    log("serve", json.dumps(out))
    del params, caches, caches2, logits, logits2
    torch.cuda.empty_cache()
    return out


def phase_serve_card_vs_cpu(torch, arch=SERVE["arch"]):
    """Reduced yi-34b (or ``arch``) in f32 from the same weights: one
    prefill and 4 greedy decode steps on the card (kernels) and on the CPU
    (plain); the encoder-decoder's prefill also takes 64 frames beside a
    prompt of 8."""
    from repro_torch.configs.base import get_config
    from repro_torch.configs.reduce import reduced_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model_zoo
    from repro_torch.models.transformer import pad_caches
    model = model_zoo.build(reduced_config(get_config(arch)))
    cfg = model.cfg
    params = model.init(torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    S = 64 // cfg.dec_len_ratio if cfg.family == "encdec" else 64
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, S), generator=gen)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((2, 64, cfg.d_model), generator=gen)
    out = {}
    # the f32 serve path (head dim 16) runs the tf32x3 flash kernel; its
    # counts (by kernel and by shape) are zeroed just before the card's run
    # and read just after
    fa.flash_attention_fwd.launches_by_kernel = {k: 0 for k in fa.SOURCES}
    fa.flash_attention_fwd.launches_by_shape = {}
    for dev in ("cuda", "cpu"):
        p = _tree_to(params, dev)
        with torch.inference_mode():
            caches, logits, _ = model.prefill(p, {k: v.to(dev) for k, v in batch.items()})
            caches = pad_caches(caches, 4)
            length = torch.full((2,), S, dtype=torch.int32, device=dev)
            all_logits, toks = [logits], []
            tok = model.greedy_token(logits)
            for _ in range(4):
                toks.append(tok)
                logits, caches = model.decode_step(p, tok, caches, length)
                all_logits.append(logits)
                tok = model.greedy_token(logits)
                length = length + 1
            toks.append(tok)
        out[dev] = (torch.stack(toks).cpu(), torch.stack(all_logits).cpu())
    flash_by_kernel = dict(fa.flash_attention_fwd.launches_by_kernel)
    flash_by_shape = named(fa.flash_attention_fwd.launches_by_shape)
    if flash_by_kernel != {"wgmma": 0, "tf32x3": attention_layers(cfg)}:
        raise AssertionError(f"f32 serve path flash launches {flash_by_kernel}")
    if not torch.equal(out["cuda"][0], out["cpu"][0]):
        raise AssertionError("serve card vs cpu: tokens differ")
    # tolerance: f32 matmuls sum in another order on the card (TF32 off)
    err = close(torch, "serve card vs cpu logits", out["cuda"][1], out["cpu"][1], 1e-4)
    res = {"max_abs_logit_diff": err, "tokens_equal": True, "steps": 4,
           "flash_by_kernel": flash_by_kernel, "flash_by_shape": flash_by_shape,
           "mla": cfg.attn_type == "mla"}
    log(f"serve card vs cpu (reduced {arch}, f32, prefill + 4 decode steps)", json.dumps(res))
    return res


# phase 8 (slice 7): campaigns (sweeps, the planner, successive halving), the
# flight recorder and the round probes, on MAIN_JOB
LANE_SHAPE = (4, 100, 189_952, 256)    # S lanes of the FL path's C x N, qblock
SWEEP = {"seed": [0, 1], "client_lr": [0.05, 0.1]}
PLAN_SWEEP = {"strategy": ["fedavg", "fedprox"], "mode": ["sync", "async"], "seed": [0, 1]}
PLAN_TRAIN = {"prox_mu": 0.01, "async_buffer": 10, "staleness_exponent": 0.5}
# a campaign lane's losses against its single run's on the card, where the
# lanes' convs take other algorithms (ROADMAP C): 3 rounds at client_lr up
# to 0.1 from a first loss up to 20 stayed within 6e-3 (this script, on an H100)
LANE_LOSS_RTOL = 3e-2


def losses_close(got, want, rtol) -> bool:
    return len(got) == len(want) and all(
        abs(a - b) <= rtol * abs(b) for a, b in zip(got, want))


def lane_op_check(torch):
    """Which ops of a campaign round give other bits for a lane than for
    the single run of it on the card: each op at the FL path's shapes (a
    client batch of 32 CIFAR images, flsim-cnn's widths), run for 4 lanes
    under ``torch.func.vmap`` and for each lane alone; logs bitwise or the
    max |diff|."""
    import torch.nn.functional as F
    from torch.func import grad, vmap
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    S, C, B = 4, 8, 32

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    x = rnd(S, C, B, 32, 32, 32)
    w = rnd(S, 64, 32, 3, 3) * 0.1
    wc = rnd(S, C, 64, 32, 3, 3) * 0.1
    h, fc = rnd(S, C, B, 1024), rnd(S, 1024, 128) * 0.03
    d = rnd(S, C, 189_952)
    cw = torch.rand((S, C), generator=g, device=dev)

    def conv(w, x):
        return F.conv2d(x, w, padding=1)

    def conv_wgrad(w, x):
        return grad(lambda w: (F.conv2d(x, w, padding=1) ** 2).sum())(w)

    checks = {
        "conv forward, weights shared by the clients": (
            lambda w, x: vmap(conv, in_dims=(None, 0))(w, x), (w, x)),
        "conv forward, a weight per client": (
            lambda w, x: vmap(conv)(w, x), (wc, x)),
        "conv weight gradient, a weight per client": (
            lambda w, x: vmap(conv_wgrad)(w, x), (wc, x)),
        "dense matmul, weights shared by the clients": (
            lambda w, h: vmap(lambda hh: hh @ w)(h), (fc, h)),
        "client-weighted sum over the clients": (
            lambda cw, d: (cw[:, None] * d).sum(0), (cw, d)),
    }
    out = {}
    for name, (fn, args) in checks.items():
        lanes = vmap(fn)(*args)
        single = torch.stack([fn(*(a[s] for a in args)) for s in range(S)])
        diff = (lanes - single).abs().max().item()
        out[name] = {"bitwise": torch.equal(lanes, single), "max_abs_diff": diff}
    log("lane ops vs single run on the card", json.dumps(out))
    return out


def phase_b1_lanes(torch, qa):
    """B1 over S = 4 lanes of C = 100 x N = 189,952 in one launch: bitwise
    its plain version (lane by lane) and four single (C, N) launches, timed
    beside them and its bound."""
    dev = torch.device("cuda")
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    S, C, N, qblock = LANE_SHAPE
    lanes = [agg_inputs(C, N, qblock, seed=40 + s, device=dev) for s in range(S)]
    q, s, w = (torch.stack([ln[i] for ln in lanes]).contiguous() for i in range(3))
    got = qa.quant_aggregate(q, s, w)
    want = qa.plain(q, s, w)
    singles = torch.stack([qa.quant_aggregate(*ln) for ln in lanes])
    torch.cuda.synchronize()
    if got.shape != (S, N) or not torch.isfinite(got).all():
        raise AssertionError("quant_aggregate lanes: bad output")
    if not (torch.equal(got, want) and torch.equal(got, singles)):
        raise AssertionError("quant_aggregate lanes: not bitwise its plain version and "
                             f"its single launches (max |diff| {(got - want).abs().max()})")
    nbytes = S * (C * N + 4 * C * (N // qblock) + 4 * C + 4 * N)
    bound_ms, bound_by = bound(nbytes, 3 * S * C * N, F32_FLOPS_PER_S)

    def four_singles(q, s, w):
        for i in range(S):
            qa.quant_aggregate(q[i], s[i], w[i])

    row = {"S": S, "C": C, "N": N, "qblock": qblock, "bitwise": True, "max_abs_err": 0.0,
           "plan": qa.launch_plan(C, N, qblock, S=S)._asdict(),
           "kernel_ms": time_device(qa.quant_aggregate, (q, s, w), 200, flush),
           "kernel_call_ms": time_call(qa.quant_aggregate, (q, s, w), 200, flush),
           "four_single_launches_ms": time_device(four_singles, (q, s, w), 100, flush),
           "plain_ms": time_device(qa.plain, (q, s, w), 20, flush, batch=2),
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "library_ms": None}
    tiles = {}
    for tile in qa.TILES:
        p = qa.launch_plan(C, N, qblock, S=S, tile=tile)
        if not torch.equal(qa._launch(q, s, w, qblock, p), want):
            raise AssertionError(f"quant_aggregate lanes, tile {tile}: not bitwise plain")
        tiles[tile] = time_device(qa._launch, (q, s, w, qblock, p), 200, flush)
    row["ms_by_tile"] = tiles
    log("kernel quant_aggregate lanes", json.dumps(row))
    del flush
    return row


class _CachedDatasets:
    """Campaign staging draws each lane's dataset through
    ``core.jobs.make_dataset``; this wraps it so the phase's jobs share one
    partitioned root set per (items, seed, partition) through ``_DATA``, as
    ``_SharedData`` does for single runs."""

    def __init__(self, module):
        self.module, self.orig = module, module.make_dataset

    def __enter__(self):
        self.module.make_dataset = lambda raw, fl, cfg=None: _SharedData(
            self.orig(raw, fl, cfg))
        return self

    def __exit__(self, *exc):
        self.module.make_dataset = self.orig
        return False


def _lane_diff(torch, single_state, campaign, s) -> float:
    """Max |diff| between a single run's state and lane ``s`` of a campaign."""
    from repro_torch.runtime.campaign import lane_of
    a, b = _flat(single_state), _flat(lane_of(campaign.state, s))
    if len(a) != len(b):
        raise AssertionError("lane and single run differ in their leaves")
    return max(((x.double() - y.double()).abs().max().item() if x.numel() else 0.0)
               for x, y in zip(a, b))


def run_campaign(torch, qa, load_job, label, raw, **kw):
    """One campaign through ``load_job`` -> ``CampaignExecutor``; B1's
    count set to 0 just before the run and read just after."""
    from repro_torch.runtime.campaign import CampaignExecutor
    job = load_job(raw)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ex = CampaignExecutor(job, **kw).scaffold()
    scaffold_s = time.perf_counter() - t0
    qa.quant_aggregate.launches = 0
    _, logger = ex.run()
    launches = qa.quant_aggregate.launches
    rows = logger.rows
    out = {"campaign": label, "S": ex.S, "round_s": [r["round_s"] for r in rows],
           "traj_round_s": [r["round_s"] / ex.S for r in rows], "scaffold_s": scaffold_s,
           "lane_losses": [[r["loss"] for r in ex.results if r["traj"] == s]
                           for s in range(ex.S)],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
           "agg_launches": launches}
    log("campaign", json.dumps(out))
    if not all(math.isfinite(v) for ls in out["lane_losses"] for v in ls):
        raise AssertionError(f"{label}: non-finite loss")
    return out, ex


def phase_campaigns(torch, qa, load_job, Executor):
    """Slice 7 at MAIN_JOB's width:

    - an int8 sweep ``{seed: [0, 1], client_lr: [0.05, 0.1]}`` (S = 4), 3
      rounds in chunks of 3 and of 1: one B1 launch per round for all four
      lanes, chunks of 1 bitwise chunks of 3, and each lane against the
      single run of its config (max |diff| and losses printed, bitwise
      expected); seconds per trajectory-round beside the single runs'
      ``round_s``;
    - a ``PlanExecutor`` over strategy [fedavg, fedprox] x mode [sync,
      async (FedBuff, K = 10)] x seed [0, 1] with successive halving (eta 2
      at round 2), 3 rounds in chunks of 1 with a checkpoint every round;
      the same plan stopped at round 2 and resumed from its checkpoint and
      ``decisions.jsonl``: the same drops, bitwise the same lanes.

    Returns the phase's summary."""
    from repro_torch.runtime import campaign as campaign_mod
    from repro_torch.runtime.scheduler import PlanExecutor, SuccessiveHalving
    out = {}
    with _CachedDatasets(campaign_mod):
        raws = {}
        for rpl in (3, 1):
            raws[rpl] = dict(job_dict("compressed", "int8", rpl, rounds=3), sweep=SWEEP)
        # chunks of 1 first: its first round pays the lanes' first-use costs
        # (cuDNN's choices for the new conv shapes), so the chunks-of-3 run
        # after it gives the warm seconds per round
        c1, ex1 = run_campaign(torch, qa, load_job, "int8 sweep (chunks of 1)", raws[1])
        c3, ex3 = run_campaign(torch, qa, load_job, "int8 sweep (chunks of 3)", raws[3])
        if c3["agg_launches"] != 3 or c1["agg_launches"] != 3:
            raise AssertionError(f"int8 sweep: {c3['agg_launches']} / {c1['agg_launches']} "
                                 "B1 launches in 3 rounds, want one per round")
        if c1["lane_losses"] != c3["lane_losses"] or not _same(torch, ex1.state, ex3.state):
            raise AssertionError("int8 sweep: chunks of 1 != chunks of 3")
        log("int8 sweep: one B1 launch per round for 4 lanes; chunks of 1 == 3 bitwise")
        singles, diffs = [], []
        for s, fl_s in enumerate(ex3.fls):
            raw = job_dict("compressed", "int8", 3, rounds=3, seed=fl_s.seed,
                           client_lr=fl_s.client_lr)
            one, ex = run_slice5(torch, qa, load_job, Executor, f"single lane {s}", raw)
            diffs.append(_lane_diff(torch, ex.state, ex3, s))
            singles.append(one)
            del ex
        lanes = {"max_abs_diff": diffs, "bitwise": all(d == 0.0 for d in diffs),
                 "single_losses": [o["losses"] for o in singles],
                 "lane_losses": c3["lane_losses"],
                 "single_round_s": [o["round_s"] for o in singles],
                 "campaign_traj_round_s": c3["traj_round_s"]}
        log("lane vs single run", json.dumps(lanes))
        # on the card the lanes' convs run at other shapes than a single
        # run's (lane_op_check names the ops): the losses must still agree
        for got, want in zip(lanes["lane_losses"], lanes["single_losses"]):
            if not losses_close(got, want, LANE_LOSS_RTOL):
                raise AssertionError(f"lane losses {got} vs single run {want}")
        lanes["ops"] = lane_op_check(torch)
        out.update(sweep=c3, sweep_chunks_1=c1, lanes=lanes,
                   b1_launches_by_path={"campaign_int8": c3["agg_launches"]})
        del ex1, ex3
        torch.cuda.empty_cache()

        def plan_raw():
            raw = job_dict("fedavg", "none", 1, rounds=3, checkpoint_every=1,
                           runtime=ASYNC_RUNTIME, **PLAN_TRAIN)
            raw["sweep"] = PLAN_SWEEP
            return raw

        sched = SuccessiveHalving(metric="loss", rung_every=2, eta=2.0)
        base = ROOT / "build" / "chip_smoke" / "plan"
        shutil.rmtree(base, ignore_errors=True)

        def plan(name, rounds):
            t0 = time.perf_counter()
            pe = PlanExecutor(load_job(plan_raw()), scheduler=sched,
                              out_dir=str(base / name / "out"),
                              ckpt_dir=str(base / name / "ckpt")).scaffold()
            pe.run(rounds)
            return pe, time.perf_counter() - t0

        full, full_s = plan("full", 3)
        _, half_s = plan("resumed", 2)
        resumed, resumed_s = plan("resumed", 3)
        if len(full.plan.buckets) != 4 or sorted(full.dropped) != sorted(resumed.dropped) \
                or len(full.dropped) != 4:
            raise AssertionError(f"plan: buckets {len(full.plan.buckets)}, drops "
                                 f"{full.dropped} vs resumed {resumed.dropped}")
        for lane in range(full.S):
            if not _same(torch, full.lane_params(lane), resumed.lane_params(lane)):
                raise AssertionError(f"plan: lane {lane} resumed != uninterrupted")
        rows = full.rows()
        plan_out = {"buckets": len(full.plan.buckets), "lanes": full.S,
                    "dropped": {str(k): v for k, v in sorted(full.dropped.items())},
                    "final_losses": {str(r["lane"]): r["loss"] for r in rows
                                     if r["round"] == 2},
                    "launch_keys": full.compiled_programs(),
                    "full_s": full_s, "half_s": half_s, "resumed_s": resumed_s}
        log("plan", json.dumps(plan_out))
        out["plan"] = plan_out
        shutil.rmtree(base, ignore_errors=True)
        del full, resumed
        torch.cuda.empty_cache()
    return out


TELEMETRY_JOBS = {   # name: (compression kwargs over MAIN_JOB, rounds)
    "spatial_int8": ({}, 3),
    "temporal_int8": ({"placement": "temporal"}, 1),
    "fedbuff_int8": ({"mode": "async", "async_buffer": 10, "staleness_exponent": 0.5}, 2),
}


def phase_telemetry(torch, qa, load_job, Executor):
    """The flight recorder and the round probes on == off, bitwise, for the
    spatial, temporal and FedBuff int8 jobs; ``round_s`` of both; a
    ``torch.profiler`` trace of the spatial job's first launch, which must
    hold B1's kernel; the trace report."""
    from repro_torch.telemetry import trace
    jobs = {}
    base = ROOT / "build" / "chip_smoke" / "telemetry"
    shutil.rmtree(base, ignore_errors=True)
    for name, (tp, rounds) in TELEMETRY_JOBS.items():
        runtime = ASYNC_RUNTIME if tp.get("mode") == "async" else None
        off = job_dict("compressed", "int8", 1, runtime=runtime, rounds=rounds, **tp)
        on = dict(off, telemetry={"out_dir": str(base / name),
                                  "profile_chunks": [0] if name == "spatial_int8" else []},
                  probes={"out_dir": str(base / name)})
        o_off, ex_off = run_slice5(torch, qa, load_job, Executor, f"{name} telemetry off", off)
        o_on, ex_on = run_slice5(torch, qa, load_job, Executor, f"{name} telemetry on", on)
        if o_on["losses"] != o_off["losses"] or not _same(torch, ex_on.state, ex_off.state):
            raise AssertionError(f"{name}: telemetry and probes on != off")
        if len(ex_on.probe_rows) != rounds or not all(
                r["nonfinite"] == 0.0 for r in ex_on.probe_rows):
            raise AssertionError(f"{name}: probes {ex_on.probe_rows}")
        jobs[name] = {"round_s_off": o_off["round_s"], "round_s_on": o_on["round_s"],
                      "last_probes": ex_on.probe_rows[-1]}
        if name == "spatial_int8":
            # where a warm round's time goes with and without them
            for label, ex in (("off", ex_off), ("on", ex_on)):
                prof, _ = profile_device(torch, lambda: ex.run(rounds + 1),
                                         f"one warm {name} round, telemetry {label}", top=4)
                jobs[name][f"profile_{label}"] = prof
        if name == "spatial_int8":
            path = ex_on.recorder.profile_paths[0]
            events = json.loads(path.read_text())
            events = events.get("traceEvents", events)
            b1 = [e for e in events if "quant_aggregate" in str(e.get("name", ""))
                  and e.get("cat") == "kernel"]
            if not b1:
                raise AssertionError(f"torch profile {path}: no quant_aggregate kernel")
            jobs[name]["profile_b1_kernels"] = len(b1)
            log(f"torch profile of launch 0: {len(b1)} quant_aggregate kernel events")
        ex_on.recorder.close()
        report = trace.report(base / name)
        log(report)
        jobs[name]["report_lines"] = len(report.splitlines())
        del ex_on, ex_off
        torch.cuda.empty_cache()
    log("telemetry and probes on == off bitwise for spatial, temporal and FedBuff int8",
        json.dumps({k: {"off": v["round_s_off"], "on": v["round_s_on"]}
                    for k, v in jobs.items()}))
    shutil.rmtree(base, ignore_errors=True)
    return jobs


# phase 9 (slice 8): the streaming client plane. MAIN_JOB's int8 job on the
# ragged plane (error feedback off: the plane carries no per-client state),
# a population that does not fit on the card, ragged async and a ragged
# campaign; B1 at the plane's shapes
RAGGED_TRAIN = {"max_cohort": 25, "error_feedback": False}
POPULATION_JOB = {
    "name": "chip_smoke_population",
    "model": {"arch": "flsim-cnn"},              # CIFAR-shaped shards, config width
    "dataset": {"dataset": "synthetic_population", "items_per_client": 8},
    "strategy": {"strategy": "compressed",
                 "train_params": {"n_clients": 1_000_000, "cohort": 100, "max_cohort": 128,
                                  "streaming": True, "compression": "int8",
                                  "error_feedback": False, "local_steps": 5,
                                  "batch_size": 8, "client_lr": 0.05, "rounds": 4,
                                  "rounds_per_launch": 2, "seed": 0}},
    "runtime": {"straggler_prob": 0.1, "straggler_overprovision": 1.25},
}
RAGGED_SWEEP = {"cohort": [10, 20], "seed": [0, 1]}
B1_RAGGED_SHAPES = {   # name: (S, C, N, qblock, real slots per lane)
    "ragged_c25": (1, 25, 189_952, 256, (20,)),
    "ragged_c128": (1, 128, 189_952, 256, (100,)),
    "ragged_lanes": (4, 25, 189_952, 256, (10, 20, 10, 20)),
}


def phase_b1_ragged(torch, qa):
    """B1 at the ragged plane's shapes, the pad slots at weight 0: bitwise
    its plain version, timed as phase 3 times it, beside its bound."""
    dev = torch.device("cuda")
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    rows = {}
    for i, (name, (S, C, N, qblock, real)) in enumerate(B1_RAGGED_SHAPES.items()):
        lanes = [agg_inputs(C, N, qblock, seed=60 + 4 * i + s, device=dev) for s in range(S)]
        for (_, _, w), k in zip(lanes, real):
            w[k:] = 0.0
        q, s, w = (torch.stack([ln[j] for ln in lanes]).contiguous() for j in range(3))
        if S == 1:
            q, s, w = q[0], s[0], w[0]
        got, want = qa.quant_aggregate(q, s, w), qa.plain(q, s, w)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all() or not torch.equal(got, want):
            raise AssertionError(f"quant_aggregate {name}: not bitwise its plain version")
        nbytes = S * (C * N + 4 * C * (N // qblock) + 4 * C + 4 * N)
        bound_ms, bound_by = bound(nbytes, 3 * S * C * N, F32_FLOPS_PER_S)
        rows[name] = {"S": S, "C": C, "N": N, "qblock": qblock, "real_slots": list(real),
                      "bitwise": True, "max_abs_err": 0.0,
                      "plan": qa.launch_plan(C, N, qblock, S=S)._asdict(),
                      "kernel_ms": time_device(qa.quant_aggregate, (q, s, w), 200, flush),
                      "kernel_call_ms": time_call(qa.quant_aggregate, (q, s, w), 200, flush),
                      "plain_ms": time_device(qa.plain, (q, s, w), 20, flush, batch=2),
                      "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
                      "library_ms": None}
        log(f"kernel quant_aggregate {name}", json.dumps(rows[name]))
    del flush
    return rows


def profile_copies(torch, fn, label):
    """``fn`` under ``torch.profiler``: the slab copies (pinned host to
    device) against the kernels: their streams, their device ms, and the ms
    of them that ran while a kernel ran on another stream."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = {(e.name, e.time_range.start, e.time_range.end, e.device_resource_id)
             for e in prof.events() if e.device_type == DeviceType.CUDA}
    copies = [sp for sp in spans if "Memcpy HtoD" in sp[0] and "Pinned" in sp[0]]
    kernels = [sp for sp in spans if "Memcpy" not in sp[0] and "Memset" not in sp[0]]

    def union(ivs):
        out = []
        for a, b in sorted(ivs):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    overlap_us = 0.0
    for _, a, b, stream in copies:
        for ka, kb in union([(x, y) for _, x, y, st in kernels if st != stream]):
            overlap_us += max(0.0, min(b, kb) - max(a, ka))
    copy_ms = sum(b - a for _, a, b, _ in copies) / 1e3
    out = {"wall_ms": wall_ms, "slab_copies": len(copies), "copy_ms": copy_ms,
           "copy_ms_under_kernels": overlap_us / 1e3,
           "copy_streams": sorted({str(sp[3]) for sp in copies}),
           "kernel_streams": sorted({str(sp[3]) for sp in kernels}),
           "kernels": len(kernels),
           "kernel_busy_ms": sum(b - a for a, b in union([(x, y) for _, x, y, _ in kernels]))
           / 1e3}
    log(f"profile {label}", json.dumps(out))
    return out


def _chunk_stats(stager) -> list:
    rows = stager.chunk_stats()
    return [{k: (list(v) if isinstance(v, tuple) else v) for k, v in r.items()} for r in rows]


def run_ragged(torch, qa, load_job, Executor, label, raw, rounds=None):
    """One ragged job through the entry points (``run_slice5``), with its
    stager's per-chunk host and copy times and slab bytes."""
    out, ex = run_slice5(torch, qa, load_job, Executor, label, raw, rounds=rounds)
    st = ex.stager
    out.update(peak_slab=st.peak_slab_bytes, resident_equiv=st.resident_bytes,
               data_plane=st.device_bytes, chunks=_chunk_stats(st))
    log(f"{label} stager", json.dumps({k: out[k] for k in (
        "peak_slab", "resident_equiv", "data_plane", "chunks")}))
    return out, ex


def phase_streaming(torch, qa, load_job, Executor):
    """Slice 8 at full width, through ``load_job`` -> ``Executor``:

    - MAIN_JOB's int8 job on the ragged plane (max_cohort 25), resident and
      streaming, 6 rounds in chunks of 3 and of 1: streaming == resident and
      chunks of 1 == chunks of 3, bitwise; B1 once a round at C = 25;
      ``round_s``, the host's plan and assembly seconds, the side stream's
      copy ms per chunk, ``peak_slab`` against ``resident_equiv``; then two
      warm streaming chunks under ``torch.profiler``, the second prefetched
      while the first runs: does the copy overlap the kernels?
    - a population of 1,000,000 CIFAR-shaped clients (98 GB if staged),
      cohort 100 of 128 slots, streaming, 4 rounds in chunks of 2: losses
      finite and falling, ``peak_slab < 0.01 resident_equiv``, B1 once a
      round at C = 128; the host's plan and shard seconds per chunk, and
      a further chunk under ``torch.profiler`` (the device's busy share);
    - ragged async: FedBuff (K = 10) and FedAsync on int8, 2 rounds, dense,
      resident and streaming: all three bitwise; B1 once per flush / event;
    - a ragged campaign, sweep cohort [10, 20] x seed [0, 1] (S = 4), 3
      rounds in chunks of 1, resident and streaming: one launch key, one B1
      launch of (4, 25, N) a round, streaming lanes == resident lanes
      bitwise, each lane's losses within LANE_LOSS_RTOL of its single run.

    B1's count is set to 0 just before each counted path and read just
    after. Returns the phase's summary."""
    from repro_torch.runtime import campaign as campaign_mod
    out, by_path = {}, {}

    # resident against streaming on MAIN_JOB's ragged int8 job
    runs = {}
    qa.quant_aggregate.launches = 0
    for rpl in (3, 1):
        for streaming in (False, True):
            raw = job_dict("compressed", "int8", rpl, streaming=streaming, **RAGGED_TRAIN)
            label = f"ragged int8 {'streaming' if streaming else 'resident'} (chunks of {rpl})"
            runs[(rpl, streaming)] = run_ragged(torch, qa, load_job, Executor, label, raw)
    by_path["ragged_int8_c25"] = qa.quant_aggregate.launches
    if by_path["ragged_int8_c25"] != 4 * 6 or any(
            o["agg_launches"] != 6 for o, _ in runs.values()):
        raise AssertionError(f"ragged int8: {by_path['ragged_int8_c25']} B1 launches in "
                             "4 runs of 6 rounds, want one a round")
    (ref, ex_ref) = runs[(3, False)]
    for key, (o, ex) in runs.items():
        if o["losses"] != ref["losses"] or not _same(torch, ex.state, ex_ref.state):
            raise AssertionError(f"ragged int8 {key} != resident chunks of 3")
    log("ragged int8: streaming == resident, chunks of 1 == chunks of 3, bitwise; "
        "B1 once a round at C = 25")
    ex_str = runs[(3, True)][1]
    out["main"] = {f"{'streaming' if s else 'resident'}_chunks_{r}": o
                   for (r, s), (o, _) in runs.items()}
    # two warm chunks: [6, 9) is taken synchronously, [9, 12) is prefetched
    # while [6, 9) runs
    prof = profile_copies(torch, lambda: ex_str.run(12), "two warm streaming chunks of 3")
    prof["chunks"] = _chunk_stats(ex_str.stager)[-2:]
    log("profiled chunks", json.dumps(prof["chunks"]))
    out["profile"] = prof
    del runs, ex_ref, ex_str
    torch.cuda.empty_cache()

    # a population that does not fit on the card
    qa.quant_aggregate.launches = 0
    t0 = time.perf_counter()
    pop, ex = run_ragged(torch, qa, load_job, Executor, "population 1e6 (streaming)",
                         POPULATION_JOB)
    pop["wall_s"] = time.perf_counter() - t0
    by_path["population_c128"] = qa.quant_aggregate.launches
    if by_path["population_c128"] != 4:
        raise AssertionError(f"population: {by_path['population_c128']} B1 launches in "
                             "4 rounds")
    if not pop["losses"][-1] < pop["losses"][0]:
        raise AssertionError(f"population: loss did not fall {pop['losses']}")
    if not pop["peak_slab"] < 0.01 * pop["resident_equiv"]:
        raise AssertionError(f"population: peak slab {pop['peak_slab']} against "
                             f"{pop['resident_equiv']} resident")
    log(f"population: peak slab {pop['peak_slab']} B = "
        f"{pop['peak_slab'] / pop['resident_equiv']:.2e} of {pop['resident_equiv']} B resident")
    # two more rounds, one chunk assembled in line: the device's busy share
    # of a chunk whose host plans and generates its shards first
    pop["profile"], _ = profile_device(torch, lambda: ex.run(6), "one population chunk "
                                       "(2 rounds, assembled in line)", top=4)
    pop["profile"]["chunk"] = _chunk_stats(ex.stager)[-1]
    log("profiled population chunk", json.dumps(pop["profile"]["chunk"]))
    out["population"] = pop
    del ex
    torch.cuda.empty_cache()

    # ragged async: dense, resident and streaming, bitwise
    for name, tp in ASYNC_JOBS.items():
        res = {}
        for plane, extra in (("dense", {}), ("resident", {"max_cohort": 100}),
                             ("streaming", {"max_cohort": 100, "streaming": True})):
            raw = job_dict("compressed", "int8", 1, runtime=ASYNC_RUNTIME, rounds=2,
                           mode="async", staleness_exponent=0.5, cohort=0,
                           error_feedback=False, **tp, **extra)
            qa.quant_aggregate.launches = 0
            run = run_ragged if extra else run_slice5
            o, ex = run(torch, qa, load_job, Executor, f"{name} {plane}", raw)
            n_ev = 2 * ex.events_per_round
            want = int(ex.schedule.apply[:n_ev].sum()) if tp["async_buffer"] > 1 else n_ev
            if qa.quant_aggregate.launches != want:
                raise AssertionError(f"{name} {plane}: {qa.quant_aggregate.launches} B1 "
                                     f"launches, want {want}")
            res[plane] = (o, ex)
        (dense, ex_d) = res["dense"]
        for plane in ("resident", "streaming"):
            o, ex = res[plane]
            if o["losses"] != dense["losses"] or not _same(torch, ex.state, ex_d.state):
                raise AssertionError(f"{name}: {plane} ragged != dense async")
        by_path[f"ragged_{name}"] = want
        out[f"async_{name}"] = {p: {k: o[k] for k in ("losses", "round_s", "events_per_s")
                                    if k in o} | {"chunks": o.get("chunks")}
                                for p, (o, _) in res.items()}
        log(f"ragged {name}: resident and streaming bitwise the dense run; "
            f"B1 launches {want}")
        del res, ex_d, ex
        torch.cuda.empty_cache()

    # a ragged campaign, resident and streaming
    with _CachedDatasets(campaign_mod):
        camps = {}
        for streaming in (False, True):
            raw = dict(job_dict("compressed", "int8", 1, rounds=3, streaming=streaming,
                                **RAGGED_TRAIN), sweep=RAGGED_SWEEP)
            c, ex = run_campaign(torch, qa, load_job, f"ragged int8 sweep "
                                 f"({'streaming' if streaming else 'resident'})", raw)
            c["launch_keys"] = ex.compiled_programs()
            c["peak_slab"] = ex.stager.peak_slab_bytes
            c["chunks"] = _chunk_stats(ex.stager)
            if c["agg_launches"] != 3 or c["launch_keys"] != 1:
                raise AssertionError(f"ragged sweep: {c['agg_launches']} B1 launches in 3 "
                                     f"rounds, {c['launch_keys']} launch keys")
            camps[streaming] = (c, ex)
        (c_res, ex_res), (c_str, ex_str) = camps[False], camps[True]
        if c_res["lane_losses"] != c_str["lane_losses"] or \
                not _same(torch, ex_res.state, ex_str.state):
            raise AssertionError("ragged sweep: streaming lanes != resident lanes")
        by_path["ragged_campaign_lanes"] = c_res["agg_launches"] + c_str["agg_launches"]
        singles, diffs = [], []
        for s, fl_s in enumerate(ex_res.fls):
            raw = job_dict("compressed", "int8", 1, rounds=3, seed=fl_s.seed,
                           cohort=fl_s.cohort, **RAGGED_TRAIN)
            one, ex = run_slice5(torch, qa, load_job, Executor, f"ragged single lane {s}", raw)
            diffs.append(_lane_diff(torch, ex.state, ex_res, s))
            singles.append(one["losses"])
            del ex
        for got, want in zip(c_res["lane_losses"], singles):
            if not losses_close(got, want, LANE_LOSS_RTOL):
                raise AssertionError(f"ragged lane losses {got} vs single run {want}")
        out["campaign"] = {"resident": c_res, "streaming": c_str, "single_losses": singles,
                           "lane_max_abs_diff": diffs}
        log("ragged sweep: one launch key, one B1 launch of (4, 25, N) a round, streaming "
            "lanes == resident lanes bitwise, lanes within LANE_LOSS_RTOL of single runs",
            json.dumps({"lane_max_abs_diff": diffs}))
        del camps, ex_res, ex_str
        torch.cuda.empty_cache()
    out["b1_launches_by_path"] = by_path
    return out


# phase 10 (slice 9): the LM training path. B2 and B3 under autograd and
# torch.func on the card, qwen2.5-32b trained at full width (bf16, depth cut
# 64 -> 2), reduced qwen2.5-32b / chameleon-34b card vs CPU, and serving of
# the QKV-bias and qk-norm archs at full width
TRAIN = {"arch": "qwen2.5-32b", "n_layers": 2, "strategy": "fedavgm", "clients": 4,
         "cohort": 2, "local_epochs": 1, "local_steps": 2, "batch": 2, "seq": 2048,
         "rounds": 3, "client_lr": 0.05, "server_momentum": 0.9,
         "norms_per_layer": 2}      # B2 launches a layer a forward: ln1, ln2
# gradients: max |got - want| within GRAD_TOL of max(1, max |want|), against
# autograd through the plain version (f32: another summation order; bf16: the
# two round products at other places, and dk, dv sum over every q row)
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TRAIN_FLASH_CHECKS = [  # B, Sq, Sk, H, KV, Dk, Dv, dtype
    (2, 2048, 2048, 40, 8, 128, 128, "bfloat16"),   # the training shape (wgmma)
    (1, 333, 333, 40, 8, 128, 128, "bfloat16"),     # ragged
    (2, 512, 512, 8, 2, 64, 64, "float32")]         # f32 (tf32x3)
TRAIN_RMS_CHECKS = [((2, 2048, 5120), "bfloat16"),          # the train stack's norms
                    ((2, 2048, 40, 128), "bfloat16"),       # qk-norm rows, D 128
                    ((4, 300, 128), "float32")]
TRAIN_CARD_CPU_TOL = 1e-4     # f32, reduced: the summation orders differ
SERVE_NEW = {"archs": ("qwen2.5-32b", "chameleon-34b"), "n_layers": 2, "batch": 2,
             "prompt_len": 128, "max_new": 8, "seed": 3}


def grad_close(torch, name, got, want, tol) -> float:
    """max |got - want|; raises unless finite and within ``tol`` of
    max(1, max |want|)."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} or non-finite")
    err = (got - want).abs().max().item()
    if err > tol * max(1.0, want.abs().max().item()):
        raise AssertionError(f"{name}: max |diff| {err} beyond {tol} of max |want|")
    return err


def _fwd_bwd(torch, fn, args, dout):
    """fn(*args) and its gradients against ``dout``."""
    xs = [a.detach().clone().requires_grad_() for a in args]
    out = fn(*xs)
    out.backward(dout)
    return out.detach(), [x.grad for x in xs]


def check_train_kernels(torch):
    """B3 and B2 forward + backward on the card against autograd through
    their plain versions, and under ``vmap(grad)`` over a dim of 1 and 2
    against the loop. Returns the worst errors."""
    from torch.func import grad, vmap
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rms
    dev = torch.device("cuda")
    worst = {"flash_out": 0.0, "flash_grads": 0.0, "rms_out": 0.0, "rms_grads": 0.0,
             "vmap": 0.0}
    for i, (B, Sq, Sk, H, KV, Dk, Dv, dt) in enumerate(TRAIN_FLASH_CHECKS):
        dtype = getattr(torch, dt)
        args = [_randn(torch, s, dtype, 60 + 4 * i + j, dev) for j, s in enumerate(
            [(B, Sq, H, Dk), (B, Sk, KV, Dk), (B, Sk, KV, Dv)])]
        dout = _randn(torch, (B, Sq, H, Dv), dtype, 63 + 4 * i, dev)
        name = f"flash train {(B, Sq, Sk, H, KV, Dk, Dv)} {dt}"
        out, grads = _fwd_bwd(torch, lambda q, k, v: ops.flash_attention(q, k, v, Sk - Sq),
                              args, dout)
        pout, pgrads = _fwd_bwd(torch, lambda q, k, v: fa.plain(q, k, v, Sk - Sq)[0],
                                args, dout)
        worst["flash_out"] = max(worst["flash_out"],
                                 close(torch, name, out, pout, ATTN_TOL[dt]))
        for tag, g, pg in zip("qkv", grads, pgrads):
            worst["flash_grads"] = max(worst["flash_grads"], grad_close(
                torch, f"{name} d{tag}", g, pg, GRAD_TOL[dt]))
        del args, dout, out, grads, pout, pgrads
    for i, (shape, dt) in enumerate(TRAIN_RMS_CHECKS):
        dtype = getattr(torch, dt)
        x = _randn(torch, shape, dtype, 80 + i, dev)
        w = _randn(torch, shape[-1:], dtype, 90 + i, dev)
        g = _randn(torch, shape, dtype, 100 + i, dev)
        name = f"rmsnorm train {shape} {dt}"
        out, grads = _fwd_bwd(torch, ops.rmsnorm, (x, w), g)
        pout, pgrads = _fwd_bwd(torch, rms.plain, (x, w), g)
        worst["rms_out"] = max(worst["rms_out"], close(torch, name, out, pout, RMS_TOL[dt]))
        for tag, a, b in zip(("dx", "dw"), grads, pgrads):
            worst["rms_grads"] = max(worst["rms_grads"], grad_close(
                torch, f"{name} {tag}", a, b, RMS_TOL[dt]))
    # under the rounds' transform: vmap(grad) over a leading dim of 1 and 2,
    # one launch of each kernel per call (the dim folds into rows and B)
    for n in (1, 2):
        q = _randn(torch, (n, 2, 256, 40, 128), torch.bfloat16, 110 + n, dev)
        kv = _randn(torch, (n, 2, 256, 8, 128), torch.bfloat16, 120 + n, dev)
        w = _randn(torch, (128,), torch.bfloat16, 130 + n, dev)

        def f(q, kv, w):
            return ops.flash_attention(ops.rmsnorm(q, w), kv, kv).float().square().sum()
        counts = (rms.rmsnorm.launches, fa.flash_attention_fwd.launches)
        got = vmap(grad(f, argnums=(0, 1, 2)), in_dims=(0, 0, None))(q, kv, w)
        torch.cuda.synchronize()
        step = (rms.rmsnorm.launches - counts[0], fa.flash_attention_fwd.launches - counts[1])
        if step != (1, 1):
            raise AssertionError(f"vmap over {n}: launches (rmsnorm, flash) {step}, "
                                 "want (1, 1)")
        for j in range(n):
            want = grad(f, argnums=(0, 1, 2))(q[j], kv[j], w)
            for tag, a, b in zip(("dq", "dkv", "dw"), got, want):
                worst["vmap"] = max(worst["vmap"], grad_close(
                    torch, f"vmap({n}) index {j} {tag}", a[j], b, GRAD_TOL["bfloat16"]))
    torch.cuda.synchronize()
    log("check train kernels (forward + backward, vmap(grad) over 1 and 2), worst:",
        json.dumps(worst))
    return worst


def time_train_kernels(torch, flush):
    """B3 at the training shape (forward, the ported backward, both under
    autograd) and B2 at the train stack's and the qk-norm rows (forward,
    backward), beside their plain versions, SDPA and F.rms_norm forward and
    forward + backward, and their bounds."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rms
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    B, S = TRAIN["batch"], TRAIN["seq"]
    H, KV, HD = 40, 8, 128
    rows = {}
    torch_version = tuple(int(p) for p in torch.__version__.split("+")[0].split(".")[:2])
    gqa = {"enable_gqa": True} if torch_version >= (2, 5) else {}

    def timed(fn, args, iters, batch):
        return time_device(fn, args, iters, flush, batch=batch)

    # B3: one training layer's attention, causal, q_offset 0
    q = _randn(torch, (B, S, H, HD), bf16, 140, dev)
    k = _randn(torch, (B, S, KV, HD), bf16, 141, dev)
    v = _randn(torch, (B, S, KV, HD), bf16, 142, dev)
    dout = _randn(torch, (B, S, H, HD), bf16, 143, dev)
    out, lse = fa.flash_attention_fwd(q, k, v, 0, True)
    want, _ = fa.plain(q, k, v, 0, True)
    err = close(torch, "flash train fwd", out, want, ATTN_TOL["bfloat16"])

    def ours_fb(q, k, v, dout):
        xs = [t.detach().requires_grad_() for t in (q, k, v)]
        return torch.autograd.grad(ops.flash_attention(*xs, 0, True), xs, dout)

    def kv_heads(t):
        return t if gqa else t.repeat_interleave(H // KV, dim=1)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q.transpose(1, 2), kv_heads(k.transpose(1, 2)),
                                              kv_heads(v.transpose(1, 2)), is_causal=True,
                                              **gqa).transpose(1, 2)

    def sdpa_fb(q, k, v, dout):
        xs = [t.detach().requires_grad_() for t in (q, k, v)]
        return torch.autograd.grad(sdpa(*xs), xs, dout)
    ours_g = ours_fb(q, k, v, dout)
    lib_g = sdpa_fb(q, k, v, dout)
    lib_err = close(torch, "sdpa train fwd", sdpa(q, k, v), out, YARDSTICK_TOL)
    lib_grad_err = max(grad_close(torch, f"sdpa d{t}", a, b, YARDSTICK_TOL)
                       for t, a, b in zip("qkv", lib_g, ours_g))
    pairs = S * (S + 1) // 2
    fwd_bytes = (q.numel() + k.numel() + v.numel() + out.numel()) * 2 + lse.numel() * 4
    fwd_flops = 2 * B * H * pairs * (HD + HD)
    # the backward reads q, k, v, out, dout and lse once and writes dq, dk, dv
    # once; it recomputes the scores and does four more products per pair
    bwd_bytes = (2 * q.numel() + 2 * (k.numel() + v.numel()) + 2 * out.numel()) * 2 \
        + lse.numel() * 4
    bwd_flops = 2 * B * H * pairs * (3 * HD + 2 * HD)
    fb_ms, fb_by = bound(fwd_bytes + bwd_bytes, fwd_flops + bwd_flops, BF16_FLOPS_PER_S)
    r = {"shape": [B, S, S, H, KV, HD, HD], "dtype": "bfloat16", "max_abs_err": err,
         "kernel_ms": timed(lambda q, k, v: fa.flash_attention_fwd(q, k, v, 0, True),
                            (q, k, v), 20, 10),
         "plain_ms": timed(lambda q, k, v: fa.plain(q, k, v, 0, True), (q, k, v), 4, 2),
         "library_ms": timed(sdpa, (q, k, v), 20, 10), "library_max_abs_err": lib_err}
    r["bound_ms"], r["bound_by"] = bound(fwd_bytes, fwd_flops, BF16_FLOPS_PER_S)
    r["bwd_ms"] = timed(lambda *a: fa.plain_bwd(*a, 0, True),
                        (q, k, v, out, lse, dout), 6, 3)
    r["bwd_bound_ms"], r["bwd_bound_by"] = bound(bwd_bytes, bwd_flops, BF16_FLOPS_PER_S)
    r["fwd_bwd_ms"] = timed(ours_fb, (q, k, v, dout), 6, 3)
    r["library_fwd_bwd_ms"] = timed(sdpa_fb, (q, k, v, dout), 6, 3)
    r["library_grad_err"] = lib_grad_err
    r["fwd_bwd_bound_ms"], r["fwd_bwd_bound_by"] = fb_ms, fb_by
    r["bytes"], r["flops"] = fwd_bytes, fwd_flops
    r["bwd_bytes"], r["bwd_flops"] = bwd_bytes, bwd_flops
    log("kernel flash_attention train (wgmma fwd + ported bwd)", json.dumps(r))
    rows["flash_train"] = r
    del q, k, v, dout, out, lse, want, ours_g, lib_g

    # B2: the train stack's norms (B*S rows of 5120) and qk-norm rows (B*S*H of 128)
    for tag, shape in (("train", (B, S, 5120)), ("qk_norm", (B, S, H, HD))):
        D = shape[-1]
        x = _randn(torch, shape, bf16, 150, dev)
        w = _randn(torch, (D,), bf16, 151, dev)
        g = _randn(torch, shape, bf16, 152, dev)
        got = rms.rmsnorm(x, w)
        err = close(torch, f"rmsnorm {tag}", got, rms.plain(x, w), RMS_TOL["bfloat16"])

        def lib(x, w):
            return F.rms_norm(x, (D,), w, 1e-6)

        def ours_fb(x, w, g):
            xs = [t.detach().requires_grad_() for t in (x, w)]
            return torch.autograd.grad(ops.rmsnorm(*xs), xs, g)

        def lib_fb(x, w, g):
            xs = [t.detach().requires_grad_() for t in (x, w)]
            return torch.autograd.grad(lib(*xs), xs, g)
        lib_err = close(torch, f"F.rms_norm {tag}", lib(x, w), got, YARDSTICK_TOL)
        R = x.numel() // D
        plan = rms.launch_plan(R, D, bf16, torch.cuda.get_device_properties(dev)
                               .multi_processor_count)
        r = {"shape": list(shape), "rows": R, "D": D, "dtype": "bfloat16", "plan":
             plan._asdict(), "max_abs_err": err,
             "kernel_ms": timed(rms.rmsnorm, (x, w), 100, 20),
             "plain_ms": timed(rms.plain, (x, w), 20, 10),
             "library_ms": timed(lib, (x, w), 100, 20), "library_max_abs_err": lib_err,
             "bwd_ms": timed(lambda x, w, g: rms.backward(x, w, g), (x, w, g), 20, 10),
             "fwd_bwd_ms": timed(ours_fb, (x, w, g), 20, 10),
             "library_fwd_bwd_ms": timed(lib_fb, (x, w, g), 20, 10)}
        r["bound_ms"], r["bound_by"] = bound(2 * R * D * 2 + D * 2, 4 * R * D,
                                             F32_FLOPS_PER_S)
        # the backward reads x, w, g once and writes dx, dw once
        r["bwd_bound_ms"], r["bwd_bound_by"] = bound(3 * R * D * 2 + 2 * D * 2, 10 * R * D,
                                                     F32_FLOPS_PER_S)
        log(f"kernel rmsnorm {tag} (fwd + bwd)", json.dumps(r))
        rows[f"rmsnorm_{tag}"] = r
        del x, w, g, got
    torch.cuda.empty_cache()
    return rows


# B3's backward kernel: yi-34b's int8 round (the benchmark's yi34b_l4_int8) and
# the training phase's shape; B, S, H, KV, head dim, all causal at q_offset 0
B3_BWD_SHAPES = {"yi34b_round": (2, 4096, 56, 8, 128), "train": (2, 2048, 40, 8, 128)}


def time_b3_bwd(torch, flush):
    """B3's backward kernel (``flash_attention_bwd``, bf16, causal) at
    ``B3_BWD_SHAPES``: two calls bitwise equal, within GRAD_TOL of
    ``plain_bwd``; its device ms beside the five-product bound
    (``flash_attention.bwd_cost``), ``plain_bwd``'s ms and SDPA's forward +
    backward (the library yardstick); both from the forward kernel's out
    and lse."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    rows = {}
    for tag, (B, S, H, KV, D) in B3_BWD_SHAPES.items():
        q, k, v, dout = (_randn(torch, s, bf16, 170 + i, dev) for i, s in enumerate(
            [(B, S, H, D), (B, S, KV, D), (B, S, KV, D), (B, S, H, D)]))
        out, lse = fa.flash_attention_fwd(q, k, v, 0, True)
        args = (q, k, v, out, lse, dout)
        before = fa.flash_attention_bwd.launches_by_kernel["wgmma"]
        got = fa.flash_attention_bwd(*args, 0, True)
        again = fa.flash_attention_bwd(*args, 0, True)
        torch.cuda.synchronize()
        if fa.flash_attention_bwd.launches_by_kernel["wgmma"] != before + 2:
            raise AssertionError(f"b3 bwd {tag}: the kernel did not take both calls")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"b3 bwd {tag}: two calls differ")
        plain = fa.plain_bwd(*args, 0, True)
        errs = {f"d{n}": grad_close(torch, f"b3 bwd {tag} d{n}", g, p, GRAD_TOL["bfloat16"])
                for n, g, p in zip("qkv", got, plain)}
        del got, again, plain
        sdout = dout.transpose(1, 2)

        def lib_fb(*xs):   # as time_train_kernels' sdpa_fb: PyTorch picks the backend
            xs = [x.detach().transpose(1, 2).requires_grad_() for x in xs]
            o = F.scaled_dot_product_attention(*xs, is_causal=True, enable_gqa=True)
            return torch.autograd.grad(o, xs, sdout)
        flops, nbytes = fa.bwd_cost(B, S, S, H, KV, D, D, 0, True, 2)
        r = {"shape": [B, S, S, H, KV, D, D], "causal": True, "bitwise_repeat": True,
             "max_abs_err_vs_plain": errs,
             "kernel_ms": time_device(lambda *a: fa.flash_attention_bwd(*a, 0, True), args,
                                      20, flush, batch=5),
             "kernel_call_ms": time_call(lambda *a: fa.flash_attention_bwd(*a, 0, True), args,
                                         20, flush),
             "plain_ms": time_device(lambda *a: fa.plain_bwd(*a, 0, True), args, 4, flush,
                                     batch=2),
             "library_fwd_bwd_ms": time_device(lib_fb, (q, k, v), 10, flush, batch=5),
             "flops": flops, "bytes": nbytes}
        r["bound_ms"], r["bound_by"] = bound(nbytes, flops, BF16_FLOPS_PER_S)
        r["x_bound"] = r["kernel_ms"] / r["bound_ms"]
        r["tflops_7_products"] = flops * 7 / 5 / (r["kernel_ms"] * 1e9)
        log(f"kernel flash_attention bwd {tag}", json.dumps(r))
        rows[tag] = r
        del q, k, v, dout, out, lse, args, sdout
        torch.cuda.empty_cache()
    return rows


def train_launches(T, n_layers: int, steps: int) -> dict:
    """B2 and B3 launches of ``steps`` local steps of a dense LM: a
    client's gradient recomputes each layer in the backward (a checkpoint
    per layer, the JAX package's ``jax.checkpoint``), so each layer's norms
    and its attention launch twice a step, in the forward and in the
    recompute, and the final norm, outside the layers, once; B3 all on
    the tensor-core kernel (bf16, head dims 128/128 or MLA's absorbed
    288/256)."""
    return {"rmsnorm": (2 * T["norms_per_layer"] * n_layers + 1) * steps,
            "flash_attention": 2 * n_layers * steps, "decode_attention": 0}


def phase_train_lm(torch, kernels, T=TRAIN):
    """An LM at its published width with its depth cut (qwen2.5-32b, 64 ->
    2, by default), bf16: the temporal FedAvgM rounds of
    ``repro_torch.launch.train_fl_lm`` on fixed client data, counted and
    timed round by round; then the same run from the same initial state
    again, bitwise; then one warm round profiled."""
    from repro_torch.configs.base import FLConfig, get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train_fl_lm
    from repro_torch.metrics.logger import PerformanceLogger
    dev = torch.device("cuda")
    bwd = fa.flash_attention_bwd
    torch.cuda.empty_cache()     # the earlier phases' cached blocks back to the card
    cfg = get_config(T["arch"]).replace(n_layers=T["n_layers"])
    fl = FLConfig(strategy=T["strategy"], n_clients=T["clients"],
                  local_epochs=T["local_epochs"], client_lr=T["client_lr"],
                  server_momentum=T["server_momentum"], seed=0)
    t0 = time.perf_counter()
    model, round_fn, state = train_fl_lm.setup(cfg, fl, dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(v.numel() for v in state["params"].values())
    log(f"train: {cfg.name} d_model {cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} "
        f"d_ff {cfg.d_ff} vocab {cfg.padded_vocab} qkv_bias {cfg.qkv_bias} attn "
        f"{cfg.attn_type} moe {cfg.moe is not None} tied {cfg.tie_embeddings}, "
        f"{cfg.n_layers} of {get_config(T['arch']).n_layers} layers, bf16: {n_params} "
        f"params ({n_params * 2 / 1e9:.2f} GB) drawn in {init_s:.1f}s")
    initial = {part: _tree_to(t, "cpu") if isinstance(t, dict) else t
               for part, t in state.items()}
    lm = SyntheticLM(vocab=cfg.vocab_size, seed=0)
    kw = dict(clients=T["clients"], cohort=T["cohort"], batch=T["batch"], seq=T["seq"],
              local_steps=T["local_steps"], device=dev, data_round=0)

    def run(state):
        logger = PerformanceLogger(run_name="chip_smoke-lm")
        per_round = []
        for r in range(T["rounds"]):
            before = {n: fn.launches for n, fn in kernels.items()}
            layouts = dict(kernels["rmsnorm"].launches_by_layout)
            flash = dict(kernels["flash_attention"].launches_by_kernel)
            flash_bwd = dict(bwd.launches_by_kernel)
            state, logger = train_fl_lm.run_rounds(round_fn, state, lm, r, r + 1,
                                                   logger=logger, **kw)
            per_round.append({
                "launches": {n: fn.launches - before[n] for n, fn in kernels.items()},
                "rmsnorm_by_layout": {k: v - layouts[k] for k, v in
                                      kernels["rmsnorm"].launches_by_layout.items()},
                "flash_by_kernel": {k: v - flash[k] for k, v in
                                    kernels["flash_attention"].launches_by_kernel.items()},
                "flash_bwd_by_kernel": {k: v - flash_bwd[k] for k, v in
                                        bwd.launches_by_kernel.items()}})
        return state, logger, per_round

    # the counted run; counts zeroed just before it and read just after. The
    # initial state is handed over (popped from a list), so that this frame
    # holds no reference to it while the rounds run: a held initial state
    # stays on the card the whole run and would add to the peak
    handover = [state]
    del state
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(kernels)
    state, logger, per_round = run(handover.pop())
    launches = {n: fn.launches for n, fn in kernels.items()}
    flash_by_kernel = dict(kernels["flash_attention"].launches_by_kernel)
    bwd_by_kernel = dict(bwd.launches_by_kernel)
    bwd_by_shape = named(bwd.launches_by_shape)
    norm_by_layout = dict(kernels["rmsnorm"].launches_by_layout)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses, round_s = logger.series("loss"), logger.series("round_s")
    L, steps = cfg.n_layers, T["cohort"] * T["local_steps"] * T["local_epochs"]
    want = {"quant_aggregate": 0, **train_launches(T, L, steps * T["rounds"])}
    # the backward once a layer a local step (the recompute's forward is
    # the second of that layer's forward launches), all on the route
    # ``bwd_plan`` gives bf16 at the head dims launched: the kernel at
    # 128/128, plain_bwd at MLA's absorbed 288/256
    dims = {k[5:7] for k in bwd.launches_by_shape}
    route = fa.bwd_plan(torch.bfloat16, *dims.pop()) if len(dims) == 1 else None
    want_bwd = {"wgmma": 0, "plain": 0, route: L * steps * T["rounds"]}
    log(f"train launches {json.dumps(launches)} (want {json.dumps(want)}); flash by kernel "
        f"{json.dumps(flash_by_kernel)}; flash bwd by kernel {json.dumps(bwd_by_kernel)} "
        f"(want {json.dumps(want_bwd)}) by shape {json.dumps(bwd_by_shape)}; rmsnorm by "
        f"layout {json.dumps(norm_by_layout)}; per round {json.dumps(per_round[0])}")
    if launches != want or flash_by_kernel["tf32x3"] != 0:
        raise AssertionError(f"train launches {launches} by kernel {flash_by_kernel}, "
                             f"want {want}, all flash on wgmma")
    if bwd_by_kernel != want_bwd or bwd.launches != want_bwd.get(route):
        raise AssertionError(f"train flash bwd launches {bwd.launches} by kernel "
                             f"{bwd_by_kernel} at {bwd_by_shape}, want {want_bwd}, all on "
                             f"bwd_plan's route")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: non-finite losses {losses}")
    final = {k: v.cpu() for k, v in state["params"].items()}
    if not all(torch.isfinite(v.float()).all() for v in final.values()):
        raise AssertionError("train: non-finite params")
    del state
    torch.cuda.empty_cache()

    # the same run again from the same initial state: bitwise
    state2 = {part: (_tree_to(tree, dev) if isinstance(tree, dict) else tree)
              for part, tree in initial.items()}
    state2, logger2, _ = run(state2)
    losses2 = logger2.series("loss")
    same = losses2 == losses and all(torch.equal(state2["params"][k].cpu(), v)
                                     for k, v in final.items())
    log(f"train repeat: losses {losses2} vs {losses}; params bitwise: {same}")
    if not same:
        raise AssertionError("train: a second run from the same state is not bitwise")
    # where a warm round's time goes
    prof, by_name = profile_device(torch, lambda: train_fl_lm.run_rounds(
        round_fn, state2, lm, T["rounds"], T["rounds"] + 1, **kw),
        f"train round (warm) {cfg.name}")
    for tag in ("flash_wgmma", "rmsnorm", "gemm", "nvjet", "elementwise", "reduce", "index",
                "scatter", "gather", "scan", "sort", "topk", "copy"):
        hits = [val for name, val in by_name.items() if tag in name.lower()]
        prof[f"{tag}_ms"] = sum(h[0] for h in hits)
    b = train_fl_lm.round_batch(lm, 0, clients=T["clients"], cohort=1, batch=T["batch"],
                                seq=T["seq"], local_steps=1, device=dev)
    grad_mem = grad_memory(torch, model, state2["params"], {k: v[0, 0] for k, v in b.items()})
    del state2
    torch.cuda.empty_cache()
    tokens = T["cohort"] * T["local_steps"] * T["local_epochs"] * T["batch"] * T["seq"]
    out = {"arch": cfg.name, "n_layers": L, "params": n_params, "init_s": init_s,
           "losses": losses, "loss_fell": losses[-1] < losses[0], "round_s": round_s,
           "tokens_per_round": tokens,
           "tokens_per_s": [tokens / s for s in round_s], "peak_mem_gb": peak_gb,
           "launches": launches, "launches_per_round": per_round,
           "flash_by_kernel": flash_by_kernel, "flash_bwd_by_kernel": bwd_by_kernel,
           "flash_bwd_by_shape": bwd_by_shape, "rmsnorm_by_layout": norm_by_layout,
           "bitwise_repeat": True, "profile": prof, "grad_memory": grad_mem}
    log(f"train {cfg.name}", json.dumps(out))
    if not out["loss_fell"]:
        raise AssertionError(f"train: the loss did not fall over {T['rounds']} rounds at "
                             f"client_lr {T['client_lr']}: {losses}")
    return out


# one local step's gradient peak under autograd's backward() before the LM
# step rematerialized (GB, this script's earlier runs on an H100 80GB HBM3 at
# 700.00 W; PERF.md section 6), printed beside today's: the port keeps no
# switch to run the un-remat'd step again
RECORDED_AUTOGRAD_PEAK_GB = {("minicpm3-4b", 8): 8.015, ("qwen2.5-32b", 2): 9.91,
                             ("qwen3-moe-30b-a3b", 2): 9.03, ("whisper-base", 6): 3.39}


def grad_memory(torch, model, params, batch):
    """Device memory one local step's gradient takes above the params
    (GB), for a ``FlatModel`` over its flat ``params``: the forward's saved
    activations (``saved_gb``) and the peak (``backward_peak_gb``) of the
    step an LM client takes, ``torch.autograd.grad`` of the loss, which
    rematerializes each layer in the backward; beside it the peak of
    ``torch.func.grad_and_value`` (``func_grad_peak_gb``: the transform
    keeps every activation and records the backward's own graph) and the
    recorded peak of autograd before it rematerialized. The remat'd
    gradient is held to ``grad_and_value``'s, bitwise or within
    ``GRAD_TOL`` (with the reason printed)."""
    from torch.func import grad_and_value
    cfg = model.cfg
    out = {"recorded_unremat_backward_peak_gb":
           RECORDED_AUTOGRAD_PEAK_GB.get((cfg.name, cfg.n_layers))}

    def peak(fn):
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = fn()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 1e9, res

    def step():
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        before = torch.cuda.memory_allocated()
        loss = model.loss(leaves, batch)
        out["saved_gb"] = (torch.cuda.memory_allocated() - before) / 1e9
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return dict(zip(leaves, (g.cpu() for g in grads)))

    def func_step():
        grads, _ = grad_and_value(model.loss)(params, batch)
        return {k: g.cpu() for k, g in grads.items()}
    out["backward_peak_gb"], got = peak(step)
    out["func_grad_peak_gb"], want = peak(func_step)
    differ = [k for k in got if not torch.equal(got[k], want[k])]
    out["remat_bitwise"] = not differ
    if differ:
        tol = GRAD_TOL[str(next(iter(params.values())).dtype).split(".")[1]]
        out["remat_max_abs_diff"] = max(grad_close(torch, f"remat {k}", got[k], want[k], tol)
                                        for k in differ)
        again = step()          # is the remat'd step itself repeatable?
        out["remat_differs_because"] = (
            f"{len(differ)} of {len(got)} leaves differ from grad_and_value's ("
            f"{', '.join(differ[:4])}{', ...' if len(differ) > 4 else ''}): its backward "
            "sums them in another order; two remat'd steps differ in "
            f"{sum(not torch.equal(again[k], got[k]) for k in got)} leaves")
        del again
    del got, want
    torch.cuda.empty_cache()
    log(f"train {cfg.name}: one local step's gradient memory", json.dumps(out))
    return out


def phase_train_card_vs_cpu(torch, archs=("qwen2.5-32b", "chameleon-34b")):
    """One temporal FedAvgM round of reduced qwen2.5-32b (QKV bias) and
    chameleon-34b (qk-norm), or ``archs``, in f32 on the card and on the
    CPU; B3's launches counted on the card's round."""
    from repro_torch.configs.base import FLConfig, get_config
    from repro_torch.configs.reduce import reduced_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train_fl_lm
    res = {}
    for arch in archs:
        cfg = reduced_config(get_config(arch))
        fl = FLConfig(strategy="fedavgm", n_clients=4, client_lr=0.05, server_momentum=0.9)
        lm = SyntheticLM(vocab=cfg.vocab_size, seed=0)
        out = {}
        for tag, dev in (("card", torch.device("cuda")), ("cpu", torch.device("cpu"))):
            _, round_fn, state = train_fl_lm.setup(cfg, fl, dev)
            # B3's counts zeroed just before the round, read just after
            fa.flash_attention_fwd.launches_by_kernel = {k: 0 for k in fa.SOURCES}
            fa.flash_attention_fwd.launches_by_shape = {}
            fa.flash_attention_bwd.launches_by_kernel = {"wgmma": 0, "plain": 0}
            state, logger = train_fl_lm.run_rounds(
                round_fn, state, lm, 0, 1, clients=4, cohort=2, batch=2, seq=64,
                local_steps=2, device=dev)
            out[tag] = (logger.series("loss")[0],
                        {k: v.cpu() for k, v in state["params"].items()},
                        dict(fa.flash_attention_fwd.launches_by_kernel),
                        named(fa.flash_attention_fwd.launches_by_shape),
                        dict(fa.flash_attention_bwd.launches_by_kernel))
        # f32 on the card: two tf32x3 launches a layer per local step (cohort 2
        # x 2), in the forward and in the backward's recompute of the layer;
        # the backward once a layer a local step, all on plain_bwd (f32)
        want_by_kernel = {"wgmma": 0, "tf32x3": 2 * cfg.n_layers * 4}
        want_bwd = {"wgmma": 0, "plain": cfg.n_layers * 4}
        if out["card"][2] != want_by_kernel or out["card"][4] != want_bwd:
            raise AssertionError(f"train card vs cpu {arch}: flash launches "
                                 f"{out['card'][2]}, bwd {out['card'][4]}, want "
                                 f"{want_by_kernel}, bwd {want_bwd}")
        loss_err = abs(out["card"][0] - out["cpu"][0])
        if loss_err > TRAIN_CARD_CPU_TOL * abs(out["cpu"][0]):
            raise AssertionError(f"train card vs cpu {arch}: losses {out['card'][0]} vs "
                                 f"{out['cpu'][0]}")
        err = max(close(torch, f"train card vs cpu {arch} {k}", out["card"][1][k], v,
                        TRAIN_CARD_CPU_TOL) for k, v in out["cpu"][1].items())
        res[arch] = {"loss_card": out["card"][0], "loss_cpu": out["cpu"][0],
                     "max_abs_param_diff": err, "flash_by_kernel": out["card"][2],
                     "flash_bwd_by_kernel": out["card"][4],
                     "flash_by_shape": out["card"][3],
                     "mla": cfg.attn_type == "mla"}
    log(f"train card vs cpu (reduced {', '.join(archs)}, f32, one temporal fedavgm round)",
        json.dumps(res))
    return res


def phase_serve_new_archs(torch, kernels):
    """qwen2.5-32b (QKV bias) and chameleon-34b (qk-norm) at their published
    widths, 2 layers, bf16 drawn on the card: ``generate`` counted, then
    again, bitwise."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import model_zoo
    dev, S_ = torch.device("cuda"), SERVE_NEW
    B, S, new, L = S_["batch"], S_["prompt_len"], S_["max_new"], S_["n_layers"]
    res = {}
    for arch in S_["archs"]:
        cfg = get_config(arch).replace(n_layers=L)
        model = model_zoo.build(cfg)
        g = torch.Generator(device=dev)
        g.manual_seed(S_["seed"])
        params = model.init(g, dtype=torch.bfloat16)
        prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=dev)
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = generate(model, params, prompts, new)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in kernels.items()}
        qk = 2 * L * (1 + new) if cfg.qk_norm else 0
        want = {"quant_aggregate": 0, "rmsnorm": (2 * L + 1) * (1 + new) + qk,
                "flash_attention": L, "decode_attention": L * new}
        if launches != want:
            raise AssertionError(f"serve {arch}: launches {launches}, want {want}")
        if not torch.equal(generate(model, params, prompts, new), toks) or \
                toks.min() < 0 or toks.max() >= cfg.padded_vocab:
            raise AssertionError(f"serve {arch}: tokens not repeatable or out of range")
        res[arch] = {"launches": launches, "qk_norm_launches": qk, "generate_s": gen_s,
                     "tokens_head": toks[0].tolist(), "bitwise_repeat": True}
        log(f"serve {arch} (d_model {cfg.d_model}, {L} layers, bf16)", json.dumps(res[arch]))
        del params
        torch.cuda.empty_cache()
    return res


# phase 11 (slice 10): MLA with tied embeddings (minicpm3-4b) and the
# capacity-bucketed MoE (qwen3-moe-30b-a3b, arctic-480b), served and trained
MLA_KERNEL_SHAPES = {  # name: (B, S, absorbed): one minicpm3-4b prefill layer's B3 call
    "mla_serve": (8, 2048, True),      # the absorbed form: 40 heads on one kv head, 288/256
    "mla_train": (2, 2048, True),
    "mla_expanded": (8, 2048, False)}  # mla_seqsharded(absorbed=False): 40/40 heads, 96/64
# depth 62 -> 16: the serve's host-bound decode took ~24 s at 62 layers, and
# phase 13 trains the deep model
SERVE_MLA = {"arch": "minicpm3-4b", "n_layers": 16, "batch": 8, "prompt_len": 2048,
             "max_new": 64, "seed": 4,
             "norms_per_layer": 4,     # B2 a layer a forward: ln1, q_norm, kv_norm, ln2
             # width: (launches a layer, more a forward): ln1 + ln2 + the final
             # norm, q_norm, kv_norm
             "norm_widths": {2560: (2, 1), 768: (1, 0), 256: (1, 0)},
             "decode_per_layer": 0}    # MLA decode attends with einsums (no B4)
SERVE_MOE = {"arch": "qwen3-moe-30b-a3b", "n_layers": 4, "batch": 8, "prompt_len": 2048,
             "max_new": 64, "seed": 5,
             "norms_per_layer": 4,     # ln1, ln2 and qk-norm's q_norm, k_norm
             "norm_widths": {2048: (2, 1), 128: (2, 0)},
             "decode_per_layer": 1}
# B2 at each row width the phase-11 serve paths give it: (serve prefill
# rows, a column slice of a wider row or None); also checked at a decode
# step's rows (B of them) and the training rows (2 x 2048)
SLICE10_RMS = {"mla_ln": ((8, 2048, 2560), None),
               "mla_q_norm": ((8, 2048, 768), None),
               "mla_kv_norm": ((8, 2048, 256), 288),    # dkv[..., :256] of a 288-wide row
               "moe_ln": ((8, 2048, 2048), None),
               "moe_qk_norm": ((8, 2048, 32, 128), None)}
SLICE10_DECODE = (8, 2112, 32, 4, 128)   # B, S, H, KV, D: qwen3-moe's decode layer
TRAIN_MLA = dict(TRAIN, arch="minicpm3-4b", n_layers=8, norms_per_layer=4)
TRAIN_MOE = dict(TRAIN, arch="qwen3-moe-30b-a3b", n_layers=2, norms_per_layer=4)
SLICE10_CARD_CPU = ("minicpm3-4b", "qwen3-moe-30b-a3b", "arctic-480b")


def sdpa_yardstick(torch, q, k, v, scale, causal=True):
    """One SDPA call computing B3's function on (B, S, H, D) inputs (causal
    only where Sq = Sk: SDPA aligns the mask to the top left), for its time
    only: the first backend that takes it, fused ones first,
    GQA through ``enable_gqa``, else with k's and v's heads repeated once
    here, outside the call. -> (fn, args, grads, backend name): ``fn(*args)``
    is the SDPA call alone, on (B, H, S, D) views, giving (B, H, S, Dv);
    ``grads(dq, dk, dv)`` takes the gradients of ``args`` back to q's, k's
    and v's layouts (summing the repeated heads)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    G = q.shape[2] // k.shape[2]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        for gqa in (True, False):
            def fn(q, k, v, backend=backend, gqa=gqa):
                with sdpa_kernel([backend]):
                    return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                          scale=scale, enable_gqa=gqa)
            rep = 1 if gqa else G
            args = (qt, kt, vt) if rep == 1 else (
                qt, kt.repeat_interleave(rep, dim=1), vt.repeat_interleave(rep, dim=1))
            try:
                fn(*args)
                torch.cuda.synchronize()
            except RuntimeError:
                del args
                continue

            def grads(dq, dk, dv, rep=rep):
                dk, dv = (t.unflatten(1, (-1, rep)).sum(2) for t in (dk, dv))
                return tuple(t.transpose(1, 2) for t in (dq, dk, dv))
            return fn, args, grads, f"{backend.name.lower()}{' gqa' if gqa else ' repeated kv'}"
    raise AssertionError("no SDPA backend takes these inputs")


def mla_b3_inputs(torch, B, S, absorbed, seed):
    """B3's (q, k, v, scale) as minicpm3-4b's MLA gives them at prefill: one
    layer's weights drawn as the model draws them (bf16 on the card), hidden
    states N(0, 1), and ``attention.mla_seqsharded`` itself run up to its
    B3 call, whose arguments are kept."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn
    from repro_torch.models import model_zoo
    dev = torch.device("cuda")
    cfg = get_config("minicpm3-4b").replace(n_layers=1)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    w = {k: v[0] for k, v in
         model_zoo.build(cfg).init(g, torch.bfloat16)["blocks"]["attn"].items()}
    h = _randn(torch, (B, S, cfg.d_model), torch.bfloat16, seed + 1, dev)
    seen, inner = {}, ops.flash_attention

    def keep(q, k, v, q_offset=0, causal=True, scale=None):
        seen.update(q=q, k=k, v=v, scale=scale)
        return inner(q, k, v, q_offset, causal, scale)
    ops.flash_attention = keep
    try:
        with torch.no_grad():
            attn.mla_seqsharded(w, h, cfg, absorbed=absorbed)
    finally:
        ops.flash_attention = inner
    return seen["q"].contiguous(), seen["k"].contiguous(), seen["v"].contiguous(), \
        seen["scale"]


def time_mla_kernels(torch, flush, extras):
    """B3 at MLA's shapes (MLA_KERNEL_SHAPES) on the inputs the MLA layer
    gives it: against its plain version and against the plain version in
    f32 (both at 2e-2, with max |want| and the relative errors logged);
    in the absorbed form also against the plain version with the rope
    columns (256-287, the fifth Q/K panel) zeroed, which the 2e-2 check
    must reject. Then its device ms beside the plain version's, SDPA's (the
    backend it picked named) and the bound; at the training shape also the
    ported backward beside SDPA forward + backward. At the serve shape also
    on N(0, 1) inputs at MLA's scale, against an f32 reference (the plain
    version in f32), with the plain version's bf16 error beside it: raw
    scores of 288-wide unit rows are ~17, and the plain version rounds them
    to bf16 before scaling (as the JAX package's blockwise forward does);
    the kernel keeps them in f32. With ``--baseline`` the expanded form
    also on the PR 12 kernel, in turns."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    bf16 = torch.bfloat16
    rows = {}
    for i, (name, (B, S, absorbed)) in enumerate(MLA_KERNEL_SHAPES.items()):
        q, k, v, scale = mla_b3_inputs(torch, B, S, absorbed, 170 + 10 * i)
        H, KV, Dk, Dv = q.shape[2], k.shape[2], q.shape[3], v.shape[3]
        kernel = fa.launch_plan(bf16, Dk, Dv).kernel
        before = dict(fa.flash_attention_fwd.launches_by_kernel)
        out, lse = fa.flash_attention_fwd(q, k, v, 0, True, scale)
        torch.cuda.synchronize()
        if fa.flash_attention_fwd.launches_by_kernel[kernel] != before[kernel] + 1:
            raise AssertionError(f"flash {name}: not launched on the {kernel} kernel")
        want, want_lse = fa.plain(q, k, v, 0, True, scale)
        tol = ATTN_TOL["bfloat16"]
        err = close(torch, f"flash {name}", out, want, tol)
        close(torch, f"flash {name} lse", lse, want_lse, tol)
        ref = fa.plain(q.float(), k.float(), v.float(), 0, True, scale)[0]
        wf = want.float()
        r = {"shape": [B, S, S, H, KV, Dk, Dv], "dtype": "bfloat16", "kernel": kernel,
             "scale": scale, "max_abs_err": err, "max_abs_want": wf.abs().max().item(),
             "mean_abs_want": wf.abs().mean().item(),
             "rel_norm_err": ((out.float() - wf).norm() / wf.norm()).item(),
             "err_vs_f32": close(torch, f"flash {name} vs f32", out, ref, tol),
             "rel_norm_err_vs_f32": ((out.float() - ref).norm() / ref.norm()).item(),
             "plain_err_vs_f32": (wf - ref).abs().max().item()}
        r["rel_err"] = err / r["max_abs_want"]
        del ref
        if absorbed:   # a kernel that dropped the rope panel must fail the check
            qd = q.clone()
            qd[..., Dv:] = 0
            d = (fa.plain(qd, k, v, 0, True, scale)[0].float() - wf).abs()
            r["rope_dropped_max_diff"] = d.max().item()
            r["rope_dropped_rel_norm"] = (d.norm() / wf.norm()).item()
            if bool((d <= tol + tol * wf.abs()).all()):
                raise AssertionError(f"flash {name}: the {tol} check cannot tell a kernel "
                                     "that drops the rope columns from a right one")
            del qd, d
        del wf
        lib, lib_args, lib_grads, backend = sdpa_yardstick(torch, q, k, v, scale)
        lib_err = close(torch, f"sdpa {name} ({backend})", lib(*lib_args).transpose(1, 2),
                        out, YARDSTICK_TOL)
        pairs = S * (S + 1) // 2
        nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * 2 + lse.numel() * 4
        flops = 2 * B * H * pairs * (Dk + Dv)
        r.update({
            "kernel_ms": time_device(lambda q, k, v: fa.flash_attention_fwd(
                q, k, v, 0, True, scale), (q, k, v), 20, flush, batch=10),
            "plain_ms": time_device(lambda q, k, v: fa.plain(q, k, v, 0, True, scale),
                                    (q, k, v), 4, flush, batch=2),
            "library_ms": time_device(lib, lib_args, 6, flush, batch=3),
            "library_backend": backend, "library_max_abs_err": lib_err,
            "bytes": nbytes, "flops": flops})
        r["bound_ms"], r["bound_by"] = bound(nbytes, flops, BF16_FLOPS_PER_S)
        if not absorbed and "flash_attention" in extras:   # the PR 12 kernel
            old = extras["flash_attention"]
            r["baseline_max_abs_err"] = close(torch, f"baseline flash {name}",
                                              old(q, k, v, 0, True, scale)[0], want, tol)
            r["baseline_ms"], r["new_ms_in_turns"] = in_turns(
                lambda q, k, v: old(q, k, v, 0, True, scale),
                lambda q, k, v: fa.flash_attention_fwd(q, k, v, 0, True, scale),
                (q, k, v), 4, flush, batch=2)
        if name == "mla_serve":   # unit-variance inputs against an f32 reference
            g = [_randn(torch, t.shape, bf16, 190 + j, q.device) for j, t in
                 enumerate((q, k, v))]
            ref, _ = fa.plain(*(t.float() for t in g), 0, True, scale)
            got, _ = fa.flash_attention_fwd(*g, 0, True, scale)
            r["unit_inputs_err_vs_f32"] = close(torch, "flash mla_serve N(0, 1) vs f32",
                                                got, ref, ATTN_TOL["bfloat16"])
            r["unit_inputs_plain_err_vs_f32"] = (
                fa.plain(*g, 0, True, scale)[0].float() - ref).abs().max().item()
            r["unit_inputs_err_vs_plain"] = (
                got.float() - fa.plain(*g, 0, True, scale)[0].float()).abs().max().item()
            del g, ref, got
        if name == "mla_train":   # the ported backward at the MLA training shape
            dout = _randn(torch, (B, S, H, Dv), bf16, 163, q.device)

            def ours_fb(q, k, v, dout):
                xs = [t.detach().requires_grad_() for t in (q, k, v)]
                return torch.autograd.grad(ops.flash_attention(*xs, 0, True, scale), xs,
                                           dout)

            def lib_fb(q, k, v, dout):
                xs = [t.detach().requires_grad_() for t in (q, k, v)]
                return torch.autograd.grad(lib(*xs), xs, dout)
            dout_t = dout.transpose(1, 2)
            lib_g = lib_grads(*lib_fb(*lib_args, dout_t))
            r["library_grad_err"] = max(grad_close(torch, f"sdpa {name} d{t}", a, b,
                                                   YARDSTICK_TOL)
                                        for t, a, b in zip("qkv", lib_g, ours_fb(q, k, v, dout)))
            bwd_bytes = (2 * q.numel() + 2 * (k.numel() + v.numel()) + 2 * out.numel()) * 2 \
                + lse.numel() * 4
            bwd_flops = 2 * B * H * pairs * (3 * Dk + 2 * Dv)
            r["bwd_ms"] = time_device(lambda *a: fa.plain_bwd(*a, 0, True, scale),
                                      (q, k, v, out, lse, dout), 4, flush, batch=2)
            r["bwd_bound_ms"], r["bwd_bound_by"] = bound(bwd_bytes, bwd_flops,
                                                         BF16_FLOPS_PER_S)
            r["fwd_bwd_ms"] = time_device(ours_fb, (q, k, v, dout), 4, flush, batch=2)
            r["library_fwd_bwd_ms"] = time_device(lib_fb, (*lib_args, dout_t), 4, flush,
                                                  batch=2)
            r["fwd_bwd_bound_ms"], r["fwd_bwd_bound_by"] = bound(
                nbytes + bwd_bytes, flops + bwd_flops, BF16_FLOPS_PER_S)
            del dout, dout_t, lib_g
        log(f"kernel flash_attention {name} ({kernel})", json.dumps(r))
        rows[name] = r
        del q, k, v, out, lse, want, want_lse, lib_args
        torch.cuda.empty_cache()
    return rows


def time_slice10_norms_decode(torch, flush):
    """B2 at every row width of the phase-11 serve paths (SLICE10_RMS) and
    B4 at qwen3-moe-30b-a3b's decode layer (SLICE10_DECODE), against their
    plain versions on the card, then timed beside the plain version, the
    PyTorch call and the bound. B2 is checked at the serve prefill's rows,
    a decode step's and the training rows; MLA's kv_norm input is the
    256-column slice of 288-wide rows that the model gives it, through
    ``ops.rmsnorm`` (which copies it) and the kernel on the copy. B4 is
    checked at ragged lengths (one 0, one full) and timed at a full
    cache."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rms
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    tol = RMS_TOL["bfloat16"]
    rows = {}
    for i, (name, (shape, wide)) in enumerate(SLICE10_RMS.items()):
        D = shape[-1]
        w = _randn(torch, (D,), bf16, 200 + i, dev)
        checks = {}
        for tag, lead in (("prefill", shape[:2]), ("decode", (shape[0], 1)),
                          ("train", (2, shape[1]))):
            full = _randn(torch, (*lead, *shape[2:-1], wide or D), bf16, 210 + i, dev)
            x = full[..., :D]
            want = rms.plain(x, w)
            checks[tag] = {"rows": x.numel() // D,
                           "plan": rms.launch_plan(x.numel() // D, D, bf16, sm)._asdict()}
            if wide:   # the path's op on the strided slice, then the kernel on a copy
                checks[tag]["ops_err"] = close(torch, f"rmsnorm {name} {tag} (ops, slice)",
                                               ops.rmsnorm(x, w), want, tol)
                x = x.contiguous()
            checks[tag]["max_abs_err"] = close(torch, f"rmsnorm {name} {tag}",
                                               rms.rmsnorm(x, w), want, tol)
            if tag == "prefill":
                xp, fullp = x, full
            del full, x, want
        x = xp
        R = x.numel() // D
        lib = (lambda x, w: F.rms_norm(x, (D,), w, 1e-6))
        r = {"shape": list(shape), "rows": R, "D": D, "dtype": "bfloat16",
             "strided_from": wide, "checks": checks,
             "max_abs_err": max(c["max_abs_err"] for c in checks.values()),
             "kernel_ms": time_device(rms.rmsnorm, (x, w), 100, flush, batch=20),
             "plain_ms": time_device(rms.plain, (x, w), 20, flush, batch=10),
             "library_ms": time_device(lib, (x, w), 100, flush, batch=20),
             "library_max_abs_err": close(torch, f"F.rms_norm {name}", lib(x, w),
                                          rms.rmsnorm(x, w), YARDSTICK_TOL)}
        if wide:   # what the path pays: the slice's copy and the kernel
            r["ops_with_copy_ms"] = time_device(
                lambda t, w: ops.rmsnorm(t[..., :D], w), (fullp, w), 100, flush, batch=20)
        r["bound_ms"], r["bound_by"] = bound(2 * R * D * 2 + D * 2, 4 * R * D,
                                             F32_FLOPS_PER_S)
        log(f"kernel rmsnorm {name}", json.dumps(r))
        rows[f"rmsnorm_{name}"] = r
        del x, xp, fullp, w
    # B4: qwen3-moe's decode layer, 32 heads on 4 kv heads (group 8)
    B, Sc, H, KV, HD = SLICE10_DECODE
    q = _randn(torch, (B, H, HD), bf16, 220, dev)
    k = _randn(torch, (B, Sc, KV, HD), bf16, 221, dev)
    v = _randn(torch, (B, Sc, KV, HD), bf16, 222, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(223)
    ragged = torch.randint(1, Sc + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    ragged[0], ragged[-1] = 0, Sc
    full = torch.full((B,), Sc, dtype=torch.int32, device=dev)
    tol = ATTN_TOL["bfloat16"]
    errs = {}
    for tag, length in (("ragged", ragged), ("full", full)):
        o, m, l = da.decode_attention_fwd(q, k, v, length)
        po, pm, pl = da.plain(q, k, v, length)
        ok = length > 0
        if not ((m[~ok] == -1e30).all() and (l[~ok] == 0).all() and (o[~ok] == 0).all()):
            raise AssertionError("decode moe: a length-0 row is not m=-1e30, l=0, o=0")
        errs[tag] = close(torch, f"decode moe {tag}", o[ok] / l[ok][..., None],
                          po[ok] / pl[ok][..., None], tol)
        close(torch, f"decode moe {tag} m", m, pm, tol)
        close(torch, f"decode moe {tag} l", l, pl, tol)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)

    def sdpa_decode(q, k, v, length):
        return F.scaled_dot_product_attention(q[:, :, None], kt, vt, enable_gqa=True)
    lib_err = close(torch, "sdpa decode moe", sdpa_decode(q, k, v, full)[:, :, 0],
                    o / l[..., None], YARDSTICK_TOL)
    keys = B * Sc
    nbytes = keys * KV * (HD + HD) * 2 + q.numel() * 2 + (o.numel() + 2 * m.numel() + B) * 4
    flops = 2 * keys * H * (HD + HD)
    r = {"shape": [B, Sc, H, KV, HD], "dtype": "bfloat16", "max_abs_err": max(errs.values()),
         "ragged_lengths": ragged.tolist(), "errs": errs,
         "kernel_ms": time_device(da.decode_attention_fwd, (q, k, v, full), 200, flush),
         "plain_ms": time_device(da.plain, (q, k, v, full), 20, flush, batch=20),
         "library_ms": time_device(sdpa_decode, (q, k, v, full), 200, flush),
         "library_max_abs_err": lib_err, "bytes": nbytes, "flops": flops}
    r["bound_ms"], r["bound_by"] = bound(nbytes, flops, BF16_FLOPS_PER_S)
    log("kernel decode_attention moe", json.dumps(r))
    rows["decode_attention_moe"] = r
    del q, k, v, kt, vt, o, m, l, po, pm, pl
    torch.cuda.empty_cache()
    return rows


def moe_drop_fractions(torch, model, params, prompts):
    """One prefill with ``moe.moe_ffn`` wrapped to keep each layer's
    MoEAux: the drop fraction per layer (and the aux losses)."""
    from repro_torch.models import moe
    seen, inner = [], moe.moe_ffn

    def keep(*a, **kw):
        out, aux = inner(*a, **kw)
        seen.append(aux)
        return out, aux
    moe.moe_ffn = keep
    try:
        with torch.inference_mode():
            model.prefill(params, {"tokens": prompts})
    finally:
        moe.moe_ffn = inner
    return {"drop_fraction": [float(a.drop_fraction) for a in seen],
            "load_balance": [float(a.load_balance) for a in seen],
            "z_loss": [float(a.z_loss) for a in seen]}


def phase_serve_slice10(torch, kernels, S_):
    """An LM of slice 10 at its published width (``S_``: minicpm3-4b cut to
    16 layers, qwen3-moe-30b-a3b to 4), bf16 drawn on the card:
    ``generate`` counted, again for its wall time (bitwise the same
    tokens), a prefill alone timed and profiled; the MoE's drop fraction
    per layer at prefill."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import model_zoo
    dev = torch.device("cuda")
    cfg = get_config(S_["arch"]).replace(n_layers=S_["n_layers"])
    model = model_zoo.build(cfg)
    B, S, new, L = S_["batch"], S_["prompt_len"], S_["max_new"], cfg.n_layers
    g = torch.Generator(device=dev)
    g.manual_seed(S_["seed"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(g, dtype=torch.bfloat16)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"serve {cfg.name}: d_model {cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} "
        f"attn {cfg.attn_type} moe {cfg.moe} tied {cfg.tie_embeddings} vocab "
        f"{cfg.padded_vocab}, {L} of {get_config(S_['arch']).n_layers} layers, bf16: "
        f"{n_params} params ({n_params * 2 / 1e9:.2f} GB) drawn in {init_s:.2f}s")
    # the serve path; counts zeroed just before it and read just after
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = generate(model, params, prompts, new)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    flash_by_kernel = dict(kernels["flash_attention"].launches_by_kernel)
    norm_by_layout = dict(kernels["rmsnorm"].launches_by_layout)
    norm_by_width = {}
    for (_, D), n in kernels["rmsnorm"].launches_by_shape.items():
        norm_by_width[D] = norm_by_width.get(D, 0) + n
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {"quant_aggregate": 0, "rmsnorm": (S_["norms_per_layer"] * L + 1) * (1 + new),
            "flash_attention": L, "decode_attention": S_["decode_per_layer"] * L * new}
    want_width = {D: (a * L + b) * (1 + new) for D, (a, b) in S_["norm_widths"].items()}
    log(f"serve {cfg.name} launches {json.dumps(launches)} (want {json.dumps(want)}); "
        f"flash by kernel {json.dumps(flash_by_kernel)}; rmsnorm by layout "
        f"{json.dumps(norm_by_layout)}, by width {json.dumps(norm_by_width)} (want "
        f"{json.dumps(want_width)}); a decode step: rmsnorm "
        f"{S_['norms_per_layer'] * L + 1}, decode attention {S_['decode_per_layer'] * L}")
    if launches != want or flash_by_kernel != {"wgmma": L, "tf32x3": 0} or \
            norm_by_width != want_width:
        raise AssertionError(f"serve {cfg.name}: launches {launches} by kernel "
                             f"{flash_by_kernel}, rmsnorm by width {norm_by_width}, want "
                             f"{want}, {want_width}, all flash on wgmma")
    if toks.shape != (B, new) or toks.min() < 0 or toks.max() >= cfg.padded_vocab:
        raise AssertionError(f"serve {cfg.name}: bad tokens {tuple(toks.shape)}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks2 = generate(model, params, prompts, new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    if not torch.equal(toks, toks2):
        raise AssertionError(f"serve {cfg.name}: a second generate gave other tokens")
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        caches, logits, _ = model.prefill(params, {"tokens": prompts})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        if not torch.isfinite(logits).all() or \
                not torch.equal(model.greedy_token(logits), toks[:, 0]):
            raise AssertionError(f"serve {cfg.name}: prefill logits do not give token 0")
        del caches
        prof, by_name = profile_device(
            torch, lambda: model.prefill(params, {"tokens": prompts}),
            f"serve prefill {cfg.name}")
        for tag in ("flash_wgmma", "rmsnorm", "nvjet", "gemm", "elementwise", "index",
                    "scatter", "gather", "scan", "sort", "topk", "copy"):
            prof[f"{tag}_ms"] = sum(v[0] for k, v in by_name.items() if tag in k.lower())
    out = {"arch": cfg.name, "n_layers": L, "batch": B, "prompt_len": S, "max_new": new,
           "params": n_params, "init_s": init_s, "first_generate_s": first_s,
           "generate_s": gen_s, "prefill_s": prefill_s,
           "decode_ms_per_token": (gen_s - prefill_s) / new * 1e3,
           "generated_tokens_per_s": B * new / gen_s, "peak_mem_gb": peak_gb,
           "launches": launches, "flash_by_kernel": flash_by_kernel,
           "rmsnorm_by_layout": norm_by_layout, "rmsnorm_by_width": norm_by_width,
           "bitwise_repeat": True,
           "tokens_head": toks[0, :8].tolist(), "profile_prefill": prof}
    if cfg.moe is not None:
        out["moe_prefill"] = moe_drop_fractions(torch, model, params, prompts)
    if cfg.attn_type == "mla":
        # the expanded form (mla_seqsharded(absorbed=False)) of layer 0 on
        # the layer's own input: B3 at (96, 64) on the wgmma kernel, counted;
        # its output near the absorbed form's
        from repro_torch.models import attention as attn
        from repro_torch.models.layers import rms_norm
        from repro_torch.models.transformer import embed_lookup
        w0 = {k: v[0] for k, v in params["blocks"]["attn"].items()}
        with torch.inference_mode():
            h0 = rms_norm(embed_lookup(params["embed"], prompts),
                          params["blocks"]["ln1"]["w"][0], cfg.norm_eps)
            for form, absorbed in (("absorbed", True), ("expanded", False)):
                _zero_counts(kernels)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                o = attn.mla_seqsharded(w0, h0, cfg, absorbed=absorbed)
                torch.cuda.synchronize()
                out[f"{form}_layer_s"] = time.perf_counter() - t0
                out[f"{form}_flash_by_kernel"] = dict(
                    kernels["flash_attention"].launches_by_kernel)
                if absorbed:
                    oa = o
        if out["expanded_flash_by_kernel"] != {"wgmma": 1, "tf32x3": 0} or \
                out["absorbed_flash_by_kernel"] != {"wgmma": 1, "tf32x3": 0}:
            raise AssertionError(f"MLA layer 0: flash launches absorbed "
                                 f"{out['absorbed_flash_by_kernel']}, expanded "
                                 f"{out['expanded_flash_by_kernel']}")
        out["expanded_layer_rel_diff"] = ((o - oa).norm() / oa.norm()).item()
        if not out["expanded_layer_rel_diff"] < 5e-2:
            raise AssertionError(f"MLA layer 0: the expanded form's output "
                                 f"{out['expanded_layer_rel_diff']} from the absorbed "
                                 "form's (relative norm)")
        del w0, h0, o, oa
    log(f"serve {cfg.name}", json.dumps(out))
    del params, logits
    torch.cuda.empty_cache()
    return out


# phase 12 (slice 12): the last three LM families. whisper-base (the
# encoder-decoder, full depth) and xlstm-125m (one sLSTM period) served at full
# width (whisper's loss gradient, an xlstm temporal round); jamba-1.5-large-398b, whose one
# full-width period holds ~77 GB of MoE weights in bf16, as its attention
# sublayer and one Mamba mixer at full width; reduced card vs CPU for all
# three; C7's two halves of determinism.normal over every input
WHISPER = {"arch": "whisper-base", "batch": 8, "frames": 1500, "max_new": 64, "seed": 6}
# xlstm-125m at one period of its sLSTM (4 of 12 layers) since slice 19: its
# per-token sLSTM loop made the full depth's serve and round ~35 s of the script
XLSTM = {"arch": "xlstm-125m", "n_layers": 4, "batch": 8, "prompt_len": 2048, "max_new": 64,
         "seed": 7, "slstm_profile_len": 256}
XLSTM_TRAIN = {"clients": 4, "cohort": 2, "local_epochs": 1, "local_steps": 2, "batch": 2,
               "seq": 512, "client_lr": 0.05, "server_momentum": 0.9}
JAMBA = {"arch": "jamba-1.5-large-398b", "batch": 8, "prompt_len": 2048, "seed": 8}
SLICE12_CARD_CPU = ("whisper-base", "xlstm-125m", "jamba-1.5-large-398b")
# B3 and B4 at the slice-12 paths' shapes, bf16: (B, Sq, Sk, H, KV, D, causal)
# and (B, S, H, KV, D); B2 at their rows, (leading dims, D)
SLICE12_FLASH = {"whisper_encoder": (8, 1500, 1500, 8, 8, 64, False),
                 "whisper_cross": (8, 187, 1500, 8, 8, 64, False),
                 "whisper_decoder": (8, 187, 187, 8, 8, 64, True),
                 "jamba": (8, 2048, 2048, 64, 8, 128, True)}
SLICE12_DECODE = {"whisper_self": (8, 251, 8, 8, 64),      # 187 + 64 slots
                  "whisper_cross": (8, 1500, 8, 8, 64),    # the encoder cache, G = 1
                  "jamba": (8, 2049, 64, 8, 128)}          # one step after 2,048
SLICE12_RMS = {"xlstm_prefill": ((8, 2048), 768), "xlstm_decode": ((8, 1), 768),
               "xlstm_train": ((XLSTM_TRAIN["batch"], XLSTM_TRAIN["seq"]), 768),
               "jamba_prefill": ((8, 2048), 8192), "jamba_decode": ((8, 1), 8192)}


def check_normal_halves(torch):
    """C7: ``determinism.normal``'s two halves over every one of their 2**24
    inputs, bitwise on the card and the CPU (with IEEE ``sqrt``, ``*`` and
    the one rounding to f32 this covers every draw); beside them, how many
    of the same inputs f64 ``torch.log`` / ``torch.cos`` give other bits on
    the card (what the draws went through before)."""
    from repro_torch.core import determinism as det
    k = torch.arange(1 << 24, dtype=torch.int64)
    kc = k.cuda()
    log_diff = int((det._log_u1(kc).cpu() * -2.0 != det._log_u1(k) * -2.0).sum())
    cos_diff = int((det._cos_2pi_u2(kc).cpu() != det._cos_2pi_u2(k)).sum())
    u1 = (k + 1).to(torch.float64) * 2.0 ** -24
    u2 = k.to(torch.float64) * 2.0 ** -24
    libm = {"log": int((torch.log(u1.cuda()).cpu() != torch.log(u1)).sum()),
            "cos": int((torch.cos((2 * math.pi) * u2.cuda()).cpu()
                        != torch.cos((2 * math.pi) * u2)).sum())}
    out = {"inputs": 1 << 24, "neg2_log_u1_differing": log_diff,
           "cos_2pi_u2_differing": cos_diff, "f64_libm_differing": libm}
    log("C7 normal halves card vs cpu", json.dumps(out))
    if log_diff or cos_diff:
        raise AssertionError(f"determinism.normal's halves differ on the card: {out}")
    return out


def time_slice12_kernels(torch, flush):
    """B3, B4 and B2 at every new shape of the slice-12 paths, bf16,
    against their plain versions on the card, then timed beside the plain
    version, the PyTorch call (SDPA, ``F.rms_norm``) and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    tol = ATTN_TOL["bfloat16"]
    rows = {}
    for i, (name, (B, Sq, Sk, H, KV, D, causal)) in enumerate(SLICE12_FLASH.items()):
        q = _randn(torch, (B, Sq, H, D), bf16, 300 + 3 * i, dev)
        k = _randn(torch, (B, Sk, KV, D), bf16, 301 + 3 * i, dev)
        v = _randn(torch, (B, Sk, KV, D), bf16, 302 + 3 * i, dev)
        off = Sk - Sq if causal else 0
        if fa.launch_plan(bf16, D, D).kernel != "wgmma":
            raise AssertionError(f"flash {name}: bf16 at head dim {D} is not on wgmma")
        out, lse = fa.flash_attention_fwd(q, k, v, off, causal)
        want, want_lse = fa.plain(q, k, v, off, causal)
        err = close(torch, f"flash {name}", out, want, tol)
        close(torch, f"flash {name} lse", lse, want_lse, tol)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

        def sdpa(q, k, v, causal=causal):
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                  enable_gqa=H != KV)
        lib_err = close(torch, f"sdpa {name}", sdpa(q, k, v).transpose(1, 2), out,
                        YARDSTICK_TOL)
        pairs = Sq * (Sq + 1) // 2 + Sq * off if causal else Sq * Sk
        nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * 2 + lse.numel() * 4
        flops = 2 * B * H * pairs * (D + D)
        fn = (lambda q, k, v, off=off, causal=causal:
              fa.flash_attention_fwd(q, k, v, off, causal))
        r = {"shape": [B, Sq, Sk, H, KV, D, D], "causal": causal, "kernel": "wgmma",
             "dtype": "bfloat16", "max_abs_err": err,
             "kernel_ms": time_device(fn, (q, k, v), 50, flush),
             "plain_ms": time_device(lambda q, k, v, off=off, causal=causal:
                                     fa.plain(q, k, v, off, causal), (q, k, v), 5, flush,
                                     batch=5),
             "library_ms": time_device(sdpa, (q, k, v), 50, flush),
             "library_max_abs_err": lib_err, "bytes": nbytes, "flops": flops}
        r["bound_ms"], r["bound_by"] = bound(nbytes, flops, BF16_FLOPS_PER_S)
        log(f"kernel flash_attention {name}", json.dumps(r))
        rows[f"flash_{name}"] = r
        del q, k, v, qt, kt, vt, out, lse, want, want_lse
    for i, (name, (B, S, H, KV, D)) in enumerate(SLICE12_DECODE.items()):
        q = _randn(torch, (B, H, D), bf16, 320 + 3 * i, dev)
        k = _randn(torch, (B, S, KV, D), bf16, 321 + 3 * i, dev)
        v = _randn(torch, (B, S, KV, D), bf16, 322 + 3 * i, dev)
        g = torch.Generator(device=dev)
        g.manual_seed(330 + i)
        ragged = torch.randint(1, S + 1, (B,), generator=g, device=dev, dtype=torch.int32)
        ragged[0], ragged[-1] = 0, S
        full = torch.full((B,), S, dtype=torch.int32, device=dev)
        errs = {}
        for tag, length in (("ragged", ragged), ("full", full)):
            o, m, l = da.decode_attention_fwd(q, k, v, length)
            po, pm, pl = da.plain(q, k, v, length)
            ok = length > 0
            if not ((m[~ok] == -1e30).all() and (l[~ok] == 0).all() and (o[~ok] == 0).all()):
                raise AssertionError(f"decode {name}: a length-0 row is not m=-1e30, l=0, o=0")
            errs[tag] = close(torch, f"decode {name} {tag}", o[ok] / l[ok][..., None],
                              po[ok] / pl[ok][..., None], tol)
            close(torch, f"decode {name} {tag} m", m, pm, tol)
            close(torch, f"decode {name} {tag} l", l, pl, tol)
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)

        def sdpa_decode(q, k, v, length):
            return F.scaled_dot_product_attention(q[:, :, None], kt, vt, enable_gqa=H != KV)
        lib_err = close(torch, f"sdpa decode {name}", sdpa_decode(q, k, v, full)[:, :, 0],
                        o / l[..., None], YARDSTICK_TOL)
        keys = B * S
        nbytes = keys * KV * 2 * D * 2 + q.numel() * 2 + (o.numel() + 2 * m.numel() + B) * 4
        flops = 2 * keys * H * 2 * D
        r = {"shape": [B, S, H, KV, D], "dtype": "bfloat16", "max_abs_err": max(errs.values()),
             "errs": errs, "ragged_lengths": ragged.tolist(),
             "kernel_ms": time_device(da.decode_attention_fwd, (q, k, v, full), 200, flush),
             "plain_ms": time_device(da.plain, (q, k, v, full), 20, flush, batch=20),
             "library_ms": time_device(sdpa_decode, (q, k, v, full), 200, flush),
             "library_max_abs_err": lib_err, "bytes": nbytes, "flops": flops}
        r["bound_ms"], r["bound_by"] = bound(nbytes, flops, BF16_FLOPS_PER_S)
        log(f"kernel decode_attention {name}", json.dumps(r))
        rows[f"decode_{name}"] = r
        del q, k, v, kt, vt, o, m, l, po, pm, pl
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for i, (name, (lead, D)) in enumerate(SLICE12_RMS.items()):
        w = _randn(torch, (D,), bf16, 340 + i, dev)
        x = _randn(torch, (*lead, D), bf16, 350 + i, dev)
        R = x.numel() // D
        lib = (lambda x, w, D=D: F.rms_norm(x, (D,), w, 1e-6))
        err = close(torch, f"rmsnorm {name}", rms.rmsnorm(x, w), rms.plain(x, w),
                    RMS_TOL["bfloat16"])
        r = {"shape": list(x.shape), "rows": R, "D": D, "dtype": "bfloat16",
             "plan": rms.launch_plan(R, D, bf16, sm)._asdict(), "max_abs_err": err,
             "kernel_ms": time_device(rms.rmsnorm, (x, w), 100, flush),
             "plain_ms": time_device(rms.plain, (x, w), 20, flush, batch=10),
             "library_ms": time_device(lib, (x, w), 100, flush),
             "library_max_abs_err": close(torch, f"F.rms_norm {name}", lib(x, w),
                                          rms.rmsnorm(x, w), YARDSTICK_TOL)}
        r["bound_ms"], r["bound_by"] = bound(2 * R * D * 2 + D * 2, 4 * R * D, F32_FLOPS_PER_S)
        log(f"kernel rmsnorm {name}", json.dumps(r))
        rows[f"rmsnorm_{name}"] = r
        del x
    torch.cuda.empty_cache()
    return rows


def _encdec_generate(torch, model, params, batch, new):
    """The encoder-decoder's greedy serve: ``launch.serve.generate``'s loop
    (prefill, caches grown by ``new``, ``new`` decode steps) with the frames
    passed to the prefill, which ``generate`` (token-only, as in the JAX
    package) does not take -> (B, new) tokens."""
    from repro_torch.models.transformer import pad_caches
    with torch.inference_mode():
        caches, logits, _ = model.prefill(params, batch)
        caches = pad_caches(caches, new)
        B, S = batch["tokens"].shape
        length = torch.full((B,), S, dtype=torch.int32, device=logits.device)
        tok, out = model.greedy_token(logits), []
        for _ in range(new):
            out.append(tok)
            logits, caches = model.decode_step(params, tok, caches, length)
            tok = model.greedy_token(logits)
            length = length + 1
    return torch.stack(out, dim=1)


def _serve_twice(torch, kernels, gen, model, params, batch, new, label):
    """The counted serve run ``gen(batch)`` -> (B, new) tokens (counts
    zeroed just before, read just after, by shape too), a second run for
    its wall time (bitwise the same tokens), a prefill alone timed."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = gen(batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    by_shape = launches_by_shape(kernels)
    flash_by_kernel = dict(kernels["flash_attention"].launches_by_kernel)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks2 = gen(batch)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    if not torch.equal(toks, toks2):
        raise AssertionError(f"serve {label}: a second run gave other tokens")
    cfg = model.cfg
    if toks.shape != (batch["tokens"].shape[0], new) or toks.min() < 0 or \
            toks.max() >= cfg.padded_vocab:
        raise AssertionError(f"serve {label}: bad tokens {tuple(toks.shape)}")
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, logits, _ = model.prefill(params, batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    if not torch.isfinite(logits).all() or \
            not torch.equal(model.greedy_token(logits), toks[:, 0]):
        raise AssertionError(f"serve {label}: prefill logits do not give token 0")
    B = batch["tokens"].shape[0]
    return {"arch": cfg.name, "batch": B, "prompt_len": batch["tokens"].shape[1],
            "max_new": new, "first_s": first_s, "generate_s": gen_s, "prefill_s": prefill_s,
            "decode_ms_per_token": (gen_s - prefill_s) / new * 1e3,
            "generated_tokens_per_s": B * new / gen_s, "peak_mem_gb": peak_gb,
            "launches": launches, "flash_by_kernel": flash_by_kernel,
            "by_shape": by_shape, "bitwise_repeat": True, "tokens_head": toks[0, :8].tolist()}


PROFILE_TAGS = ("flash_wgmma", "decode_mma", "decode_combine", "rmsnorm", "gemm", "nvjet",
                "cutlass", "elementwise", "reduce", "cat", "copy")


def profile_tags(torch, fn, label):
    """``profile_device`` of one call, with the device ms of the kernels
    whose names hold each of ``PROFILE_TAGS``; profiled again once if the
    profiler saw no device time, and None (not measured) if it saw none
    again."""
    prof, by_name = profile_device(torch, fn, label)
    if not by_name:
        prof, by_name = profile_device(torch, fn, f"{label} (again)")
    if not by_name:
        return None
    for tag in PROFILE_TAGS:
        prof[f"{tag}_ms"] = sum(v[0] for k, v in by_name.items() if tag in k.lower())
    return prof


def _decode_profile(torch, model, params, batch, label):
    """One prefill, the caches grown by a slot, then one decode step
    profiled (host-bound by nature: its idle share is the measurement)."""
    from repro_torch.models.transformer import pad_caches
    with torch.inference_mode():
        caches, logits, _ = model.prefill(params, batch)
        caches = pad_caches(caches, 1)
        B, S = batch["tokens"].shape
        length = torch.full((B,), S, dtype=torch.int32, device=logits.device)
        tok = model.greedy_token(logits)
        return profile_tags(torch, lambda: model.decode_step(params, tok, caches, length),
                            label)


def phase_whisper(torch, kernels):
    """whisper-base at full width and depth (6 + 6 layers, 512, 8 heads of
    64, vocab 51,865), bf16 drawn on the card: served over 1,500 frames
    (its 30-second window) with a 187-token prompt and 64 greedy tokens,
    counted by kernel and shape; then one loss gradient at batch 8."""
    from torch.func import grad_and_value
    from repro_torch.configs.base import get_config
    from repro_torch.models import model_zoo
    from repro_torch.models.transformer import FlatModel, flatten_params
    W, dev = WHISPER, torch.device("cuda")
    cfg = get_config(W["arch"])
    model = model_zoo.build(cfg)
    g = torch.Generator(device=dev)
    g.manual_seed(W["seed"])
    B, Fr, new = W["batch"], W["frames"], W["max_new"]
    S = Fr // cfg.dec_len_ratio
    params = model.init(g, dtype=torch.bfloat16)
    frames = torch.randn((B, Fr, cfg.d_model), generator=g, device=dev).to(torch.bfloat16)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g, device=dev)
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"whisper: {cfg.name} d_model {cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} "
        f"d_ff {cfg.d_ff} vocab {cfg.padded_vocab}, {cfg.n_enc_layers} + {cfg.n_layers} "
        f"layers, bf16: {n_params} params; frames {Fr}, prompt {S}, {new} new")
    serve_batch = {"frames": frames, "tokens": toks[:, :-1]}
    out = _serve_twice(torch, kernels,
                       lambda b: _encdec_generate(torch, model, params, b, new),
                       model, params, serve_batch, new, cfg.name)
    L, Le, Dh = cfg.n_layers, cfg.n_enc_layers, cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    want = {"quant_aggregate": 0, "rmsnorm": 0, "flash_attention": Le + 2 * L,
            "decode_attention": 2 * L * new}
    want_shape = {"quant_aggregate": {}, "rmsnorm": {},
                  "flash_attention": named({(B, Fr, Fr, H, KV, Dh, Dh, False): Le,
                                            (B, S, Fr, H, KV, Dh, Dh, False): L,
                                            (B, S, S, H, KV, Dh, Dh, True): L}),
                  "decode_attention": named({(B, S + new, H, KV, Dh, Dh): L * new,
                                             (B, Fr, H, KV, Dh, Dh): L * new})}
    with torch.inference_mode():
        out["profile_prefill"] = profile_tags(
            torch, lambda: model.prefill(params, serve_batch), "whisper prefill")
    out["profile_decode_step"] = _decode_profile(torch, model, params, serve_batch,
                                                 "whisper decode step")
    log(f"whisper serve launches {json.dumps(out['launches'])} (want {json.dumps(want)}); "
        f"by shape {json.dumps(out['by_shape'])}")
    if out["launches"] != want or out["by_shape"] != want_shape or \
            out["flash_by_kernel"] != {"wgmma": Le + 2 * L, "tf32x3": 0}:
        raise AssertionError(f"whisper serve: launches {out['launches']} by shape "
                             f"{out['by_shape']}, by kernel {out['flash_by_kernel']}; want "
                             f"{want}, {want_shape}, all flash on wgmma")
    # one loss gradient at batch 8 (the FL rounds' transform)
    batch = {"frames": frames, "tokens": toks[:, :-1], "labels": toks[:, 1:]}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grads, loss = grad_and_value(model.loss)(params, batch)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    grad_launches = {name: fn.launches for name, fn in kernels.items()}
    bad = [p for p, v in zip(_paths(grads), _leaves(grads))
           if not torch.isfinite(v.float()).all()]
    if not math.isfinite(loss.item()) or bad or grad_launches["flash_attention"] != Le + 2 * L:
        raise AssertionError(f"whisper gradient: loss {loss.item()}, non-finite {bad}, "
                             f"launches {grad_launches}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    grad_norm = float(sum(v.float().square().sum() for v in _leaves(grads)) ** 0.5)
    del grads
    torch.cuda.synchronize()
    t0 = time.perf_counter()          # again, warm: the first call's set-up left out
    grads, loss2 = grad_and_value(model.loss)(params, batch)
    torch.cuda.synchronize()
    out["gradient"] = {"loss": loss.item(), "first_s": grad_s,
                       "warm_s": time.perf_counter() - t0, "launches": grad_launches,
                       "peak_mem_gb": peak_gb, "grad_norm": grad_norm,
                       "repeat_bitwise": bool(torch.equal(loss, loss2))}
    del grads
    out["grad_memory"] = grad_memory(torch, FlatModel(model), flatten_params(params), batch)
    log("whisper", json.dumps(out))
    del params, frames
    torch.cuda.empty_cache()
    return out


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1]


def phase_xlstm(torch, kernels):
    """xlstm-125m at full width (768) and XLSTM's depth (one sLSTM period,
    4 of 12 layers), bf16 drawn on the card: served (batch 8, prompt 2,048,
    64 new), B2 counted by rows;
    the sLSTM's launches a token of the prompt (profiled on one layer); one
    temporal FedAvgM round of ``repro_torch.launch.train_fl_lm``."""
    from repro_torch.configs.base import FLConfig, get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train_fl_lm
    from repro_torch.launch.serve import generate
    from repro_torch.models import model_zoo, ssm
    X, dev = XLSTM, torch.device("cuda")
    cfg = get_config(X["arch"]).replace(n_layers=X["n_layers"])
    model = model_zoo.build(cfg)
    g = torch.Generator(device=dev)
    g.manual_seed(X["seed"])
    B, S, new = X["batch"], X["prompt_len"], X["max_new"]
    params = model.init(g, dtype=torch.bfloat16)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=dev)
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"xlstm: {cfg.name} d_model {cfg.d_model} {cfg.n_layers} layers (mLSTM head dim "
        f"{ssm.xlstm_dims(cfg)[2]}), bf16: {n_params} params")
    out = _serve_twice(torch, kernels, lambda b: generate(model, params, b["tokens"], new),
                       model, params, {"tokens": prompts}, new, cfg.name)
    norms = cfg.n_layers + 1                   # one before each block, and the final norm
    want = {"quant_aggregate": 0, "rmsnorm": norms * (1 + new), "flash_attention": 0,
            "decode_attention": 0}
    want_rows = named({(B * S, cfg.d_model): norms, (B, cfg.d_model): norms * new})
    log(f"xlstm serve launches {json.dumps(out['launches'])} (want {json.dumps(want)}); "
        f"rmsnorm by rows {json.dumps(out['by_shape']['rmsnorm'])}")
    if out["launches"] != want or out["by_shape"]["rmsnorm"] != want_rows:
        raise AssertionError(f"xlstm serve: launches {out['launches']}, by rows "
                             f"{out['by_shape']['rmsnorm']}; want {want}, {want_rows}")
    out["profile_decode_step"] = _decode_profile(torch, model, params, {"tokens": prompts},
                                                 "xlstm decode step")
    # the sLSTM's launches a token: one layer's forward over a shorter prompt
    n = X["slstm_profile_len"]
    w = {k: v[0] for k, v in params["blocks"]["slstm"].items()}
    x = torch.randn((B, n, cfg.d_model), generator=g, device=dev).to(torch.bfloat16)
    with torch.inference_mode():
        prof, _ = profile_device(torch, lambda: ssm.slstm_forward(w, x, cfg),
                                 f"slstm forward {B} x {n}")
    out["slstm_launches_per_token"] = prof["kernel_launches"] / n
    out["slstm_profile"] = prof
    del params, x
    torch.cuda.empty_cache()
    # one temporal round at full width, XLSTM's depth
    T = XLSTM_TRAIN
    fl = FLConfig(strategy="fedavgm", n_clients=T["clients"], local_epochs=T["local_epochs"],
                  client_lr=T["client_lr"], server_momentum=T["server_momentum"], seed=0)
    t0 = time.perf_counter()
    _, round_fn, state = train_fl_lm.setup(cfg, fl, dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    lm = SyntheticLM(vocab=cfg.vocab_size, seed=0)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(kernels)
    state, logger = train_fl_lm.run_rounds(
        round_fn, state, lm, 0, 1, clients=T["clients"], cohort=T["cohort"],
        batch=T["batch"], seq=T["seq"], local_steps=T["local_steps"], device=dev)
    steps = T["cohort"] * T["local_steps"] * T["local_epochs"]
    launches = {name: fn.launches for name, fn in kernels.items()}
    by_shape = launches_by_shape(kernels)
    # each period's norms twice a step, in the forward and in the backward's
    # recompute of the period; the final norm once
    train_norms = 2 * cfg.n_layers + 1
    want_rows = named({(T["batch"] * T["seq"], cfg.d_model): train_norms * steps})
    losses = logger.series("loss")
    if launches["rmsnorm"] != train_norms * steps or by_shape["rmsnorm"] != want_rows \
            or not all(math.isfinite(v) for v in losses) \
            or not all(torch.isfinite(v.float()).all() for v in state["params"].values()):
        raise AssertionError(f"xlstm train round: losses {losses}, launches {launches}, "
                             f"B2 by rows {by_shape['rmsnorm']} (want {want_rows})")
    out["train"] = {"losses": losses, "round_s": logger.series("round_s"), "init_s": init_s,
                    "seq": T["seq"], "batch": T["batch"], "local_steps": steps,
                    "tokens_per_round": steps * T["batch"] * T["seq"],
                    "launches": launches, "by_shape": by_shape, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log("xlstm", json.dumps(out))
    del state
    torch.cuda.empty_cache()
    return out


def phase_jamba_sublayers(torch, kernels):
    """jamba-1.5-large-398b's attention sublayer and one Mamba mixer alone
    at full width (d_model 8,192; 64 heads on 8 of 128; d_inner 16,384, N
    16, dt_rank 512), bf16 drawn on the card, each after its RMSNorm:
    prefill over 8 x 2,048 and one decode step, counted and timed."""
    import torch.nn.functional as F
    from repro_torch.configs.base import get_config
    from repro_torch.models import attention as attn
    from repro_torch.models import ssm
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.transformer import init_tree
    J, dev = JAMBA, torch.device("cuda")
    cfg = get_config(J["arch"])
    B, S, D = J["batch"], J["prompt_len"], cfg.d_model
    g = torch.Generator(device=dev)
    g.manual_seed(J["seed"])
    w = init_tree(g, {"ln_mix": {"w": (D,)}, "attn": attn.attn_param_shapes(cfg),
                      "mamba": ssm.mamba_param_shapes(cfg)}, torch.bfloat16)
    ln = w["ln_mix"]["w"]
    x = torch.randn((B, S, D), generator=g, device=dev).to(torch.bfloat16)
    xd = torch.randn((B, 1, D), generator=g, device=dev).to(torch.bfloat16)
    length = torch.full((B,), S, dtype=torch.int32, device=dev)
    Q = ssm.mamba_chunk_len(cfg, B, S)
    out = {"shape": [B, S, D], "mamba_chunk": Q, "mamba_dims": list(ssm.mamba_dims(cfg))}

    def attn_prefill():
        o, cache = attn.gqa_seqsharded(w["attn"], rms_norm(x, ln, cfg.norm_eps), cfg,
                                       return_cache=True)
        return x + o, cache

    def attn_decode(cache):
        o, cache = attn.gqa_decode(w["attn"], rms_norm(xd, ln, cfg.norm_eps), cache,
                                   length, cfg)
        return xd + o

    def mamba_prefill():
        return ssm.mamba_forward(w["mamba"], rms_norm(x, ln, cfg.norm_eps), cfg)

    def mamba_decode(st):
        return ssm.mamba_decode(w["mamba"], rms_norm(xd, ln, cfg.norm_eps), cfg, st)

    def timed(fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn(*a)
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) * 1e3

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        for name, pre, dec in (("attention", attn_prefill, attn_decode),
                               ("mamba", mamba_prefill, mamba_decode)):
            _zero_counts(kernels)
            (y, cache), pre_ms = timed(pre)
            if name == "attention":     # one free slot for the decode token
                cache = attn.KVCache(*(F.pad(t, (0, 0, 0, 0, 0, 1)) for t in cache))
            yd, dec_ms = timed(dec, cache)
            yd = yd[0] if isinstance(yd, tuple) else yd
            launches = {n: fn.launches for n, fn in kernels.items()}
            by_shape = launches_by_shape(kernels)
            flash = dict(kernels["flash_attention"].launches_by_kernel)
            if not (torch.isfinite(y).all() and torch.isfinite(yd).all()):
                raise AssertionError(f"jamba {name} sublayer: non-finite output")
            attention = name == "attention"
            want = {"quant_aggregate": 0, "rmsnorm": 2, "flash_attention": int(attention),
                    "decode_attention": int(attention)}
            if launches != want or flash["tf32x3"]:
                raise AssertionError(f"jamba {name}: launches {launches}, flash {flash}; "
                                     f"want {want}")
            # warm times: the median of three more
            pre_ms = sorted([pre_ms] + [timed(pre)[1] for _ in range(3)])[1]
            dec_ms = sorted([dec_ms] + [timed(dec, cache)[1] for _ in range(3)])[1]
            out[name] = {"prefill_ms": pre_ms, "decode_step_ms": dec_ms,
                         "launches": launches, "by_shape": by_shape,
                         "profile_prefill": profile_tags(torch, pre, f"jamba {name} prefill")}
            del y, yd, cache
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log("jamba sublayers at full width", json.dumps(out))
    del w, x, xd
    torch.cuda.empty_cache()
    return out


# phase 13 (slice 13): the rematerialized LM training step and int8 LM
# sends. minicpm3-4b (hf:openbmb/MiniCPM3-4B) trained at published width and
# TRAIN_FULL's depth, bf16, through train_fl_lm's temporal FedAvgM round and
# through the same round with int8 sends (strategy compressed): B1 at the
# packed N (past 2**31), checked bitwise over column slices first;
# qwen3-moe-30b-a3b's MoE FFN repeats its forward bitwise (the recompute's
# routing must pick the forward's experts); B2 at minicpm3-4b's train rows
# at 32 of its 62 layers since slice 19 (the script's time): still the
# smallest depth whose packed int8 delta passes 2**31 values
TRAIN_FULL = dict(TRAIN, arch="minicpm3-4b", n_layers=32, norms_per_layer=4)
B1_LM = {"C": 2, "qblock": 256, "slice": 1 << 27, "seed": 90}   # N from TRAIN_FULL's arch
MOE_REPEAT = {"arch": "qwen3-moe-30b-a3b", "batch": 2, "seq": 2048, "seed": 91}
# B2 at the training rows of minicpm3-4b (2 x 2048): (width, a column slice of
# a wider row or None): ln1/ln2/final norm, q_norm, kv_norm of the 288-wide dkv
TRAIN_MLA_RMS = {"mla_train_ln": (2560, None), "mla_train_q_norm": (768, None),
                 "mla_train_kv_norm": (256, 288)}
# qwen2.5-32b's round before rematerialization (PERF.md), printed beside today's
RECORDED = {"qwen2.5-32b_peak_gb": 59.86, "qwen2.5-32b_warm_round_s": 0.58}


def packed_n(cfg) -> int:
    """The packed int8 length of an LM's delta: every leaf padded to whole
    256-value blocks (``core/packing``), from the config's shapes alone."""
    from repro_torch.core.packing import QBLOCK
    from repro_torch.models.transformer import flatten_params, param_shapes
    return sum(n + (-n) % QBLOCK for n in
               (math.prod(s) for s in flatten_params(param_shapes(cfg)).values()))


def time_b1_sliced(torch, qa, C, N, seed, label):
    """B1 at (C, N) on random sends: bitwise its plain version over every
    column slice of ``B1_LM["slice"]`` (the plain version of a whole row
    past 2**31 values would need (C, N) f32 temporaries), then timed beside
    its bound and the plain version run slice by slice."""
    dev = torch.device("cuda")
    qblock, step = B1_LM["qblock"], B1_LM["slice"]
    q, s, w = agg_inputs(C, N, qblock, seed=seed, device=dev)
    got = qa.quant_aggregate(q, s, w)

    def plain_by_slices(q, s, w, check=None):
        for lo in range(0, N, step):
            hi = min(N, lo + step)
            part = qa.plain(q[:, lo:hi], s[:, lo // qblock:hi // qblock], w)
            if check is not None and not torch.equal(check[lo:hi], part):
                raise AssertionError(f"quant_aggregate at N={N}: columns [{lo}, {hi}) are "
                                     "not bitwise its plain version")
    plain_by_slices(q, s, w, check=got)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"quant_aggregate at N={N}: non-finite output")
    del got
    nbytes = C * N + 4 * C * (N // qblock) + 4 * C + 4 * N
    bound_ms, bound_by = bound(nbytes, 3 * C * N, F32_FLOPS_PER_S)
    plan = qa.launch_plan(C, N, qblock)
    r = {"S": 1, "C": C, "N": N, "qblock": qblock, "bitwise": True, "max_abs_err": 0.0,
         "checked_slices": -(-N // step), "plan": plan._asdict(),
         "tma_last_column": (-(-N // plan.tile) - 1) * plan.tile // 4,
         "kernel_ms": time_device(qa.quant_aggregate, (q, s, w), 10, None, batch=5),
         "kernel_call_ms": time_call(qa.quant_aggregate, (q, s, w), 10, None),
         "plain_ms": time_device(plain_by_slices, (q, s, w), 2, None, batch=1),
         "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "library_ms": None}
    log(f"kernel quant_aggregate {label}", json.dumps(r))
    del q, s, w
    torch.cuda.empty_cache()
    return r


def check_moe_repeat(torch):
    """qwen3-moe-30b-a3b's MoE FFN at full width (128 experts top-8, one
    layer's weights in bf16) on a training batch's tokens, twice: the
    outputs, aux losses and routing bitwise (the backward's recompute then
    routes every token to the forward's experts)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import moe
    M, dev = MOE_REPEAT, torch.device("cuda")
    cfg = get_config(M["arch"])
    g = torch.Generator(device=dev)
    g.manual_seed(M["seed"])
    w = moe.init_moe_params(g, cfg, dtype=torch.bfloat16)
    x = torch.randn((M["batch"], M["seq"], cfg.d_model), generator=g, device=dev) \
        .to(torch.bfloat16)
    runs = []
    for _ in range(2):
        out, aux = moe.moe_ffn(w, x, cfg)
        _, eids, *_ = moe._route(x.reshape(-1, cfg.d_model), w["router"], cfg)
        runs.append((out, aux, eids))
    torch.cuda.synchronize()
    same = torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][2], runs[1][2]) \
        and all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    r = {"arch": cfg.name, "tokens": M["batch"] * M["seq"], "experts": cfg.moe.n_experts,
         "top_k": cfg.moe.top_k, "bitwise_repeat": same,
         "drop_fraction": runs[0][1].drop_fraction.item()}
    log("moe forward repeat", json.dumps(r))
    if not same:
        raise AssertionError("moe_ffn's forward is not bitwise repeatable: a recompute "
                             "could route a token to another expert")
    del w, x, runs
    torch.cuda.empty_cache()
    return r


def time_train_norms_mla(torch, flush):
    """B2 at minicpm3-4b's training rows (2 x 2048) at each width the train
    stack gives it, against its plain version and timed beside it, the
    PyTorch call and the bound; kv_norm's input is the 256-column slice of
    288-wide rows, through ``ops.rmsnorm`` (which copies it)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rms
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    B, S = TRAIN_FULL["batch"], TRAIN_FULL["seq"]
    rows = {}
    for i, (name, (D, wide)) in enumerate(TRAIN_MLA_RMS.items()):
        full = _randn(torch, (B, S, wide or D), bf16, 230 + i, dev)
        w = _randn(torch, (D,), bf16, 240 + i, dev)
        want = rms.plain(full[..., :D], w)
        err = close(torch, f"rmsnorm {name} (ops)", ops.rmsnorm(full[..., :D], w), want,
                    RMS_TOL["bfloat16"])
        x = full[..., :D].contiguous()
        err = max(err, close(torch, f"rmsnorm {name}", rms.rmsnorm(x, w), want,
                             RMS_TOL["bfloat16"]))
        R = B * S
        lib = (lambda x, w: F.rms_norm(x, (D,), w, 1e-6))
        r = {"shape": [B, S, D], "rows": R, "D": D, "dtype": "bfloat16",
             "strided_from": wide, "max_abs_err": err,
             "kernel_ms": time_device(rms.rmsnorm, (x, w), 100, flush, batch=20),
             "plain_ms": time_device(rms.plain, (x, w), 20, flush, batch=10),
             "library_ms": time_device(lib, (x, w), 100, flush, batch=20)}
        r["bound_ms"], r["bound_by"] = bound(2 * R * D * 2 + D * 2, 4 * R * D,
                                             F32_FLOPS_PER_S)
        log(f"kernel rmsnorm {name}", json.dumps(r))
        rows[f"rmsnorm_{name}"] = r
        del full, w, want, x
    return rows


def phase_train_full_depth(torch, kernels, T=TRAIN_FULL):
    """minicpm3-4b at its published width and ``T["n_layers"]`` of its 62
    layers (32: 2.19 B params in bf16, a packed delta past 2**31; all 62
    until slice 19): ``train_fl_lm.setup`` and ``run_rounds`` on fixed client
    data, TRAIN's temporal FedAvgM round (4 clients, cohort 2, 2 local steps
    of 2 x 2048 tokens, 3 rounds), then the same round with int8 sends
    (``strategy: compressed``) from the same initial params; each run counted
    (B2 and B3 by shape, forward plus recompute; B1 once a round at (2, N)
    on the int8 run), timed round by round, its peak memory read."""
    from repro_torch.configs.base import FLConfig, get_config
    from repro_torch.core.rounds import build_temporal_round
    from repro_torch.core.strategies import get_strategy
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train_fl_lm
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    full = get_config(T["arch"]).n_layers
    cfg = get_config(T["arch"]).replace(n_layers=T["n_layers"])
    kw_fl = dict(n_clients=T["clients"], local_epochs=T["local_epochs"],
                 client_lr=T["client_lr"], seed=0)
    t0 = time.perf_counter()
    model, round_fn, state = train_fl_lm.setup(
        cfg, FLConfig(strategy=T["strategy"], server_momentum=T["server_momentum"], **kw_fl),
        dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(v.numel() for v in state["params"].values())
    N = packed_n(cfg)
    log(f"train full depth: {cfg.name}, {cfg.n_layers} of {full} layers, bf16: "
        f"{n_params} params ({n_params * 2 / 1e9:.2f} GB) drawn in {init_s:.1f}s; packed "
        f"N {N} ({N / 2**31:.3f} x 2**31)")
    initial = {k: v.cpu() for k, v in state["params"].items()}
    lm = SyntheticLM(vocab=cfg.vocab_size, seed=0)
    kw = dict(clients=T["clients"], cohort=T["cohort"], batch=T["batch"], seq=T["seq"],
              local_steps=T["local_steps"], device=dev, data_round=0)
    L, steps = cfg.n_layers, T["cohort"] * T["local_steps"] * T["local_epochs"] * T["rounds"]
    want = train_launches(T, L, steps)
    rows = T["batch"] * T["seq"]
    want_by_shape = {
        "rmsnorm": named({(rows, D): (2 * per_layer * L + more) * steps
                          for D, (per_layer, more) in SERVE_MLA["norm_widths"].items()}),
        "flash_attention": named({(T["batch"], T["seq"], T["seq"], cfg.n_heads, 1,
                                   cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim,
                                   cfg.mla.kv_lora_rank, True): 2 * L * steps})}
    out = {"arch": cfg.name, "n_layers": L, "params": n_params, "packed_n": N,
           "init_s": init_s}
    # each run's initial state is handed over (popped from a list), so that no
    # frame here holds it while the rounds run (16.3 GB of params and
    # momentum on the card at this depth)
    handover = [state]
    del state
    for tag in ("plain", "int8"):
        if tag == "int8":
            fl8 = FLConfig(strategy="compressed", compression="int8", **kw_fl)
            strategy = get_strategy(fl8)
            round_fn = build_temporal_round(model, strategy, fl8)
            params = {k: v.to(dev) for k, v in initial.items()}
            handover.append({"params": params, "server": strategy.server_state_init(params),
                             "clients": ()})
            del params
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(kernels)
        state, logger = train_fl_lm.run_rounds(round_fn, handover.pop(), lm, 0, T["rounds"],
                                               **kw)
        launches = {n: fn.launches for n, fn in kernels.items()}
        by_shape = launches_by_shape(kernels)
        flash_by_kernel = dict(kernels["flash_attention"].launches_by_kernel)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses, round_s = logger.series("loss"), logger.series("round_s")
        b1 = T["rounds"] if tag == "int8" else 0
        run_want = {"quant_aggregate": b1, **want}
        b1_shape = named({(1, B1_LM["C"], N, B1_LM["qblock"]): b1} if b1 else {})
        tokens = steps // T["rounds"] * T["batch"] * T["seq"]
        r = {"losses": losses, "loss_fell": losses[-1] < losses[0], "round_s": round_s,
             "tokens_per_round": tokens, "tokens_per_s": [tokens / t for t in round_s],
             "peak_mem_gb": peak_gb, "launches": launches, "flash_by_kernel": flash_by_kernel,
             "by_shape": by_shape}
        log(f"train full depth {tag} {cfg.name}", json.dumps(r))
        if launches != run_want or flash_by_kernel["tf32x3"] != 0 \
                or by_shape["rmsnorm"] != want_by_shape["rmsnorm"] \
                or by_shape["flash_attention"] != want_by_shape["flash_attention"] \
                or by_shape["quant_aggregate"] != b1_shape:
            raise AssertionError(f"train full depth {tag}: launches {launches}, by shape "
                                 f"{by_shape}; want {run_want}, {want_by_shape}, B1 {b1_shape}")
        if not all(math.isfinite(x) for x in losses) or not r["loss_fell"] \
                or not all(torch.isfinite(v.float()).all() for v in state["params"].values()):
            raise AssertionError(f"train full depth {tag}: losses {losses} not finite and "
                                 "falling, or non-finite params")
        out[tag] = r
        del state
        torch.cuda.empty_cache()
    del initial
    return out


# ---------------------------------------------------------------------------
# 14. the mesh runtime (slice 14)
# ---------------------------------------------------------------------------

# the spatial LM train steps on a (1, 1) mesh: (seq_len, global batch, layers
# or None for all); whisper-base's decoder runs seq_len // 8 = 187 tokens over
# 1,500 frames, at full depth; xlstm-125m at one period of its sLSTM (4 of 12
# layers: the per-token sLSTM loop made the full depth's two steps ~50 s)
MESH_LM = {"xlstm-125m": (2048, 8, 4), "whisper-base": (1500, 8, None)}
MESH_ROUNDS = 3
MESH_LANES = 2                      # lane ranks sharing the one card
LANE_BLOCK_SHAPE = (2, 100, 189_952, 256)   # each lane rank's B1 launch


def _counted_kernels():
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quant_aggregate as qa
    from repro_torch.kernels import rmsnorm as rms
    return {"quant_aggregate": qa.quant_aggregate, "rmsnorm": rms.rmsnorm,
            "flash_attention": fa.flash_attention_fwd,
            "decode_attention": da.decode_attention_fwd}


def _mesh_fl_rounds(torch, job, staged, ctx, kernels):
    """MESH_ROUNDS spatial rounds of ``job`` bound to ``ctx`` (every
    client on this rank), as the executor's round loop gathers and masks
    them; B1's count zeroed just before, read just after."""
    from repro_torch.core import determinism
    from repro_torch.core.rounds import build_spatial_round, init_state
    from repro_torch.data.pipeline import gather_client_batches
    from repro_torch.runtime.faults import cohort_mask
    fl, dev = job.fl, staged["x"].device
    root = determinism.root_key(fl.seed)
    round_fn = build_spatial_round(job.model, job.strategy, fl, ctx=ctx)
    state = init_state(job.model, job.strategy, fl, root, n_clients_local=fl.n_clients,
                       device=dev)
    base_w = staged["len"].to(torch.float32)
    losses, round_s = [], []
    _zero_counts(kernels)
    for r in range(MESH_ROUNDS):
        rkey = determinism.round_key(root, r)
        mask = torch.as_tensor(cohort_mask(job.fault, r, fl.n_clients, fl.cohort,
                                           fl.straggler_overprovision), device=dev)
        t0 = time.perf_counter()
        batch = gather_client_batches(staged, rkey, fl.batch_size, fl.local_steps)
        state, m = round_fn(state, batch, base_w * mask, rkey)
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        losses.append(m["loss"].item())
    return {"losses": losses, "round_s": round_s, "state": state,
            "b1": kernels["quant_aggregate"].launches,
            "b1_by_shape": dict(kernels["quant_aggregate"].launches_by_shape)}


def _event_ms(torch, fn, iters=50) -> float:
    """Median device ms of ``fn()`` by CUDA events, after a warm call."""
    fn()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def mesh_world1_rank(rank, world):
    """Phase 14's world-1 rank (``launch.mesh.spawn(..., 1, "cuda")``): a
    (1, 1) ``("data", "model")`` mesh on the card over NCCL, beside a (1, 1)
    CPU mesh over ``gloo``. The int8 FL rounds (client-server and
    hierarchical) and the spatial LM train steps bound to the mesh against
    the same rounds meshless, bitwise; ``Decentralized.mix`` on the card
    mesh against the CPU mesh, bitwise; the cost of the round's NCCL
    ``all_reduce``. Counts zeroed just before each counted path, read just
    after. Returns the results (raises on a failed check)."""
    import torch
    from repro_torch.configs.base import FLConfig, ShapeConfig, get_config
    from repro_torch.core.jobs import load_job
    from repro_torch.core.rounds import build_spatial_round
    from repro_torch.core.strategies import get_strategy
    from repro_torch.core.topology import Decentralized
    from repro_torch.data.pipeline import stage_partitions
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import make_train_step, mesh_ctx
    from repro_torch.models import model_zoo
    from repro_torch.models.transformer import FlatModel
    from repro_torch.runtime.device import resolve_device
    from repro_torch.sharding.axes import SINGLE
    import torch.distributed as dist

    dev = resolve_device("cuda")
    kernels = _counted_kernels()
    ctx = mesh_ctx(make_test_mesh((1, 1), ("data", "model"), device="cuda"))
    cpu_ctx = mesh_ctx(make_test_mesh((1, 1), ("data", "model"), device="cpu"))
    out = {"backend": str(dist.get_backend_config()), "world": world}
    # the int8 FL round, client-server and hierarchical
    data = None
    for topo in ("client_server", "hierarchical"):
        job = load_job(job_dict("compressed", "int8", 1, rounds=MESH_ROUNDS, topology=topo))
        fl = job.fl
        if data is None:
            data = job.dataset.distribute_into_chunks(fl.partition, fl.n_clients,
                                                      fl.dirichlet_alpha)
        staged = stage_partitions(*data, dev)
        mesh_run = _mesh_fl_rounds(torch, job, staged, ctx, kernels)
        plain_run = _mesh_fl_rounds(torch, job, staged, SINGLE, kernels)
        if mesh_run["losses"] != plain_run["losses"] or \
                not _same(torch, mesh_run["state"], plain_run["state"]):
            raise AssertionError(f"mesh {topo}: the (1, 1) NCCL mesh round != the meshless "
                                 f"round ({mesh_run['losses']} vs {plain_run['losses']})")
        if mesh_run["b1"] != MESH_ROUNDS or not all(math.isfinite(v)
                                                    for v in mesh_run["losses"]):
            raise AssertionError(f"mesh {topo}: {mesh_run['b1']} B1 launches in "
                                 f"{MESH_ROUNDS} rounds, losses {mesh_run['losses']}")
        out[topo] = {"losses": mesh_run["losses"], "round_s_mesh": mesh_run["round_s"],
                     "round_s_meshless": plain_run["round_s"], "bitwise": True,
                     "b1": mesh_run["b1"], "b1_by_shape": named(mesh_run["b1_by_shape"])}
        log(f"mesh fl {topo}", json.dumps(out[topo]))
        del mesh_run, plain_run, staged
    # the round's two all_reduces (the (N,) numerator and the weight sum)
    num = torch.randn(189_952, device=dev)
    den = num[:1].sum()
    out["all_reduce_ms"] = {
        "numerator_189952_f32": _event_ms(torch, lambda: ctx.psum(num, ("data", "model"))),
        "weight_sum_f32": _event_ms(torch, lambda: ctx.psum(den, ("data", "model"))),
        "clone_189952_f32": _event_ms(torch, lambda: num.clone())}
    log("mesh all_reduce (NCCL, world 1)", json.dumps(out["all_reduce_ms"]))
    # gossip: the card's mesh against the CPU's, bitwise
    g = torch.Generator(device="cpu")
    g.manual_seed(140)
    state = {"w": torch.randn(20, 189_952, generator=g), "b": torch.randn(20, 10, generator=g)}
    card = Decentralized(gossip_steps=2, ctx=ctx).mix(_tree_to(state, dev))
    cpu = Decentralized(gossip_steps=2, ctx=cpu_ctx).mix(state)
    if not all(torch.equal(card[k].cpu(), cpu[k]) for k in state):
        raise AssertionError("Decentralized.mix: the card's (1, 1) mesh != the CPU's")
    out["gossip_card_eq_cpu"] = True
    log("mesh gossip: Decentralized.mix on the card's NCCL mesh == the CPU's gloo mesh, "
        "bitwise")
    # the spatial LM train steps at published width (MESH_LM's depths)
    fl = FLConfig(strategy="fedavg", local_epochs=1, client_lr=1e-2)
    for arch, (S, B, L) in MESH_LM.items():
        cfg = get_config(arch)
        cfg = cfg.replace(n_layers=L) if L else cfg
        built = make_train_step(cfg, ShapeConfig(arch, S, B, "train"), ctx.mesh)
        t0 = time.perf_counter()
        state, batch, w, rng = built.materialize(seed=14, device=dev)
        w = torch.ones_like(w)
        init_s = time.perf_counter() - t0
        # the meshless twin first: it pays the process's first-use costs
        plain_fn = build_spatial_round(FlatModel(model_zoo.build(cfg)), get_strategy(fl), fl)
        t0 = time.perf_counter()
        want, wmet = plain_fn(state, batch, w, int(rng))
        torch.cuda.synchronize()
        meshless_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(kernels)
        t0 = time.perf_counter()
        new, met = built.fn(state, batch, w, rng)
        loss = met["loss"].item()
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        by_shape = {k: dict(fn.launches_by_shape) for k, fn in kernels.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        if wmet["loss"].item() != loss or not _same(torch, new, want) \
                or not math.isfinite(loss):
            raise AssertionError(f"mesh step {arch}: loss {loss} vs meshless "
                                 f"{wmet['loss'].item()}, params bitwise "
                                 f"{_same(torch, new, want)}")
        tokens = B * (S // cfg.dec_len_ratio if cfg.family == "encdec" else S)
        r = {"loss": loss, "step_s": step_s, "meshless_step_s": meshless_s,
             "tokens_per_s": tokens / step_s, "tokens": tokens, "peak_mem_gb": peak,
             "init_s": init_s, "bitwise_meshless": True,
             "launches_by_shape": {k: named(v) for k, v in by_shape.items() if v}}
        log(f"mesh train step {arch}", json.dumps(r))
        r["by_shape_raw"] = by_shape
        out[arch] = r
        del built, state, batch, new, want
        torch.cuda.empty_cache()
    return out


def _lane_raw(rounds_per_launch: int, **train) -> dict:
    """Phase 8's int8 sweep (S = 4) on MAIN_JOB."""
    return dict(job_dict("compressed", "int8", rounds_per_launch, rounds=3, **train),
                sweep=SWEEP)


def _plan_raw() -> dict:
    return dict(job_dict("compressed", "int8", 1, rounds=2), sweep=SWEEP)


def _halving():
    from repro_torch.runtime.scheduler import SuccessiveHalving
    return SuccessiveHalving(metric="loss", rung_every=1, eta=2.0)


def mesh_lanes_rank(rank, world, out_dir, ckpt_dir):
    """Phase 14's lane rank (``spawn(..., MESH_LANES, "cuda",
    backend="gloo")``, every rank on the one card): the int8 sweep at
    ``lane_devices = world`` in chunks of 1 with a checkpoint at round 2,
    B1 counted just before and read just after; the halving plan. Returns
    this rank's block."""
    from repro_torch.runtime import campaign as campaign_mod
    with _CachedDatasets(campaign_mod):     # one dataset draw for the rank's runs
        return _mesh_lanes_rank(rank, world, out_dir, ckpt_dir)


def _mesh_lanes_rank(rank, world, out_dir, ckpt_dir):
    from repro_torch.core.jobs import load_job
    from repro_torch.kernels import quant_aggregate as qa
    from repro_torch.runtime.campaign import CampaignExecutor
    from repro_torch.runtime.device import resolve_device
    from repro_torch.runtime.scheduler import PlanExecutor
    resolve_device("cuda")
    ex = CampaignExecutor(load_job(_lane_raw(1, checkpoint_every=2)), lane_devices=world,
                          out_dir=out_dir, ckpt_dir=ckpt_dir).scaffold()
    qa.quant_aggregate.launches, qa.quant_aggregate.launches_by_shape = 0, {}
    ex.run()
    res = {"rank": rank, "block": (ex.block.start, ex.block.stop), "S_pad": ex.S_pad,
           "b1": qa.quant_aggregate.launches,
           "b1_by_shape": dict(qa.quant_aggregate.launches_by_shape),
           "rank_round_s": ex.rank_round_s,
           "lane_losses": [[r["loss"] for r in ex.results if r["traj"] == s]
                           for s in range(ex.S)],
           "params": {k: v.cpu() for k, v in ex.state["params"].items()}}
    log(f"mesh lanes rank {rank}", json.dumps({k: res[k] for k in (
        "block", "b1", "rank_round_s", "lane_losses")}))
    del ex
    pe = PlanExecutor(load_job(_plan_raw()), scheduler=_halving(),
                      lane_devices=world).scaffold()
    pe.run()
    res["plan_dropped"] = dict(pe.dropped)
    return res


def time_mesh_kernels(torch, flush, by_shape):
    """B2 and B3 at every shape the mesh LM steps launched them (bf16),
    against their plain versions, timed beside the PyTorch call and the
    bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    rows = {}
    for i, key in enumerate(sorted(by_shape.get("flash_attention", {}))):
        r = _time_flash_row(torch, F, fa, flush, key, key[2] - key[1] if key[-1] else 0,
                            1400 + 3 * i, "mesh")
        log(f"kernel flash_attention mesh {shape_name(key)}", json.dumps(r))
        rows[("flash_attention", key)] = r
    for i, key in enumerate(sorted(by_shape.get("rmsnorm", {}))):
        r = _time_rms_row(torch, F, rms, flush, key, 1450 + 10 * i, "mesh")
        log(f"kernel rmsnorm mesh {shape_name(key)}", json.dumps(r))
        rows[("rmsnorm", key)] = r
    torch.cuda.empty_cache()
    return rows


def phase_b1_lane_block(torch, qa, flush):
    """B1 at a lane rank's block, (2, 100, 189,952): bitwise its plain
    version, timed beside it and the bound."""
    dev = torch.device("cuda")
    S, C, N, qblock = LANE_BLOCK_SHAPE
    lanes = [agg_inputs(C, N, qblock, seed=140 + s, device=dev) for s in range(S)]
    q, s, w = (torch.stack([ln[i] for ln in lanes]).contiguous() for i in range(3))
    got, want = qa.quant_aggregate(q, s, w), qa.plain(q, s, w)
    if got.shape != (S, N) or not torch.equal(got, want):
        raise AssertionError("quant_aggregate at the lane block: not bitwise its plain version")
    nbytes = S * (C * N + 4 * C * (N // qblock) + 4 * C + 4 * N)
    bound_ms, bound_by = bound(nbytes, 3 * S * C * N, F32_FLOPS_PER_S)
    row = {"S": S, "C": C, "N": N, "qblock": qblock, "bitwise": True, "max_abs_err": 0.0,
           "plan": qa.launch_plan(C, N, qblock, S=S)._asdict(),
           "kernel_ms": time_device(qa.quant_aggregate, (q, s, w), 200, flush),
           "kernel_call_ms": time_call(qa.quant_aggregate, (q, s, w), 200, flush),
           "plain_ms": time_device(qa.plain, (q, s, w), 20, flush, batch=2),
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "library_ms": None}
    log("kernel quant_aggregate lane block", json.dumps(row))
    return row


def phase_mesh(torch, qa, load_job, sweep):
    """Slice 14: the mesh runtime on the card.

    - A world-1 rank over NCCL (``mesh_world1_rank``): the int8 FL round
      (client-server, hierarchical) and the spatial LM steps at published
      width (xlstm-125m at one sLSTM period, whisper-base at full depth;
      MESH_LM) bound to a (1, 1)
      mesh == their meshless rounds, bitwise; gossip card == CPU mesh.
    - Two lane ranks on the one card (``mesh_lanes_rank``, ``gloo`` for
      host objects only): phase 8's int8 sweep at ``lane_devices = 2``;
      each rank's block bitwise a one-process campaign of its two lanes
      (run here), within LANE_LOSS_RTOL of phase 8's one-process S = 4
      campaign (``sweep``: its summary, losses and round_s); ``campaign.csv`` written once; the checkpoint saved at
      ``lane_devices = 2`` resumed here at 0; the halving plan's drops the
      same as at 0.
    - B1 at the lane block's shape, and B2/B3 at every shape the LM steps
      launched, against their plain versions and timed.

    Returns the phase's summary."""
    from repro_torch.launch.mesh import spawn
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    w1 = spawn(mesh_world1_rank, 1, "cuda")[0]
    w1_s = time.perf_counter() - t0
    base = ROOT / "build" / "chip_smoke" / "mesh"
    shutil.rmtree(base, ignore_errors=True)
    t1 = time.perf_counter()
    ranks = spawn(mesh_lanes_rank, MESH_LANES, "cuda", str(base / "out"), str(base / "ckpt"),
                  backend="gloo")
    lanes_s = time.perf_counter() - t1
    from repro_torch.runtime import campaign as campaign_mod
    with _CachedDatasets(campaign_mod):
        blocks, resumed_losses, plan0_dropped = _mesh_lanes_here(torch, load_job, ranks, base,
                                                                 sweep["lane_losses"])
    shutil.rmtree(base, ignore_errors=True)
    log("mesh lanes: each rank's block == a one-process campaign of its lanes, bitwise; "
        "campaign.csv written once; checkpoint at lane_devices=2 resumed at 0; plan drops "
        "the same")
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")  # > 50 MB L2
    block_row = phase_b1_lane_block(torch, qa, flush)
    # each arch's step counts kept apart: {arch: {kernel: {shape: launches}}}
    lm_by_shape = {arch: {fn: c for fn, c in w1[arch]["by_shape_raw"].items() if c}
                   for arch in MESH_LM}
    shapes = {}
    for counts in lm_by_shape.values():
        for fn, c in counts.items():
            shapes.setdefault(fn, set()).update(c)
    kernel_rows = time_mesh_kernels(torch, flush, shapes)
    del flush
    out = {"phase_s": time.perf_counter() - t0, "world1_s": w1_s, "lanes_s": lanes_s,
           "world1": {k: ({f: v[f] for f in v if f != "by_shape_raw"}
                          if isinstance(v, dict) else v) for k, v in w1.items()},
           "lanes": {"blocks": blocks, "plan_dropped": plan0_dropped,
                     "one_process_s4_round_s": sweep["round_s"],
                     "resumed_round_2_losses": resumed_losses,
                     "b1_launches": sum(r["b1"] for r in ranks)},
           "b1_block": block_row, "lm_by_shape": lm_by_shape, "kernel_rows": kernel_rows}
    log(f"mesh phase: {out['phase_s']:.1f}s (world-1 rank {w1_s:.1f}s, lane ranks "
        f"{lanes_s:.1f}s)")
    return out


def _mesh_lanes_here(torch, load_job, ranks, base, sweep_lane_losses):
    """Phase 14's one-process twins of the lane ranks' runs: each block's
    two lanes, the resume of their checkpoint, the plan at 0."""
    from repro_torch.runtime.campaign import CampaignExecutor, read_results
    from repro_torch.runtime.scheduler import PlanExecutor
    blocks = []
    for res in ranks:
        lo, hi = res["block"]
        job = load_job(_lane_raw(1, checkpoint_every=2))
        one = CampaignExecutor(job, lanes=(job.sweep.coords()[lo:hi],
                                           _sweep_fls(job)[lo:hi])).scaffold()
        one.run()
        same = all(torch.equal(res["params"][k], v.cpu()) for k, v in one.state["params"].items())
        one_losses = [[r["loss"] for r in one.results if r["traj"] == s]
                      for s in range(hi - lo)]
        if not same or res["lane_losses"][lo:hi] != one_losses:
            raise AssertionError(f"lane rank {res['rank']}: its block != a one-process "
                                 f"campaign of lanes {lo}..{hi - 1}")
        if res["b1"] != 3 or list(res["b1_by_shape"]) != [LANE_BLOCK_SHAPE]:
            raise AssertionError(f"lane rank {res['rank']}: B1 {res['b1_by_shape']}")
        blocks.append({"block": [lo, hi], "rank_round_s": res["rank_round_s"],
                       "lane_losses": res["lane_losses"][lo:hi], "bitwise_one_process": True})
        del one
    for got, want in zip(ranks[0]["lane_losses"], sweep_lane_losses):
        if not losses_close(got, want, LANE_LOSS_RTOL):
            raise AssertionError(f"lane block losses {got} vs phase 8's S = 4 campaign {want}")
    rows = read_results(base / "out" / "campaign.csv")
    table = sorted((r["traj"], r["round"], r["loss"]) for r in rows)
    want_table = sorted((s, i, v) for s, ls in enumerate(ranks[0]["lane_losses"])
                        for i, v in enumerate(ls))
    if table != want_table:
        raise AssertionError("campaign.csv is not the gathered table of the lane ranks")
    # the checkpoint of lane_devices = 2, resumed in one process
    resumed = CampaignExecutor(load_job(_lane_raw(1, checkpoint_every=2)),
                               ckpt_dir=str(base / "ckpt")).scaffold()
    if resumed.round_idx != 2:
        raise AssertionError(f"lane checkpoint: resumed at round {resumed.round_idx}")
    resumed.run()
    resumed_losses = [[r["loss"] for r in resumed.results if r["traj"] == s and r["round"] == 2]
                      for s in range(resumed.S)]
    for got, want in zip(resumed_losses, sweep_lane_losses):
        if not losses_close(got, want[2:], LANE_LOSS_RTOL):
            raise AssertionError(f"resumed round 2 losses {got} vs {want[2:]}")
    del resumed
    plan0 = PlanExecutor(load_job(_plan_raw()), scheduler=_halving()).scaffold()
    plan0.run()
    for res in ranks:
        if res["plan_dropped"] != plan0.dropped or not plan0.dropped:
            raise AssertionError(f"plan drops at lane_devices=2 {res['plan_dropped']} vs "
                                 f"at 0 {plan0.dropped}")
    dropped = dict(plan0.dropped)
    del plan0
    return blocks, resumed_losses, dropped


def _sweep_fls(job):
    from repro_torch.core import sweeps
    return sweeps.expand(job.fl, job.sweep)


# phase 15 (slice 15): the temporal placement on a (1, 1) NCCL mesh, yi-34b at
# published width: one FedAvg round of one local step, a prefill and decode
# steps, each against its meshless twin, bitwise
MESH_TRAIN = {"arch": "yi-34b", "n_layers": 4, "batch": 2, "seq": 2048, "seed": 150}
MESH_SERVE = {"arch": "yi-34b", "n_layers": 8, "batch": 8, "prompt_len": 2048,
              "max_new": 16, "seed": 151}
# what one rank of a 4-rank model axis launches (kernel-level, 0 launches on
# the card's world-1 path): B3 over its 512 rows of the training sequence at
# ranks 0 and 3, B4 over a 512-key cache shard
MESH_SHARD_FLASH = {"rank0": 0, "rank3": 1536}        # q_offset at B 2, Sq 512, Sk 2048
MESH_SHARD_DECODE = {"S_loc": 512, "lengths": (0, 1, 300, 512)}


def _serve_run(torch, prefill, decode, greedy_first, greedy, B, S, new):
    """A prefill, the caches grown by ``new`` zero slots, then ``new``
    decode steps with greedy tokens -> (every logits tensor, the tokens
    (B, new + 1), the final caches, prefill s, decode ms per step)."""
    from repro_torch.models.transformer import pad_caches
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        caches, logits = prefill()
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        caches = pad_caches(caches, new)
        length = torch.full((B,), S, dtype=torch.int32, device=logits.device)
        tok = greedy_first(logits)
        all_logits, toks, step_ms = [logits], [tok], []
        for _ in range(new):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = decode(tok, caches, length)
            tok = greedy(logits)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            all_logits.append(logits)
            toks.append(tok)
            length = length + 1
    return all_logits, torch.stack(toks, dim=1), caches, prefill_s, step_ms


def _mesh_setup(torch):
    """The world-1 rank's card, counted kernels and (1, 1) ``("data",
    "model")`` NCCL mesh; every group the steps use set up once (NCCL sets
    a group's communicator up at its first collective), before anything
    is timed. -> (dev, kernels, mesh, out)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import mesh_ctx
    from repro_torch.runtime.device import resolve_device

    dev = resolve_device("cuda")
    kernels = _counted_kernels()
    mesh = make_test_mesh((1, 1), ("data", "model"), device="cuda")
    ctx = mesh_ctx(mesh)
    t0 = time.perf_counter()
    for name in ("data", "model", ("data", "model")):
        ctx.psum(torch.zeros(1, device=dev), name)
    torch.cuda.synchronize()
    return dev, kernels, mesh, {"backend": str(dist.get_backend_config()),
                                "world": dist.get_world_size(),
                                "nccl_first_use_s": time.perf_counter() - t0}


def _mesh_train_check(torch, kernels, mesh, dev, arch, L, B, S, seed, want_launches,
                      label, fl=None, warm=True):
    """``make_train_step``'s temporal step of ``arch`` at published width,
    ``L`` layers, bf16 weights drawn on the card from ``seed``: one round
    (FedAvg of one local step, or ``fl``'s fields over those) of ``B`` x
    ``S`` tokens over the whole vocab, its loss and every new param bitwise
    the meshless ``build_temporal_round`` on the same inputs (which runs
    first and pays the process's first uses); the kernels counted in the
    mesh run only (zeroed just before it, read just after) and held to
    ``want_launches(cfg)`` ({kernel: launches}, with B3 all on wgmma);
    ``warm``: both once more, uncounted, timed. Returns the run's record,
    with ``by_shape_raw``."""
    from repro_torch.configs.base import FLConfig, ShapeConfig, get_config
    from repro_torch.core.rounds import build_temporal_round
    from repro_torch.core.strategies import get_strategy
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model_zoo
    from repro_torch.models.transformer import FlatModel, flatten_params

    cfg = get_config(arch).replace(n_layers=L)
    fl = FLConfig(**{"strategy": "fedavg", "local_epochs": 1, "client_lr": 1e-2, **(fl or {})})
    built = make_train_step(cfg, ShapeConfig(f"{label}_train", S, B, "train"), mesh, fl)
    model = model_zoo.build(cfg)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = {"params": flatten_params(model.init(g, dtype=torch.bfloat16)), "server": (),
             "clients": ()}
    tokens = torch.randint(0, cfg.vocab_size, (2, 1, 1, B, S), generator=g, device=dev)
    batch = {"tokens": tokens[0], "labels": tokens[1]}
    weights = torch.ones(1, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in state["params"].values())
    plain_fn = build_temporal_round(FlatModel(model), get_strategy(fl), fl)
    t0 = time.perf_counter()
    want, wmet = plain_fn(state, batch, weights, 0)
    want_loss = wmet["loss"].item()
    meshless_s = time.perf_counter() - t0
    # this rank's shards (the whole arrays at world 1), through the step's specs
    shards = built.shard((state, batch, weights, torch.zeros((), dtype=torch.int64)), dev)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(kernels)
    t0 = time.perf_counter()
    new, met = built.fn(*shards)
    loss = met["loss"].item()
    step_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    by_shape = {k: dict(fn.launches_by_shape) for k, fn in kernels.items()}
    flash_by_kernel = dict(kernels["flash_attention"].launches_by_kernel)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if loss != want_loss or not _same(torch, new["params"], want["params"]) \
            or not math.isfinite(loss):
        raise AssertionError(f"{label} mesh temporal step: loss {loss} vs meshless "
                             f"{want_loss}, params bitwise "
                             f"{_same(torch, new['params'], want['params'])}")
    want_n = want_launches(cfg)
    if launches != want_n or flash_by_kernel != {"wgmma": want_n["flash_attention"],
                                                 "tf32x3": 0}:
        raise AssertionError(f"{label} mesh temporal step launches {launches} (want "
                             f"{want_n}), flash by kernel {flash_by_kernel}")
    moved = sum(not torch.equal(new["params"][k], state["params"][k]) for k in state["params"])
    del new, want
    # both once more, warm, uncounted
    warm_s = {}
    for name, fn, args in (("meshless", plain_fn, (state, batch, weights, 0)),
                           ("mesh", built.fn, shards)) if warm else ():
        t0 = time.perf_counter()
        res, m = fn(*args)
        m["loss"].item()
        warm_s[name] = time.perf_counter() - t0
        del res, m
    out = {"arch": cfg.name, "n_layers": L, "batch": B, "seq": S, "params": n_params,
           "fl": {k: v for k, v in dataclasses.asdict(fl).items() if k in (
               "strategy", "compression", "dp_clip", "dp_noise", "prox_mu", "local_epochs",
               "n_workers", "byzantine_workers", "consensus")},
           "init_s": init_s, "loss": loss, "step_s": step_s, "meshless_step_s": meshless_s,
           "warm_step_s": warm_s.get("mesh"), "meshless_warm_step_s": warm_s.get("meshless"),
           "tokens_per_s": B * S / step_s, "peak_mem_gb": peak, "bitwise_meshless": True,
           "leaves_moved": moved, "leaves": len(state["params"]), "launches": launches,
           "launches_by_shape": {k: named(v) for k, v in by_shape.items() if v}}
    log(f"{label} mesh temporal train step", json.dumps(out))
    out["by_shape_raw"] = by_shape
    del built, state, batch, tokens, shards, model, plain_fn
    torch.cuda.empty_cache()
    return out


def _mesh_serve_check(torch, kernels, mesh, dev, arch, L, B, S, new_tok, seed,
                      want_launches, label, frames=0):
    """``make_prefill_step`` then ``new_tok`` ``make_decode_step`` steps
    with ``greedy_token`` for ``arch`` at published width, ``L`` layers,
    batch ``B``, prompt ``S`` (an encoder-decoder's over ``frames`` frame
    embeddings, drawn too): every logits tensor, the tokens and the final
    caches bitwise meshless ``Model.prefill`` / ``decode_step`` (which run
    first); the kernels counted in the mesh run only and held to
    ``want_launches(cfg)``. Returns the run's record, with
    ``by_shape_raw``."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import model_zoo
    from repro_torch.models.transformer import flatten_params

    cfg = get_config(arch).replace(n_layers=L)
    model = model_zoo.build(cfg)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    params = model.init(g, dtype=torch.bfloat16)
    flat = flatten_params(params)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=dev)
    batch = {"tokens": prompts}
    if frames:
        batch["frames"] = torch.randn((B, frames, cfg.d_model), generator=g,
                                      device=dev).to(torch.bfloat16)
    seq = frames or S
    pre = make_prefill_step(cfg, ShapeConfig(f"{label}_prefill", seq, B, "prefill"), mesh)
    dec = make_decode_step(cfg, ShapeConfig(f"{label}_decode", frames or S + new_tok, B,
                                            "decode"), mesh)
    pflat, pbatch = pre.shard((flat, dict(batch, labels=prompts)), dev)
    dflat = flat                  # the tp shards at world 1: every leaf whole
    plain = _serve_run(
        torch, lambda: model.prefill(params, batch)[:2],
        lambda t, c, ln: model.decode_step(params, t, c, ln), model.greedy_token,
        model.greedy_token, B, S, new_tok)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(kernels)
    mesh_run = _serve_run(
        torch, lambda: pre.fn(pflat, pbatch), lambda t, c, ln: dec.fn(dflat, t, c, ln),
        model.greedy_token, lambda lg: model.greedy_token(lg, ctx=dec.ctx), B, S, new_tok)
    launches = {k: fn.launches for k, fn in kernels.items()}
    by_shape = {k: dict(fn.launches_by_shape) for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    same_logits = all(torch.equal(a, b) for a, b in zip(mesh_run[0], plain[0]))
    same_caches = _same(torch, mesh_run[2], plain[2])
    if not (same_logits and torch.equal(mesh_run[1], plain[1]) and same_caches):
        raise AssertionError(f"{label} mesh serve: logits bitwise {same_logits}, tokens "
                             f"{torch.equal(mesh_run[1], plain[1])}, caches {same_caches}")
    if not all(torch.isfinite(t).all() for t in mesh_run[0]) or \
            mesh_run[0][0].shape != (B, cfg.padded_vocab) or \
            mesh_run[0][1].shape != (B, cfg.padded_vocab):
        raise AssertionError(f"{label} mesh serve: logits not finite or not (B, V)")
    want_n = want_launches(cfg)
    if launches != want_n:
        raise AssertionError(f"{label} mesh serve launches {launches}, want {want_n}")
    out = {"arch": cfg.name, "n_layers": L, "batch": B, "prompt_len": S,
           **({"frames": frames} if frames else {}),
           "decode_steps": new_tok, "cache_len": S + new_tok,
           "prefill_s": mesh_run[3], "meshless_prefill_s": plain[3],
           "decode_step_ms": sorted(mesh_run[4])[new_tok // 2],
           "meshless_decode_step_ms": sorted(plain[4])[new_tok // 2],
           "peak_mem_gb": peak, "bitwise_meshless": True,
           "tokens_head": mesh_run[1][0, :8].tolist(), "launches": launches,
           "launches_by_shape": {k: named(v) for k, v in by_shape.items() if v}}
    log(f"{label} mesh temporal serve", json.dumps(out))
    out["by_shape_raw"] = by_shape
    del params, flat, pflat, dflat, plain, mesh_run, model
    torch.cuda.empty_cache()
    return out


def mesh_temporal_rank(rank, world):
    """Phase 15's world-1 rank (``launch.mesh.spawn(..., 1, "cuda")``): on a
    (1, 1) ``("data", "model")`` NCCL mesh, yi-34b at published width in
    bf16, weights drawn on the card from a seed:

    - ``make_train_step``'s temporal step (MESH_TRAIN: 4 of 60 layers, one
      FedAvg round of one local step of 2 x 2,048 tokens over the whole
      vocab): loss and new params bitwise the meshless
      ``build_temporal_round`` on the same inputs; B2 and B3 counted
      (each layer's forward and recompute, the final norm once);
    - ``make_prefill_step`` then 16 ``make_decode_step`` steps with
      ``greedy_token`` (MESH_SERVE: 8 of 60 layers, batch 8, prompt 2,048,
      cache 2,064): every logits tensor, the tokens and the final caches
      bitwise meshless ``Model.prefill`` / ``decode_step``; B2-B4 counted.

    Then phase 17's rounds (``mesh_strategies_checks``). Counts zeroed just
    before each mesh run, read just after; the meshless twins run first (they
    pay the process's first uses). Returns the results (raises on a failed
    check)."""
    import torch
    dev, kernels, mesh, out = _mesh_setup(torch)
    T, V = MESH_TRAIN, MESH_SERVE
    out["train"] = _mesh_train_check(
        torch, kernels, mesh, dev, T["arch"], T["n_layers"], T["batch"], T["seq"],
        T["seed"], lambda cfg: dict(train_launches({"norms_per_layer": 2}, cfg.n_layers, 1),
                                    quant_aggregate=0), "yi-34b")
    new_tok, L = V["max_new"], V["n_layers"]
    out["serve"] = _mesh_serve_check(
        torch, kernels, mesh, dev, V["arch"], L, V["batch"], V["prompt_len"], new_tok,
        V["seed"], lambda cfg: {"quant_aggregate": 0, "rmsnorm": (2 * L + 1) * (1 + new_tok),
                                "flash_attention": L, "decode_attention": L * new_tok},
        "yi-34b")
    # phase 17's rounds, here where the process has paid its first uses
    out["strategies"] = mesh_strategies_checks(torch, kernels, mesh, dev)
    return out


def _time_flash_row(torch, F, fa, flush, key, off, seed, label):
    """B3 at ``key`` = (B, Sq, Sk, H, KV, Dk, Dv, causal) with ``q_offset``
    ``off`` (bf16): against its plain version, timed beside it, SDPA with
    the same mask and the bound (the keys the causal mask reaches read
    once)."""
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    B, Sq, Sk, H, KV, Dk, Dv, causal = key
    q = _randn(torch, (B, Sq, H, Dk), bf16, seed, dev)
    k = _randn(torch, (B, Sk, KV, Dk), bf16, seed + 1, dev)
    v = _randn(torch, (B, Sk, KV, Dv), bf16, seed + 2, dev)
    out, lse = fa.flash_attention_fwd(q, k, v, off, causal)
    want, want_lse = fa.plain(q, k, v, off, causal)
    err = close(torch, f"{label} flash {key} q_offset {off}", out, want, ATTN_TOL["bfloat16"])
    close(torch, f"{label} flash {key} q_offset {off} lse", lse, want_lse,
          ATTN_TOL["bfloat16"])
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    mask = None
    if causal and (Sq != Sk or off):
        mask = (torch.arange(Sk, device=dev)[None, :]
                <= off + torch.arange(Sq, device=dev)[:, None])

    def sdpa(q, k, v):
        if mask is None:
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                  enable_gqa=H != KV)
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=H != KV)
    keys = min(Sk, off + Sq) if causal else Sk
    pairs = Sq * (Sq + 1) // 2 + Sq * off if causal else Sq * Sk
    nbytes = (q.numel() + out.numel() + B * keys * KV * (Dk + Dv)) * 2 + lse.numel() * 4
    flops = 2 * B * H * pairs * (Dk + Dv)
    r = {"shape": list(key[:-1]), "causal": causal, "q_offset": off,
         "kernel": fa.launch_plan(bf16, Dk, Dv).kernel, "max_abs_err": err,
         "library_max_abs_err": close(torch, f"{label} sdpa {key} {off}",
                                      sdpa(q, k, v).transpose(1, 2), out, YARDSTICK_TOL),
         "kernel_ms": time_device(lambda q, k, v: fa.flash_attention_fwd(q, k, v, off, causal),
                                  (q, k, v), 50, flush),
         "plain_ms": time_device(lambda q, k, v: fa.plain(q, k, v, off, causal), (q, k, v), 5,
                                 flush, batch=5),
         "library_ms": time_device(sdpa, (q, k, v), 50, flush),
         "bytes": nbytes, "flops": flops}
    r["bound_ms"], r["bound_by"] = bound(nbytes, flops, BF16_FLOPS_PER_S)
    return r


def _time_decode_row(torch, F, da, flush, key, lengths, seed):
    """B4 at ``key`` = (B, S, H, KV, Dk, Dv), ``combine=False`` as the mesh
    decode calls it, at per-row ``lengths``: (o, m, l) against its plain
    version (a row of length 0: exactly m = -1e30, l = 0, o = 0, no NaN),
    timed beside it, SDPA with the same length mask (rows of length 0 left
    out of its check) and the bound (the keys up to each row's length)."""
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    B, Sc, H, KV, Dk, Dv = key
    q = _randn(torch, (B, H, Dk), bf16, seed, dev)
    k = _randn(torch, (B, Sc, KV, Dk), bf16, seed + 1, dev)
    v = _randn(torch, (B, Sc, KV, Dv), bf16, seed + 2, dev)
    length = torch.tensor(lengths, dtype=torch.int32, device=dev)
    o, m, l = da.decode_attention_fwd(q, k, v, length)
    po, pm, pl = da.plain(q, k, v, length)
    ok = length > 0
    if not (torch.isfinite(o).all() and (m[~ok] == -1e30).all() and (l[~ok] == 0).all()
            and (o[~ok] == 0).all()):
        raise AssertionError(f"mesh temporal decode {key}: a length-0 row is not "
                             "m=-1e30, l=0, o=0, or an output is not finite")
    tol = ATTN_TOL["bfloat16"]
    err = close(torch, f"mesh temporal decode {key}", o[ok] / l[ok][..., None],
                po[ok] / pl[ok][..., None], tol)
    close(torch, f"mesh temporal decode {key} m", m[ok], pm[ok], tol)
    close(torch, f"mesh temporal decode {key} l", l[ok], pl[ok], tol)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(Sc, device=dev)[None, :] < length[:, None])[:, None, None, :]

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q[:, :, None], kt, vt, attn_mask=mask,
                                              enable_gqa=H != KV)[:, :, 0]
    keys = int(length.clamp(0, Sc).sum())
    nbytes = keys * KV * (Dk + Dv) * 2 + q.numel() * 2 + (o.numel() + 2 * m.numel() + B) * 4
    flops = 2 * keys * H * (Dk + Dv)
    r = {"shape": list(key), "lengths": list(lengths), "combine": False, "max_abs_err": err,
         "library_max_abs_err": close(torch, f"mesh temporal sdpa decode {key}",
                                      sdpa(q, k, v)[ok], (o / l[..., None])[ok],
                                      YARDSTICK_TOL),
         "kernel_ms": time_device(lambda q, k, v: da.decode_attention_fwd(q, k, v, length),
                                  (q, k, v), 200, flush),
         "plain_ms": time_device(lambda q, k, v: da.plain(q, k, v, length), (q, k, v), 20,
                                 flush, batch=20),
         "library_ms": time_device(sdpa, (q, k, v), 200, flush),
         "bytes": nbytes, "flops": flops}
    r["bound_ms"], r["bound_by"] = bound(nbytes, flops, BF16_FLOPS_PER_S)
    return r


def _time_rms_row(torch, F, rms, flush, key, seed, label):
    """B2 at ``key`` = (rows, D) in bf16: against its plain version, timed
    beside it, ``F.rms_norm`` and the bound."""
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    R, D = key
    w = _randn(torch, (D,), bf16, seed, dev)
    x = _randn(torch, (R, D), bf16, seed + 1, dev)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = (lambda x, w: F.rms_norm(x, (D,), w, 1e-6))
    r = {"shape": [R, D], "plan": rms.launch_plan(R, D, bf16, sm)._asdict(),
         "max_abs_err": close(torch, f"{label} rmsnorm {key}", rms.rmsnorm(x, w),
                              rms.plain(x, w), RMS_TOL["bfloat16"]),
         "library_max_abs_err": close(torch, f"{label} F.rms_norm {key}", lib(x, w),
                                      rms.rmsnorm(x, w), YARDSTICK_TOL),
         "kernel_ms": time_device(rms.rmsnorm, (x, w), 100, flush),
         "plain_ms": time_device(rms.plain, (x, w), 20, flush, batch=10),
         "library_ms": time_device(lib, (x, w), 100, flush)}
    r["bound_ms"], r["bound_by"] = bound(2 * R * D * 2 + D * 2, 4 * R * D, F32_FLOPS_PER_S)
    return r


def time_mesh_temporal_kernels(torch, flush, by_path):
    """B2, B3 and B4 at every shape phase 15's counted runs launched
    (``by_path``: {path: {kernel: {shape: launches}}}), and, kernel-level,
    at one rank's shapes on a 4-rank model axis (MESH_SHARD_FLASH,
    MESH_SHARD_DECODE). Returns {(kernel, tag): row}."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    rows, seed = {}, 1500
    shapes = {}
    for counts in by_path.values():
        for fn, c in counts.items():
            shapes.setdefault(fn, set()).update(c)
    for key in sorted(shapes.get("flash_attention", ())):
        rows[("flash_attention", shape_name(key))] = _time_flash_row(
            torch, F, fa, flush, key, key[2] - key[1], seed, "mesh temporal")
        seed += 10
    for key in sorted(shapes.get("rmsnorm", ())):
        rows[("rmsnorm", shape_name(key))] = _time_rms_row(torch, F, rms, flush, key, seed,
                                                           "mesh temporal")
        seed += 10
    S, new = MESH_SERVE["prompt_len"], MESH_SERVE["max_new"]
    for key in sorted(shapes.get("decode_attention", ())):
        # the cache as the decode steps see it half way: prompt + new / 2
        rows[("decode_attention", shape_name(key))] = _time_decode_row(
            torch, F, da, flush, key, (S + new // 2,) * key[0], seed)
        seed += 10
    from repro_torch.configs.base import get_config
    T, V = MESH_TRAIN, MESH_SERVE
    cfg = get_config(T["arch"])
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    for tag, off in MESH_SHARD_FLASH.items():
        key = (T["batch"], T["seq"] // 4, T["seq"], H, KV, HD, HD, True)
        rows[("flash_attention", f"shard_{tag}")] = _time_flash_row(torch, F, fa, flush, key,
                                                                    off, seed, "mesh temporal")
        seed += 10
    lengths = MESH_SHARD_DECODE["lengths"] * (V["batch"] // len(MESH_SHARD_DECODE["lengths"]))
    key = (V["batch"], MESH_SHARD_DECODE["S_loc"], H, KV, HD, HD)
    rows[("decode_attention", "shard")] = _time_decode_row(torch, F, da, flush, key, lengths,
                                                           seed)
    for (fn, tag), r in rows.items():
        log(f"kernel {fn} mesh temporal {tag}", json.dumps(r))
    torch.cuda.empty_cache()
    return rows


def phase_mesh_temporal(torch):
    """Slice 15: the temporal placement on the card. A world-1 NCCL rank
    (``mesh_temporal_rank``) drives the temporal train step and the
    prefill and decode steps of yi-34b at published width, each bitwise
    its meshless twin (and phase 17's rounds, whose results go under
    ``strategies``); then B2, B3 and B4 at every shape those runs
    launched and at one rank's shapes on a 4-rank model axis, against their
    plain versions, timed. Returns the phase's summary."""
    from repro_torch.launch.mesh import spawn
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    w1 = spawn(mesh_temporal_rank, 1, "cuda")[0]
    rank_s = time.perf_counter() - t0
    by_path = {path: {fn: c for fn, c in w1[path]["by_shape_raw"].items() if c}
               for path in ("train", "serve")}
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")  # > 50 MB L2
    rows = time_mesh_temporal_kernels(torch, flush, by_path)
    del flush
    out = {"phase_s": time.perf_counter() - t0, "rank_s": rank_s,
           "train": {k: v for k, v in w1["train"].items() if k != "by_shape_raw"},
           "serve": {k: v for k, v in w1["serve"].items() if k != "by_shape_raw"},
           "by_path": by_path, "kernel_rows": rows, "strategies": w1["strategies"]}
    log(f"mesh temporal phase: {out['phase_s']:.1f}s (world-1 rank {rank_s:.1f}s)")
    return out


# phase 15b (slice 16): MLA and the MoE FFN's expert parallelism on the (1, 1)
# NCCL mesh, at published width: each arch's temporal step, a prefill and
# decode steps, each bitwise its meshless twin; one jamba-width MoE layer
# through the grid ring
MESH_MLA_MOE = {  # arch: train layers, serve layers, B2 a layer a forward
    "minicpm3-4b": {"train_layers": 8, "serve_layers": 16, "norms_per_layer": 4,
                    "decode_per_layer": 0},      # MLA decode attends with einsums
    "qwen3-moe-30b-a3b": {"train_layers": 2, "serve_layers": 4, "norms_per_layer": 4,
                          "decode_per_layer": 1}}
MESH_MLA_MOE_TRAIN = {"batch": 2, "seq": 2048, "seed": 160}
MESH_MLA_MOE_SERVE = {"batch": 8, "prompt_len": 2048, "max_new": 16, "seed": 161}
MESH_GRID_RING = {"arch": "jamba-1.5-large-398b", "batch": 8, "seq": 2048, "seed": 162}
# one rank of a 4-rank model axis, kernel-level: B3 in MLA's absorbed form
# (40 heads on one kv head, 288/256) over its 512 of 2,048 rows at ranks 0
# and 3, B 8; B4 at qwen3-moe's heads over a 512-key cache shard
MESH_MLA_SHARD_FLASH = {"rank0": 0, "rank3": 1536}
MESH_MOE_SHARD_DECODE = {"S_loc": 512, "lengths": (0, 1, 300, 512)}


def _grid_ring_check(torch, dev, mesh):
    """One MoE layer of jamba-1.5-large-398b at published width (16
    experts of d_ff 24,576 on d_model 8,192, ~19.3 GB of bf16 experts) over
    8 x 2,048 tokens, ``moe_ffn`` on the (1, 1) mesh's ctx: the grid ring
    (one hop at world 1) bitwise the meshless ``moe_ffn``; ``quant_ring``
    at the bucket level within the accumulator's int8 rounding (half a
    step, ``amax / 254`` a row) plus bf16's (``amax / 256``) of the plain
    ring run on the same dequantized visit, and its whole error against the
    plain output reported. Returns the record."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.steps import mesh_ctx
    from repro_torch.models import moe

    G = MESH_GRID_RING
    cfg = get_config(G["arch"])
    m = cfg.moe
    ctx = mesh_ctx(mesh)
    g = torch.Generator(device=dev)
    g.manual_seed(G["seed"])
    t0 = time.perf_counter()
    w = moe.init_moe_params(g, cfg, dtype=torch.bfloat16)
    x = torch.randn((G["batch"], G["seq"], cfg.d_model), generator=g, device=dev,
                    dtype=torch.float32).to(torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    expert_gb = sum(w[k].numel() * 2 for k in ("w1", "w3", "w2")) / 1e9
    times = {}
    with torch.inference_mode():
        outs = {}
        for name, kw in (("meshless", {}), ("ring", {"ctx": ctx}),
                         ("quant_ring", {"ctx": ctx, "quant_ring": True})):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[name] = moe.moe_ffn(w, x, cfg, **kw)
            torch.cuda.synchronize()
            times[name] = time.perf_counter() - t0
        plain, paux = outs["meshless"]
        ring, raux = outs["ring"]
        if not (torch.equal(ring, plain) and torch.equal(raux.drop_fraction,
                                                        paux.drop_fraction)):
            raise AssertionError("grid ring at world 1: not bitwise the meshless moe_ffn "
                                 f"(max diff {(ring.float() - plain.float()).abs().max()})")
        q_out = outs["quant_ring"][0]
        rowmax = plain.float().abs().amax(dim=-1, keepdim=True)
        q_rel = ((q_out.float() - plain.float()).abs() / rowmax.clamp(min=1e-30)).max().item()
        # the bucket level: the quantized ring against the plain ring on
        # the same dequantized visit differs by the accumulator's rounding
        xf = x.reshape(-1, cfg.d_model)
        _, eids, _, _, hits = moe._route(xf, w["router"], cfg)
        C = moe.capacity(xf.shape[0], m.top_k, m.n_experts, m.capacity_factor)
        buckets = moe._dispatch(xf, eids, hits, C, m.n_experts)[0]
        vq, vs = moe._q8(buckets)
        acc = moe._ring(ctx, moe._dq(vq, vs, buckets.dtype), w, False).float()
        qb = moe._ring(ctx, buckets, w, True).float()
        amax = acc.abs().amax(dim=-1, keepdim=True)
        excess = ((qb - acc).abs() - amax * (0.5 / 127 + 2.0 ** -8)).max().item()
        acc_rel = ((qb - acc).abs() / amax.clamp(min=1e-30)).max().item()
    if excess > 0 or not torch.isfinite(q_out).all():
        raise AssertionError(f"quant ring: the accumulator's error passes half an int8 "
                             f"step plus bf16 rounding by {excess}")
    out = {"arch": cfg.name, "n_experts": m.n_experts, "expert_d_ff": m.expert_d_ff,
           "d_model": cfg.d_model, "tokens": G["batch"] * G["seq"], "capacity": C,
           "expert_gb": expert_gb, "init_s": init_s, "bitwise_meshless": True,
           "drop_fraction": paux.drop_fraction.item(), "meshless_s": times["meshless"],
           "ring_s": times["ring"], "quant_ring_s": times["quant_ring"],
           "quant_ring_max_rel_err_of_row_max": q_rel,
           "quant_ring_acc_max_rel_err_of_row_max": acc_rel,
           "quant_ring_acc_bound": 0.5 / 127 + 2.0 ** -8}
    log("grid ring world 1", json.dumps(out))
    del w, x, outs, plain, ring, q_out, buckets, acc, qb, xf
    torch.cuda.empty_cache()
    return out


def mesh_mla_moe_rank(rank, world):
    """Phase 15b's world-1 rank: on a (1, 1) ``("data", "model")`` NCCL
    mesh, in bf16 at published width, weights drawn on the card from a
    seed, for minicpm3-4b (MLA, tied embeddings) and qwen3-moe-30b-a3b
    (model EP; the experts' all-to-alls over the model axis): the temporal
    train step (8 and 2 layers, one local step of 2 x 2,048) and a prefill
    of 8 x 2,048 with 16 decode steps (16 and 4 layers), each bitwise its
    meshless twin, B2-B4 counted in the mesh runs; then one jamba-width MoE
    layer through the grid ring (``_grid_ring_check``). Returns the
    results (raises on a failed check)."""
    import torch
    dev, kernels, mesh, out = _mesh_setup(torch)
    T, V = MESH_MLA_MOE_TRAIN, MESH_MLA_MOE_SERVE
    new_tok = V["max_new"]
    for arch, A in MESH_MLA_MOE.items():
        def train_want(cfg, A=A):
            return dict(train_launches(A, cfg.n_layers, 1), quant_aggregate=0)

        def serve_want(cfg, A=A):
            L = cfg.n_layers
            return {"quant_aggregate": 0,
                    "rmsnorm": (A["norms_per_layer"] * L + 1) * (1 + new_tok),
                    "flash_attention": L,
                    "decode_attention": A["decode_per_layer"] * L * new_tok}
        out[arch] = {
            "train": _mesh_train_check(torch, kernels, mesh, dev, arch, A["train_layers"],
                                       T["batch"], T["seq"], T["seed"], train_want, arch),
            "serve": _mesh_serve_check(torch, kernels, mesh, dev, arch, A["serve_layers"],
                                       V["batch"], V["prompt_len"], new_tok, V["seed"],
                                       serve_want, arch)}
    out["grid_ring"] = _grid_ring_check(torch, dev, mesh)
    return out


def time_mesh_mla_moe_kernels(torch, flush, by_path):
    """B2, B3 and B4 at every shape phase 15b's counted runs launched
    (``by_path``: {path: {kernel: {shape: launches}}}), and, kernel-level,
    at one rank's shapes on a 4-rank model axis (MESH_MLA_SHARD_FLASH,
    MESH_MOE_SHARD_DECODE). Returns {(kernel, tag): row}."""
    import torch.nn.functional as F
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    rows, seed = {}, 1600
    shapes = {}
    for counts in by_path.values():
        for fn, c in counts.items():
            shapes.setdefault(fn, set()).update(c)
    for key in sorted(shapes.get("flash_attention", ())):
        rows[("flash_attention", shape_name(key))] = _time_flash_row(
            torch, F, fa, flush, key, key[2] - key[1], seed, "mesh mla/moe")
        seed += 10
    for key in sorted(shapes.get("rmsnorm", ())):
        rows[("rmsnorm", shape_name(key))] = _time_rms_row(torch, F, rms, flush, key, seed,
                                                           "mesh mla/moe")
        seed += 10
    S, new = MESH_MLA_MOE_SERVE["prompt_len"], MESH_MLA_MOE_SERVE["max_new"]
    for key in sorted(shapes.get("decode_attention", ())):
        rows[("decode_attention", shape_name(key))] = _time_decode_row(
            torch, F, da, flush, key, (S + new // 2,) * key[0], seed)
        seed += 10
    mla = get_config("minicpm3-4b")
    B, Sq = MESH_MLA_MOE_SERVE["batch"], MESH_MLA_MOE_SERVE["prompt_len"]
    dk, dv = mla.mla.kv_lora_rank + mla.mla.qk_rope_head_dim, mla.mla.kv_lora_rank
    for tag, off in MESH_MLA_SHARD_FLASH.items():
        key = (B, Sq // 4, Sq, mla.n_heads, 1, dk, dv, True)
        rows[("flash_attention", f"mla_shard_{tag}")] = _time_flash_row(
            torch, F, fa, flush, key, off, seed, "mesh mla/moe")
        seed += 10
    qm = get_config("qwen3-moe-30b-a3b")
    lengths = MESH_MOE_SHARD_DECODE["lengths"] * (B // len(MESH_MOE_SHARD_DECODE["lengths"]))
    HD = qm.resolved_head_dim
    key = (B, MESH_MOE_SHARD_DECODE["S_loc"], qm.n_heads, qm.n_kv_heads, HD, HD)
    rows[("decode_attention", "moe_shard")] = _time_decode_row(torch, F, da, flush, key,
                                                               lengths, seed)
    for (fn, tag), r in rows.items():
        log(f"kernel {fn} mesh mla/moe {tag}", json.dumps(r))
    torch.cuda.empty_cache()
    return rows


def phase_mesh_mla_moe(torch):
    """Slice 16: MLA and the MoE FFN's expert parallelism in the temporal
    placement on the card. A world-1 NCCL rank (``mesh_mla_moe_rank``)
    drives minicpm3-4b's and qwen3-moe-30b-a3b's temporal train step,
    prefill and decode steps at published width, each bitwise its meshless
    twin, and a jamba-width MoE layer through the grid ring; then B2, B3
    and B4 at every shape those runs launched and at one rank's shapes on a
    4-rank model axis, against their plain versions, timed. Returns the
    phase's summary."""
    from repro_torch.launch.mesh import spawn
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    w1 = spawn(mesh_mla_moe_rank, 1, "cuda")[0]
    rank_s = time.perf_counter() - t0
    by_path = {f"{arch}_{path}": {fn: c for fn, c in w1[arch][path]["by_shape_raw"].items()
                                  if c}
               for arch in MESH_MLA_MOE for path in ("train", "serve")}
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")  # > 50 MB L2
    rows = time_mesh_mla_moe_kernels(torch, flush, by_path)
    del flush
    out = {"phase_s": time.perf_counter() - t0, "rank_s": rank_s,
           **{arch: {path: {k: v for k, v in w1[arch][path].items() if k != "by_shape_raw"}
                     for path in ("train", "serve")} for arch in MESH_MLA_MOE},
           "grid_ring": w1["grid_ring"], "nccl_first_use_s": w1["nccl_first_use_s"],
           "by_path": by_path, "kernel_rows": rows}
    log(f"mesh mla/moe phase: {out['phase_s']:.1f}s (world-1 rank {rank_s:.1f}s)")
    return out


# phase 15c (slice 17): jamba's period parts, whisper-base and xlstm-125m on
# the (1, 1) NCCL mesh at published width, each bitwise its meshless twin
MESH_SERVE_SPATIAL = {  # arch: (prompt or decoder length, frames, decode steps, seed)
    "whisper-base": {"prompt_len": 1500 // 8, "frames": 1500, "max_new": 16, "seed": 170},
    "xlstm-125m": {"prompt_len": 2048, "frames": 0, "max_new": 8, "seed": 171}}
MESH_SERVE_SPATIAL_BATCH = 8
MESH_JAMBA_PARTS = {"arch": "jamba-1.5-large-398b", "batch": 8, "prompt_len": 2048,
                    "seed": 172}
# one rank of a 4-rank model axis, kernel-level: B3 at jamba's heads over its
# 512 of 2,048 rows at ranks 0 and 3, and whisper's encoder over its 375 of
# 1,500 frames (full); B4 over whisper's 375-key cross shard and jamba's
# 512-key cache shard with empty rows
MESH_JAMBA_SHARD_FLASH = {"rank0": 0, "rank3": 1536}
MESH_WHISPER_SHARD = 1500 // 4
MESH_JAMBA_SHARD_DECODE = {"S_loc": 512, "lengths": (0, 1, 300, 512)}


def _jamba_parts_check(torch, kernels, mesh, dev):
    """jamba-1.5-large-398b's period parts at published width (d_model
    8,192; d_inner 16,384; 64 heads on 8 of 128), bf16 drawn on the card,
    each after its RMSNorm, over 8 x 2,048: one Mamba mixer through
    ``ssm.mamba_forward``'s sequence-sharded branch (the conv boundary's
    ``ppermute``, the handoff's all-gather and fold, the correction scan)
    then its tensor-parallel decode step (``x_proj``'s and ``out_proj``'s
    ``psum``), and the attention sublayer through the mesh prefill
    (``gqa_seqsharded(ctx=)``) and a tp decode step over one more slot
    (``gqa_decode(ctx=, tp=True)``), each bitwise the meshless twin (which
    runs first); the kernels counted in the mesh runs only. Returns the
    record, with ``by_shape_raw`` by part."""
    import torch.nn.functional as F
    from repro_torch.configs.base import get_config
    from repro_torch.launch.steps import mesh_ctx
    from repro_torch.models import attention as attn
    from repro_torch.models import ssm
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.transformer import init_tree
    from repro_torch.sharding.axes import SINGLE
    J = MESH_JAMBA_PARTS
    cfg = get_config(J["arch"])
    B, S, D, eps = J["batch"], J["prompt_len"], cfg.d_model, cfg.norm_eps
    g = torch.Generator(device=dev)
    g.manual_seed(J["seed"])
    w = init_tree(g, {"ln": {"w": (D,)}, "attn": attn.attn_param_shapes(cfg),
                      "mamba": ssm.mamba_param_shapes(cfg)}, torch.bfloat16)
    ln = w["ln"]["w"]
    x = torch.randn((B, S, D), generator=g, device=dev).to(torch.bfloat16)
    xd = torch.randn((B, 1, D), generator=g, device=dev).to(torch.bfloat16)
    length = torch.full((B,), S, dtype=torch.int32, device=dev)
    ctx = mesh_ctx(mesh)

    def mamba(c, tp):
        y, st = ssm.mamba_forward(w["mamba"], rms_norm(x, ln, eps), cfg, ctx=c)
        yd, std = ssm.mamba_decode(w["mamba"], rms_norm(xd, ln, eps), cfg, st, ctx=c, tp=tp)
        return [y, st, yd, std]

    def attention(c, tp):
        o, cache = attn.gqa_seqsharded(w["attn"], rms_norm(x, ln, eps), cfg, ctx=c,
                                       return_cache=True)
        cache = attn.KVCache(*(F.pad(t, (0, 0, 0, 0, 0, 1)) for t in cache))
        od, cache = attn.gqa_decode(w["attn"], rms_norm(xd, ln, eps), cache, length, cfg,
                                    ctx=c, tp=tp)
        return [o, od, cache]

    def timed(fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn(*a)
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    out = {"arch": cfg.name, "shape": [B, S, D], "mamba_dims": list(ssm.mamba_dims(cfg)),
           "mamba_chunk": ssm.mamba_chunk_len(cfg, B, S), "by_shape_raw": {}}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        for name, fn, want in (
                ("mamba", mamba, {"quant_aggregate": 0, "rmsnorm": 2, "flash_attention": 0,
                                  "decode_attention": 0}),
                ("attention", attention, {"quant_aggregate": 0, "rmsnorm": 2,
                                          "flash_attention": 1, "decode_attention": 1})):
            plain, plain_s = timed(fn, SINGLE, False)
            _zero_counts(kernels)
            got, mesh_s = timed(fn, ctx, True)
            launches = {k: f.launches for k, f in kernels.items()}
            by_shape = {k: dict(f.launches_by_shape) for k, f in kernels.items()}
            flash = dict(kernels["flash_attention"].launches_by_kernel)
            if not _same(torch, got, plain):
                diffs = [(a.float() - b.float()).abs().max().item()
                         for a, b in zip(_flat(got), _flat(plain))]
                raise AssertionError(f"jamba {name} on the mesh: not bitwise meshless {diffs}")
            if not all(torch.isfinite(t.float()).all() for t in _flat(got)):
                raise AssertionError(f"jamba {name} on the mesh: non-finite output")
            if launches != want or flash.get("tf32x3"):
                raise AssertionError(f"jamba {name} on the mesh: launches {launches}, "
                                     f"flash {flash}; want {want}")
            warm = sorted(timed(fn, ctx, True)[1] for _ in range(3))[1]
            plain_warm = sorted(timed(fn, SINGLE, False)[1] for _ in range(3))[1]
            out[name] = {"first_s": mesh_s, "meshless_first_s": plain_s,
                         "prefill_and_decode_s": warm, "meshless_prefill_and_decode_s":
                         plain_warm, "bitwise_meshless": True, "launches": launches,
                         "launches_by_shape": {k: named(v) for k, v in by_shape.items() if v}}
            out["by_shape_raw"][name] = by_shape
            del got, plain
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log("jamba parts mesh", json.dumps({k: v for k, v in out.items() if k != "by_shape_raw"}))
    del w, x, xd
    torch.cuda.empty_cache()
    return out


def mesh_hybrid_encdec_rank(rank, world):
    """Phase 15c's world-1 rank: on a (1, 1) ``("data", "model")`` NCCL
    mesh, in bf16 at published width, weights drawn on the card from a
    seed: whisper-base at full depth (6 + 6 layers; the spatial serve steps:
    the encoder and the decoder sequence-sharded over ``model``, the cross
    decode's B4 over the encoder cache shard and the shards' combine), a
    prefill of 8 x 1,500 frames (decoder length 187) then 16 decode steps;
    xlstm-125m at full depth (12 layers, whole sequences on every rank), a
    prefill of 8 x 2,048 then 8 decode steps; each bitwise its meshless
    twin, B2-B4 counted in the mesh runs; then jamba's period parts
    (``_jamba_parts_check``). Returns the results (raises on a failed
    check)."""
    import torch
    from repro_torch.configs.base import get_config
    dev, kernels, mesh, out = _mesh_setup(torch)
    B = MESH_SERVE_SPATIAL_BATCH
    for arch, A in MESH_SERVE_SPATIAL.items():
        new = A["max_new"]

        def want(cfg, new=new):
            L = cfg.n_layers
            if cfg.family == "encdec":
                return {"quant_aggregate": 0, "rmsnorm": 0,
                        "flash_attention": cfg.n_enc_layers + 2 * L,
                        "decode_attention": 2 * L * new}
            return {"quant_aggregate": 0, "rmsnorm": (L + 1) * (1 + new),
                    "flash_attention": 0, "decode_attention": 0}
        out[arch] = _mesh_serve_check(torch, kernels, mesh, dev, arch,
                                      get_config(arch).n_layers, B, A["prompt_len"], new,
                                      A["seed"], want, arch, frames=A["frames"])
    out["jamba"] = _jamba_parts_check(torch, kernels, mesh, dev)
    return out


def time_mesh_hybrid_encdec_kernels(torch, flush, by_path):
    """B2, B3 and B4 at every shape phase 15c's counted runs launched
    (``by_path``: {path: {kernel: {shape: launches}}}; a decode shape timed
    at its run's lengths half way: whisper's self cache at prompt + 8, its
    encoder cache and jamba's whole), and, kernel-level, at one rank's
    shapes on a 4-rank model axis (MESH_JAMBA_SHARD_FLASH,
    MESH_WHISPER_SHARD, MESH_JAMBA_SHARD_DECODE). Returns {(kernel, tag):
    row}."""
    import torch.nn.functional as F
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    rows, seed, label = {}, 1700, "mesh hybrid/encdec"
    shapes = {}
    for counts in by_path.values():
        for fn, c in counts.items():
            shapes.setdefault(fn, set()).update(c)
    for key in sorted(shapes.get("flash_attention", ())):
        rows[("flash_attention", shape_name(key))] = _time_flash_row(
            torch, F, fa, flush, key, key[2] - key[1] if key[-1] else 0, seed, label)
        seed += 10
    for key in sorted(shapes.get("rmsnorm", ())):
        rows[("rmsnorm", shape_name(key))] = _time_rms_row(torch, F, rms, flush, key, seed,
                                                           label)
        seed += 10
    Wh = MESH_SERVE_SPATIAL["whisper-base"]
    self_len = Wh["prompt_len"] + Wh["max_new"]
    for key in sorted(shapes.get("decode_attention", ())):
        n = Wh["prompt_len"] + Wh["max_new"] // 2 if key[1] == self_len else key[1]
        rows[("decode_attention", shape_name(key))] = _time_decode_row(
            torch, F, da, flush, key, (n,) * key[0], seed)
        seed += 10
    jc, wc = get_config(MESH_JAMBA_PARTS["arch"]), get_config("whisper-base")
    B, S = MESH_JAMBA_PARTS["batch"], MESH_JAMBA_PARTS["prompt_len"]
    jhd, whd = jc.resolved_head_dim, wc.resolved_head_dim
    for tag, off in MESH_JAMBA_SHARD_FLASH.items():
        key = (B, S // 4, S, jc.n_heads, jc.n_kv_heads, jhd, jhd, True)
        rows[("flash_attention", f"jamba_shard_{tag}")] = _time_flash_row(
            torch, F, fa, flush, key, off, seed, label)
        seed += 10
    Fr, Ws = Wh["frames"], MESH_WHISPER_SHARD
    key = (B, Ws, Fr, wc.n_heads, wc.n_kv_heads, whd, whd, False)
    rows[("flash_attention", "whisper_encoder_shard")] = _time_flash_row(
        torch, F, fa, flush, key, 0, seed, label)
    seed += 10
    key = (B, Ws, wc.n_heads, wc.n_kv_heads, whd, whd)
    rows[("decode_attention", "whisper_cross_shard")] = _time_decode_row(
        torch, F, da, flush, key, (Ws,) * B, seed)
    seed += 10
    lengths = MESH_JAMBA_SHARD_DECODE["lengths"] * (B // len(MESH_JAMBA_SHARD_DECODE["lengths"]))
    key = (B, MESH_JAMBA_SHARD_DECODE["S_loc"], jc.n_heads, jc.n_kv_heads, jhd, jhd)
    rows[("decode_attention", "jamba_shard")] = _time_decode_row(torch, F, da, flush, key,
                                                                 lengths, seed)
    for (fn, tag), r in rows.items():
        log(f"kernel {fn} {label} {tag}", json.dumps(r))
    torch.cuda.empty_cache()
    return rows


def phase_mesh_hybrid_encdec(torch):
    """Slice 17: the hybrid, ssm and encdec families on the card's mesh. A
    world-1 NCCL rank (``mesh_hybrid_encdec_rank``) drives whisper-base's
    and xlstm-125m's prefill and decode steps at full depth and jamba's
    period parts at published width, each bitwise its meshless twin; then
    B2, B3 and B4 at every shape those runs launched and at one rank's
    shapes on a 4-rank model axis, against their plain versions, timed.
    Returns the phase's summary."""
    from repro_torch.launch.mesh import spawn
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    w1 = spawn(mesh_hybrid_encdec_rank, 1, "cuda")[0]
    rank_s = time.perf_counter() - t0
    by_path = {f"{arch}_serve": {fn: c for fn, c in w1[arch]["by_shape_raw"].items() if c}
               for arch in MESH_SERVE_SPATIAL}
    by_path.update({f"jamba_{part}": {fn: c for fn, c in counts.items() if c}
                    for part, counts in w1["jamba"]["by_shape_raw"].items()})
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")  # > 50 MB L2
    rows = time_mesh_hybrid_encdec_kernels(torch, flush, by_path)
    del flush
    out = {"phase_s": time.perf_counter() - t0, "rank_s": rank_s,
           **{arch: {k: v for k, v in w1[arch].items() if k != "by_shape_raw"}
              for arch in (*MESH_SERVE_SPATIAL, "jamba")},
           "nccl_first_use_s": w1["nccl_first_use_s"], "by_path": by_path,
           "kernel_rows": rows}
    log(f"mesh hybrid/encdec phase: {out['phase_s']:.1f}s (world-1 rank {rank_s:.1f}s)")
    return out


# phase 16 (slice 18): the dry run of production-mesh cells, rank 0, on the
# meta device and on the card: (arch, shape, 2x16x16, layers; 0: all); yi-34b
# at 30 of 60 layers since slice 19 (its two cells took 67 s at 60, the meta
# runs most of it: time for phase 17)
DRY_RUN_CELLS = (("yi-34b", "train_4k", False, 30),
                 ("yi-34b", "decode_32k", True, 30),
                 ("jamba-1.5-large-398b", "long_500k", True, 8))
DRY_RUN_PEAK_TOL = 0.10           # the card's peak against the meta prediction
DRY_RUN_COUNTED = ("cost", "collectives", "kernels")
# B3 kernel-level at the train cell's last model rank: its 256 of 4,096 rows
DRY_RUN_SHARD_FLASH = {"rank15": 15 * 4096 // 16}


def _dry_run_cell(arch, shape, multi_pod, layers) -> dict:
    """One cell through ``python -m repro_torch.launch.dryrun --device
    cuda`` -> its record (the card's, the meta prediction under ``meta``);
    raises unless the meta and counted card records agree exactly and the
    card's peak is within DRY_RUN_PEAK_TOL of the meta one."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
           shape, "--device", "cuda", "--tag", "smoke"]
    cmd += ["--multi-pod"] if multi_pod else []
    cmd += ["--layers", str(layers)] if layers else []
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    if proc.returncode != 0:
        raise AssertionError(f"dry run {arch} {shape}: exit {proc.returncode}\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    key = f"{arch}__{shape}__{'mp' if multi_pod else 'sp'}"
    key += f"__L{layers}" if layers else ""
    rec = json.loads((ROOT / "results" / "dryrun_torch" / f"{key}__cuda__smoke.json").read_text())
    rec["subprocess_s"] = time.perf_counter() - t0
    meta = rec["meta"]
    for f in DRY_RUN_COUNTED:
        if rec[f] != meta[f]:
            raise AssertionError(f"dry run {key}: the card's counted {f} differ from the meta "
                                 f"run's:\n{json.dumps(rec[f])}\n{json.dumps(meta[f])}")
    card, pred = rec["memory"]["peak_GiB"], meta["memory"]["peak_GiB"]
    rec["peak_rel_diff"] = (card - pred) / pred
    if abs(rec["peak_rel_diff"]) > DRY_RUN_PEAK_TOL:
        raise AssertionError(f"dry run {key}: card peak {card:.3f} GiB, meta prediction "
                             f"{pred:.3f} GiB: beyond {DRY_RUN_PEAK_TOL:.0%}")
    log(f"dry run {key}: card {rec['run_s']:.3f}s peak {card:.3f} GiB (meta {pred:.3f} GiB, "
        f"{rec['peak_rel_diff']:+.2%}); meta run {meta['run_s']:.1f}s; "
        f"flops {rec['cost']['flops']:.4e}, bytes {rec['cost']['bytes_accessed']:.4e}; "
        f"collectives {json.dumps({k: v for k, v in rec['collectives']['counts'].items() if v})};"
        f" launches {json.dumps(rec['launches_by_shape'])}; {rec['subprocess_s']:.1f}s")
    return rec


def _key(text):
    """An ``op_cost`` shape key back to the wrappers' tuple (B3's causal
    flag a bool)."""
    k = tuple(int(x) for x in text.split(","))
    return k[:-1] + (bool(k[-1]),) if len(k) == 8 else k


def time_dry_run_kernels(torch, flush, by_cell):
    """B2, B3 and B4 at every shape phase 16's card runs launched
    (``by_cell``: {cell: {kernel: {shape: launches}}}; a decode at the
    cache's full length, as the dry run's lengths put it; B3 at rank 0's
    q_offset 0), and B3 kernel-level at DRY_RUN_SHARD_FLASH, each against
    its plain version and timed, its bound from its module's ``cost``.
    Returns {(kernel, tag): row}."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    rows, seed, label = {}, 1900, "dry run"
    shapes = {}
    for counts in by_cell.values():
        for fn, c in counts.items():
            shapes.setdefault(fn, set()).update(_key(k) for k in c)

    def with_bound(r, cost, rate=BF16_FLOPS_PER_S):
        r["flops"], r["bytes"] = cost
        r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["flops"], rate)
        return r
    for key in sorted(shapes.get("flash_attention", ())):
        offs = {"rank0": 0, **DRY_RUN_SHARD_FLASH} if key[-1] else {"rank0": 0}
        for tag, off in offs.items():
            rows[("flash_attention", f"{shape_name(key)} {tag}")] = with_bound(
                _time_flash_row(torch, F, fa, flush, key, off, seed, label),
                fa.cost(*key[:-1], off, key[-1], 2))
            seed += 10
    for key in sorted(shapes.get("rmsnorm", ())):
        rows[("rmsnorm", shape_name(key))] = with_bound(
            _time_rms_row(torch, F, rms, flush, key, seed, label), rms.cost(*key, 2, 2),
            F32_FLOPS_PER_S)
        seed += 10
    for key in sorted(shapes.get("decode_attention", ())):
        rows[("decode_attention", shape_name(key))] = with_bound(
            _time_decode_row(torch, F, da, flush, key, (key[1],) * key[0], seed),
            da.cost(*key, 2, keys=key[0] * key[1]))
        seed += 10
    for (fn, tag), r in rows.items():
        log(f"kernel {fn} {label} {tag}", json.dumps(r))
    torch.cuda.empty_cache()
    return rows


def dry_run_entries(dr, sources, flash_src) -> list:
    """The ``kernels`` entries of phase 16's rows (``phase_dry_run``'s
    summary ``dr``): each shape a card run launched, with its launches
    there, and B3's kernel-level rows with none."""
    paths = {name: (f"the dry run's timed card run of rank 0 of {name}: "
                    f"{dr['cells'][name]['layers']} layers, bf16 at published width, "
                    "the other ranks a fake process group") for name in dr["by_cell"]}
    entries = []
    for cell, counts in dr["by_cell"].items():
        for fn in sorted(counts):
            for k, launches in sorted(counts[fn].items()):
                key = _key(k)
                flash = fn == "flash_attention"
                tags = ([f"{shape_name(key)} rank0"] +
                        [f"{shape_name(key)} {t}" for t in DRY_RUN_SHARD_FLASH if key[-1]]
                        if flash else [shape_name(key)])
                for tag in tags:
                    r = dr["kernel_rows"][(fn, tag)]
                    on_path = not flash or tag.endswith("rank0")
                    source, replaces = ((("src/repro_torch/csrc/flash_attention_wgmma.cu"
                                          if r["kernel"] == "wgmma" else
                                          "src/repro_torch/csrc/flash_attention.cu"), flash_src)
                                        if flash else sources[fn])
                    entries.append({
                        "name": f"{fn}_{r['kernel'] + '_' if flash else ''}dry_run_"
                                f"{cell.replace(' ', '_')}_{tag.replace(' ', '_')}",
                        "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches if on_path else 0,
                        "launches_path": paths[cell] if on_path else (
                            f"kernel-level only: the last rank of {cell}'s model axis, its "
                            f"rows at q_offset {r['q_offset']}"),
                        "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "bitwise": False, "shape": r["shape"],
                        **{f: r[f] for f in ("q_offset", "lengths") if f in r}})
    return entries


def phase_dry_run(torch):
    """Slice 18: each DRY_RUN_CELLS cell's dry run (``_dry_run_cell``),
    then its kernels' rows (``time_dry_run_kernels``). Returns the phase's
    summary."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    cells = {}
    for arch, shape, mp, layers in DRY_RUN_CELLS:
        cells[f"{arch} {shape} {'2x16x16' if mp else '16x16'}"] = _dry_run_cell(
            arch, shape, mp, layers)
    by_cell = {name: rec["launches_by_shape"] for name, rec in cells.items()}
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")  # > 50 MB L2
    rows = time_dry_run_kernels(torch, flush, by_cell)
    del flush
    out = {"phase_s": time.perf_counter() - t0, "by_cell": by_cell, "kernel_rows": rows,
           "cells": {name: {
               "layers": rec["layers"], "card_run_s": rec["run_s"],
               "meta_run_s": rec["meta"]["run_s"], "subprocess_s": rec["subprocess_s"],
               "card_peak_GiB": rec["memory"]["peak_GiB"],
               "meta_peak_GiB": rec["meta"]["memory"]["peak_GiB"],
               "peak_rel_diff": rec["peak_rel_diff"], "args_GiB": rec["memory"]["args_GiB"],
               "flops": rec["cost"]["flops"], "bytes": rec["cost"]["bytes_accessed"],
               "collectives": rec["collectives"]["counts"],
               "collective_traffic": rec["collectives"]["traffic_bytes"],
               "kernels": rec["kernels"]} for name, rec in cells.items()}}
    log(f"dry run phase: {out['phase_s']:.1f}s")
    return out


# phase 17 (slice 19): every strategy of the temporal round on the (1, 1) NCCL
# mesh, yi-34b at published width (MESH_TRAIN's 4 of 60 layers, bf16), each
# round bitwise its meshless twin; B1 at the int8 round's (1, N) and,
# kernel-level, at the packed shards of rank 0 of yi-34b train_4k on 16x16
MESH_STRATEGIES = {  # label: the FLConfig fields over one FedAvg local step
    "int8": {"strategy": "compressed", "compression": "int8"},
    "dp_fedavg": {"strategy": "dp_fedavg", "dp_clip": 1e-3, "dp_noise": 1.0},
    "fedprox": {"strategy": "fedprox", "prox_mu": 0.1, "local_epochs": 2},
    "majority_digest": {"n_workers": 3, "byzantine_workers": 1},
    "median": {"n_workers": 3, "byzantine_workers": 1, "consensus": "median"},
}
MESH_RANK_B1 = {"arch": "yi-34b", "sizes": {"data": 16, "model": 16}, "seed": 170}


def rank_packed_n(cfg, sizes) -> int:
    """The packed int8 length of one rank's shards of ``cfg``'s params on a
    mesh of axis ``sizes`` (``steps.param_structs``' global shapes and fsdp
    specs: each sharded dim divided by its axes' size; every leaf padded to
    whole 256-value blocks), from the shapes alone."""
    from repro_torch.core.packing import QBLOCK
    from repro_torch.launch.steps import param_structs

    def share(e):
        names = () if e is None else (e if isinstance(e, tuple) else (e,))
        return math.prod(sizes[a] for a in names)
    n = 0
    for sp in param_structs(cfg, sizes, "fsdp").values():
        local = math.prod(d // share(e) for d, e in zip(sp.shape, sp.spec))
        n += local + (-local) % QBLOCK
    return n


def mesh_strategies_checks(torch, kernels, mesh, dev) -> dict:
    """Phase 17's rounds, run in phase 15's world-1 rank (``mesh_temporal_rank``,
    on its (1, 1) ``("data", "model")`` NCCL mesh, after the process's first
    uses of the card are paid): ``make_train_step``'s temporal round of
    yi-34b at published width (MESH_TRAIN) under each of MESH_STRATEGIES,
    its loss and new params bitwise the meshless ``build_temporal_round``'s
    (at world 1 the rank holds every leaf whole: its int8 row is the
    meshless row, its DP noise and poison the meshless draws, its digest
    the meshless digest); B1 counted once an int8 round, B2 and B3 as in
    phase 15 (a local step's forward and recompute), each run's counts
    zeroed just before it, read just after. Returns {label: record} and
    ``rounds_s`` (raises on a failed check)."""
    T = MESH_TRAIN
    t0 = time.perf_counter()

    def want(label, steps):
        return lambda cfg: dict(train_launches({"norms_per_layer": 2}, cfg.n_layers, steps),
                                quant_aggregate=int(label == "int8"))
    out = {label: _mesh_train_check(
        torch, kernels, mesh, dev, T["arch"], T["n_layers"], T["batch"], T["seq"], T["seed"],
        want(label, fields.get("local_epochs", 1)), f"yi-34b {label}", fl=fields, warm=False)
        for label, fields in MESH_STRATEGIES.items()}
    out["rounds_s"] = time.perf_counter() - t0
    return out


def phase_mesh_strategies(torch, qa, rounds):
    """Slice 19: every strategy of the temporal round on the card. The
    rounds (``rounds``: ``mesh_strategies_checks``' results, run in phase
    15's world-1 NCCL rank) drove int8 sends, DP-FedAvg with noise, FedProx
    of two local steps and the consensus (majority digest and median, W = 3
    with one byzantine worker) through ``make_train_step``, each bitwise its
    meshless twin; here B1 at the int8 round's (1, N) and, kernel-level, at
    rank 0's packed shards of yi-34b train_4k on 16x16, bitwise its plain
    version and timed beside its bound. Returns the phase's summary."""
    from repro_torch.configs.base import get_config
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    by_run = {label: {fn: c for fn, c in rounds[label]["by_shape_raw"].items() if c}
              for label in MESH_STRATEGIES}
    [(S, C, N, qblock)] = by_run["int8"]["quant_aggregate"]
    R = MESH_RANK_B1
    n_loc = rank_packed_n(get_config(R["arch"]), R["sizes"])
    rows = {"round": time_b1_sliced(torch, qa, C, N, R["seed"], "mesh strategies int8 round"),
            "rank": time_b1_sliced(torch, qa, 1, n_loc, R["seed"] + 1,
                                   "mesh strategies train_4k rank")}
    out = {"phase_s": time.perf_counter() - t0, "rounds_s": rounds["rounds_s"],
           "by_run": by_run, "b1_rows": rows,
           "runs": {label: {k: v for k, v in rounds[label].items() if k != "by_shape_raw"}
                    for label in MESH_STRATEGIES}}
    log(f"mesh strategies phase: {out['phase_s']:.1f}s (and the rounds {out['rounds_s']:.1f}s "
        "in phase 15's rank)")
    return out


def mesh_strategies_entries(ms, mesh_temporal, sources, flash_src) -> list:
    """The ``kernels`` entries of phase 17: B1 at the int8 round's (1, N)
    (its launches the round's count) and at a production rank's (1, N_loc)
    (kernel-level); B2 and B3 with the five rounds' launches at phase 15's
    rows of the same shapes (the same step, its kernels timed there)."""
    entries = []
    for tag, launches, where in (
            ("round", ms["by_run"]["int8"]["quant_aggregate"],
             "yi-34b's temporal round with int8 sends on a (1, 1) NCCL mesh"),
            ("rank", {}, "kernel-level only: rank 0's packed shards of yi-34b train_4k on "
                         "16x16 (fsdp specs)")):
        r = ms["b1_rows"][tag]
        entries.append({
            "name": f"quant_aggregate_mesh_strategies_{tag}", "route": "cuda",
            "source": "src/repro_torch/csrc/quant_aggregate.cu",
            "replaces": "src/repro/kernels/quant_aggregate.py:22",
            "launches": sum(launches.values()), "launches_path": where,
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "call_ms": r["kernel_call_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None, "bitwise": True,
            "shape": [r["C"], r["N"], r["qblock"]]})
    counts: dict = {}
    for run in ms["by_run"].values():
        for fn in ("rmsnorm", "flash_attention"):
            for key, n in run.get(fn, {}).items():
                counts[(fn, key)] = counts.get((fn, key), 0) + n
    for (fn, key), launches in sorted(counts.items()):
        r = mesh_temporal["kernel_rows"].get((fn, shape_name(key)))
        if r is None:
            raise AssertionError(f"phase 17 launched {fn} at {shape_name(key)}, which phase "
                                 "15 did not time")
        flash = fn == "flash_attention"
        source, replaces = ((("src/repro_torch/csrc/flash_attention_wgmma.cu"
                              if r["kernel"] == "wgmma" else
                              "src/repro_torch/csrc/flash_attention.cu"), flash_src)
                            if flash else sources[fn])
        entries.append({
            "name": f"{fn}_{r['kernel'] + '_' if flash else ''}mesh_strategies_"
                    f"{shape_name(key).replace(' ', '_')}",
            "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
            "launches_path": "yi-34b's temporal round on a (1, 1) NCCL mesh under "
                             f"{', '.join(MESH_STRATEGIES)} (timed in phase 15)",
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "bitwise": False, "shape": r["shape"]})
    return entries


def attention_layers(cfg) -> int:
    """B3 launches of one prefill: every attention layer (the encoder's and
    the decoder's self and cross attention for encdec, one a period for
    hybrid, none for ssm)."""
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_layers
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid.period
    if cfg.family == "ssm":
        return 0
    return cfg.n_layers


def main() -> int:
    """Run every phase; 0 only when all of them pass."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=pathlib.Path, default=None,
                    help="sources of an earlier version: whichever of its rmsnorm, "
                         "quant_aggregate and flash_attention the directory holds are "
                         "timed beside this tree's")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from repro_torch.configs.base import get_config
    from repro_torch.core.jobs import load_job
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quant_aggregate as qa
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.runtime.device import resolve_device
    from repro_torch.runtime.executor import Executor

    # 1. device
    resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(f"device: {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    log(f"tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32} "
        f"cudnn.deterministic={torch.backends.cudnn.deterministic}")

    # 2. build
    t0 = time.perf_counter()

    def timed_build(name):   # one source's nvcc, timed from the common start
        path = build.build([name])[name]
        return path, time.perf_counter() - t0
    sources = build.sources()
    with ThreadPoolExecutor(len(sources) + 1) as pool:   # every nvcc started together
        extra_build = pool.submit(build_extras, build, args.baseline)
        builds = {name: pool.submit(timed_build, name) for name in sources}
        libs = {name: f.result()[0] for name, f in builds.items()}
        nvcc_s = {name: round(f.result()[1], 1) for name, f in builds.items()}
        extra_libs = extra_build.result()
    log(f"build: {sorted(libs)} + {sorted(extra_libs)} in {time.perf_counter() - t0:.1f}s; "
        f"nvcc seconds by source (all started together): {json.dumps(nvcc_s)}")
    extras = bind_extras(torch, extra_libs)
    for name, path in sorted({**libs, **extra_libs}.items()):
        for line in build.ptxas(path).splitlines():
            if "entry function" in line:
                log(f"ptxas {name}: {line.split('entry function')[1].strip()[:110]}")
            if ("registers" in line and "Used" in line) or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    sass = subprocess.run([shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump",
                           "-sass", str(libs["flash_attention_wgmma"])],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    hgmma = sum("HGMMA" in line for line in sass.splitlines())
    log(f"cuobjdump flash_attention_wgmma: {hgmma} HGMMA (wgmma) instructions")
    if hgmma == 0:
        raise AssertionError("the tensor-core flash kernel holds no wgmma instruction")
    sass = subprocess.run([shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump",
                           "-sass", str(libs["flash_attention"])],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    hmma_tf32 = sum("HMMA" in line and "TF32" in line for line in sass.splitlines())
    log(f"cuobjdump flash_attention: {hmma_tf32} TF32 HMMA (mma.sync) instructions")
    if hmma_tf32 == 0:
        raise AssertionError("the tf32x3 flash kernel holds no TF32 mma.sync instruction")
    sass = subprocess.run([shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump",
                           "-sass", str(libs[fa.BWD_SOURCE])],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    hgmma = sum("HGMMA" in line for line in sass.splitlines())
    log(f"cuobjdump {fa.BWD_SOURCE}: {hgmma} HGMMA (wgmma) instructions")
    if hgmma == 0:
        raise AssertionError("the flash backward kernel holds no wgmma instruction")

    # 3. kernels vs plain versions
    rows = phase_kernels(torch, qa, extras)
    lm_worst = check_lm_kernels(torch)
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")  # > 50 MB L2
    lm_rows = time_lm_kernels(torch, flush, extras)
    f32_flash_rows = time_f32_flash(torch, flush, extras)
    del flush

    # 4. FL path; counts zeroed just before it, read just after
    qa.quant_aggregate.launches = 0
    job_a, _ = run_job(torch, qa, load_job, Executor, "fedavg", "none", 3)
    job_b, params_b = run_job(torch, qa, load_job, Executor, "compressed", "int8", 3)
    main_launches = qa.quant_aggregate.launches
    if job_a["agg_launches"] != 0:
        raise AssertionError(f"fedavg launched quant_aggregate {job_a['agg_launches']}x")
    if job_b["agg_launches"] != len(job_b["losses"]):
        raise AssertionError(f"int8 job: {job_b['agg_launches']} launches for "
                             f"{len(job_b['losses'])} rounds")
    card_cpu = phase_card_vs_cpu(torch)

    # 5. determinism: 1+1+1+1+1+1 == 3+3, bitwise
    job_c, params_c = run_job(torch, qa, load_job, Executor, "compressed", "int8", 1)
    if job_c["losses"] != job_b["losses"] or not all(
            torch.equal(params_b[k], params_c[k]) for k in params_b):
        raise AssertionError(f"chunked != unchunked: {job_b['losses']} vs "
                             f"{job_c['losses']}")
    log("determinism: rounds_per_launch 1 == 3, bitwise (losses and params)")
    phase_profile(torch, load_job, Executor)

    # 6. slice 5: B1 at its new shapes, the hash card vs CPU, then every
    # strategy, topology, placement and async server; B1's counts zeroed just
    # before each counted path, read just after
    b1_rows, b1_floor = phase_b1_slice5(torch, qa, extras)
    check_hash(torch)
    t0 = time.perf_counter()
    slice5 = phase_slice5(torch, qa, load_job, Executor)
    slice5_s = time.perf_counter() - t0
    log(f"slice 5 phase: {slice5_s:.1f}s")

    # 7. control plane (slice 6): consensus, the ledger, the comms plane; B1's
    # counts zeroed just before each counted path, read just after
    t0 = time.perf_counter()
    f32_differ = check_control_plane_bits(torch)
    control = phase_control_plane(torch, qa, load_job, Executor)
    control_s = time.perf_counter() - t0
    log(f"control plane phase: {control_s:.1f}s")

    # 8. campaigns, the flight recorder and the probes (slice 7): B1 over
    # lanes, then the paths; B1's counts zeroed just before each counted
    # path, read just after
    t0 = time.perf_counter()
    lane_row = phase_b1_lanes(torch, qa)
    campaigns = phase_campaigns(torch, qa, load_job, Executor)
    telemetry = phase_telemetry(torch, qa, load_job, Executor)
    slice7_s = time.perf_counter() - t0
    log(f"slice 7 phase: {slice7_s:.1f}s")

    # 9. the streaming client plane (slice 8): B1 at its shapes, then the
    # paths; B1's counts zeroed just before each counted path, read just after
    t0 = time.perf_counter()
    ragged_rows = phase_b1_ragged(torch, qa)
    streaming = phase_streaming(torch, qa, load_job, Executor)
    slice8_s = time.perf_counter() - t0
    log(f"slice 8 phase: {slice8_s:.1f}s")

    # 10. the LM training path (slice 9): B2 and B3 under autograd and
    # torch.func, qwen2.5-32b trained at full width, card vs CPU, the new
    # archs served; counts zeroed just before each counted path, read just after
    kernels = {"quant_aggregate": qa.quant_aggregate, "rmsnorm": rms.rmsnorm,
               "flash_attention": fa.flash_attention_fwd,
               "decode_attention": da.decode_attention_fwd}
    t0 = time.perf_counter()
    train_worst = check_train_kernels(torch)
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")  # > 50 MB L2
    train_rows = time_train_kernels(torch, flush)
    b3_bwd_rows = time_b3_bwd(torch, flush)
    del flush
    train = phase_train_lm(torch, kernels)
    train_cpu = phase_train_card_vs_cpu(torch)
    serve_new = phase_serve_new_archs(torch, kernels)
    slice9_s = time.perf_counter() - t0
    log(f"slice 9 phase: {slice9_s:.1f}s")

    # 11. MLA with tied embeddings and MoE (slice 10): B3 at MLA's shapes,
    # minicpm3-4b served at full width and depth, minicpm3-4b and
    # qwen3-moe-30b-a3b trained, qwen3-moe-30b-a3b served, reduced card vs
    # CPU; counts zeroed just before each counted path, read just after
    t0 = time.perf_counter()
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")  # > 50 MB L2
    mla_rows = time_mla_kernels(torch, flush, extras)
    norm_decode_rows = time_slice10_norms_decode(torch, flush)
    del flush
    serve_mla = phase_serve_slice10(torch, kernels, SERVE_MLA)
    train_moe = phase_train_lm(torch, kernels, TRAIN_MOE)
    serve_moe = phase_serve_slice10(torch, kernels, SERVE_MOE)
    train_cpu10 = phase_train_card_vs_cpu(torch, SLICE10_CARD_CPU)
    serve_cpu10 = {arch: phase_serve_card_vs_cpu(torch, arch) for arch in SLICE10_CARD_CPU}
    slice10_s = time.perf_counter() - t0
    log(f"slice 10 phase: {slice10_s:.1f}s")

    # 12. the last three LM families (slice 12): C7's normal halves on the
    # card, B2-B4 at the new shapes, whisper-base and xlstm-125m at full
    # width and depth, jamba's sublayers at full width, reduced card vs CPU;
    # counts zeroed just before each counted path, read just after
    t0 = time.perf_counter()
    c7 = check_normal_halves(torch)
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")  # > 50 MB L2
    slice12_rows = time_slice12_kernels(torch, flush)
    del flush
    whisper = phase_whisper(torch, kernels)
    xlstm = phase_xlstm(torch, kernels)
    jamba = phase_jamba_sublayers(torch, kernels)
    serve_cpu12 = {arch: phase_serve_card_vs_cpu(torch, arch) for arch in SLICE12_CARD_CPU}
    slice12_s = time.perf_counter() - t0
    log(f"slice 12 phase: {slice12_s:.1f}s")

    # 13. the rematerialized LM training step and int8 LM sends (slice 13):
    # B1 at the int8 LM round's (2, N > 2**31) bitwise over column slices, the
    # MoE forward's repeat, B2 at minicpm3-4b's train rows, minicpm3-4b at 32
    # of its 62 layers trained plain and with int8 sends, then at 8 layers
    # twice, bitwise (the cut depth); counts zeroed just before each counted
    # path, read just after
    t0 = time.perf_counter()
    b1_lm = time_b1_sliced(torch, qa, B1_LM["C"], packed_n(get_config(
        TRAIN_FULL["arch"]).replace(n_layers=TRAIN_FULL["n_layers"])), B1_LM["seed"], "lm_int8")
    moe_repeat = check_moe_repeat(torch)
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")  # > 50 MB L2
    mla_train_norms = time_train_norms_mla(torch, flush)
    del flush
    full = phase_train_full_depth(torch, kernels)
    train_mla = phase_train_lm(torch, kernels, TRAIN_MLA)
    slice13_s = time.perf_counter() - t0
    log(f"slice 13 phase: {slice13_s:.1f}s")

    # 14. the mesh runtime (slice 14): a world-1 NCCL rank's mesh rounds and
    # spatial LM steps against their meshless twins, two lane ranks sharing
    # the card for a lane-sharded int8 sweep; counts zeroed just before each
    # counted path, read just after (in the ranks)
    mesh = phase_mesh(torch, qa, load_job, campaigns["sweep"])

    # 15. the temporal placement on a mesh (slice 15): a world-1 NCCL rank's
    # temporal train step and prefill and decode steps of yi-34b at published
    # width against their meshless twins, bitwise; counts zeroed just before
    # each mesh run, read just after (in the rank)
    mesh_temporal = phase_mesh_temporal(torch)

    # 15b. MLA and the MoE FFN's expert parallelism on a mesh (slice 16): the
    # world-1 NCCL rank's temporal train, prefill and decode steps of
    # minicpm3-4b and qwen3-moe-30b-a3b at published width against their
    # meshless twins, bitwise, and a jamba-width MoE layer through the grid
    # ring; counts zeroed just before each mesh run, read just after (in the
    # rank)
    mesh_mla_moe = phase_mesh_mla_moe(torch)

    # 15c. the hybrid, ssm and encdec families on a mesh (slice 17): the
    # world-1 NCCL rank's prefill and decode steps of whisper-base and
    # xlstm-125m at full depth and jamba's period parts at published width
    # (a Mamba mixer's sequence-sharded prefill and tp decode, the attention
    # sublayer's mesh prefill and decode) against their meshless twins,
    # bitwise; counts zeroed just before each mesh run, read just after (in
    # the rank)
    mesh_hybrid_encdec = phase_mesh_hybrid_encdec(torch)

    # 16. the dry run of production-mesh cells (slice 18): rank 0 of each
    # cell's mesh on the meta device and on the card, in a subprocess a cell;
    # the card's counts zeroed just before its timed run, read just after (in
    # the subprocess)
    dry_run = phase_dry_run(torch)

    # 17. every strategy of the temporal round on a mesh (slice 19): phase
    # 15's world-1 NCCL rank ran the int8, DP, FedProx and consensus rounds of
    # yi-34b at published width against their meshless twins, bitwise, counts
    # zeroed just before each mesh run, read just after; here B1 at their
    # shapes
    mesh_strategies = phase_mesh_strategies(torch, qa, mesh_temporal.pop("strategies"))

    # 18. serve path; counts zeroed just before it, read just after
    serve = phase_serve(torch, kernels)
    serve_cpu = phase_serve_card_vs_cpu(torch)

    # 19. summary
    main = rows[0]
    entries = [{
        "name": "quant_aggregate", "route": "cuda",
        "source": "src/repro_torch/csrc/quant_aggregate.cu",
        "replaces": "src/repro/kernels/quant_aggregate.py:22",
        "launches": main_launches, "max_abs_err": main["max_abs_err"],
        "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
        "call_ms": main["kernel_call_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None, "bitwise": True,
        "shape": [main["C"], main["N"], main["qblock"]],
        "launches_by_path": {"sync_int8": main_launches, **slice5["b1_launches_by_path"],
                             **control["b1_launches_by_path"],
                             **streaming["b1_launches_by_path"]},
        "slice5_shapes": {name: {k: r[k] for k in ("C", "kernel_ms", "kernel_call_ms",
                                                   "plain_ms", "bound_ms", "bound_by")}
                          for name, r in b1_rows.items()},
        "launch_floor_ms": b1_floor["after_flush_ms"]}]
    if "baseline_ms" in main:
        entries[0]["baseline_ms"] = main["baseline_ms"]
    # the lane launch: every lane of an int8 campaign round in one launch
    entries.append({
        "name": "quant_aggregate_lanes", "route": "cuda",
        "source": "src/repro_torch/csrc/quant_aggregate.cu",
        "replaces": "src/repro/kernels/quant_aggregate.py:22",
        "launches": campaigns["b1_launches_by_path"]["campaign_int8"],
        "max_abs_err": lane_row["max_abs_err"], "ms": lane_row["kernel_ms"],
        "plain_ms": lane_row["plain_ms"], "call_ms": lane_row["kernel_call_ms"],
        "bound_ms": lane_row["bound_ms"], "bound_by": lane_row["bound_by"],
        "library_ms": None, "bitwise": True,
        "four_single_launches_ms": lane_row["four_single_launches_ms"],
        "shape": [lane_row["S"], lane_row["C"], lane_row["N"], lane_row["qblock"]]})
    # the ragged plane's launches: C = max_cohort slots, pads at weight 0
    for name, path in (("ragged_c25", "ragged_int8_c25"),
                       ("ragged_c128", "population_c128"),
                       ("ragged_lanes", "ragged_campaign_lanes")):
        r = ragged_rows[name]
        entries.append({
            "name": f"quant_aggregate_{name}", "route": "cuda",
            "source": "src/repro_torch/csrc/quant_aggregate.cu",
            "replaces": "src/repro/kernels/quant_aggregate.py:22",
            "launches": streaming["b1_launches_by_path"][path],
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "call_ms": r["kernel_call_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "bitwise": True, "shape": [r["S"], r["C"], r["N"], r["qblock"]]})
    flash_src = "src/repro/kernels/flash_attention.py:30"
    for name, key, source, replaces, launches, worst in (
            # one TPU kernel, two launch layouts: a narrow CTA per row for
            # prefill's rows, a wide one for decode's
            ("rmsnorm_prefill", "rmsnorm_prefill", "src/repro_torch/csrc/rmsnorm.cu",
             "src/repro/kernels/rmsnorm.py:11", serve["rmsnorm_by_layout"]["row"],
             lm_worst["rmsnorm"]),
            ("rmsnorm_decode", "rmsnorm_decode", "src/repro_torch/csrc/rmsnorm.cu",
             "src/repro/kernels/rmsnorm.py:11", serve["rmsnorm_by_layout"]["wide_row"],
             lm_worst["rmsnorm"]),
            ("flash_attention_wgmma", "flash_attention",
             "src/repro_torch/csrc/flash_attention_wgmma.cu", flash_src,
             serve["flash_by_kernel"]["wgmma"], lm_worst["flash_attention_wgmma"]),
            ("decode_attention", "decode_attention",
             "src/repro_torch/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention.py:29", serve["launches"]["decode_attention"],
             lm_worst["decode_attention"])):
        r = lm_rows[key]
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": r["max_abs_err"],
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"], "call_ms": r["kernel_call_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "bitwise": False,
            "worst_max_abs_err_test_shapes": worst, "shape": r["shape"]})
        if "baseline_ms" in r:
            entries[-1]["baseline_ms"] = r["baseline_ms"]
    # slice 11: B3 in f32 on the tf32x3 kernel. Each path entry is timed at
    # the shape its launches have, counted by shape in the f32 card-vs-CPU
    # serve and train runs; yi-34b's serve shape and MLA's absorbed dims in
    # f32 are kernel-level only
    f32_runs = (serve_cpu, *serve_cpu10.values(), *serve_cpu12.values(),
                *train_cpu.values(), *train_cpu10.values())
    f32_by_shape = {}
    for r in f32_runs:
        for k, n in r["flash_by_shape"].items():
            f32_by_shape[k] = f32_by_shape.get(k, 0) + n
    unlisted = set(f32_by_shape) - {shape_name(v) for v in F32_FLASH.values()}
    if unlisted:
        raise AssertionError(f"tf32x3 launched on the f32 paths at shapes F32_FLASH lacks: "
                             f"{sorted(unlisted)}")
    for name, key, path in (
            ("flash_attention_tf32x3_reduced", "reduced",
             "reduced yi-34b, qwen3-moe-30b-a3b, arctic-480b, jamba-1.5-large-398b served "
             "and reduced qwen2.5-32b, chameleon-34b, qwen3-moe-30b-a3b, arctic-480b "
             "trained in f32 on the card (card vs CPU)"),
            ("flash_attention_tf32x3_mla_reduced", "mla_reduced",
             "reduced minicpm3-4b (absorbed MLA) served and trained in f32 on the card "
             "(card vs CPU)"),
            ("flash_attention_tf32x3_whisper_encoder_reduced", "whisper_encoder_reduced",
             "reduced whisper-base served in f32 on the card: the encoder's self-attention "
             "(full)"),
            ("flash_attention_tf32x3_whisper_cross_reduced", "whisper_cross_reduced",
             "reduced whisper-base served in f32 on the card: the cross-attention (full, "
             "Sq != Sk)"),
            ("flash_attention_tf32x3_whisper_decoder_reduced", "whisper_decoder_reduced",
             "reduced whisper-base served in f32 on the card: the decoder's self-attention"),
            ("flash_attention_tf32x3_f32_serve_shape", "serve",
             "kernel-level only: no path launches f32 at yi-34b's width"),
            ("flash_attention_tf32x3_f32_mla_absorbed", "mla_absorbed",
             "kernel-level only: no path launches f32 at minicpm3-4b's width")):
        launches = f32_by_shape.get(shape_name(F32_FLASH[key]), 0)
        if (launches == 0) != path.startswith("kernel-level only"):
            raise AssertionError(f"{name}: {launches} launches on the f32 paths ({path})")
        r = f32_flash_rows[key]
        entries.append({
            "name": name, "route": "cuda", "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": flash_src, "launches": launches, "launches_path": path,
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "call_ms": r["kernel_call_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "bound_f32_cores_ms": r["bound_f32_cores_ms"],
            "library_ms": r["library_ms"], "library_backend": r["library_backend"],
            "baseline_ms": r.get("baseline_ms"), "bitwise": False, "shape": r["shape"],
            "dtype": "float32",
            "worst_max_abs_err_test_shapes": max(lm_worst["flash_attention_tf32x3_f32"],
                                                 lm_worst["flash_attention_tf32x3_bf16"])})
    # slice 9: B3 forward at the training shape under autograd (the ported
    # backward's times beside it), B2 at the train stack's and qk-norm rows
    fl_row = train_rows["flash_train"]
    entries.append({
        "name": "flash_attention_wgmma_train", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_wgmma.cu", "replaces": flash_src,
        "launches": train["flash_by_kernel"]["wgmma"], "max_abs_err": fl_row["max_abs_err"],
        "ms": fl_row["kernel_ms"], "plain_ms": fl_row["plain_ms"],
        "bound_ms": fl_row["bound_ms"], "bound_by": fl_row["bound_by"],
        "library_ms": fl_row["library_ms"], "bitwise": False, "shape": fl_row["shape"],
        "worst_grad_err_checks": train_worst["flash_grads"],
        **{k: fl_row[k] for k in ("bwd_ms", "bwd_bound_ms", "bwd_bound_by", "fwd_bwd_ms",
                                  "fwd_bwd_bound_ms", "library_fwd_bwd_ms")}})
    # B3's backward kernel: its launches in the counted qwen2.5-32b train
    # run (at the train shape), timed kernel-level there and at yi-34b's int8
    # round's shape, which no path here launches
    for tag, path in (("train", f"{train['arch']} train at {train['n_layers']} layers, "
                                f"{TRAIN['rounds']} rounds"),
                      ("yi34b_round", "kernel-level only: yi-34b's int8 FL round (the "
                                      "benchmark's yi34b_l4_int8) at 2 x 4096")):
        r = b3_bwd_rows[tag]
        launches = train["flash_bwd_by_shape"].get(
            shape_name(tuple(r["shape"]) + (True,)), 0)
        if (launches == 0) != path.startswith("kernel-level only") or \
                (tag == "train" and launches != train["flash_bwd_by_kernel"]["wgmma"]):
            raise AssertionError(f"flash_attention_bwd {tag}: {launches} launches at "
                                 f"{r['shape']} of {train['flash_bwd_by_shape']} ({path})")
        entries.append({
            "name": f"flash_attention_bwd_wgmma_{tag}", "route": "cuda",
            "source": f"src/repro_torch/csrc/{fa.BWD_SOURCE}.cu",
            "replaces": "src/repro/kernels/ops.py:108", "launches": launches,
            "launches_path": path, "max_abs_err": max(r["max_abs_err_vs_plain"].values()),
            "ms": r["kernel_ms"], "call_ms": r["kernel_call_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_fwd_bwd_ms"], "bitwise": True, "shape": r["shape"],
            "causal": True})
    for name, key, launches in (
            ("rmsnorm_train", "rmsnorm_train", train["launches"]["rmsnorm"]),
            # the qk-norm launches of the counted chameleon-34b serve run
            ("rmsnorm_qk_norm", "rmsnorm_qk_norm",
             serve_new["chameleon-34b"]["qk_norm_launches"])):
        r = train_rows[key]
        entries.append({
            "name": name, "route": "cuda", "source": "src/repro_torch/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm.py:11", "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "bitwise": False, "shape": r["shape"],
            "layout": r["plan"]["layout"], "worst_grad_err_checks": train_worst["rms_grads"],
            **{k: r[k] for k in ("bwd_ms", "bwd_bound_ms", "bwd_bound_by", "fwd_bwd_ms",
                                 "library_fwd_bwd_ms")}})
    # slice 10: B3 at MLA's shapes, launches from the counted paths
    for name, key, launches, path in (
            ("flash_attention_wgmma_mla_serve", "mla_serve",
             serve_mla["flash_by_kernel"]["wgmma"],
             f"minicpm3-4b serve, {SERVE_MLA['n_layers']} layers"),
            ("flash_attention_wgmma_mla_train", "mla_train",
             sum(full[t]["flash_by_kernel"]["wgmma"] for t in ("plain", "int8")),
             f"minicpm3-4b train at {TRAIN_FULL['n_layers']} of 62 layers, 3 rounds plain and 3 "
             "with int8 sends (a layer's forward and its recompute)"),
            ("flash_attention_wgmma_mla_expanded", "mla_expanded",
             serve_mla["expanded_flash_by_kernel"]["wgmma"],
             "minicpm3-4b layer 0, mla_seqsharded(absorbed=False)")):
        r = mla_rows[key]
        source = ("src/repro_torch/csrc/flash_attention_wgmma.cu" if r["kernel"] == "wgmma"
                  else "src/repro_torch/csrc/flash_attention.cu")
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": flash_src,
            "launches": launches, "launches_path": path, "max_abs_err": r["max_abs_err"],
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "library_backend": r["library_backend"], "bitwise": False, "shape": r["shape"],
            **{k: r[k] for k in ("bwd_ms", "bwd_bound_ms", "bwd_bound_by", "fwd_bwd_ms",
                                 "fwd_bwd_bound_ms", "library_fwd_bwd_ms", "baseline_ms")
               if k in r}})
    # slice 10: B2 at each row width and B4 at qwen3-moe's decode layer,
    # launches from the counted serve paths (B2 by width, prefill and decode)
    for name, key, launches, path in (
            ("rmsnorm_mla_ln", "rmsnorm_mla_ln", serve_mla["rmsnorm_by_width"][2560],
             f"minicpm3-4b serve, {SERVE_MLA['n_layers']} layers: ln1, ln2, final norm"),
            ("rmsnorm_mla_q_norm", "rmsnorm_mla_q_norm", serve_mla["rmsnorm_by_width"][768],
             f"minicpm3-4b serve, {SERVE_MLA['n_layers']} layers: q_norm"),
            ("rmsnorm_mla_kv_norm", "rmsnorm_mla_kv_norm",
             serve_mla["rmsnorm_by_width"][256],
             f"minicpm3-4b serve, {SERVE_MLA['n_layers']} layers: kv_norm"),
            ("rmsnorm_moe_ln", "rmsnorm_moe_ln", serve_moe["rmsnorm_by_width"][2048],
             "qwen3-moe-30b-a3b serve, 4 layers: ln1, ln2, final norm"),
            ("rmsnorm_moe_qk_norm", "rmsnorm_moe_qk_norm", serve_moe["rmsnorm_by_width"][128],
             "qwen3-moe-30b-a3b serve, 4 layers: q_norm, k_norm"),
            ("decode_attention_moe", "decode_attention_moe",
             serve_moe["launches"]["decode_attention"], "qwen3-moe-30b-a3b serve, 4 layers")):
        r = norm_decode_rows[key]
        rms_row = key.startswith("rmsnorm")
        entries.append({
            "name": name, "route": "cuda",
            "source": ("src/repro_torch/csrc/rmsnorm.cu" if rms_row
                       else "src/repro_torch/csrc/decode_attention.cu"),
            "replaces": ("src/repro/kernels/rmsnorm.py:11" if rms_row
                         else "src/repro/kernels/decode_attention.py:29"),
            "launches": launches, "launches_path": path, "max_abs_err": r["max_abs_err"],
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "bitwise": False,
            "shape": r["shape"]})
    # slice 12: B3, B4 and B2 at the last three families' shapes, launches
    # from the counted whisper-base and xlstm-125m serve runs and jamba's
    # sublayer runs
    def s12_launches(key):
        """A slice-12 row's launches: its shape's count in the counted run of
        the path that launches it."""
        kind, name = key.split("_", 1)
        if kind == "flash":
            B, Sq, Sk, H, KV, D, causal = SLICE12_FLASH[name]
            shape, fn = (B, Sq, Sk, H, KV, D, D, causal), "flash_attention"
        elif kind == "decode":
            shape, fn = (*SLICE12_DECODE[name], SLICE12_DECODE[name][-1]), "decode_attention"
        else:
            lead, D = SLICE12_RMS[name]
            shape, fn = (math.prod(lead), D), "rmsnorm"
        runs = {"whisper": [whisper], "jamba": [jamba["attention"], jamba["mamba"]],
                "xlstm": [xlstm["train"] if name.endswith("train") else xlstm]}
        return sum(r["by_shape"][fn].get(shape_name(shape), 0)
                   for r in runs[name.split("_")[0]])
    for name, key, path in (
            ("flash_attention_wgmma_whisper_encoder", "flash_whisper_encoder",
             "whisper-base serve: the encoder's self-attention (full)"),
            ("flash_attention_wgmma_whisper_cross", "flash_whisper_cross",
             "whisper-base serve: the decoder's cross-attention (full, Sq != Sk)"),
            ("flash_attention_wgmma_whisper_decoder", "flash_whisper_decoder",
             "whisper-base serve: the decoder's self-attention"),
            ("flash_attention_wgmma_jamba", "flash_jamba",
             "jamba-1.5-large-398b attention sublayer at full width, prefill"),
            ("decode_attention_whisper_self", "decode_whisper_self",
             "whisper-base serve: the decoder's self cache, 64 steps"),
            ("decode_attention_whisper_cross", "decode_whisper_cross",
             "whisper-base serve: cross-attention over the encoder cache (combine=False)"),
            ("decode_attention_jamba", "decode_jamba",
             "jamba-1.5-large-398b attention sublayer at full width, one decode step"),
            ("rmsnorm_xlstm_prefill", "rmsnorm_xlstm_prefill",
             "xlstm-125m serve: the prefill's norms"),
            ("rmsnorm_xlstm_decode", "rmsnorm_xlstm_decode",
             "xlstm-125m serve: 64 decode steps' norms"),
            ("rmsnorm_xlstm_train", "rmsnorm_xlstm_train",
             "xlstm-125m: one temporal train_fl_lm round's forward norms"),
            ("rmsnorm_jamba_prefill", "rmsnorm_jamba_prefill",
             "jamba-1.5-large-398b attention and Mamba sublayers at full width, prefill"),
            ("rmsnorm_jamba_decode", "rmsnorm_jamba_decode",
             "jamba-1.5-large-398b attention and Mamba sublayers, one decode step")):
        launches = s12_launches(key)
        if not launches:
            raise AssertionError(f"{name}: its shape was launched no time on its path")
        r = slice12_rows[key]
        kind = key.split("_")[0]
        entries.append({
            "name": name, "route": "cuda",
            "source": {"flash": "src/repro_torch/csrc/flash_attention_wgmma.cu",
                       "decode": "src/repro_torch/csrc/decode_attention.cu",
                       "rmsnorm": "src/repro_torch/csrc/rmsnorm.cu"}[kind],
            "replaces": {"flash": flash_src,
                         "decode": "src/repro/kernels/decode_attention.py:29",
                         "rmsnorm": "src/repro/kernels/rmsnorm.py:11"}[kind],
            "launches": launches, "launches_path": path, "max_abs_err": r["max_abs_err"],
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "bitwise": False,
            "shape": r["shape"]})
    # slice 13: B1 at the int8 LM round's N (past 2**31), B2 at minicpm3-4b's
    # train rows; launches from the counted full-depth runs
    entries.append({
        "name": "quant_aggregate_lm_int8", "route": "cuda",
        "source": "src/repro_torch/csrc/quant_aggregate.cu",
        "replaces": "src/repro/kernels/quant_aggregate.py:22",
        "launches": full["int8"]["launches"]["quant_aggregate"],
        "launches_path": f"minicpm3-4b at {TRAIN_FULL['n_layers']} of 62 layers, 3 temporal "
                         "rounds with int8 sends",
        "max_abs_err": b1_lm["max_abs_err"], "ms": b1_lm["kernel_ms"],
        "plain_ms": b1_lm["plain_ms"], "call_ms": b1_lm["kernel_call_ms"],
        "bound_ms": b1_lm["bound_ms"], "bound_by": b1_lm["bound_by"], "library_ms": None,
        "bitwise": True, "shape": [b1_lm["S"], b1_lm["C"], b1_lm["N"], b1_lm["qblock"]]})
    for name, (D, _) in TRAIN_MLA_RMS.items():
        r = mla_train_norms[f"rmsnorm_{name}"]
        key = shape_name((TRAIN_FULL["batch"] * TRAIN_FULL["seq"], D))
        entries.append({
            "name": f"rmsnorm_{name}", "route": "cuda",
            "source": "src/repro_torch/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm.py:11",
            "launches": sum(full[t]["by_shape"]["rmsnorm"].get(key, 0)
                            for t in ("plain", "int8")),
            "launches_path": f"minicpm3-4b train at {TRAIN_FULL['n_layers']} of 62 layers, "
                             "plain and int8 (forward and recompute)",
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "bitwise": False, "shape": r["shape"]})
    # slice 14: B1 at the mesh round (C = 100, a (1, 1) NCCL mesh; timed in
    # phase 3 at this shape) and at a lane rank's block (2, 100, N); B2 and B3
    # at every shape the spatial LM steps launched
    mesh_b1 = sum(mesh["world1"][t]["b1"] for t in ("client_server", "hierarchical"))
    main_key = named({(1, main["C"], main["N"], main["qblock"]): MESH_ROUNDS})
    for t in ("client_server", "hierarchical"):
        if mesh["world1"][t]["b1_by_shape"] != main_key:
            raise AssertionError(f"mesh {t}: B1 by shape {mesh['world1'][t]['b1_by_shape']}, "
                                 f"not phase 3's timed row {main_key}")
    entries.append({
        "name": "quant_aggregate_mesh_round", "route": "cuda",
        "source": "src/repro_torch/csrc/quant_aggregate.cu",
        "replaces": "src/repro/kernels/quant_aggregate.py:22", "launches": mesh_b1,
        "launches_path": f"the int8 FL round bound to a (1, 1) NCCL mesh, client-server "
                         f"and hierarchical, {MESH_ROUNDS} rounds each",
        "max_abs_err": main["max_abs_err"], "ms": main["kernel_ms"],
        "plain_ms": main["plain_ms"], "call_ms": main["kernel_call_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": None,
        "bitwise": True, "shape": [main["C"], main["N"], main["qblock"]]})
    br = mesh["b1_block"]
    entries.append({
        "name": "quant_aggregate_lane_block", "route": "cuda",
        "source": "src/repro_torch/csrc/quant_aggregate.cu",
        "replaces": "src/repro/kernels/quant_aggregate.py:22",
        "launches": mesh["lanes"]["b1_launches"],
        "launches_path": f"the int8 sweep at lane_devices = {MESH_LANES}, each rank's "
                         "block, 3 rounds",
        "max_abs_err": br["max_abs_err"], "ms": br["kernel_ms"], "plain_ms": br["plain_ms"],
        "call_ms": br["kernel_call_ms"], "bound_ms": br["bound_ms"],
        "bound_by": br["bound_by"], "library_ms": None, "bitwise": True,
        "shape": [br["S"], br["C"], br["N"], br["qblock"]]})
    for arch, counts in mesh["lm_by_shape"].items():
        for fn, key in ((fn, key) for fn in sorted(counts) for key in sorted(counts[fn])):
            r, launches = mesh["kernel_rows"][(fn, key)], counts[fn][key]
            flash = fn == "flash_attention"
            entries.append({
                "name": f"{fn}_{r['kernel'] + '_' if flash else ''}mesh_step_{arch}_"
                        f"{shape_name(key).replace(' ', '_')}",
                "route": "cuda",
                "source": ("src/repro_torch/csrc/flash_attention_wgmma.cu"
                           if flash and r["kernel"] == "wgmma" else
                           "src/repro_torch/csrc/flash_attention.cu" if flash
                           else "src/repro_torch/csrc/rmsnorm.cu"),
                "replaces": flash_src if flash else "src/repro/kernels/rmsnorm.py:11",
                "launches": launches,
                "launches_path": f"the spatial train step on a (1, 1) NCCL mesh: {arch} at "
                                 "published width, "
                                 + (f"{MESH_LM[arch][2]} layers" if MESH_LM[arch][2]
                                    else "full depth") + " (forward and recompute)",
                "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"], "bitwise": False, "shape": r["shape"]})
    # slice 15: B2, B3 and B4 at every shape the temporal mesh runs launched
    # (a world-1 NCCL rank), and kernel-level at one rank's shapes on a
    # 4-rank model axis
    mt = mesh_temporal
    sources = {"rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:11"),
               "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                                    "src/repro/kernels/decode_attention.py:29")}
    paths = {"train": f"the temporal train step on a (1, 1) NCCL mesh: yi-34b at published "
                      f"width, {MESH_TRAIN['n_layers']} layers, one local step of "
                      f"{MESH_TRAIN['batch']} x {MESH_TRAIN['seq']} (forward and recompute)",
             "serve": f"the prefill step and {MESH_SERVE['max_new']} decode steps on a (1, 1) "
                      f"NCCL mesh: yi-34b at published width, {MESH_SERVE['n_layers']} "
                      f"layers, batch {MESH_SERVE['batch']}"}
    rows15 = [(path, fn, shape_name(key), n, paths[path])
              for path, counts in mt["by_path"].items()
              for fn in sorted(counts) for key, n in sorted(counts[fn].items())]
    rows15 += [(None, "flash_attention", f"shard_{tag}", 0,
                f"kernel-level only: rank {tag[-1]} of a 4-rank model axis, its "
                f"{MESH_TRAIN['seq'] // 4} rows of the training sequence at q_offset {off}")
               for tag, off in MESH_SHARD_FLASH.items()]
    rows15.append((None, "decode_attention", "shard", 0,
                   f"kernel-level only: combine=False over one rank's {MESH_SHARD_DECODE['S_loc']}"
                   f"-key cache shard of a 4-rank model axis, row lengths "
                   f"{list(MESH_SHARD_DECODE['lengths'])}"))
    for path, fn, tag, launches, where in rows15:
        r = mt["kernel_rows"][(fn, tag)]
        flash = fn == "flash_attention"
        source, replaces = ((("src/repro_torch/csrc/flash_attention_wgmma.cu"
                              if r["kernel"] == "wgmma" else
                              "src/repro_torch/csrc/flash_attention.cu"), flash_src)
                            if flash else sources[fn])
        entries.append({
            "name": f"{fn}_{r['kernel'] + '_' if flash else ''}mesh_temporal_"
                    f"{path + '_' if path else ''}{tag.replace(' ', '_')}",
            "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
            "launches_path": where, "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "bitwise": False, "shape": r["shape"],
            **{k: r[k] for k in ("q_offset", "lengths") if k in r}})
    # slice 16: B2, B3 and B4 at every shape the world-1 rank's MLA and MoE
    # mesh runs launched, and kernel-level at one rank's shapes on a 4-rank
    # model axis
    mm = mesh_mla_moe
    T16, V16 = MESH_MLA_MOE_TRAIN, MESH_MLA_MOE_SERVE
    paths16 = {}
    for arch, A in MESH_MLA_MOE.items():
        paths16[f"{arch}_train"] = (
            f"the temporal train step on a (1, 1) NCCL mesh: {arch} at published width, "
            f"{A['train_layers']} layers, one local step of {T16['batch']} x {T16['seq']} "
            "(forward and recompute)")
        paths16[f"{arch}_serve"] = (
            f"the prefill step and {V16['max_new']} decode steps on a (1, 1) NCCL mesh: "
            f"{arch} at published width, {A['serve_layers']} layers, batch {V16['batch']}")
    rows16 = [(path, fn, shape_name(key), n, paths16[path])
              for path, counts in mm["by_path"].items()
              for fn in sorted(counts) for key, n in sorted(counts[fn].items())]
    rows16 += [(None, "flash_attention", f"mla_shard_{tag}", 0,
                f"kernel-level only: rank {tag[-1]} of a 4-rank model axis, its "
                f"{V16['prompt_len'] // 4} rows of minicpm3-4b's absorbed MLA prefill "
                f"(288/256) at q_offset {off}")
               for tag, off in MESH_MLA_SHARD_FLASH.items()]
    rows16.append((None, "decode_attention", "moe_shard", 0,
                   f"kernel-level only: qwen3-moe-30b-a3b's heads, combine=False over one "
                   f"rank's {MESH_MOE_SHARD_DECODE['S_loc']}-key cache shard of a 4-rank "
                   f"model axis, row lengths {list(MESH_MOE_SHARD_DECODE['lengths'])}"))
    for path, fn, tag, launches, where in rows16:
        r = mm["kernel_rows"][(fn, tag)]
        flash = fn == "flash_attention"
        source, replaces = ((("src/repro_torch/csrc/flash_attention_wgmma.cu"
                              if r["kernel"] == "wgmma" else
                              "src/repro_torch/csrc/flash_attention.cu"), flash_src)
                            if flash else sources[fn])
        entries.append({
            "name": f"{fn}_{r['kernel'] + '_' if flash else ''}mesh_mla_moe_"
                    f"{path + '_' if path else ''}{tag.replace(' ', '_')}",
            "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
            "launches_path": where, "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "bitwise": False, "shape": r["shape"],
            **{k: r[k] for k in ("q_offset", "lengths") if k in r}})
    # slice 17: B2, B3 and B4 at every shape the world-1 rank's whisper-base,
    # xlstm-125m and jamba mesh runs launched, and kernel-level at one rank's
    # shapes on a 4-rank model axis
    mh = mesh_hybrid_encdec
    paths17 = {f"{arch}_serve": (
        f"the prefill step and {A['max_new']} decode steps on a (1, 1) NCCL mesh: {arch} "
        f"at published width and depth, batch {MESH_SERVE_SPATIAL_BATCH}, "
        + (f"{A['frames']} frames, decoder prompt {A['prompt_len']}" if A["frames"]
           else f"prompt {A['prompt_len']}")) for arch, A in MESH_SERVE_SPATIAL.items()}
    J17 = MESH_JAMBA_PARTS
    paths17.update({f"jamba_{part}": (
        f"{MESH_JAMBA_PARTS['arch']}'s {what} at published width on a (1, 1) NCCL mesh, "
        f"{J17['batch']} x {J17['prompt_len']}, after its RMSNorm")
        for part, what in (("mamba", "Mamba mixer: the sequence-sharded prefill and a "
                                     "tensor-parallel decode step"),
                           ("attention", "attention sublayer: the mesh prefill and a "
                                         "tensor-parallel decode step"))})
    rows17 = [(path, fn, shape_name(key), n, paths17[path])
              for path, counts in mh["by_path"].items()
              for fn in sorted(counts) for key, n in sorted(counts[fn].items())]
    rows17 += [(None, "flash_attention", f"jamba_shard_{tag}", 0,
                f"kernel-level only: rank {tag[-1]} of a 4-rank model axis, its "
                f"{J17['prompt_len'] // 4} rows of jamba's attention prefill at q_offset {off}")
               for tag, off in MESH_JAMBA_SHARD_FLASH.items()]
    rows17.append((None, "flash_attention", "whisper_encoder_shard", 0,
                   f"kernel-level only: one rank's {MESH_WHISPER_SHARD} of whisper-base's "
                   "1500 encoder frames over all of them (full), a 4-rank model axis"))
    rows17.append((None, "decode_attention", "whisper_cross_shard", 0,
                   f"kernel-level only: whisper-base's cross decode, combine=False over one "
                   f"rank's {MESH_WHISPER_SHARD}-key encoder cache shard (G = 1)"))
    rows17.append((None, "decode_attention", "jamba_shard", 0,
                   f"kernel-level only: jamba's heads, combine=False over one rank's "
                   f"{MESH_JAMBA_SHARD_DECODE['S_loc']}-key cache shard of a 4-rank model "
                   f"axis, row lengths {list(MESH_JAMBA_SHARD_DECODE['lengths'])}"))
    for path, fn, tag, launches, where in rows17:
        r = mh["kernel_rows"][(fn, tag)]
        flash = fn == "flash_attention"
        source, replaces = ((("src/repro_torch/csrc/flash_attention_wgmma.cu"
                              if r["kernel"] == "wgmma" else
                              "src/repro_torch/csrc/flash_attention.cu"), flash_src)
                            if flash else sources[fn])
        entries.append({
            "name": f"{fn}_{r['kernel'] + '_' if flash else ''}mesh_hybrid_encdec_"
                    f"{path + '_' if path else ''}{tag.replace(' ', '_')}",
            "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
            "launches_path": where, "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "bitwise": False, "shape": r["shape"],
            **{k: r[k] for k in ("q_offset", "lengths") if k in r}})
    # slice 18: B2, B3 and B4 at every shape phase 16's card runs launched,
    # and B3 kernel-level at the train cell's last model rank
    entries += dry_run_entries(dry_run, sources, flash_src)
    # slice 19: B1 at the int8 mesh round's (1, N) and at a production rank's
    # (1, N_loc); B2 and B3 with phase 17's launches at phase 15's rows
    entries += mesh_strategies_entries(mesh_strategies, mesh_temporal, sources, flash_src)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"slice": "1: FL round loop (fedavg + int8 compressed) on "
                    "flsim-cnn, quant_aggregate on CUDA",
                    "card_vs_cpu": card_cpu}))
    log(json.dumps({"slice": "2: LM serving (prefill + greedy decode) of yi-34b at full "
                    "width, 8 of 60 layers, bf16; rmsnorm, flash attention and decode "
                    "attention on CUDA",
                    "serve": {k: serve[k] for k in (
                        "prefill_s", "decode_ms_per_token", "decode_step_ms",
                        "generated_tokens_per_s", "generate_s", "peak_mem_gb")},
                    "rmsnorm_decode_ms": lm_rows["rmsnorm_decode"]["kernel_ms"],
                    "card_vs_cpu": serve_cpu}))
    log(json.dumps({"slice": "3: B3 flash attention on the tensor cores (wgmma, TMA) and "
                    "B4 decode attention split over the cache",
                    "flash_wgmma_ms": lm_rows["flash_attention"]["kernel_ms"],
                    "flash_tf32x3_bf16_ms": lm_rows["flash_attention_tf32x3_bf16"]["kernel_ms"],
                    "decode_ms": lm_rows["decode_attention"]["kernel_ms"],
                    "prefill_device_busy_ms": serve["profile_prefill"]["device_busy_ms"],
                    "decode_step_device_busy_ms":
                        serve["profile_decode_step"]["device_busy_ms"],
                    "flash_by_kernel": serve["flash_by_kernel"]}))
    dec = lm_rows["rmsnorm_decode"]
    log(json.dumps({"slice": "4: B2 rmsnorm with each row in registers (a wide CTA per "
                    "row at decode, a narrow one at prefill, clusters for long rows), B1 "
                    "quant_aggregate through a TMA-fed ring in shared memory",
                    "quant_aggregate_ms": main["kernel_ms"],
                    "quant_aggregate_baseline_ms": main.get("baseline_ms"),
                    "rmsnorm_prefill_ms": lm_rows["rmsnorm_prefill"]["kernel_ms"],
                    "rmsnorm_prefill_baseline_ms": lm_rows["rmsnorm_prefill"].get("baseline_ms"),
                    "rmsnorm_decode_ms": dec["kernel_ms"],
                    "rmsnorm_decode_warm_ms": dec["kernel_warm_ms"],
                    "rmsnorm_decode_baseline_ms": dec.get("baseline_ms"),
                    "launch_floor_ms": dec["launch_floor_ms"],
                    "rmsnorm_by_layout": serve["rmsnorm_by_layout"]}))
    log(json.dumps({"slice": "5: every FL strategy, gossip topology, temporal placement, "
                    "checkpoints and the async FedAsync/FedBuff driver on flsim-cnn at full "
                    "width, B1 on their int8 paths",
                    "phase_s": slice5_s,
                    "jobs": {name: {k: j.get(k) for k in ("round_s", "events_per_s",
                                                          "peak_mem_gb", "losses")}
                             for name, j in slice5["jobs"].items()},
                    "b1_launches_by_path": slice5["b1_launches_by_path"],
                    "b1_ms": {name: r["kernel_ms"] for name, r in b1_rows.items()},
                    "launch_floor_ms": b1_floor["after_flush_ms"]}))
    log(json.dumps({"slice": "6: multi-worker consensus (majority_digest, median, "
                    "trimmed_mean), the hash-chain ledger, the control-plane store and the "
                    "comms plane on flsim-cnn at full width, B1 on the consensus int8 path",
                    "phase_s": control_s, "f32_normals_differing": f32_differ,
                    "jobs": {name: {k: j.get(k) for k in (
                        "round_s", "round_s_w1", "ledger_ms_per_chunk", "agg_launches",
                        "losses", "next_loss")} for name, j in control["jobs"].items()},
                    "consensus_round_profile":
                        control["jobs"]["int8_majority"]["profile"],
                    "b1_launches_by_path": control["b1_launches_by_path"],
                    "last_comms_rows": control["comms_rows"],
                    "byzantine_losses": control["byzantine_losses"],
                    "gossip_losses": control["gossip_losses"]}))
    log(json.dumps({"slice": "7: campaigns (sweeps, the planner, successive halving), the "
                    "flight recorder and the round probes on flsim-cnn at full width, B1 "
                    "reducing every lane in one launch",
                    "phase_s": slice7_s, "b1_lanes": lane_row,
                    "sweep_traj_round_s": campaigns["sweep"]["traj_round_s"],
                    "lanes_vs_single": campaigns["lanes"], "plan": campaigns["plan"],
                    "telemetry": {k: {"round_s_off": v["round_s_off"],
                                      "round_s_on": v["round_s_on"]}
                                  for k, v in telemetry.items()}}))
    log(json.dumps({"slice": "8: the streaming client plane (ragged cohorts, resident and "
                    "streaming slab stagers on pinned memory and a side stream, a "
                    "1,000,000-client population, ragged async and ragged campaigns) on "
                    "flsim-cnn at full width, B1 at C = max_cohort",
                    "phase_s": slice8_s, "b1_ragged": ragged_rows,
                    "round_s": {k: v["round_s"] for k, v in streaming["main"].items()},
                    "chunks": {k: v["chunks"] for k, v in streaming["main"].items()},
                    "peak_slab": streaming["main"]["streaming_chunks_3"]["peak_slab"],
                    "resident_equiv":
                        streaming["main"]["streaming_chunks_3"]["resident_equiv"],
                    "copy_profile": streaming["profile"],
                    "population": {k: streaming["population"][k] for k in (
                        "losses", "round_s", "scaffold_s", "wall_s", "peak_slab",
                        "resident_equiv", "chunks", "profile")},
                    "async": {k: streaming[k] for k in ("async_fedbuff_int8",
                                                        "async_fedasync_int8")},
                    "campaign": {p: {k: streaming["campaign"][p][k] for k in (
                        "round_s", "traj_round_s", "lane_losses", "chunks", "peak_slab")}
                                 for p in ("resident", "streaming")},
                    "campaign_single_losses": streaming["campaign"]["single_losses"],
                    "b1_launches_by_path": streaming["b1_launches_by_path"]}))
    log(json.dumps({"slice": "9: the LM training path (Model.loss, the train stack, "
                    "SyntheticLM, temporal FL rounds of train_fl_lm) with B2 and B3 "
                    "differentiable, plus QKV bias and qk-norm: qwen2.5-32b trained at "
                    "full width, 2 of 64 layers, bf16",
                    "phase_s": slice9_s, "train": {k: train[k] for k in (
                        "losses", "loss_fell", "round_s", "tokens_per_s", "peak_mem_gb",
                        "launches_per_round", "init_s")},
                    "train_profile": train["profile"],
                    "worst": train_worst, "card_vs_cpu": train_cpu,
                    "serve_new_archs": serve_new}))
    log(json.dumps({"slice": "10: MLA with tied embeddings (minicpm3-4b) and "
                    "capacity-bucketed MoE (qwen3-moe-30b-a3b, arctic-480b), served and "
                    "trained, with B3 at the absorbed-MLA head dims 288/256 on wgmma",
                    "phase_s": slice10_s, "b3": mla_rows, "b2_b4": norm_decode_rows,
                    "serve": {s_["arch"]: {k: s_.get(k) for k in (
                        "n_layers", "prefill_s", "decode_ms_per_token",
                        "generated_tokens_per_s", "generate_s", "peak_mem_gb", "init_s",
                        "moe_prefill", "absorbed_layer_s", "expanded_layer_s",
                        "expanded_layer_rel_diff")}
                        for s_ in (serve_mla, serve_moe)},
                    "train": {t_["arch"]: {k: t_[k] for k in (
                        "n_layers", "losses", "loss_fell", "round_s", "tokens_per_s",
                        "peak_mem_gb", "launches_per_round", "init_s")}
                        for t_ in (train_mla, train_moe)},
                    "train_profiles": {t_["arch"]: t_["profile"] for t_ in (train_mla, train_moe)},
                    "card_vs_cpu": {"train": train_cpu10, "serve": serve_cpu10}}))
    exp = mla_rows["mla_expanded"]
    log(json.dumps({"slice": "11: B3 on the tensor cores only: f32 (and bf16 at dims TMA "
                    "cannot take) in three TF32 passes on mma.sync, bf16 at any head dim "
                    "that is a multiple of 8 on wgmma",
                    "f32_flash": f32_flash_rows,
                    "tf32x3_bf16_at_serve_shape_ms":
                        lm_rows["flash_attention_tf32x3_bf16"]["kernel_ms"],
                    "mla_expanded_wgmma": {k: exp.get(k) for k in (
                        "kernel_ms", "bound_ms", "library_ms", "library_backend",
                        "baseline_ms", "new_ms_in_turns", "max_abs_err")},
                    "tf32x3_launches": {
                        "serve_card_vs_cpu": {a: r["flash_by_kernel"] for a, r in
                                              ((SERVE["arch"], serve_cpu),
                                               *serve_cpu10.items())},
                        "train_card_vs_cpu": {a: r["flash_by_kernel"] for a, r in
                                              (*train_cpu.items(), *train_cpu10.items())}},
                    "worst": {k: v for k, v in lm_worst.items() if k.startswith("flash")}}))
    log(json.dumps({"slice": "12: the last three LM families: whisper-base (encoder-decoder) "
                    "at full depth and xlstm-125m (mLSTM/sLSTM, one sLSTM period) served and "
                    "trained at full width, jamba-1.5-large-398b's attention sublayer and Mamba mixer at full "
                    "width, reduced card vs CPU; determinism.normal from correctly rounded "
                    "operations (C7)",
                    "card": smi, "phase_s": slice12_s, "c7": c7, "kernels": slice12_rows,
                    "whisper": {k: whisper[k] for k in (
                        "prefill_s", "decode_ms_per_token", "generated_tokens_per_s",
                        "generate_s", "peak_mem_gb", "by_shape", "gradient",
                        "profile_prefill", "profile_decode_step")},
                    "xlstm": {k: xlstm[k] for k in (
                        "prefill_s", "decode_ms_per_token", "generated_tokens_per_s",
                        "generate_s", "peak_mem_gb", "launches", "slstm_launches_per_token",
                        "train", "profile_decode_step")},
                    "jamba": jamba, "card_vs_cpu": serve_cpu12}))
    log(json.dumps({"slice": "13: the rematerialized LM training step (a checkpoint per "
                    "layer, block, period, Mamba mixer, MoE FFN and scan chunk, under plain "
                    "autograd for an LM client) and int8 LM sends quantized leaf by leaf: "
                    f"minicpm3-4b trained at {TRAIN_FULL['n_layers']} of its 62 layers, plain and "
                    "int8",
                    "card": smi, "phase_s": slice13_s, "b1_lm": b1_lm,
                    "moe_repeat": moe_repeat, "rmsnorm_mla_train": mla_train_norms,
                    "full_depth": {k: full[k] if k not in ("plain", "int8") else {
                        f: full[k][f] for f in ("losses", "round_s", "tokens_per_s",
                                                "peak_mem_gb", "by_shape")}
                        for k in full},
                    "gradient_memory": {
                        "qwen2.5-32b, 2 layers": train["grad_memory"],
                        "minicpm3-4b, 8 layers": train_mla["grad_memory"],
                        "qwen3-moe-30b-a3b, 2 layers": train_moe["grad_memory"],
                        "whisper-base": whisper["grad_memory"]},
                    "qwen2.5-32b": {"peak_mem_gb": train["peak_mem_gb"],
                                    "warm_round_s": train["round_s"][-1],
                                    "recorded": RECORDED},
                    "minicpm3-4b, 8 layers": {k: train_mla[k] for k in (
                        "losses", "round_s", "peak_mem_gb", "bitwise_repeat")}}))
    log(json.dumps({"slice": "14: the mesh runtime: AxisCtx on a (1, 1) NCCL mesh (the int8 "
                    "FL round client-server and hierarchical, the spatial LM train step of "
                    "xlstm-125m (one sLSTM period) and whisper-base (full depth) at published "
                    "width, each bitwise its meshless twin; gossip card == CPU mesh), and a lane-sharded "
                    "int8 campaign over two ranks sharing the card",
                    "card": smi, **{k: v for k, v in mesh.items()
                                    if k not in ("kernel_rows", "lm_by_shape")},
                    "lm_launches_by_shape": {arch: {fn: named(v) for fn, v in c.items()}
                                             for arch, c in mesh["lm_by_shape"].items()},
                    "kernel_rows": {f"{fn} {shape_name(key)}": {
                        f: r[f] for f in ("kernel_ms", "plain_ms", "library_ms", "bound_ms",
                                          "bound_by", "max_abs_err")}
                        for (fn, key), r in mesh["kernel_rows"].items()}}))
    log(json.dumps({"slice": "15: the temporal placement on a device mesh for dense GQA "
                    "(differentiable collectives, ZeRO-3 gathers, sequence-sharded attention, "
                    "an exact sharded embedding and loss, the mesh train, prefill and decode "
                    "steps): yi-34b at published width on a (1, 1) NCCL mesh, bitwise its "
                    "meshless twins",
                    "card": smi, **{k: v for k, v in mesh_temporal.items()
                                    if k not in ("kernel_rows", "by_path")},
                    "launches_by_shape": {p: {fn: named(v) for fn, v in c.items()}
                                          for p, c in mesh_temporal["by_path"].items()},
                    "kernel_rows": {f"{fn} {tag}": {
                        f: r[f] for f in ("kernel_ms", "plain_ms", "library_ms", "bound_ms",
                                          "bound_by", "max_abs_err")}
                        for (fn, tag), r in mesh_temporal["kernel_rows"].items()}}))
    log(json.dumps({"slice": "16: MLA (minicpm3-4b, tied embeddings) and the MoE FFN's "
                    "expert parallelism (qwen3-moe-30b-a3b's model all-to-all; the grid ring) "
                    "in the temporal placement on a device mesh: each step at published width "
                    "on a (1, 1) NCCL mesh bitwise its meshless twin, a jamba-width MoE layer "
                    "through the grid ring bitwise the meshless moe_ffn",
                    "card": smi, **{k: v for k, v in mesh_mla_moe.items()
                                    if k not in ("kernel_rows", "by_path")},
                    "launches_by_shape": {p: {fn: named(v) for fn, v in c.items()}
                                          for p, c in mesh_mla_moe["by_path"].items()},
                    "kernel_rows": {f"{fn} {tag}": {
                        f: r[f] for f in ("kernel_ms", "plain_ms", "library_ms", "bound_ms",
                                          "bound_by", "max_abs_err")}
                        for (fn, tag), r in mesh_mla_moe["kernel_rows"].items()}}))
    log(json.dumps({"slice": "17: jamba's period (the Mamba cross-shard handoff and its "
                    "tensor-parallel decode), whisper-base's sequence-sharded encoder and "
                    "cross decode, and xlstm-125m's serve steps on a device mesh: each at "
                    "published width on a (1, 1) NCCL mesh bitwise its meshless twin",
                    "card": smi, **{k: v for k, v in mesh_hybrid_encdec.items()
                                    if k not in ("kernel_rows", "by_path")},
                    "launches_by_shape": {p: {fn: named(v) for fn, v in c.items()}
                                          for p, c in mesh_hybrid_encdec["by_path"].items()},
                    "kernel_rows": {f"{fn} {tag}": {
                        f: r[f] for f in ("kernel_ms", "plain_ms", "library_ms", "bound_ms",
                                          "bound_by", "max_abs_err")}
                        for (fn, tag), r in mesh_hybrid_encdec["kernel_rows"].items()}}))
    log(json.dumps({"slice": "18: the dry run of production-mesh cells as one rank (the meta "
                    "device's prediction, the card's counted and timed runs, the other ranks "
                    "a fake process group): yi-34b train_4k on 16x16 and yi-34b decode_32k on "
                    "2x16x16 at 30 of 60 layers, jamba-1.5-large-398b long_500k (one period) "
                    "on 2x16x16",
                    "card": smi, "phase_s": dry_run["phase_s"], "cells": dry_run["cells"],
                    "kernel_rows": {f"{fn} {tag}": {
                        f: r[f] for f in ("kernel_ms", "plain_ms", "library_ms", "bound_ms",
                                          "bound_by", "max_abs_err")}
                        for (fn, tag), r in dry_run["kernel_rows"].items()}}))
    ms = mesh_strategies
    log(json.dumps({"slice": "19: every strategy of the temporal round on a device mesh "
                    "(int8 sends over a rank's shards through B1, DP-FedAvg's clip and noise "
                    "and FedProx's term over the whole model, multi-worker consensus): "
                    "yi-34b at published width on a (1, 1) NCCL mesh, each round bitwise its "
                    "meshless twin",
                    "card": smi, "phase_s": ms["phase_s"], "rounds_s": ms["rounds_s"],
                    "runs": {label: {k: r[k] for k in (
                        "fl", "loss", "step_s", "meshless_step_s", "peak_mem_gb", "launches",
                        "bitwise_meshless", "leaves_moved")} for label, r in ms["runs"].items()},
                    "b1_rows": {tag: {k: r[k] for k in (
                        "C", "N", "kernel_ms", "kernel_call_ms", "plain_ms", "bound_ms",
                        "bound_by", "plan")} for tag, r in ms["b1_rows"].items()}}))
    log(json.dumps({"slice": "20: B3's backward as a hand-written wgmma kernel (dK/dV and "
                    "dQ each by its own kernel, no atomics): bitwise across calls, against "
                    "plain_bwd, timed beside its bound, plain_bwd and SDPA forward + backward",
                    "card": smi, "rows": b3_bwd_rows}))
    log(f"whole script: {time.perf_counter() - T_START:.1f}s")
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
