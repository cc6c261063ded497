#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. card    — require CUDA; print nvidia-smi's name and power limit line;
2. build   — compile every CUDA source of the port with nvcc (one process
             per source, all started together), print the seconds and, per
             kernel, the tensor-core instructions (HMMA / HGMMA) that
             ``cuobjdump -sass`` lists: every flash-attention forward and
             backward body (``*mma_kernel``: bf16, and f32 in 3xTF32) and
             every WKV forward and backward instantiation must have some,
             and every bf16 flash-attention body (``*_wgmma_kernel``,
             Hopper's wgmma fed by TMA) HGMMA (the forward's merge kernel
             and the backward's row-dot and reduce kernels hold no product
             and are not asked for any);
3. kernels — every hand-written kernel against its plain torch version on
             the card, at the test shapes, the main path's shapes and a
             large shape (flash attention also at the shapes phases 21-25
             launch: whisper's encoder, non-causal S = 1500, and its
             cross-attention, 64 x 1500, in f32; G = 5 at hd 128, G = 7 at
             hd 64 and G = 4 at hd 128 in bf16).  The gossip mix also as a tree launch (one launch
             per dtype group of up to 48 leaves) on ``tree_cases()`` --
             the MLP tree in f32, bf16 and f16, leaves off 16-byte
             boundaries, n = 10 and n = 1, rows of 70,000, R = 1, mixed
             dtypes, more leaves than one table -- bit-equal leaf by leaf
             with u given and absent; and the cohort's MLP tree timed as
             one launch (u absent and given), as six one-leaf launches with
             ``zeros_like`` u (the engine before the tree launch), and as six
             ``torch.lerp`` calls.  Max error within tolerance (the WKV scan's final
             state too; with bf16 r/k/v and f32 w, y to the bf16 tolerance
             and the f32 state to the f32 one; decays below the Pallas
             wrapper's clamp -- w = 1e-30, log w = -5 and -8, sub-chunks
             straddling the factorised range -- against the unclamped
             plain recurrence at the same tolerances), and per kernel the median
             time (profiler and CUDA events), the bound, the plain
             version's time and a one-call yardstick (``torch.lerp``, which
             computes only the u = 0 case of the gossip mix,
             ``scaled_dot_product_attention`` for flash attention; none for
             the WKV scan, which no single PyTorch call computes), which the
             port never calls;
4. main    — the paper's NetMax loop through ``simulate`` at the repo's
             model width (MLP [32, 128, 64, 10], 32 workers, 3000 events):
             the launch counters are zeroed just before and read just
             after: the gossip mix must launch exactly once per cohort,
             and the kernels' modules make no ``zeros_like`` tensor;
5. parity  — the same configuration, 1000 events, on the card and on the
             CPU: host-side outputs bit-equal, losses within 5e-4;
6. algos   — every registered strategy (the JAX package's eight) through
             ``simulate`` at the main path's width (3000 events; 93 rounds
             for the synchronous ones), engine "auto": each runs batched
             with finite, falling losses; the gossip mix launches once a
             cohort for netmax, adpsgd and adpsgd+mon and never for the
             other five, no LM kernel at all.  Prints each strategy's wall
             time, events/s, cohorts, dispatches, virtual time, comm time
             and final loss, then the README quickstart's comparison on the
             simulator's virtual clock: time to 1.3x the worst final loss
             and NetMax's speedup over allreduce, prague and adpsgd;
7. algo parity — allreduce, prague, ps-sync, ps-async and netmax-topk at
             32 workers, 640 events, traced, on the card and on the CPU:
             host-side outputs bit-equal, losses within 5e-4;
8. lm      — LM serving at the full width of tinyllama-1.1b (22 layers,
             bf16, random weights from seed 0): ``lm.prefill_logits`` on
             4 prompts of 512 tokens, ``capture_prefill`` of the same batch
             into a 1024-token cache, and ``ServeEngine.run`` of 4 requests
             (prompt 64, 16 new tokens).  The launch counters are zeroed
             just before and read just after: flash attention must launch
             22 times per forward, all through the tensor-core body, logits
             be finite, tokens in the vocab;
9. lm parity — the tinyllama widths cut to 2 layers, f32, S = 256: prefill
             logits on the card and on the CPU within 1e-3 * max |logit|,
             and on the card the decode logits at position P-1 after
             ``capture_prefill`` within the same bound of the prefill's;
             then the same cut in bf16 (the tensor-core body), card against
             CPU within 2e-2 * max |logit|;
10. ssm    — LM serving at the full width of rwkv6-7b (32 layers, bf16,
             random weights from seed 0): ``lm.prefill_logits`` on 4 prompts
             of 512 tokens (twice), ``capture_prefill`` of 4 x 128 tokens,
             and ``ServeEngine.run`` of 4 requests (prompt 32, 16 new
             tokens).  The launch counters are zeroed just before and read
             just after: the WKV kernel must launch 32 times per forward,
             all with bf16 r/k/v and f32 decays, and no other kernel at
             all; logits and the captured state finite, the state
             non-zero, tokens in the vocab.  A profiled
             prefill and 8 decode steps give the device's busy share;
11. ssm parity — the rwkv6-7b widths cut to 2 layers, f32: prefill logits
             (S = 128) on the card and on the CPU within 1e-3 * max |logit|,
             and on the card the decode logits of token 63 after
             ``capture_prefill`` of tokens 0..62 against the prefill logits
             of tokens 0..63 (the WKV kernel against the plain recurrence);
             at random init, then with ``w0`` shifted so the median log
             decay is -7, below the Pallas wrapper's clamp, where the
             kernel's pairwise branch runs.  The kernel and the dense and
             simulator paths never meet: the WKV kernel must launch 0 times
             in phases 4, 6 and 8;
12. flash bwd — the flash-attention backward kernels against the plain
             version's autograd gradient (``ref.reference_attention_backward``)
             in f32 and bf16: causal and not, GQA with G = 8 and MQA,
             S != Sk both ways, hd 32/64/128/160, ragged lengths, a short
             query sequence whose dQ key walk is split (``dq_splits``),
             G = 5 and 7, and the training shape (2 x 512 tokens, 32/4
             heads, hd 64); max |err| of dq, dk and dv within 1e-4 (f32) /
             2e-2 (bf16) of max |grad|; per case the body (bf16 on wgmma,
             f32 in 3xTF32 on mma.sync, at every head dim), the key ranges
             and grids as the C entry reports them, and the
             device time a call against the bound, and at the training
             shapes against SDPA's backward: the dense phase's, and phases
             30-32's in the dtype each trains in (phi3.5's 1 x 512, 32/8
             heads of 128, bf16; whisper's encoder, 4 x 1500 non-causal,
             and cross-attention, 4 x 64 x 1500 with its dQ walk split,
             f32; internvl2's 4 x 768, 14/2 heads, bf16), and llama4's
             (40/8 heads of 128) and stablelm-12b's (32/8 heads of 160)
             bf16 shapes;
13. train  — NetMax training at the widths of tinyllama-1.1b, cut to 8 of
             its 22 layers, M = 4 workers, 4 x 512 tokens a worker in 2
             micro-batches, remat, sgd(0.9, 1e-4), lr 0.02, gather pulls
             and the fused mix, through the launcher's loop
             (``launch.train.TrainLoop``: the Monitor every 4 rounds), 12
             rounds.  The launch counters are zeroed just before and read
             just after: flash attention forward 128 and backward 64 a
             round, the gossip mix once a round, losses finite, and the
             first round's mix bit-equal to its plain version on the whole
             LM tree.  Prints losses, ms a round, tokens/s, peak memory
             and the device time by kind of two profiled rounds;
14. train parity — three rounds of the trainer on the card and on the CPU
             from the same params and draws (2 layers, d_model 256, 4/2
             heads of 64), f32 and bf16: losses and params within 1e-4 /
             2e-2 (relative);
15. scenarios — the JAX package's ``bench_scenarios`` on the card:
             ``Topology.multi_cluster(32)``, ``presets.cluster_outage`` of
             the last cluster over [5, 20) s, dead-link timeout 2 s,
             Monitor period 3 s, netmax on the batched engine with the mix
             kernel, 22,000 events (past 35 s of virtual time): B1 once a
             cohort, the dead cluster's selection mass at 0 within one
             Monitor period of the outage; events/s; then 1,500 traced
             events on the card and on the CPU: host-side outputs
             bit-equal, losses within 5e-4;
16. storms — ``bench_storms``: M = 12 as 3 clusters of 4, ``storm(seed 7,
             horizon 40, intensity 2, trigger cluster 0 at 0.8)``, netmax
             (Monitor home cluster 0, failover) and adpsgd, 2,000 events
             each, and a permanent outage of the home cluster (failover
             elects a standby; no far-side pull from the dead cluster
             after the handoff), each on the card and on the CPU: host
             outputs bit-equal (failover log too), losses within 5e-4; B1
             once a cohort; events per virtual second;
17. serve chaos — ``bench_storms``' serving section on the port's
             ``PolicyServer`` (host): 35% solver faults with deadline, retry
             and stale answers, all served; a blackout where the breaker
             trips and every request gets the uniform fallback; a probe
             that closes the breaker once the faults clear;
18. trace  — the fixture's configuration (``scripts/make_trace_fixture.py``)
             traced on the card and on the CPU, JSONL bytes equal;
             ``bench_trace``'s netmax run (M = 8, 3,000 events) traced on
             the card, written to ``build/trace_smoke/`` and read back,
             calibrated, replayed on the card (event stream and virtual
             times exact), and one ``UpgradeLink`` what-if query;
19. policy service — the port's ``PolicyService`` over a loopback socket:
             a 4-shard ``ShardRouter`` behind an ``AdmissionController``,
             graphs of M = 32, 600 requests from 4 clients, every one
             answered; requests/s and round-trip p50/p99;
20. device LP — ``generate_policy_matrix_batched(backend="torch")`` (the
             float64 lockstep simplex on the card, an iteration replayed
             as one CUDA graph) against ``backend="numpy"`` at M = 16, 32,
             64, 128, K = R = 8, both timed: the same chosen (rho, t_bar);
             on the sweep's own LP stack both simplexes, called directly,
             give the same status per grid point (pivot mismatches, the
             iterations and the read-backs printed); on
             tests/test_revised.py:675's fixture (rng 23) statuses, pivot
             counts and objectives equal.
             Every time phases 15-20 print carries the card's name and
             power limit.
21-25. families — LM serving of the remaining families at their
             published widths, bf16, random weights from seed 0, each
             phase's parameters freed before the next: phi3.5-moe (21; 8
             of 32 layers), llama4-maverick's every_2 interleave (22; one
             period, 2 of 48 layers), jamba-v0.1 (23; one period, 8 of 32
             layers: 7 mamba, 1 attention, 4 MoE), whisper-small (24; full
             depth, 4 x 1500 f32 stub frames and 4 x 64 tokens) and
             internvl2-1b (25; full depth, 256 f32 stub vision tokens
             before 512 text tokens).  ``lm.prefill_logits`` on 4 x 512
             text tokens twice, ``capture_prefill`` of 4 x 64 into a
             128-token cache (not for whisper and internvl2, where it
             raises, ROADMAP C8) and ``ServeEngine.run`` of 4 requests
             (prompt 32, 16 new).  The launch counters are zeroed just
             before and read just after: flash attention launches 8 / 2 /
             1 / 36 / 24 times a forward (whisper: its encoder and cross-
             attention on the f32 3xTF32 body, the f32 frames promoted as
             JAX does, the cross-attention's key walk split in 3 ranges,
             its self-attention on the bf16 body; the rest all on the bf16
             body) and no other kernel launches; logits finite,
             tokens in the vocab, the captured K/V (and Jamba's mamba
             states) finite and non-zero.  Prints the slots the MoE
             capacity dropped, the expert bytes a decode step reads, peak
             memory and a profiled prefill and 8 decode steps;
26. family parity — each of the five at its reduced() config with
             d_model 256 and head_dim 64, f32 then bf16: prefill logits on
             the card and on the CPU within 1e-3 / 2e-2 of max |logit|,
             flash attention's launches a prefill (and their bodies) as in
             phases 21-25 at the cut's depth; for phi3.5, llama4 and Jamba
             the card's decode of token 63 after ``capture_prefill`` of
             tokens 0..62 against the prefill logits of 0..63 at a capacity
             that drops no slot, within 1e-3 of max |logit| in f32 (the
             bf16 gap printed);
27. wkv bwd — the WKV backward kernels (``csrc/rwkv_scan_bwd.cu``: a
             boundary walk and a range kernel, both with HMMA) against
             its plain version, ``ref.reference_rwkv_backward``, and against
             torch autograd through ``ref.reference_rwkv_state``: the WKV
             test cases in the three dtype combinations with and without an
             initial state and a final-state gradient, ragged lengths, the
             extreme decays (w = 1e-30, log w = -5 and -8, straddling
             sub-chunks) and the training shape (1 x 512 tokens, 64 heads of
             64, bf16 r/k/v/dy with f32 w): every gradient within 1e-4 (f32)
             / 2e-2 (bf16) of its max |.|, two calls bit-equal; each call's
             range plan and kernels, as the C entry reports them
             (``rwkv_scan.BWD_LAUNCHED``), against ``bwd_range_len`` and the
             traced kernel names (no fewer range blocks than the card has
             SMs at the training shape);
             per case the device time against the bound, at the training
             shape against the plain version (no one-call library
             equivalent);
28. ssm train — NetMax training at the widths of rwkv6-7b, cut to 1 of
             its 32 layers, through ``launch.train.TrainLoop`` as phase 13
             (M = 4, 4 x 512 tokens a worker in the config's 4 micro-batches,
             remat, sgd, 12 rounds), after the serving phases' weights are
             freed.  The launch counters are zeroed just before and read just
             after: the WKV forward 32 and backward 16 a round (bf16 r/k/v
             with f32 decays), the gossip mix twice (one launch per dtype
             group of the tree: its bf16 leaves, and u and w0 in f32),
             nothing else; the plain recurrence, its backward and the
             chunked scan never called; losses finite, the first round's
             mix bit-equal to its plain version.  Prints ms a round, tokens/s, peak memory and the device
             time by kind of two profiled rounds;
29. ssm train parity — two rounds of the trainer at a 2-layer cut of
             rwkv6-7b (d_model 256, 4 heads of 64) on the card and on the CPU,
             f32 and bf16 with f32 decays: losses and params within 1e-4 /
             2e-2 (relative), the WKV backward once per worker, micro-batch
             and layer;
30-32. family train — NetMax training of the PR 19 families at their
             published widths, bf16, random weights from seed 0, 8 rounds
             each, the last 2 profiled, as phase 13: phi3.5-moe (30) at 1 of
             its 32 layers (1.563 B parameters a replica; M = 2 stacks 3.13
             B, ~58 GB at 18.6 bytes a stacked parameter, M = 4 would need
             ~116 GB), 8 x 512 tokens a worker in its 8 micro-batches,
             through ``launch.train.TrainLoop``; whisper-small (31; 4 x 64
             tokens against 4 x 1500 f32 frames a worker) and internvl2-1b
             (32; 4 x (256 f32 vision + 512 text) tokens a worker), whole,
             M = 4, through ``make_train_step`` with a batch shaped by
             ``launch.specs.train_batch_specs`` and filled from a seeded
             generator and ``sample_round``'s gossip draws
             (``SpecsLoop``: the launcher refuses audio and vlm, ROADMAP
             C10).  The launch counters are zeroed just before the rounds
             and read just after: B3's backward once per worker,
             micro-batch and attention call and its forward twice (remat),
             B1 once per dtype group of the tree, nothing else; losses
             finite, the first round's mix bit-equal to its plain version,
             the peak under 80 GB.  Prints ms a round, tokens/s, peak
             memory, busy share and device time by kind;
33. family train parity — each of the five at ``family_cut`` with remat
             on (llama4 and jamba train only here: one period at published
             widths is 18.43 B / 13.30 B parameters, ~343 / ~247 GB at M =
             1, printed), one round of the trainer at M = 2, the config's
             micro-batches of one 64-token sequence each (two sequences
             where it has one), the fused mix, on the card and on the CPU,
             in f32 and bf16: losses and params within 1e-4 / 2e-2
             (relative), in bf16 with every MoE layer of the CPU's round --
             the remat recomputation's too -- taking the card's expert
             choices (the unpinned gap and the differing choices printed);
             B3's launches as in phases 30-32 at the cut;
34. sharded train — the multi-card trainer in a one-rank NCCL group
             (the script initialises it over a ``FileStore`` in a temporary
             directory with ``device_id=cuda:0``, and destroys it at the
             end; NCCL failing fails the run, with no fall-back), at phase
             13's cut of tinyllama-1.1b (8 layers, M = 4, 2 micro-batches,
             remat, the fused mix, netmax), pull modes gather and
             masked_psum: 3 rounds unsharded, their params moved to the host
             and freed, then the same 3 rounds through ``make_train_step``
             with ``mesh=make_debug_mesh(1, 1)``: params bit-equal, losses
             within 1e-6 (relative); the sharded rounds' launch counters
             zeroed just before and read just after: B3 forward, backward
             and B1 as phase 13 counts them.  Prints ms a round of both
             runs and the peak memory (ppermute cannot engage at one rank
             with M = 4: it would need four);
35. sharded engine — phase 4's ``simulate`` (netmax, M = 32, 3000
             events) with ``shard_workers=True`` in the one-rank group and
             unsharded: times, events, trace stream and published policies
             bit-equal, losses within 5e-4, dispatches different (one a
             cohort on the sharded path), B1 once a cohort on both; events/s
             of both.  At one rank every collective is a copy: no
             cross-card traffic is measured;
36. dry-run — ``launch.dryrun.run_cell`` in subprocesses (a fake process
             group of 256 / 512 ranks, ``meta`` tensors, a CUDA-typed
             mesh): tinyllama-1.1b and rwkv6-7b at full width, every shape
             each supports, phi3.5-moe's and jamba's train_4k, on 16x16,
             and tinyllama's train_4k on 2x16x16; each cell ok (or an
             explicit unsupported-shape skip) with its per-rank FLOPs,
             bytes, collective bytes by kind, argument and temp GB, the
             roofline's dominant term and its seconds; other subprocesses count each 16x16 cell's
             program unsharded (``dryrun.unsharded_flops``), and every
             16x16 cell that ``dryrun.PLAN_BOUNDS`` names (tinyllama's and
             rwkv6-7b's train, prefill and decode, phi3.5-moe's and jamba's
             train_4k) must do per-rank FLOPs x 256 within
             ``dryrun.PLAN_RATIO`` of it (1.0-1.3x), with a rank's
             collective bytes and temp within its bounds (ROADMAP C16-C22);
             rwkv6-7b's long_500k, whose one row stays whole on 'data',
             is printed with that reason;
37. cost   — ``analysis.cost.CostCounter`` around two rounds of phase 13's
             cut under the profiler (the two rounds traced again, up to 4
             times, when CUPTI drops kernels from a trace): the kernel
             calls it counts equal the launch counters and the profiler's
             kernels (B3 128, B3 backward 64, B1 1 a round); its FLOPs beside 6 N D plus the
             remat forward and the attention products; the compute and
             memory terms at the H100's rates beside the round time
             measured without the counter, with the card's name and power
             limit.

Prints one ``{"kernels": [...]}`` JSON line, then, last, the
``{"ok": true, "device": {...}}`` line.  With ``--out DIR`` the per-case
kernel numbers and the paths' numbers also go to
``DIR/chip_smoke_kernels.json``.  It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "src"

#: The simulator MLP, [D, 128, 64, C] at train_eval_split(4000, 800, 32, 10).
MLP_DIMS = [32, 128, 64, 10]
N_WORKERS = 32

#: HBM bytes/s by card name (NVIDIA data sheets); the SXM H100 otherwise.
HBM_BYTES_PER_S = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12}
H100_SXM_BYTES_PER_S = 3.35e12
#: Dense peak FLOP/s by card name and type (NVIDIA data sheets): bf16 on the
#: tensor cores, f32 on the FMA units, and f32-accurate products as 3xTF32 on
#: the tensor cores (a third of the TF32 peak); the SXM H100 otherwise.
FLOPS_PER_S = {"H100 PCIe": {"bfloat16": 756e12, "float32": 51e12,
                             "3xtf32": 378e12 / 3}}
H100_SXM_FLOPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "3xtf32": 495e12 / 3}

#: The LM serving configurations: tinyllama-1.1b (dense) and rwkv6-7b (ssm)
#: at full width.
LM_ARCH = "tinyllama-1.1b"
SSM_ARCH = "rwkv6-7b"

#: tests/test_kernels.py MIX_CASES / MIX_ROWS_CASES, with their tolerances.
MIX_CASES = [((1024,), "float32", 0.25), ((127, 33), "float32", 0.8),
             ((8, 64, 32), "bfloat16", 0.5), ((70000,), "float32", 0.0),
             ((256,), "float32", 1.0)]
MIX_ROWS_CASES = [((4, 1024), "float32"), ((3, 127, 33), "float32"),
                  ((8, 64, 32), "bfloat16"), ((1, 70000), "float32")]
TOL = {"float32": 1e-6, "bfloat16": 2e-2}
#: tests/test_kernels.py ATTN_CASES (B, S, Sk, H, Hk, hd, causal, dtype), a
#: ragged causal case, the tensor-core body (bf16) at every head dim, ragged,
#: non-causal with S != Sk and MQA, the LM phase's shape (one tinyllama layer
#: of a 4 x 512 prefill) and a large one; tolerances as tests/test_kernels.py:43.
ATTN_CASES = [(1, 128, 128, 4, 4, 64, True, "float32"),
              (2, 256, 256, 8, 2, 64, True, "float32"),
              (1, 128, 128, 4, 1, 32, True, "float32"),
              (2, 128, 256, 4, 4, 64, False, "float32"),
              (1, 256, 256, 2, 2, 128, True, "bfloat16"),
              (1, 512, 512, 4, 2, 64, True, "float32"),
              (1, 200, 200, 32, 4, 64, True, "float32"),
              (1, 256, 256, 4, 2, 32, True, "bfloat16"),
              (1, 256, 256, 4, 2, 64, True, "bfloat16"),
              (2, 100, 37, 8, 2, 160, True, "bfloat16"),
              (1, 200, 200, 32, 4, 64, True, "bfloat16"),
              (2, 128, 256, 4, 4, 64, False, "bfloat16"),
              (1, 128, 128, 4, 1, 32, True, "bfloat16")]
#: The shapes the families of phases 21-25 launch (B = 4): whisper's
#: encoder (non-causal, ragged S = 1500, f32) and cross-attention (64
#: queries against 1500 keys, f32), llama4 (G = 5, hd 128), internvl2 (G = 7,
#: hd 64, 256 vision + 512 text tokens), phi3.5 and Jamba (G = 4, hd 128).
ATTN_FAMILY_CASES = [(4, 1500, 1500, 12, 12, 64, False, "float32"),
                     (4, 64, 1500, 12, 12, 64, False, "float32"),
                     (4, 512, 512, 40, 8, 128, True, "bfloat16"),
                     (4, 768, 768, 14, 2, 64, True, "bfloat16"),
                     (4, 512, 512, 32, 8, 128, True, "bfloat16")]
ATTN_MAIN = (4, 512, 512, 32, 4, 64, True, "bfloat16")
ATTN_LARGE = (1, 8192, 8192, 32, 4, 64, True, "bfloat16")
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: The split f32 walk's merged log-sum-exp against one whole walk's: f32
#: sums of the same products in another order, relative to 1 + max |lse|.
FWD_SPLIT_LSE_TOL = 1e-5
#: tests/test_kernels.py RWKV_CASES (B, S, H, N, chunk, dtype), a ragged one,
#: the model's dtypes ("mixed": r/k/v bf16, w f32) at N 16/32/64 and ragged,
#: the extreme-decay cases (below the Pallas wrapper's clamp, held to the
#: unclamped plain recurrence), cases from a random initial state, the ssm
#: phase's shape (one rwkv6-7b layer of a 4 x 512 prefill, from the zero state
#: the model passes) in the model's dtypes, in f32 (every operand f32) and at
#: log w = -8 (every sub-chunk on the pairwise branch), and a large one;
#: tolerances as tests/test_kernels.py:120.
RWKV_CASES = [(1, 64, 2, 16, 16, "float32"), (2, 128, 4, 32, 32, "float32"),
              (1, 128, 2, 64, 64, "float32"), (1, 256, 2, 16, 64, "float32"),
              (1, 128, 2, 32, 32, "bfloat16"), (2, 100, 3, 64, 64, "float32"),
              (1, 64, 2, 16, 16, "mixed"), (2, 128, 4, 32, 32, "mixed"),
              (1, 128, 2, 64, 64, "mixed"), (2, 100, 3, 64, 64, "mixed")]
#: Extreme decays (case, decays): tests/test_kernels.py's w = 1e-30; a
#: constant log w of -5 and of -8 (times U(0.9, 1.1)); and "straddle", the
#: decays of the other cases with the first half of the columns of every other
#: 16-token sub-chunk at log w = -8, so those sub-chunks straddle the
#: factorised range (half their columns total -128, half stay above -75).
RWKV_EXTREME = [((1, 32, 1, 16, 16, "float32"), "1e-30"),
                ((1, 128, 2, 64, 64, "float32"), "-5"),
                ((1, 128, 2, 64, 64, "float32"), "-8"),
                ((1, 128, 2, 64, 64, "float32"), "straddle"),
                ((2, 100, 3, 64, 64, "mixed"), "straddle")]
RWKV_STATE = [(2, 128, 4, 64, 64, "float32"), (2, 100, 4, 64, 64, "mixed")]
RWKV_MAIN = (4, 512, 64, 64, 64, "mixed")
RWKV_MAIN_F32 = (4, 512, 64, 64, 64, "float32")
RWKV_MAIN_W8 = (4, 512, 64, 64, 64, "mixed")
RWKV_LARGE = (1, 8192, 64, 64, 64, "float32")
#: y's tolerance by dtype (the final state is f32 and held to y's f32
#: tolerance in the mixed case: bf16 inputs widen to f32 exactly).
RWKV_TOL = {"float32": 1e-4, "bfloat16": 5e-2, "mixed": 5e-2}
RWKV_STATE_TOL = {"float32": 1e-4, "bfloat16": 5e-2, "mixed": 1e-4}
#: Operand dtypes (r/k/v, w) of a WKV case's dtype name.
RWKV_DTYPES = {"float32": ("float32", "float32"), "bfloat16": ("bfloat16", "bfloat16"),
               "mixed": ("bfloat16", "float32")}
#: Phase 27, the WKV backward kernel's cases (B, S, H, N, dtype, decays,
#: initial state, final-state gradient): RWKV_CASES with and without an
#: initial state and a final-state gradient in turn; ragged lengths (S not
#: a multiple of 8, or below it) in the three dtype combinations;
#: RWKV_EXTREME's decays from a state and with a final-state gradient;
#: sequences cut into several ranges with a ragged last one at B * H < 132
#: (S = 300 at 6 heads: 19 ranges of 16 tokens, the last of 12; S = 150 at
#: 2 x 40 heads: 3 ranges of 64, the last of 22); ranges of several
#: sub-chunks at every N under the extreme decays (2 x 40 heads: four
#: sub-chunks a range, straddling ones beside factorised ones in a block;
#: 1 x 40 heads: ranges of 32); then the training shape, one rwkv6-7b layer
#: of a 1 x 512 micro-batch from the zero state the model passes
#: (RWKV_BWD_MAIN).
RWKV_BWD_CASES = (
    [(B, S, H, N, dtype, None, i % 2 == 1, (i // 2) % 2 == 1)
     for i, (B, S, H, N, _, dtype) in enumerate(RWKV_CASES)]
    + [(1, 7, 2, 16, "float32", None, True, True), (1, 1, 2, 64, "mixed", None, True, True),
       (2, 37, 2, 32, "bfloat16", None, False, True), (2, 100, 3, 64, "bfloat16", None, True,
                                                      False)]
    + [(B, S, H, N, dtype, how, True, True) for (B, S, H, N, _, dtype), how in RWKV_EXTREME]
    + [(1, 300, 6, 64, "mixed", None, True, True), (2, 150, 40, 64, "float32", None, True,
                                                    True)]
    + [(2, 150, 40, 64, "mixed", "straddle", True, True),
       (2, 150, 40, 32, "mixed", "straddle", False, True),
       (2, 150, 40, 16, "bfloat16", None, False, True),
       (2, 150, 40, 16, "float32", "straddle", True, True),
       (1, 150, 40, 64, "float32", "-8", True, True),
       (1, 100, 40, 32, "float32", "1e-30", True, True)])
RWKV_BWD_MAIN = (1, 512, 64, 64, "mixed", None, False, False)
#: Each gradient's max |err| against the plain version's max |.|, as the
#: flash-attention backward (ATTN_BWD_TOL).
RWKV_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2, "mixed": 2e-2}
#: Kernels that must hold tensor-core instructions (a substring of their
#: symbol in ``cuobjdump -sass``), by library.
TENSOR_CORE_KERNELS = {"flash_attention": "mma_kernel",
                       "flash_attention_bwd": "mma_kernel",
                       "rwkv_scan": "rwkv_scan_kernel",
                       "rwkv_scan_bwd": "rwkv_scan_bwd"}
#: The mark of the bodies on Hopper's warpgroup products (``wgmma``, fed by
#: TMA), which must hold HGMMA, not only HMMA, and the libraries that have
#: them.
WGMMA_MARK = "_wgmma_kernel"
WGMMA_LIBS = ("flash_attention", "flash_attention_bwd")


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def leaf_shapes(rows=None):
    """The MLP's parameter shapes, stacked over ``rows`` when given."""
    out = []
    for a, b in zip(MLP_DIMS[:-1], MLP_DIMS[1:]):
        for s in ((a, b), (b,)):
            out.append(s if rows is None else (rows,) + s)
    return out


def cuda_ms(torch, fn, iters, reps=7, warmup=3):
    """Median per-call device time of ``fn`` (ms), from CUDA events around
    ``iters`` back-to-back calls, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


#: Traces device_ms takes of one case before it gives up: CUPTI on the
#: card's machine may deliver only some of a trace's kernel records, or none
#: (an H100 run traced 65 of 200 launches in one trace, and others traced
#: none of a WKV case's, forward or backward, in four traces), so a trace
#: that misses launches is taken again, and when none holds one the caller
#: times the call with CUDA events instead.
PROFILE_ATTEMPTS = 4


def traced_device_us(events, match=None):
    """(launches, device µs) of the profiler's ``key_averages()`` rows whose
    kernel name contains ``match`` (all rows without it)."""
    found = [e for e in events if match is None or match in e.key]
    return (sum(e.count for e in found),
            sum(e.self_device_time_total for e in found))


def device_ms(torch, fn, iters, match=None, per_call=1, names=None):
    """Device time (ms) from a torch.profiler (CUPTI) trace of ``iters``
    calls of ``fn``: with ``match``, the time of the traced kernels whose
    name contains it over the calls they account for (``fn`` launches
    ``per_call`` of them a call; a trace may hold fewer launches than calls
    were made, so the sum over calls would read low); without, the device
    time of all kernels per call.  None when no trace of ``PROFILE_ATTEMPTS``
    holds device time (of the named kernels): the caller then reads CUDA
    events around the calls and says so.  A trace short of the launches made
    is taken again; the fullest is used.  ``names``, a list, receives the
    names of the kernels matched in that trace."""
    profiler = torch.profiler
    fn()
    torch.cuda.synchronize()
    want = iters * per_call
    best = (0, 0.0, [])
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profiler.profile(activities=[profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        n, us = traced_device_us(events, match)
        if us > 0 and n > best[0]:
            best = (n, us, [e.key for e in events if match is None or match in e.key])
        if us > 0 and (match is None or n >= want):
            break
    n, us, keys = best
    if names is not None:
        names.extend(keys)
    if attempt > 1:
        print(f"  (profiler: {attempt} traces of {match or 'all kernels'}, "
              f"the fullest held {n} launches)")
    if match is None:
        return us / iters / 1e3 if us > 0 else None
    if us <= 0:
        print(f"  (profiler: no device time for kernels named *{match}* in "
              f"{PROFILE_ATTEMPTS} traces; CUDA events time this case)")
        return None
    if n != want:
        print(f"  (profiler traced {n} {match} launches of {want})")
    return us / (n / per_call) / 1e3


def host_ms(torch, fn, iters, warmup=3):
    """Host time (ms) a call spends enqueueing ``fn``: the wall clock around
    ``iters`` calls, read before the device is waited for."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / iters * 1e3


def hbm_rate(name: str) -> float:
    for key, rate in HBM_BYTES_PER_S.items():
        if key in name:
            return rate
    return H100_SXM_BYTES_PER_S


def flop_rate(name: str, dtype: str) -> float:
    for key, rates in FLOPS_PER_S.items():
        if key in name:
            return rates[dtype]
    return H100_SXM_FLOPS_PER_S[dtype]


def phase_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0 and smi.stdout.strip(),
          f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip()
    print(card)
    return card


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    libs = build.build()
    secs = time.perf_counter() - t0
    print(f"build: {sorted(libs)} in {secs:.2f} s (build dir {build.build_dir()})")
    sass, hgmma = {}, {}
    for name, path in libs.items():
        sass[name], hgmma[name] = tensor_core_counts(build, path)
    for name, counts in sass.items():
        print(f"  sass {name}: {sum(counts.values())} HMMA/HGMMA in {len(counts)} kernels")
        for fn, n in sorted(counts.items()):
            print(f"    {n:6d}  (HGMMA {hgmma[name][fn]:4d})  {fn[:100]}")
        want = TENSOR_CORE_KERNELS.get(name)
        if want is not None:
            mine = {fn: n for fn, n in counts.items() if want in fn}
            check(mine and all(mine.values()),
                  f"{name}: kernels {want}* without tensor-core instructions: {mine}")
        wg = {fn: n for fn, n in hgmma[name].items() if WGMMA_MARK in fn}
        check(all(wg.values()) and (wg or name not in WGMMA_LIBS),
              f"{name}: {WGMMA_MARK} bodies without HGMMA (wgmma) instructions: {wg}")
    return {"seconds": secs, "sass_tensor_core": sass, "sass_hgmma": hgmma}


def tensor_core_counts(build, path):
    """Kernel symbol -> count of HMMA / HGMMA instructions in the library's
    SASS (``cuobjdump -sass``, from the toolkit beside nvcc), and kernel
    symbol -> HGMMA (``wgmma``) alone."""
    exe = Path(build.nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(exe), "-sass", str(path)], capture_output=True, text=True,
                         timeout=300)
    check(out.returncode == 0, f"cuobjdump -sass {path} failed: {out.stderr[-2000:]}")
    counts = sass_tensor_core_counts(out.stdout)
    check(counts, f"cuobjdump -sass {path} lists no kernel")
    return counts, sass_tensor_core_counts(out.stdout, r"\bHGMMA\.")


def sass_tensor_core_counts(sass: str, pattern: str = r"\bH(G)?MMA\.") -> dict:
    """Kernel symbol -> instructions matching ``pattern`` (by default HMMA
    and HGMMA), from ``cuobjdump -sass`` text (a ``Function : <symbol>``
    line opens each kernel)."""
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and re.search(pattern, line):
            counts[fn] += 1
    return counts


def tree_cases():
    """Trees held bit-equal between one tree launch and the plain version
    leaf by leaf, with u given and absent: name -> (R, the leaves' trailing
    shapes, their dtype (one name for all, or one per leaf), the leaves whose
    bases are moved off 16-byte boundaries)."""
    mlp = leaf_shapes()
    return {
        "mlp_f32": (N_WORKERS, mlp, "float32", ()),
        "mlp_bf16": (N_WORKERS, mlp, "bfloat16", ()),
        "mlp_f16": (N_WORKERS, mlp, "float16", ()),
        "mixed_alignment": (4, [(127, 33), (10,), (1,), (64,), (70000,)], "float32",
                            (0, 2, 4)),
        "mixed_alignment_bf16": (4, [(127, 33), (10,), (1,), (64,)], "bfloat16", (1, 3)),
        "rows_across_vectors": (32, [(10,), (1,), (3,), (5, 7), (64, 10)], "float16", ()),
        "rows_of_70000": (2, [(70000,), (127,)], "float32", ()),
        "one_row": (1, [(127, 33), (10,), (1,), (70000,)], "bfloat16", ()),
        "mixed_dtypes": (8, [(64,), (10,), (33,), (1,), (128, 64)],
                         ("float32", "bfloat16", "float32", "float16", "bfloat16"), ()),
        "more_leaves_than_a_table": (4, [(k,) for k in range(1, 51)], "float32", (7, 30)),
        "100_leaves_bf16": (3, [((k % 17) + 1, 3) for k in range(100)], "bfloat16", ()),
    }


def make_tree(torch, case, device, gen):
    """(xs, us, pulleds, w) for a ``tree_cases()`` entry: normal draws (u
    scaled 0.01), w = linspace(0, 1, R).  Row 0 (w = 0) starts with x = -0.0
    and p < 0, where only x + 0.0 gives the plain version's +0.0."""
    R, shapes, dtypes, unaligned = case
    if isinstance(dtypes, str):
        dtypes = [dtypes] * len(shapes)
    xs, us, ps = [], [], []
    for i, (trail, dt) in enumerate(zip(shapes, dtypes)):
        shape = (R,) + tuple(trail)
        numel = math.prod(shape)
        ops = []
        for scale in (1.0, 0.01, 1.0):
            flat = torch.randn(numel + 1, generator=gen, device=device).mul_(scale)
            flat = flat.to(getattr(torch, dt))
            ops.append((flat[1:] if i in unaligned else flat[:numel]).view(shape))
        x, u, p = ops
        x.view(R, -1)[0, :2] = -0.0
        p.view(R, -1)[0, :2] = -1.0
        xs.append(x)
        us.append(u)
        ps.append(p)
    return xs, us, ps, torch.linspace(0.0, 1.0, R, device=device)


def bits_equal(torch, a, b):
    """a and b hold the same bits (so +0.0 and -0.0 differ)."""
    as_int = {4: torch.int32, 2: torch.int16}[a.element_size()]
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(as_int), b.contiguous().view(as_int)))


def phase_kernels(torch, rate):
    """Every kernel against its plain version; returns per-kernel summaries
    (without launches) and the per-case records."""
    from repro_torch.kernels import gossip_mix as tk
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count

    def draw(shape, dtype):
        x, u, p = (torch.randn(shape, generator=gen, device=dev) for _ in range(3))
        u.mul_(0.01)
        return tuple(t.to(getattr(torch, dtype)) for t in (x, u, p))

    records = []

    def run_case(kernel, shape, dtype, w, role, iters):
        x, u, p = draw(shape, dtype)
        if kernel == "gossip_mix_rows":
            R = shape[0]
            wt = (torch.linspace(0.0, 1.0, R, device=dev) if w is None
                  else torch.full((R,), w, device=dev))
            k_fn = lambda: tk.gossip_mix_rows(x, u, p, wt)  # noqa: E731
            p_fn = lambda: ref.reference_gossip_mix_rows(x, u, p, wt)  # noqa: E731
            lib_fn = None  # the cohort's tree has its yardstick in main_tree
            n_w = R
        else:
            k_fn = lambda: tk.gossip_mix(x, u, p, w)  # noqa: E731
            p_fn = lambda: ref.reference_gossip_mix(x, u, p, w)  # noqa: E731
            lib_fn = lambda: torch.lerp(x, p, w)  # noqa: E731
            n_w = 1
        got, want = k_fn(), p_fn()
        torch.cuda.synchronize()
        check(got.shape == x.shape and got.dtype == x.dtype,
              f"{kernel} {shape}: output {tuple(got.shape)} {got.dtype}")
        err = (got.float() - want.float()).abs().max().item()
        check(err <= TOL[dtype], f"{kernel} {shape} {dtype}: max |err| {err}")
        _, nbytes = mix_work(x.numel() * x.element_size(), x.numel(), n_w, True)
        rec = {"kernel": kernel, "role": role, "shape": list(shape), "dtype": dtype,
               "max_abs_err": err, "bound_ms": nbytes / rate * 1e3, "bytes": nbytes}
        # torch.lerp(x, p, w) computes the u = 0 case; a yardstick only.
        fns = {"": k_fn, "plain_": p_fn}
        if role == "main" and lib_fn is not None:
            fns["library_"] = lib_fn
        for key, fn in fns.items():
            # Device time of the kernels alone (profiler) and the time per
            # call back to back (CUDA events), which includes the host's
            # launch cost whenever the kernel is shorter than that.
            call = cuda_ms(torch, fn, iters)
            dev_ms = device_ms(torch, fn, iters,
                               "mix_tree_kernel" if key == "" else None)
            rec[key + "ms"] = call if dev_ms is None else dev_ms
            rec[key + "ms_from"] = "events" if dev_ms is None else "profiler"
            rec[key + "call_ms"] = call
        rec.setdefault("library_ms", None)
        records.append(rec)
        return rec

    def run_tree(name, case):
        """One tree launch (per dtype group) against the plain version leaf
        by leaf, bit for bit, with u given and absent."""
        xs, us, ps, w = make_tree(torch, case, dev, gen)
        groups = tk.plan(tuple(x.dtype for x in xs), tuple(x.numel() for x in xs),
                         sm_count)
        for with_u in (True, False):
            n0 = tk.LAUNCHES["gossip_mix_rows"]
            got = tk.gossip_mix_rows_tree(xs, us if with_u else None, ps, w)
            torch.cuda.synchronize()
            launches = tk.LAUNCHES["gossip_mix_rows"] - n0
            check(launches == len(groups), f"tree {name}: {launches} launches, "
                                           f"expected {len(groups)}")
            err = 0.0
            for i, (x, u, p, g) in enumerate(zip(xs, us, ps, got)):
                want = ref.reference_gossip_mix_rows(x, u if with_u else None, p, w)
                err = max(err, (g.float() - want.float()).abs().max().item())
                check(bits_equal(torch, g, want),
                      f"tree {name} (u {'given' if with_u else 'absent'}) leaf {i} "
                      f"{tuple(x.shape)} {x.dtype}: not bit-equal (max |err| {err})")
            records.append({"kernel": "gossip_mix_rows", "role": "tree", "case": name,
                            "with_u": with_u, "leaves": len(xs), "launches": launches,
                            "unrolls": [g.unroll for g in groups],
                            "blocks": [g.blocks for g in groups], "max_abs_err": err})
            print(f"  tree {name}: {len(xs)} leaves, u {'given' if with_u else 'absent'}"
                  f", {launches} launch(es) of {[g.blocks for g in groups]} blocks "
                  f"(unroll {[g.unroll for g in groups]}), bit-equal")

    for shape, dtype, w in MIX_CASES:
        run_case("gossip_mix", shape, dtype, w, "test", 50)
    for shape, dtype in MIX_ROWS_CASES:
        run_case("gossip_mix_rows", shape, dtype, None, "test", 50)
    for name, case in tree_cases().items():
        run_tree(name, case)
    for dtype in ("float32", "bfloat16"):
        run_case("gossip_mix_rows", (8, 2 ** 24), dtype, None, "large", 5)
    run_case("gossip_mix", (2 ** 27,), "float32", 0.3, "large", 5)
    # A single replica's leaves for the scalar entry point; the cohort's tree
    # in ``main_tree``.
    for shape in leaf_shapes():
        run_case("gossip_mix", shape, "float32", 0.3, "main", 200)
    tree = main_tree(torch, tk, ref, rate, draw, dev, records)

    src = "src/repro_torch/kernels/csrc/gossip_mix.cu"
    b1 = [r for r in records if r["kernel"] == "gossip_mix_rows"]
    b2_main = [r for r in records if r["kernel"] == "gossip_mix" and r["role"] == "main"]
    summaries = [
        {"name": "gossip_mix_rows", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/gossip_mix.py:82",
         "max_abs_err": max(r["max_abs_err"] for r in b1 if "max_abs_err" in r),
         # One mix of the cohort's MLP tree as the engine runs it: one launch,
         # u absent; beside it u given, and the six launches with zeros_like u
         # of the engine before the tree launch.
         "ms": tree["tree"]["ms"], "plain_ms": tree["plain"]["ms"],
         "bound_ms": tree["tree"]["bound_ms"], "bound_by": "bytes",
         "library_ms": tree["lerp"]["ms"],
         "ms_with_u": tree["tree_u"]["ms"], "bound_ms_with_u": tree["tree_u"]["bound_ms"],
         "call_ms": tree["tree"]["call_ms"], "host_ms": tree["tree"]["host_ms"],
         "per_leaf_ms": tree["per_leaf"]["ms"],
         "per_leaf_call_ms": tree["per_leaf"]["call_ms"],
         "per_leaf_host_ms": tree["per_leaf"]["host_ms"]},
        {"name": "gossip_mix", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/gossip_mix.py:42",
         "max_abs_err": max(r["max_abs_err"] for r in records
                            if r["kernel"] == "gossip_mix"),
         # One replica's six leaves, one launch each.
         "ms": sum(r["ms"] for r in b2_main),
         "plain_ms": sum(r["plain_ms"] for r in b2_main),
         "bound_ms": sum(r["bound_ms"] for r in b2_main), "bound_by": "bytes",
         "library_ms": sum(r["library_ms"] for r in b2_main)},
    ]
    s1, s2 = summaries
    print(f"kernel gossip_mix_rows: max|err| {s1['max_abs_err']:.3g}; the cohort's tree "
          f"in one launch {s1['ms'] * 1e3:.2f} us on the device, u absent (bound "
          f"{s1['bound_ms'] * 1e3:.3f} us), {s1['ms_with_u'] * 1e3:.2f} us with u (bound "
          f"{s1['bound_ms_with_u'] * 1e3:.3f} us); six launches with zeros_like u "
          f"{s1['per_leaf_ms'] * 1e3:.2f} us; six lerp {s1['library_ms'] * 1e3:.2f} us; "
          f"per call {s1['call_ms'] * 1e3:.2f} us (host {s1['host_ms'] * 1e3:.2f} us) "
          f"against {s1['per_leaf_call_ms'] * 1e3:.2f} us (host "
          f"{s1['per_leaf_host_ms'] * 1e3:.2f} us)")
    print(f"kernel gossip_mix: max|err| {s2['max_abs_err']:.3g}, one replica's six "
          f"leaves {s2['ms'] * 1e3:.2f} us on the device (plain {s2['plain_ms'] * 1e3:.2f}"
          f" us, lerp {s2['library_ms'] * 1e3:.2f} us, bound {s2['bound_ms'] * 1e3:.3f} us)")
    for r in records:
        if r["role"] in ("tree", "main_tree"):
            continue
        print(f"  {r['kernel']} {r['role']} {r['shape']} {r['dtype']}: device "
              f"{r['ms'] * 1e3:.2f} us ({r['ms_from']}), per call {r['call_ms'] * 1e3:.2f}"
              f" us, plain {r['plain_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.3f} us"
              f" ({r['bytes'] / (r['ms'] * 1e-3) / 1e12:.3f} TB/s)"
              + (f", lerp {r['library_ms'] * 1e3:.2f} us" if r["library_ms"] else ""))
    return summaries, records


def main_tree(torch, tk, ref, rate, draw, dev, records, iters=200):
    """The cohort's MLP tree (six leaves x 32 rows, f32) mixed every way:
    one tree launch with u absent (the engine's form) and with u given; the
    engine's way before the tree launch (six one-leaf launches, each with a
    ``zeros_like`` u); the plain version; six ``torch.lerp`` calls (u = 0
    only, a yardstick); and the tree launch after a 128 MB write that
    evicts the operands from L2 (on the main path they were just written, so
    L2-resident is the engine's case).  Per way: device time (profiler), time
    per call back to back (CUDA events) and host enqueue time per call."""
    shapes = leaf_shapes(N_WORKERS)
    ops = [draw(s, "float32") for s in shapes]
    xs, us, ps = ([o[j] for o in ops] for j in range(3))
    w = torch.linspace(0.0, 1.0, N_WORKERS, device=dev)
    wls = [w.reshape((-1,) + (1,) * (len(s) - 1)) for s in shapes]
    flush = torch.empty(32 * 2 ** 20, device=dev)
    ways = {
        "tree": (lambda: tk.gossip_mix_rows_tree(xs, None, ps, w), "mix_tree_kernel", 1),
        "tree_u": (lambda: tk.gossip_mix_rows_tree(xs, us, ps, w), "mix_tree_kernel", 1),
        "per_leaf": (lambda: [tk.gossip_mix_rows(x, torch.zeros_like(x), p, w)
                              for x, p in zip(xs, ps)], None, 1),
        "per_leaf_kernels": (lambda: [tk.gossip_mix_rows(x, torch.zeros_like(x), p, w)
                                      for x, p in zip(xs, ps)], "mix_tree_kernel", 6),
        "plain": (lambda: [ref.reference_gossip_mix_rows(x, None, p, w)
                           for x, p in zip(xs, ps)], None, 1),
        "plain_u": (lambda: [ref.reference_gossip_mix_rows(x, u, p, w)
                             for x, u, p in zip(xs, us, ps)], None, 1),
        "lerp": (lambda: [torch.lerp(x, p, wl) for x, p, wl in zip(xs, ps, wls)], None, 1),
        "tree_cold": (lambda: (flush.zero_(), tk.gossip_mix_rows_tree(xs, None, ps, w)),
                      "mix_tree_kernel", 1),
    }
    n_el = sum(x.numel() for x in xs)
    nbytes = {key: mix_work(n_el * 4, n_el, N_WORKERS, with_u)[1]
              for key, with_u in (("tree", False), ("tree_u", True))}
    out = {}
    for key, (fn, match, per_call) in ways.items():
        dev_ms = device_ms(torch, fn, iters, match, per_call)
        rec = {"kernel": "gossip_mix_rows", "role": "main_tree", "way": key,
               "ms": cuda_ms(torch, fn, iters) if dev_ms is None else dev_ms,
               "ms_from": "events" if dev_ms is None else "profiler"}
        if key != "tree_cold":
            rec["call_ms"] = cuda_ms(torch, fn, iters)
            rec["host_ms"] = host_ms(torch, fn, iters)
        if key in nbytes:
            rec["bytes"] = nbytes[key]
            rec["bound_ms"] = nbytes[key] / rate * 1e3
        out[key] = rec
    for key, plain_key in (("tree", "plain"), ("tree_u", "plain_u")):
        got, want = ways[key][0](), ways[plain_key][0]()
        torch.cuda.synchronize()
        out[key]["max_abs_err"] = max((g - v).abs().max().item() for g, v in zip(got, want))
        check(all(bits_equal(torch, g, v) for g, v in zip(got, want)),
              f"main tree {key}: not bit-equal to the plain version "
              f"(max |err| {out[key]['max_abs_err']})")
    for key, rec in out.items():
        print(f"  main tree {key}: device {rec['ms'] * 1e3:.2f} us ({rec['ms_from']})"
              + (f", per call {rec['call_ms'] * 1e3:.2f} us, host {rec['host_ms'] * 1e3:.2f}"
                 " us" if "call_ms" in rec else "")
              + (f", bound {rec['bound_ms'] * 1e3:.3f} us "
                 f"({rec['bytes'] / (rec['ms'] * 1e-3) / 1e12:.3f} TB/s)"
                 if "bound_ms" in rec else ""))
        records.append(rec)
    return out


def mix_work(nbytes, elements, rows, with_u):
    """(flops, bytes) of one gossip-mix call: ``analysis.cost.mix_work``
    (x, pulled and u read, the output written, the f32 weights read)."""
    from repro_torch.analysis.cost import mix_work as work

    return work(nbytes, elements, rows, with_u)


def attn_work(B, S, Sk, H, Hk, hd, causal, itemsize):
    """(flops, bytes) of one attention call: ``analysis.cost.attention_work``
    (4 * hd flops per visible (query head, key) pair; q, k, v read once,
    the output written once)."""
    from repro_torch.analysis.cost import attention_work

    return attention_work(B, S, Sk, H, Hk, hd, causal, itemsize)


def flash_rate(name, dtype):
    """The peak rate of a flash-attention body's products: bf16 on the
    tensor cores, f32 as 3xTF32 on them."""
    return flop_rate(name, "3xtf32" if dtype == "float32" else dtype)


def phase_flash(torch, rate, name, records):
    """Flash attention against ``ref.reference_attention`` on every case;
    per case the body and key ranges the C entry reported (held to
    ``BODIES`` and ``forward_key_splits``), the profiler's device time, the
    time per call, the plain version's, SDPA's (family, main and large
    shapes) and the bound.  Where the f32 walk is split, the call's
    log-sum-exp against one whole walk's (``FWD_SPLIT_LSE_TOL``).  Appends to
    ``records``; returns the kernel's summary at the main shape."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for role, cases in (("test", ATTN_CASES), ("family", ATTN_FAMILY_CASES),
                        ("main", [ATTN_MAIN]), ("large", [ATTN_LARGE])):
        for case in cases:
            B, S, Sk, H, Hk, hd, causal, dtype = case
            dt = getattr(torch, dtype)
            q = torch.randn((B, S, H, hd), generator=gen, device=dev).to(dt)
            k = torch.randn((B, Sk, Hk, hd), generator=gen, device=dev).to(dt)
            v = torch.randn((B, Sk, Hk, hd), generator=gen, device=dev).to(dt)
            fa.FWD_LAUNCHED.update(body=None, key_splits=None, grid=None, blocks=None)
            got = fa.flash_attention(q, k, v, causal=causal)
            launched = dict(fa.FWD_LAUNCHED)
            want = ref.reference_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            splits = fa.forward_key_splits(dt, B, S, Sk, H, Hk, sms)
            if dt == torch.bfloat16:  # the persistent blocks walking the row tiles
                plan = fa.wgmma_plan(B, S, Sk, H, Hk, hd, causal=causal, sms=sms)
                grid, blocks = plan["fwd_grid"], plan["fwd_blocks"]
            else:
                grid = fa.tf32_plan(B, S, Sk, H, Hk, hd)["fwd_grid"]
                blocks = grid[0] * grid[1] * splits
            asked = {"body": fa.forward_body(dt, hd), "key_splits": splits, "grid": grid,
                     "blocks": blocks}
            check(launched == asked, f"flash_attention {case}: the C entry launched "
                  f"{launched}, not {asked}")
            check(got.shape == q.shape and got.dtype == q.dtype,
                  f"flash_attention {case}: output {tuple(got.shape)} {got.dtype}")
            diff = (got.float() - want.float()).abs()
            tol = ATTN_TOL[dtype]
            excess = (diff - tol * want.float().abs()).max().item()
            err = diff.max().item()
            check(excess <= tol, f"flash_attention {case}: max |err| {err} beyond "
                                 f"atol = rtol = {tol}")
            del want, diff
            flops, nbytes = attn_work(B, S, Sk, H, Hk, hd, causal, q.element_size())
            t_ops = flops / flash_rate(name, dtype) * 1e3
            t_bytes = nbytes / rate * 1e3
            rec = {"kernel": "flash_attention", "role": role, "case": list(case),
                   "dtype": dtype, **launched, "max_abs_err": err,
                   "flops": flops, "bytes": nbytes,
                   "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
            if launched["key_splits"] > 1:
                # The ranges' merged log-sum-exp against one whole walk's.
                split_lse = fa._forward(q, k, v, causal, with_lse=True)[1]
                whole_lse = fa._forward(q, k, v, causal, with_lse=True, key_splits=1)[1]
                torch.cuda.synchronize()
                lse_err = (split_lse - whole_lse).abs().max().item()
                check(lse_err <= FWD_SPLIT_LSE_TOL * (1 + whole_lse.abs().max().item()),
                      f"flash_attention {case}: the split walk's lse differs from the "
                      f"whole walk's by {lse_err}")
                rec["split_lse_err"] = lse_err
                del split_lse, whole_lse
            fns = {"": lambda: fa.flash_attention(q, k, v, causal=causal),
                   "plain_": lambda: ref.reference_attention(q, k, v, causal=causal)}
            if role != "test":
                qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
                fns["library_"] = lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True)
            iters = {"test": 10, "family": 10, "main": 20, "large": 2}[role]
            # A split walk launches the merge kernel after the body.
            per_call = 2 if launched["key_splits"] > 1 else 1
            for key, fn in fns.items():
                call = cuda_ms(torch, fn, iters)
                dev_ms = device_ms(torch, fn, iters, "flash_fwd" if key == "" else None,
                                   per_call=per_call if key == "" else 1)
                rec[key + "ms"] = call if dev_ms is None else dev_ms
                rec[key + "ms_from"] = "events" if dev_ms is None else "profiler"
                rec[key + "call_ms"] = call
            rec.setdefault("library_ms", None)
            records.append(rec)
            out.setdefault(role, []).append(rec)
            print(f"  flash_attention {role} {case} ({rec['body']}, {rec['key_splits']} key "
                  f"ranges): max|err| {err:.3g}, device "
                  f"{rec['ms'] * 1e3:.1f} us ({rec['ms_from']}), per call "
                  f"{rec['call_ms'] * 1e3:.1f} us, plain {rec['plain_ms'] * 1e3:.1f} us, "
                  + (f"sdpa {rec['library_ms'] * 1e3:.1f} us, " if rec["library_ms"] else "")
                  + f"bound {rec['bound_ms'] * 1e3:.2f} us ({rec['bound_by']}); "
                  f"{flops / (rec['ms'] * 1e-3) / 1e12:.2f} TFLOP/s")
            del q, k, v
            torch.cuda.empty_cache()
    large = out["large"][0]
    print(f"  flash_attention large {ATTN_LARGE}: device {large['ms'] * 1e3:.1f} us, sdpa "
          f"{large['library_ms'] * 1e3:.1f} us, bound {large['bound_ms'] * 1e3:.1f} us "
          f"({large['bound_by']}), {large['ms'] / large['bound_ms']:.2f}x the bound")
    main = out["main"][0]
    summary = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:87",
        "max_abs_err": max(r["max_abs_err"] for r in records
                           if r["kernel"] == "flash_attention"),
        # One launch at the LM phase's shape (one layer of the prefill).
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        # The families' shapes (whisper's f32 encoder and cross-attention on
        # the 3xTF32 body, the latter's walk split), one call each.
        "family_shapes": [{k: r[k] for k in ("case", "dtype", "body", "key_splits", "ms",
                                             "plain_ms", "bound_ms", "bound_by", "library_ms",
                                             "max_abs_err")}
                          for r in out["family"]],
    }
    print(f"kernel flash_attention: max|err| {summary['max_abs_err']:.3g}, main-path "
          f"launch {summary['ms'] * 1e3:.1f} us on the device (plain "
          f"{summary['plain_ms'] * 1e3:.1f} us, sdpa {summary['library_ms'] * 1e3:.1f} "
          f"us, bound {summary['bound_ms'] * 1e3:.2f} us, {summary['bound_by']})")
    return summary


def rwkv_work(B, S, H, N, chunk, itemsize, w_itemsize, state_in):
    """(flops, bytes) of one WKV call in the kernel's chunk form:
    ``analysis.cost.rwkv_work``."""
    from repro_torch.analysis.cost import rwkv_work as work

    return work(B, S, H, N, itemsize, w_itemsize, state_in, chunk=chunk)


def strong_decays(torch, w, how, gen):
    """Decays below the Pallas wrapper's clamp (log w < -75/16 a step), in
    w's shape (B, S, H, N) and dtype: ``"1e-30"`` everywhere; ``"-5"`` or
    ``"-8"`` a constant log decay times U(0.9, 1.1); ``"straddle"`` keeps
    ``w`` with the first half of the columns of every other 16-token
    sub-chunk at log w = -8."""
    if how == "1e-30":
        return torch.full_like(w, 1e-30)
    if how in ("-5", "-8"):
        jitter = 0.9 + 0.2 * torch.rand(w.shape, generator=gen, device=w.device)
        return torch.exp(float(how) * jitter).to(w.dtype)
    out = w.clone()
    S, N = w.shape[1], w.shape[3]
    for t0 in range(0, S, 32):
        out[:, t0:t0 + 16, :, :N // 2] = math.exp(-8.0)
    return out


def phase_rwkv(torch, rate, name, records):
    """The WKV kernel against ``ref.reference_rwkv_state`` on every case, y
    and the final state; per case the profiler's device time, the time per
    call, the plain version's (fewer repetitions: it is a loop over tokens)
    and the bound.  Appends to ``records``; returns the kernel's summary at
    the main shape."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv_scan as rs

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    cases = ([("test", c, None) for c in RWKV_CASES]
             + [("extreme", c, how) for c, how in RWKV_EXTREME]
             + [("state", c, None) for c in RWKV_STATE]
             + [("main", RWKV_MAIN, None), ("main_f32", RWKV_MAIN_F32, None),
                ("main_w8", RWKV_MAIN_W8, "-8"), ("large", RWKV_LARGE, None)])
    out = {}
    for role, case, how in cases:
        B, S, H, N, chunk, dtype = case
        dt, wdt = (getattr(torch, d) for d in RWKV_DTYPES[dtype])
        shape = (B, S, H, N)
        r = (torch.randn(shape, generator=gen, device=dev) * 0.5).to(dt)
        k = (torch.randn(shape, generator=gen, device=dev) * 0.5).to(dt)
        v = torch.randn(shape, generator=gen, device=dev).to(dt)
        w = torch.sigmoid(torch.randn(shape, generator=gen, device=dev) + 2.0).to(wdt)
        u = torch.randn((H, N), generator=gen, device=dev) * 0.1
        if how is not None:
            w = strong_decays(torch, w, how, gen)
        s0 = {"state": torch.randn((B, H, N, N), generator=gen, device=dev),
              "extreme": torch.randn((B, H, N, N), generator=gen, device=dev),
              "main": torch.zeros((B, H, N, N), device=dev),
              "main_f32": torch.zeros((B, H, N, N), device=dev),
              "main_w8": torch.zeros((B, H, N, N), device=dev)}.get(role)
        got, got_s = rs.rwkv_scan(r, k, v, w, u, chunk=chunk, state=s0)
        want, want_s = ref.reference_rwkv_state(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        check(got.shape == r.shape and got.dtype == r.dtype and got_s.shape == (B, H, N, N),
              f"rwkv_scan {case}: output {tuple(got.shape)} {got.dtype}, state "
              f"{tuple(got_s.shape)}")
        err, errs = 0.0, {}
        for what, a, b, tol in (("y", got, want, RWKV_TOL[dtype]),
                                ("state", got_s, want_s, RWKV_STATE_TOL[dtype])):
            diff = (a.float() - b.float()).abs()
            excess = (diff - tol * b.float().abs()).max().item()
            check(excess <= tol, f"rwkv_scan {case} ({role}, decays {how or 'sigmoid'}): "
                                 f"{what} max |err| {diff.max().item()} beyond atol = "
                                 f"rtol = {tol}")
            errs[what] = diff.max().item()
            err = max(err, errs[what])
        del want, want_s
        flops, nbytes = rwkv_work(B, S, H, N, chunk, r.element_size(), w.element_size(),
                                  s0 is not None)
        # The WKV arithmetic is f32 whatever the operands' dtype; its products
        # can run f32-accurate on the tensor cores (3xTF32), as the kernel's do.
        t_ops = flops / flop_rate(name, "3xtf32") * 1e3
        t_bytes = nbytes / rate * 1e3
        rec = {"kernel": "rwkv_scan", "role": role, "case": list(case), "dtype": dtype,
               "decays": how or "sigmoid",
               "max_abs_err": err, "max_abs_err_y": errs["y"],
               "max_abs_err_state": errs["state"], "flops": flops, "bytes": nbytes,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "library_ms": None}
        timings = {
            "": (lambda: rs.rwkv_scan(r, k, v, w, u, chunk=chunk, state=s0),
                 {"test": 10, "extreme": 10, "state": 10, "main": 20, "main_f32": 20,
                  "main_w8": 20, "large": 3}[role],
                 {}),
            "plain_": (lambda: ref.reference_rwkv_state(r, k, v, w, u, s0), 1,
                       {"reps": 1 if role == "large" else 3, "warmup": 1}),
        }
        for key, (fn, iters, kw) in timings.items():
            call = cuda_ms(torch, fn, iters, **kw)
            dev_ms = device_ms(torch, fn, iters, "rwkv_scan" if key == "" else None)
            rec[key + "ms"] = call if dev_ms is None else dev_ms
            rec[key + "ms_from"] = "events" if dev_ms is None else "profiler"
            rec[key + "call_ms"] = call
        records.append(rec)
        out.setdefault(role, []).append(rec)
        print(f"  rwkv_scan {role} {case} decays {rec['decays']}: max|err| y "
              f"{errs['y']:.3g}, state "
              f"{errs['state']:.3g}, device "
              f"{rec['ms'] * 1e3:.1f} us ({rec['ms_from']}), per call "
              f"{rec['call_ms'] * 1e3:.1f} us, plain {rec['plain_ms'] * 1e3:.1f} us on the "
              f"device, {rec['plain_call_ms'] * 1e3:.1f} us per call, bound "
              f"{rec['bound_ms'] * 1e3:.2f} us ({rec['bound_by']}); "
              f"{nbytes / (rec['ms'] * 1e-3) / 1e12:.3f} TB/s, "
              f"{flops / (rec['ms'] * 1e-3) / 1e12:.2f} TFLOP/s")
        del r, k, v, w, u, s0, got, got_s
        torch.cuda.empty_cache()
    main = out["main"][0]
    f32 = out["main_f32"][0]
    w8 = out["main_w8"][0]
    summary = {
        "name": "rwkv_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv_scan.cu",
        "replaces": "src/repro/kernels/rwkv_scan.py:94",
        "max_abs_err": max(r["max_abs_err"] for r in records if r["kernel"] == "rwkv_scan"),
        # One launch at the ssm phase's shape and dtypes (one layer of the
        # prefill: bf16 r/k/v, f32 decays).
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None,
    }
    print(f"kernel rwkv_scan: max|err| {summary['max_abs_err']:.3g}, main-path launch "
          f"(bf16 r/k/v, f32 w) {summary['ms'] * 1e3:.1f} us on the device (plain "
          f"{summary['plain_ms'] * 1e3:.1f} us on the device, no one-call library "
          f"equivalent, bound {summary['bound_ms'] * 1e3:.2f} us, {summary['bound_by']}); "
          f"all f32 {f32['ms'] * 1e3:.1f} us (bound {f32['bound_ms'] * 1e3:.2f} us); "
          f"at log w = -8 (pairwise scores) {w8['ms'] * 1e3:.1f} us")
    summary["ms_log_w_minus_8"] = w8["ms"]
    return summary


def sim_setup(n_events, trace, seed=0, algorithm="netmax", engine="batched"):
    from repro_torch.core.nettime import LinkTimeModel, Topology
    from repro_torch.data.partition import uniform_partition
    from repro_torch.data.synthetic import train_eval_split
    from repro_torch.train.simulator import SimConfig

    x, y, ex, ey = train_eval_split(4000, 800, 32, 10, seed=seed)
    parts = uniform_partition(len(y), N_WORKERS, seed=seed)
    topo = Topology(n_workers=N_WORKERS, workers_per_host=4, hosts_per_pod=1)
    link = LinkTimeModel(topo, jitter=0.02, seed=5)
    cfg = SimConfig(algorithm=algorithm, n_workers=N_WORKERS, engine=engine,
                    use_mix_kernel=True, total_events=n_events,
                    monitor_period=0.5, seed=seed, trace=trace)
    return cfg, link, (x, y, parts, ex, ey)


def reset_all_launches():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gossip_mix as tk
    from repro_torch.kernels import rwkv_scan as rs

    tk.reset_launches()
    fa.reset_launches()
    rs.reset_launches()


def read_all_launches():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gossip_mix as tk
    from repro_torch.kernels import rwkv_scan as rs

    return {**tk.LAUNCHES, **fa.LAUNCHES, **rs.LAUNCHES}


def phase_main(torch):
    from repro_torch.train import engine
    from repro_torch.train.simulator import simulate

    cfg, link, (x, y, parts, ex, ey) = sim_setup(3000, trace=False)
    # Host seconds inside Monitor wakes (Algorithm 3's LP sweep), measured by
    # wrapping the engine's one call site for this run only.
    monitor_s = [0.0]
    boundary = engine.monitor_boundary

    def timed_boundary(*args, **kwargs):
        t = time.perf_counter()
        try:
            return boundary(*args, **kwargs)
        finally:
            monitor_s[0] += time.perf_counter() - t

    # zeros_like calls made from the kernels' modules (the mix made one a
    # leaf before it took u as absent); the run must make none.
    from repro_torch.kernels import ops as kops

    zeros_like = torch.zeros_like
    kernels_dir = str(Path(kops.__file__).parent)
    mix_zeros = [0]

    def watched_zeros_like(*args, **kwargs):
        if sys._getframe(1).f_code.co_filename.startswith(kernels_dir):
            mix_zeros[0] += 1
        return zeros_like(*args, **kwargs)

    torch.cuda.synchronize()
    reset_all_launches()
    engine.monitor_boundary = timed_boundary
    torch.zeros_like = watched_zeros_like
    try:
        t0 = time.perf_counter()
        res = simulate(cfg, link, x, y, parts, ex, ey, record_every=500,
                       device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        engine.monitor_boundary = boundary
        torch.zeros_like = zeros_like
    launches = read_all_launches()
    check(res.engine == "batched", f"engine {res.engine}")
    check(res.policy_updates >= 3, f"policy_updates {res.policy_updates} < 3")
    check(all(map(math.isfinite, res.losses)), f"non-finite losses {res.losses}")
    check(res.losses[-1] < res.losses[0], f"loss did not fall: {res.losses}")
    # Every counted cohort runs the cohort body once, and the body mixes the
    # whole MLP tree (one dtype, six leaves) in one launch.
    check(launches["gossip_mix_rows"] == res.cohorts,
          f"gossip_mix_rows launched {launches['gossip_mix_rows']} times for "
          f"{res.cohorts} cohorts (need exactly one per cohort)")
    check(mix_zeros[0] == 0, f"the kernels' modules made {mix_zeros[0]} zeros_like "
                             "tensors on the main path")
    check(launches["rwkv_scan"] == 0,
          f"rwkv_scan launched {launches['rwkv_scan']} times on the simulator's path")
    ev = res.events[-1]
    print(f"main path: {ev} events, {res.cohorts} cohorts, {res.dispatches} "
          f"dispatches, {res.policy_updates} policy updates in {secs:.3f} s: "
          f"{ev / secs:.1f} events/s, {secs / ev * 1e6:.1f} us/event; Monitor "
          f"wakes {monitor_s[0]:.3f} s; losses {[round(v, 4) for v in res.losses]};"
          f" launches {launches}")
    return {"events": ev, "seconds": secs, "events_per_s": ev / secs,
            "us_per_event": secs / ev * 1e6, "cohorts": res.cohorts,
            "dispatches": res.dispatches, "policy_updates": res.policy_updates,
            "monitor_s": monitor_s[0], "losses": res.losses,
            "launches": launches, "mix_zeros_like": mix_zeros[0]}


def phase_profile(torch, main):
    """The main path once more under torch.profiler (device activity only):
    device busy share against the unprofiled run's wall time, and the
    kernels that hold the device longest."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train.simulator import simulate

    cfg, link, (x, y, parts, ex, ey) = sim_setup(3000, trace=False)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        simulate(cfg, link, x, y, parts, ex, ey, record_every=500, device="cuda")
        torch.cuda.synchronize()
    avg = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    device_s = sum(e.self_device_time_total for e in avg) * 1e-6
    mix_s = sum(e.self_device_time_total for e in avg
                if "mix_tree_kernel" in e.key) * 1e-6
    top = [(e.key[:80], e.count, e.self_device_time_total * 1e-3) for e in avg[:8]]
    print(f"main path device time {device_s:.4f} s = {device_s / main['seconds']:.4f} "
          f"of the wall; gossip_mix_rows {mix_s:.4f} s; top kernels (name, count, ms):")
    for row in top:
        print(f"  {row}")
    return {"device_s": device_s, "busy_share": device_s / main["seconds"],
            "mix_rows_device_s": mix_s, "top_kernels": top}


def host_outputs_equal(a, b, what):
    """Fail unless two SimResults' host-side outputs are bit-equal."""
    check(a.engine == b.engine, f"{what}: engines {a.engine} vs {b.engine}")
    check(a.times == b.times and a.events == b.events, f"{what}: times/events differ")
    check(a.comm_time == b.comm_time and a.compute_time == b.compute_time,
          f"{what}: comm/compute time differs")
    check(a.trace_events == b.trace_events, f"{what}: trace_events differ")
    check(a.failed_pulls == b.failed_pulls, f"{what}: failed_pulls differ")
    check((a.cohorts, a.dispatches) == (b.cohorts, b.dispatches),
          f"{what}: cohorts/dispatches {a.cohorts}/{a.dispatches} vs "
          f"{b.cohorts}/{b.dispatches}")
    check(len(a.policy_log) == len(b.policy_log), f"{what}: policy_log lengths differ")
    for (ta, ra, Pa), (tb, rb, Pb) in zip(a.policy_log, b.policy_log):
        check(ta == tb and ra == rb and (Pa == Pb).all(), f"{what}: policy_log differs")


def losses_close(a, b, what):
    """Losses within rtol = atol = 5e-4 (two devices sum f32 matmuls in
    different orders; the engine-parity tests' tolerance); the max diff."""
    diff = max(abs(u - v) for u, v in zip(a.losses, b.losses))
    check(len(a.losses) == len(b.losses)
          and all(abs(u - v) <= 5e-4 + 5e-4 * abs(v) for u, v in zip(a.losses, b.losses)),
          f"{what}: cuda vs cpu losses differ by {diff}: {a.losses} vs {b.losses}")
    return diff


def phase_parity(torch):
    from repro_torch.train.simulator import simulate

    out = {}
    for dev in ("cuda", "cpu"):
        cfg, link, (x, y, parts, ex, ey) = sim_setup(1000, trace=True)
        t0 = time.perf_counter()
        out[dev] = simulate(cfg, link, x, y, parts, ex, ey, record_every=500,
                            device=dev)
        print(f"parity run on {dev}: {time.perf_counter() - t0:.2f} s")
    host_outputs_equal(out["cuda"], out["cpu"], "netmax parity")
    diff = losses_close(out["cuda"], out["cpu"], "netmax parity")
    print(f"parity: host-side outputs bit-equal, max |loss diff| {diff:.3g}")


#: The strategies whose batched cohort step mixes through the gossip-mix
#: kernel (identity delta, gossip variant); the others take the leaf rule.
MIX_KERNEL_ALGOS = ("adpsgd", "adpsgd+mon", "netmax")


def phase_algos(torch):
    """Every registered strategy through ``simulate`` on the card at the
    main path's width (32 workers, MLP [32, 128, 64, 10], 3000 events; 93
    rounds of 32 for the synchronous ones), engine "auto", the mix kernel
    on.  Each must run batched, with finite losses that fall; the gossip
    mix launches once a cohort for the three identity-delta gossip
    strategies and never for the other five; no LM kernel launches.  Then
    the README quickstart's comparison on the simulator's virtual clock
    (not the card's speed): time to 1.3x the worst final loss, and NetMax's
    speedup over allreduce, prague and adpsgd."""
    from repro_torch.algos import get_algorithm, list_algorithms
    from repro_torch.algos.base import Algorithm
    from repro_torch.train.simulator import simulate

    names = list_algorithms()
    check(len(names) == 8, f"registry holds {names}")
    mixers = {n for n in names
              if not get_algorithm(n).synchronous
              and get_algorithm(n).batched_variant == "gossip"
              and type(get_algorithm(n)).delta_transform is Algorithm.delta_transform}
    check(mixers == set(MIX_KERNEL_ALGOS), f"identity-delta gossip strategies {mixers}")
    runs, out = {}, {}
    for name in names:
        cfg, link, (x, y, parts, ex, ey) = sim_setup(3000, trace=False, algorithm=name,
                                                     engine="auto")
        torch.cuda.synchronize()
        reset_all_launches()
        t0 = time.perf_counter()
        res = simulate(cfg, link, x, y, parts, ex, ey, record_every=500, device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_all_launches()
        check(res.engine == "batched", f"{name}: engine {res.engine}")
        check(all(map(math.isfinite, res.losses)), f"{name}: non-finite losses {res.losses}")
        check(res.losses[-1] < res.losses[0], f"{name}: loss did not fall: {res.losses}")
        want_mix = res.cohorts if name in MIX_KERNEL_ALGOS else 0
        check(launches["gossip_mix_rows"] == want_mix and launches["gossip_mix"] == 0,
              f"{name}: gossip mix launched {launches} for {res.cohorts} cohorts (want "
              f"{want_mix} tree launches)")
        check(launches["rwkv_scan"] == 0 and launches["flash_attention"] == 0,
              f"{name}: an LM kernel launched on the simulator's path: {launches}")
        ev = res.events[-1]
        runs[name] = res
        out[name] = {"events": ev, "seconds": secs, "events_per_s": ev / secs,
                     "cohorts": res.cohorts, "dispatches": res.dispatches,
                     "virtual_s": res.times[-1], "comm_s": res.comm_time,
                     "final_loss": res.losses[-1], "launches": launches}
        print(f"algos {name:11s}: {secs:7.3f} s wall, {ev / secs:8.1f} events/s, "
              f"{res.cohorts:4d} cohorts, {res.dispatches:4d} dispatches, virtual "
              f"{res.times[-1]:9.3f} s, comm {res.comm_time:9.3f} s, final loss "
              f"{res.losses[-1]:.4f}, B1 launches {launches['gossip_mix_rows']}")
    target = max(r.losses[-1] for r in runs.values()) * 1.3
    t_nm = runs["netmax"].time_to_loss(target)
    ttl = {n: r.time_to_loss(target) for n, r in runs.items()}
    speedup = {n: ttl[n] / t_nm for n in ("allreduce", "prague", "adpsgd")}
    print(f"algos: simulator virtual clock (not the card's speed), time to loss "
          f"< {target:.4f}: " + ", ".join(f"{n} {t:.3f} s" for n, t in ttl.items()))
    print("algos: NetMax speedup on the virtual clock: "
          + ", ".join(f"over {n} {v:.2f}x" for n, v in speedup.items()))
    return {"runs": out, "target_loss": target, "time_to_loss_virtual_s": ttl,
            "netmax_speedup_virtual": speedup}


#: The strategies this port's round engine, ps-serial fold and top-k delta
#: brought to the card, held card against CPU.
NEW_ALGOS = ("allreduce", "prague", "ps-sync", "ps-async", "netmax-topk")


def phase_algo_parity(torch):
    """The new strategies at 32 workers, 640 events (20 rounds), traced,
    on the card and on the CPU: host-side outputs bit-equal, losses within
    5e-4."""
    from repro_torch.train.simulator import simulate

    diffs = {}
    for name in NEW_ALGOS:
        out = {}
        for dev in ("cuda", "cpu"):
            cfg, link, (x, y, parts, ex, ey) = sim_setup(640, trace=True, algorithm=name,
                                                         engine="auto")
            out[dev] = simulate(cfg, link, x, y, parts, ex, ey, record_every=160,
                                device=dev)
        host_outputs_equal(out["cuda"], out["cpu"], f"{name} parity")
        diffs[name] = losses_close(out["cuda"], out["cpu"], f"{name} parity")
    print("algo parity: host-side outputs bit-equal; max |loss diff| "
          + ", ".join(f"{n} {d:.3g}" for n, d in diffs.items()))
    return diffs


def lm_requests(vocab, n=4, prompt=64, max_new=16, seed=0):
    import numpy as np

    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, vocab, size=prompt).astype(np.int32),
                    max_new=max_new) for i in range(n)]


def phase_lm(torch):
    """LM serving at the full width of tinyllama-1.1b: prefill, capture
    prefill, continuous-batching decode; flash attention launches 22 times
    per forward."""
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine, capture_prefill

    cfg = get_arch(LM_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
           cfg.vocab_size, cfg.dtype) == (22, 2048, 32, 4, 64, 32000, "bfloat16"),
          f"{LM_ARCH} is not the published width: {cfg}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = lm.param_count(cfg)
    B, P, max_seq = 4, 512, 1024
    tokens = torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device=dev,
                           dtype=torch.int32)
    reqs = lm_requests(cfg.vocab_size)
    decode_s = [0.0]

    torch.cuda.synchronize()
    reset_all_launches()
    with torch.inference_mode():
        prefill_s = []
        for _ in range(2):  # the first call warms cuBLAS and the allocator
            t0 = time.perf_counter()
            logits = lm.prefill_logits(params, {"tokens": tokens}, cfg)
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        cap_logits, cache = capture_prefill(cfg, params, tokens, max_seq)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        eng = ServeEngine(cfg, params, batch_capacity=4, max_seq=max_seq)
        step = eng.step

        def timed_step(*args, **kwargs):
            t = time.perf_counter()
            try:
                return step(*args, **kwargs)
            finally:
                decode_s[0] += time.perf_counter() - t

        eng.step = timed_step
        t0 = time.perf_counter()
        done = eng.run(reqs)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    launches = read_all_launches()
    bodies = dict(fa.BODY_LAUNCHES)
    forwards = 3
    check(launches["flash_attention"] == cfg.n_layers * forwards,
          f"flash_attention launched {launches['flash_attention']} times for "
          f"{forwards} forwards of {cfg.n_layers} layers")
    check(bodies == {"bf16_wgmma": cfg.n_layers * forwards, "tf32x3_wgmma": 0,
                     "tf32x3_mma": 0},
          f"flash_attention launches by body {bodies}: every prefill layer must run "
          "the bf16 body")
    check(launches["rwkv_scan"] == 0,
          f"rwkv_scan launched {launches['rwkv_scan']} times on the dense LM path")
    check(tuple(logits.shape) == (B, cfg.vocab_size) and logits.dtype == torch.float32,
          f"prefill logits {tuple(logits.shape)} {logits.dtype}")
    check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
    check(bool(torch.isfinite(cap_logits).all()), "non-finite capture_prefill logits")
    check(torch.equal(cap_logits[:, 0], logits), "capture_prefill logits differ from "
          "prefill_logits on the same tokens")
    check(tuple(cache["k"].shape) == (cfg.n_layers, B, max_seq, cfg.n_kv_heads, cfg.hd),
          f"cache {tuple(cache['k'].shape)}")
    check(bool(cache["k"][:, :, P:].eq(0).all()) and bool(cache["k"][:, :, :P].ne(0).any()),
          "capture_prefill filled the cache beyond the prompt or not at all")
    check(len(done) == len(reqs) and all(len(r.out) == r.max_new for r in done),
          f"ServeEngine.run finished {len(done)} of {len(reqs)} requests")
    check(all(0 <= t < cfg.vocab_size for r in done for t in r.out),
          "a generated token lies outside the vocab")
    gen_tokens = sum(len(r.out) for r in done)
    decode_steps = max(len(r.out) for r in done)
    out = {
        "arch": cfg.name, "params": n_params, "init_s": init_s,
        "prefill_batch": [B, P], "prefill_s": prefill_s,
        "prefill_tokens_per_s": B * P / prefill_s[-1],
        "capture_prefill_s": capture_s, "max_seq": max_seq,
        "serve_requests": len(reqs), "serve_prompt": len(reqs[0].prompt),
        "serve_run_s": run_s, "serve_decode_s": decode_s[0],
        "generated_tokens": gen_tokens, "decode_steps": decode_steps,
        "decode_tokens_per_s": gen_tokens / decode_s[0],
        "launches": launches, "flash_attention_bodies": bodies,
    }
    print(f"lm: {cfg.name} ({n_params / 1e9:.3f} B params, bf16) init {init_s:.2f} s; "
          f"prefill {B}x{P} in {prefill_s[-1] * 1e3:.1f} ms (first "
          f"{prefill_s[0] * 1e3:.1f} ms) = {out['prefill_tokens_per_s']:.0f} tok/s; "
          f"capture_prefill {capture_s:.2f} s; ServeEngine.run {len(reqs)} requests "
          f"in {run_s:.2f} s, {gen_tokens} tokens in {decode_steps} decode steps "
          f"({decode_s[0]:.3f} s) = {out['decode_tokens_per_s']:.1f} tok/s; "
          f"launches {launches}, flash_attention by body {bodies}")
    with torch.inference_mode():
        out["profile"] = lm_profile(torch, cfg, params, tokens, cache, "flash_attention",
                                    "flash_fwd")
    del params, cache, eng
    torch.cuda.empty_cache()
    return out


def lm_profile(torch, cfg, params, tokens, cache, kernel, match, steps=8, batch=None,
               card=None):
    """One prefill (of ``batch``, else of ``tokens``) and ``steps`` decode
    steps (positions after ``tokens``) under torch.profiler, after an
    unprofiled run of each: device busy share of the wall, ``kernel``'s
    share of the device time (device kernels whose name holds ``match``),
    the kernels launched, the device time by kind, and the kernels that hold
    the device longest."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import lm

    B, P = tokens.shape
    batch = {"tokens": tokens} if batch is None else batch

    def prefill():
        lm.prefill_logits(params, batch, cfg)

    def decode():
        for t in range(steps):
            lm.decode_step(params, cache, tokens[:, t], P + t, cfg)

    res = {}
    for name, fn in (("prefill", prefill), (f"decode_{steps}_steps", decode)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        avg = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
        device_s = sum(e.self_device_time_total for e in avg) * 1e-6
        kernel_s = sum(e.self_device_time_total for e in avg if match in e.key) * 1e-6
        by = {}
        for e in avg:
            kind = device_kind(e.key)
            by[kind] = by.get(kind, 0.0) + e.self_device_time_total * 1e-6
        n_kernels = sum(e.count for e in avg if e.self_device_time_total > 0)
        top = [(e.key[:80], e.count, e.self_device_time_total * 1e-3) for e in avg[:6]]
        res[name] = {"wall_s": wall, "device_s": device_s, "busy_share": device_s / wall,
                     f"{kernel}_device_s": kernel_s, "device_kernels": n_kernels,
                     "device_s_by": by, "top_kernels": top}
        print(("" if card is None else f"[{card}] ")
              + f"{cfg.name} profile {name}: wall {wall * 1e3:.2f} ms, device "
              f"{device_s * 1e3:.2f} ms ({device_s / wall:.3f} of the wall) in {n_kernels} "
              f"kernels, {kernel} {kernel_s * 1e3:.2f} ms; device ms by kind "
              f"{({k: round(v * 1e3, 3) for k, v in by.items()})}; top kernels (name, "
              "count, ms):")
        for row in top:
            print(f"  {row}")
    return res


#: Card vs CPU bound on bf16 prefill logits, in units of max |logit|: the two
#: devices round the same bf16 intermediates after sums taken in different
#: orders (cuBLAS vs the CPU's GEMMs; the flash kernel's bf16 P against the
#: reference's f32 softmax), a bf16 step being 2^-8 of a value; the bf16
#: kernel tolerance of tests/test_kernels.py:43, 2e-2, read against the
#: largest logit.
LM_BF16_TOL = 2e-2


def phase_lm_parity(torch):
    """The tinyllama widths at 2 layers, f32: prefill logits on the card
    (flash kernel) and on the CPU (the scan), and the card's decode logits
    at position P-1 after capture_prefill against its prefill logits.  Then
    the same cut in bf16, card (tensor-core body) against CPU."""
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm
    from repro_torch.serve.engine import capture_prefill

    cfg = dataclasses.replace(get_arch(LM_ARCH), n_layers=2, dtype="float32")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, P = 2, 256
    with torch.inference_mode():
        params = lm.init_params(cfg, gen)
        tokens = torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device=dev,
                               dtype=torch.int32)
        on_card = lm.prefill_logits(params, {"tokens": tokens}, cfg)
        cpu_params = _tree_to(params, "cpu")
        t0 = time.perf_counter()
        on_cpu = lm.prefill_logits(cpu_params, {"tokens": tokens.cpu()}, cfg)
        cpu_s = time.perf_counter() - t0
        logits, cache = capture_prefill(cfg, params, tokens, P)
        dec, _ = lm.decode_step(params, cache, tokens[:, P - 1], P - 1, cfg)
        torch.cuda.synchronize()
    scale = on_cpu.abs().max().item()
    d_cpu = (on_card.cpu() - on_cpu).abs().max().item()
    d_dec = (dec - logits[:, 0]).abs().max().item()
    check(d_cpu <= 1e-3 * scale, f"card vs CPU prefill logits differ by {d_cpu} "
                                 f"(max |logit| {scale})")
    check(d_dec <= 1e-3 * scale, f"decode at P-1 vs prefill logits differ by {d_dec} "
                                 f"(max |logit| {scale})")
    print(f"lm parity: 2 layers f32 S={P}: card vs CPU max |diff| {d_cpu:.3g}, decode "
          f"vs prefill {d_dec:.3g}, max |logit| {scale:.3g} (CPU prefill {cpu_s:.2f} s)")
    del params, cpu_params, cache

    cfg16 = dataclasses.replace(get_arch(LM_ARCH), n_layers=2)
    check(cfg16.dtype == "bfloat16", f"{LM_ARCH} serves in {cfg16.dtype}")
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        params = lm.init_params(cfg16, gen)
        n0 = fa.BODY_LAUNCHES["bf16_wgmma"]
        on_card16 = lm.prefill_logits(params, {"tokens": tokens}, cfg16)
        torch.cuda.synchronize()
        tc_launches = fa.BODY_LAUNCHES["bf16_wgmma"] - n0
        on_cpu16 = lm.prefill_logits(_tree_to(params, "cpu"), {"tokens": tokens.cpu()},
                                     cfg16)
    scale16 = on_cpu16.abs().max().item()
    d16 = (on_card16.cpu() - on_cpu16).abs().max().item()
    check(tc_launches == cfg16.n_layers,
          f"bf16 parity prefill ran the bf16 body {tc_launches} times")
    check(bool(torch.isfinite(on_card16).all()), "non-finite bf16 prefill logits")
    check(d16 <= LM_BF16_TOL * scale16, f"bf16 card vs CPU prefill logits differ by {d16} "
                                        f"(max |logit| {scale16})")
    print(f"lm parity: 2 layers bf16 S={P}: card vs CPU max |diff| {d16:.3g}, max |logit| "
          f"{scale16:.3g} ({d16 / scale16:.3g} of it; bound {LM_BF16_TOL})")
    del params
    torch.cuda.empty_cache()
    return {"card_vs_cpu": d_cpu, "decode_vs_prefill": d_dec, "max_logit": scale,
            "bf16_card_vs_cpu": d16, "bf16_max_logit": scale16}


def phase_ssm(torch):
    """LM serving at the full width of rwkv6-7b: prefill, capture prefill,
    continuous-batching decode; the WKV kernel launches 32 times per
    forward and no other kernel launches."""
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import rwkv_scan as rs
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine, capture_prefill

    cfg = get_arch(SSM_ARCH)
    check((cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.vocab_size,
           cfg.rwkv.head_dim, cfg.rwkv.decay_lora, cfg.dtype)
          == ("ssm", 32, 4096, 64, 14336, 65536, 64, 64, "bfloat16"),
          f"{SSM_ARCH} is not the published width: {cfg}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = lm.param_count(cfg)
    B, P, P_cap, max_seq = 4, 512, 128, 64
    tokens = torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device=dev,
                           dtype=torch.int32)
    reqs = lm_requests(cfg.vocab_size, prompt=32)
    decode_s = [0.0]

    torch.cuda.synchronize()
    reset_all_launches()
    with torch.inference_mode():
        prefill_s = []
        for _ in range(2):  # the first call warms cuBLAS and the allocator
            t0 = time.perf_counter()
            logits = lm.prefill_logits(params, {"tokens": tokens}, cfg)
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        cap_logits, cache = capture_prefill(cfg, params, tokens[:, :P_cap], P_cap)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        eng = ServeEngine(cfg, params, batch_capacity=4, max_seq=max_seq)
        step = eng.step

        def timed_step(*args, **kwargs):
            t = time.perf_counter()
            try:
                return step(*args, **kwargs)
            finally:
                decode_s[0] += time.perf_counter() - t

        eng.step = timed_step
        t0 = time.perf_counter()
        done = eng.run(reqs)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    launches = read_all_launches()
    dtypes = dict(rs.DTYPE_LAUNCHES)
    forwards = 3
    check(launches["rwkv_scan"] == cfg.n_layers * forwards,
          f"rwkv_scan launched {launches['rwkv_scan']} times for {forwards} forwards of "
          f"{cfg.n_layers} layers")
    check(dtypes == {"float32": 0, "bfloat16": 0, "mixed": cfg.n_layers * forwards},
          f"rwkv_scan launches by dtypes {dtypes}: every prefill layer must pass its bf16 "
          "r/k/v (and f32 decays) uncast")
    others = {k: n for k, n in launches.items() if k != "rwkv_scan"}
    check(not any(others.values()), f"other kernels launched on the ssm path: {others}")
    check(tuple(logits.shape) == (B, cfg.vocab_size) and logits.dtype == torch.float32,
          f"prefill logits {tuple(logits.shape)} {logits.dtype}")
    check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
    check(bool(torch.isfinite(cap_logits).all()), "non-finite capture_prefill logits")
    H, N = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    st = cache["tm_state"]
    check(tuple(st.shape) == (cfg.n_layers, B, H, N, N) and st.dtype == torch.float32,
          f"captured state {tuple(st.shape)} {st.dtype}")
    check(bool(torch.isfinite(st).all()) and bool(st.ne(0).any()),
          "the captured recurrent state is not finite or is all zero")
    check(len(done) == len(reqs) and all(len(r.out) == r.max_new for r in done),
          f"ServeEngine.run finished {len(done)} of {len(reqs)} requests")
    check(all(0 <= t < cfg.vocab_size for r in done for t in r.out),
          "a generated token lies outside the vocab")
    gen_tokens = sum(len(r.out) for r in done)
    decode_steps = max(len(r.out) for r in done)
    out = {
        "arch": cfg.name, "params": n_params, "init_s": init_s,
        "prefill_batch": [B, P], "prefill_s": prefill_s,
        "prefill_tokens_per_s": B * P / prefill_s[-1],
        "capture_prefill_batch": [B, P_cap], "capture_prefill_s": capture_s,
        "serve_requests": len(reqs), "serve_prompt": len(reqs[0].prompt),
        "serve_run_s": run_s, "serve_decode_s": decode_s[0],
        "generated_tokens": gen_tokens, "decode_steps": decode_steps,
        "decode_tokens_per_s": gen_tokens / decode_s[0],
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "rwkv_scan_dtypes": dtypes,
    }
    print(f"ssm: {cfg.name} ({n_params / 1e9:.3f} B params, bf16) init {init_s:.2f} s; "
          f"prefill {B}x{P} in {prefill_s[-1] * 1e3:.1f} ms (first "
          f"{prefill_s[0] * 1e3:.1f} ms) = {out['prefill_tokens_per_s']:.0f} tok/s; "
          f"capture_prefill {B}x{P_cap} {capture_s:.2f} s; ServeEngine.run {len(reqs)} "
          f"requests in {run_s:.2f} s, {gen_tokens} tokens in {decode_steps} decode steps "
          f"({decode_s[0]:.3f} s) = {out['decode_tokens_per_s']:.1f} tok/s; peak "
          f"{out['peak_memory_gb']:.1f} GB; launches {launches}, rwkv_scan by dtypes "
          f"{dtypes}")
    with torch.inference_mode():
        out["profile"] = lm_profile(torch, cfg, params, tokens, cache, "rwkv_scan",
                                    "rwkv_scan_kernel")
    del params, cache, eng
    torch.cuda.empty_cache()
    return out


def phase_ssm_parity(torch):
    """The rwkv6-7b widths at 2 layers, f32: prefill logits on the card
    (WKV kernel) and on the CPU (the sequential scan), and on the card the
    decode logits of token P-1 after capture_prefill of tokens 0..P-2
    against the prefill logits of tokens 0..P-1.  P = 64: the reference's
    scan takes S <= 64 or a multiple of 64, and both 63 and 64 are.  Twice:
    at random init (w0 = -6, log w near -0.0025 a step), then with w0
    shifted to log 7, so the median log decay is -7, below the Pallas
    wrapper's clamp of -75/16: there most sub-chunks take the kernel's
    pairwise branch, and prefill (kernel) and decode (plain step) must still
    agree."""
    return {"random_init": _ssm_parity_cut(torch, None),
            "log_w_near_minus_7": _ssm_parity_cut(torch, math.log(7.0))}


def _ssm_parity_cut(torch, w0):
    from repro_torch.configs.base import get_arch
    from repro_torch.models import lm
    from repro_torch.serve.engine import capture_prefill

    cfg = dataclasses.replace(get_arch(SSM_ARCH), n_layers=2, dtype="float32")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, S, P = 2, 128, 64
    with torch.inference_mode():
        params = lm.init_params(cfg, gen)
        if w0 is not None:
            params["blocks"]["time_mix"]["w0"].fill_(w0)
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev,
                               dtype=torch.int32)
        on_card = lm.prefill_logits(params, {"tokens": tokens}, cfg)
        cpu_params = _tree_to(params, "cpu")
        t0 = time.perf_counter()
        on_cpu = lm.prefill_logits(cpu_params, {"tokens": tokens.cpu()}, cfg)
        cpu_s = time.perf_counter() - t0
        prefill = lm.prefill_logits(params, {"tokens": tokens[:, :P]}, cfg)
        _, cache = capture_prefill(cfg, params, tokens[:, :P - 1], P)
        dec, _ = lm.decode_step(params, cache, tokens[:, P - 1], P - 1, cfg)
        torch.cuda.synchronize()
    scale = on_cpu.abs().max().item()
    scale_dec = prefill.abs().max().item()
    d_cpu = (on_card.cpu() - on_cpu).abs().max().item()
    d_dec = (dec - prefill).abs().max().item()
    what = "random init" if w0 is None else f"w0 = {w0:.4f}"
    check(all(map(math.isfinite, (scale, scale_dec, d_cpu, d_dec))),
          f"ssm parity ({what}): non-finite logits")
    check(d_cpu <= 1e-3 * scale, f"ssm parity ({what}): card vs CPU prefill logits "
                                 f"differ by {d_cpu} (max |logit| {scale})")
    check(d_dec <= 1e-3 * scale_dec, f"ssm parity ({what}): decode of token {P - 1} vs "
                                     f"prefill logits differ by {d_dec} (max |logit| "
                                     f"{scale_dec})")
    print(f"ssm parity ({what}): 2 layers f32: card vs CPU (S={S}) max |diff| "
          f"{d_cpu:.3g} (max |logit| {scale:.3g}, CPU prefill {cpu_s:.2f} s); decode of "
          f"token {P - 1} vs prefill (S={P}) {d_dec:.3g} (max |logit| {scale_dec:.3g})")
    del params, cpu_params, cache
    torch.cuda.empty_cache()
    return {"card_vs_cpu": d_cpu, "max_logit": scale, "decode_vs_prefill": d_dec,
            "max_logit_decode": scale_dec}


#: The backward kernels against ``ref.reference_attention_backward`` (B, S,
#: Sk, H, Hk, hd, causal): GQA with G = 8, MQA, causal and not, S != Sk both
#: ways, hd 64 and 128 (and 32, 160), ragged lengths, a short query sequence
#: whose dQ key walk is split into 8 ranges, G = 5 and 7 (the bf16 dQ tiles'
#: padding rows); then the training shape, one
#: tinyllama-1.1b layer of a 2 x 512 micro-batch.  Each in f32 and bf16.
ATTN_BWD_CASES = [(1, 128, 128, 4, 4, 64, True), (1, 200, 200, 32, 4, 64, True),
                  (2, 128, 128, 8, 1, 64, True), (2, 100, 37, 8, 2, 128, True),
                  (1, 64, 150, 4, 2, 128, True), (2, 128, 256, 4, 4, 64, False),
                  (1, 96, 96, 4, 2, 32, True), (1, 100, 100, 4, 2, 160, False),
                  (2, 64, 1000, 8, 4, 128, False), (2, 150, 130, 10, 2, 64, True),
                  (1, 90, 200, 7, 1, 160, False)]
ATTN_BWD_MAIN = (2, 512, 512, 32, 4, 64, True)
#: The backward at the shapes phases 30-32 train, in the dtype each runs it:
#: one phi3.5-moe layer of a 1 x 512 micro-batch (32/8 heads of 128, bf16);
#: whisper-small's encoder (4 x 1500 frames, non-causal) and cross-attention
#: (64 x 1500, its dQ key walk split), f32 as C9 promotes them;
#: internvl2-1b's 256 vision + 512 text tokens (14/2 heads of 64, bf16); then
#: llama4's (40/8 heads of 128) and stablelm-12b's (32/8 heads of 160) layers
#: of a 1 x 512 micro-batch in bf16.  bf16 runs on the tensor cores at every
#: head dim, f32 in 3xTF32 likewise.
ATTN_BWD_FAMILY = [((1, 512, 512, 32, 8, 128, True), "bfloat16"),
                   ((4, 1500, 1500, 12, 12, 64, False), "float32"),
                   ((4, 64, 1500, 12, 12, 64, False), "float32"),
                   ((4, 768, 768, 14, 2, 64, True), "bfloat16"),
                   ((1, 512, 512, 40, 8, 128, True), "bfloat16"),
                   ((1, 512, 512, 32, 8, 160, True), "bfloat16")]
#: max |err| of dq, dk and dv against the plain version's max |grad|.
ATTN_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: The part of the backward kernels' names that marks each body, the first
#: that matches.
ATTN_BWD_BODY_MARKS = (("tf32x3_wgmma", "_tf32x3_wgmma_kernel"),
                       ("wgmma", "_wgmma_kernel"),
                       ("tf32x3_wide_mma", "_tf32x3_wide_mma_kernel"))


def bwd_body(dtype: str, hd: int) -> str:
    """The backward body a dtype and head dim run
    (``flash_attention.backward_body``): bf16 on wgmma at every head dim;
    f32 in 3xTF32 on wgmma at hd 32/64, on the 8-warp mma.sync body at hd
    128/160."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    return fa.backward_body(getattr(torch, dtype), hd)


def bwd_launch(dt, B, S, Sk, H, Hk, hd, causal, sms) -> dict:
    """What the backward's C entry should report for a call: the body, the
    dQ grid's key ranges, the dK/dV grid (64 keys a block; bf16's head
    groups of ``wgmma_plan``, f32's one head a block), the dQ grid
    (``wgmma_plan``'s padded folded tiles for bf16, ``tf32_plan``'s folded
    rows for f32) and the kernels launched (``bwd_kernels``)."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    if dt == torch.bfloat16:
        plan = fa.wgmma_plan(B, S, Sk, H, Hk, hd, causal=causal, sms=sms)
    else:
        plan = fa.tf32_plan(B, S, Sk, H, Hk, hd)
    grids = {"dkdv_grid": plan["dkdv_grid"], "dq_grid": plan["dq_grid"]}
    splits = fa.backward_dq_splits(dt, B, S, Sk, H, Hk, hd, sms)
    return {"body": bwd_body("bfloat16" if dt == torch.bfloat16 else "float32", hd),
            "dq_splits": splits, **grids,
            "kernels": fa.bwd_kernels(dt, grids["dkdv_grid"][2], splits, hd)}


def traced_bwd_body(names):
    """The backward body named by the dK/dV and dQ kernels of a trace
    (``None`` when the trace holds neither)."""
    found = [n for n in names if "flash_bwd_dkdv" in n or "flash_bwd_dq" in n]
    if not found:
        return None
    bodies = {next((body for body, mark in ATTN_BWD_BODY_MARKS if mark in n), "unknown")
              for n in found}
    return bodies.pop() if len(bodies) == 1 else "+".join(sorted(bodies))


def attn_bwd_work(B, S, Sk, H, Hk, hd, causal, itemsize):
    """(flops, bytes) of one attention backward:
    ``analysis.cost.attention_bwd_work``."""
    from repro_torch.analysis.cost import attention_bwd_work

    return attention_bwd_work(B, S, Sk, H, Hk, hd, causal, itemsize)


def phase_flash_bwd(torch, rate, name, records):
    """The backward kernels against the plain version's autograd gradient on
    every case, in f32 and bf16 (the families' training shapes in the dtype
    each trains in), and a second call on the same inputs bit-equal to the
    first (no atomics: the gradients are deterministic); per case the device
    time per call (the kernels its C entry reports it launched), the plain
    version's, SDPA's backward (training shapes) and the bound.  Returns the
    summary at the training shape (bf16)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    main = None
    both = ("float32", "bfloat16")
    runs = ([("test", case, both) for case in ATTN_BWD_CASES] + [("main", ATTN_BWD_MAIN, both)]
            + [("family", case, (dtype,)) for case, dtype in ATTN_BWD_FAMILY])
    for role, case, dtypes in runs:
        for dtype in dtypes:
            B, S, Sk, H, Hk, hd, causal = case
            dt = getattr(torch, dtype)
            q, do = (torch.randn((B, S, H, hd), generator=gen, device=dev).to(dt)
                     for _ in range(2))
            k, v = (torch.randn((B, Sk, Hk, hd), generator=gen, device=dev).to(dt)
                    for _ in range(2))
            out, lse = fa._forward(q, k, v, causal, with_lse=True)
            fa.BWD_LAUNCHED.update(body=None, dq_splits=None, dkdv_grid=None, dq_grid=None,
                                   kernels=None)
            got = fa.flash_attention_backward(q, k, v, out, do, lse, causal=causal)
            launched = dict(fa.BWD_LAUNCHED)
            asked = bwd_launch(dt, B, S, Sk, H, Hk, hd, causal, sms)
            check(launched == asked, f"flash_attention_bwd {case} {dtype}: the C entry "
                  f"launched {launched}, not {asked}")
            again = fa.flash_attention_backward(q, k, v, out, do, lse, causal=causal)
            want = ref.reference_attention_backward(q, k, v, do, causal=causal)
            torch.cuda.synchronize()
            errs = {}
            for gname, g, a in zip(("dq", "dk", "dv"), got, again):
                check(torch.equal(g, a), f"flash_attention_bwd {case} {dtype}: {gname} of "
                      "two calls on the same inputs differ")
            del again
            for gname, g, w in zip(("dq", "dk", "dv"), got, want):
                check(g.shape == w.shape and g.dtype == w.dtype,
                      f"flash_attention_bwd {case} {dtype}: {gname} {tuple(g.shape)} "
                      f"{g.dtype}")
                scale = w.float().abs().max().item()
                err = (g.float() - w.float()).abs().max().item()
                check(err <= ATTN_BWD_TOL[dtype] * scale,
                      f"flash_attention_bwd {case} {dtype}: {gname} max |err| {err} "
                      f"beyond {ATTN_BWD_TOL[dtype]} x max |grad| {scale}")
                errs[gname] = err
            del got, want
            flops, nbytes = attn_bwd_work(B, S, Sk, H, Hk, hd, causal, q.element_size())
            t_ops = flops / flash_rate(name, dtype) * 1e3
            t_bytes = nbytes / rate * 1e3
            rec = {"kernel": "flash_attention_bwd", "role": role, "case": list(case),
                   "dtype": dtype, "max_abs_err": max(errs.values()), "errs": errs,
                   "flops": flops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                   "kernels_per_call": launched["kernels"], **launched}
            fns = {"": lambda: fa.flash_attention_backward(q, k, v, out, do, lse,
                                                           causal=causal),
                   "plain_": lambda: ref.reference_attention_backward(q, k, v, do,
                                                                      causal=causal)}
            if role != "test":
                qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                              for t in (q, k, v))
                sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                          enable_gqa=True)
                dot = do.transpose(1, 2).contiguous()
                fns["library_"] = lambda: torch.autograd.grad(
                    sdpa_out, (qt, kt, vt), dot, retain_graph=True)
            iters = {"test": 5, "main": 20, "family": 10}[role]
            traced = []
            for key, fn in fns.items():
                call = cuda_ms(torch, fn, iters)
                dev_ms = device_ms(torch, fn, iters, "flash_bwd" if key == "" else None,
                                   per_call=launched["kernels"] if key == "" else 1,
                                   names=traced if key == "" else None)
                rec[key + "ms"] = call if dev_ms is None else dev_ms
                rec[key + "ms_from"] = "events" if dev_ms is None else "profiler"
                rec[key + "call_ms"] = call
            rec.setdefault("library_ms", None)
            # The body again, from the names of the kernels the profiler traced.
            rec["traced_body"] = traced_bwd_body(traced)
            check(rec["traced_body"] in (None, rec["body"]),
                  f"flash_attention_bwd {case} {dtype}: the trace ran {sorted(set(traced))}, "
                  f"not the {rec['body']} body the C entry reported")
            records.append(rec)
            print(f"  flash_attention_bwd {role} {case} {dtype} ({rec['body']}, traced "
                  f"{rec['traced_body']}; {rec['dq_splits']} key ranges): max|err| "
                  f"{rec['max_abs_err']:.3g}, device {rec['ms'] * 1e3:.1f} us "
                  f"({rec['ms_from']}), per call {rec['call_ms'] * 1e3:.1f} us, plain "
                  f"{rec['plain_ms'] * 1e3:.1f} us, "
                  + (f"sdpa bwd {rec['library_ms'] * 1e3:.1f} us, "
                     if rec["library_ms"] else "")
                  + f"bound {rec['bound_ms'] * 1e3:.2f} us ({rec['bound_by']}); "
                  f"{flops / (rec['ms'] * 1e-3) / 1e12:.2f} TFLOP/s")
            if role == "main" and dtype == "bfloat16":
                main = rec
            del q, k, v, do, out, lse
            fns.clear()
            torch.cuda.empty_cache()
    summary = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        # The gradient of B3 (src/repro/kernels/flash_attention.py:87), which the
        # JAX package takes through XLA's autodiff of its attention scan.
        "replaces": "src/repro/kernels/flash_attention.py:87",
        "max_abs_err": max(r["max_abs_err"] for r in records
                           if r["kernel"] == "flash_attention_bwd"),
        # One backward call at the training shape (all its kernels).
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "kernels_per_call": main["kernels"],
        # The families' shapes: phases 30-32's, llama4's, stablelm-12b's (one
        # call each, as above), with the body and the dQ key ranges the C
        # entry reported, and the body the trace's kernel names show.
        "family_shapes": [{k: r[k] for k in ("case", "dtype", "body", "traced_body",
                                             "dq_splits", "ms",
                                             "plain_ms", "bound_ms", "bound_by", "library_ms",
                                             "max_abs_err")}
                          for r in records
                          if r["kernel"] == "flash_attention_bwd" and r["role"] == "family"],
    }
    print(f"kernel flash_attention_bwd: max|err| {summary['max_abs_err']:.3g}, training "
          f"shape {summary['ms'] * 1e3:.1f} us a call on the device (plain "
          f"{summary['plain_ms'] * 1e3:.1f} us, sdpa bwd {summary['library_ms'] * 1e3:.1f} "
          f"us, bound {summary['bound_ms'] * 1e3:.2f} us, {summary['bound_by']})")
    return summary


def rwkv_bwd_work(B, S, H, N, itemsize, w_itemsize, state_in, dstate_in, dstate0):
    """(flops, bytes) of one WKV backward: ``analysis.cost.rwkv_bwd_work``."""
    from repro_torch.analysis.cost import rwkv_bwd_work as work

    return work(B, S, H, N, itemsize, w_itemsize, state_in, dstate_in, dstate0)


def phase_rwkv_bwd(torch, rate, name, records):
    """Phase 27: the WKV backward kernel against ``ref.reference_rwkv_backward``
    and against torch autograd through ``ref.reference_rwkv_state`` on every
    case of RWKV_BWD_CASES and at RWKV_BWD_MAIN: each gradient in its operand's
    dtype within RWKV_BWD_TOL of its max |.|; repeated calls bit-equal; per
    case the profiler's device time and the bound (operations at the 3xTF32
    rate, as the forward's; the same work at the f32 FMA rate is printed
    beside it), at the training shape also the plain version's time.  The
    grids the C entry reports (``rwkv_scan.BWD_LAUNCHED``) are held to the
    range plan, a check that the entry launched what the plan asked; the
    kernels that ran are observed in the profiler's trace.  Appends to
    ``records``; returns the kernel's summary at the training shape."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv_scan as rs

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(27)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    main = None
    for role, case in ([("test", c) for c in RWKV_BWD_CASES] + [("main", RWKV_BWD_MAIN)]):
        B, S, H, N, dtype, how, with_state, with_dstate = case
        dt, wdt = (getattr(torch, d) for d in RWKV_DTYPES[dtype])
        shape = (B, S, H, N)
        r = (torch.randn(shape, generator=gen, device=dev) * 0.5).to(dt)
        k = (torch.randn(shape, generator=gen, device=dev) * 0.5).to(dt)
        v = torch.randn(shape, generator=gen, device=dev).to(dt)
        w = torch.sigmoid(torch.randn(shape, generator=gen, device=dev) + 2.0).to(wdt)
        u = torch.randn((H, N), generator=gen, device=dev) * 0.1
        if how is not None:
            w = strong_decays(torch, w, how, gen)
        dy = torch.randn(shape, generator=gen, device=dev).to(dt)
        s0 = (torch.randn((B, H, N, N), generator=gen, device=dev) * 0.3
              if with_state else None)
        ds = torch.randn((B, H, N, N), generator=gen, device=dev) if with_dstate else None

        def kernel():
            return rs.rwkv_scan_backward(r, k, v, w, u, s0, dy, ds,
                                         with_dstate0=s0 is not None)

        rs.BWD_LAUNCHED.update(range_len=None, ranges=None, blocks=None, bound_blocks=None,
                               kernels=None)
        got = kernel()
        launched = dict(rs.BWD_LAUNCHED)
        L = rs.bwd_range_len(B, S, H, sms)
        n_ranges = -(-S // L)
        asked = {"range_len": L, "ranges": n_ranges, "blocks": B * H * n_ranges,
                 "bound_blocks": B * H * (2 if n_ranges > 1 else 1) if S > rs.BWD_SUB else 0,
                 "kernels": rs.BWD_KERNELS[0 if S > rs.BWD_SUB else 1:]}
        check(launched == asked, f"rwkv_scan_bwd {case}: the C entry launched {launched}, "
              f"not the range plan's {asked}")
        check(role != "main" or launched["blocks"] >= sms,
              f"rwkv_scan_bwd {case}: {launched['blocks']} range blocks for {sms} SMs")
        want = ref.reference_rwkv_backward(r, k, v, w, u, s0, dy, ds)
        leaves = [t.clone().requires_grad_() for t in (r, k, v, w, u)]
        s0l = None if s0 is None else s0.clone().requires_grad_()
        with torch.enable_grad():
            y, final = ref.reference_rwkv_state(*leaves, s0l)
            outs, cots = ([y], [dy]) if ds is None else ([y, final], [dy, ds])
            auto = torch.autograd.grad(outs, leaves + ([] if s0l is None else [s0l]), cots)
        del y, final, leaves, s0l
        again = kernel()
        torch.cuda.synchronize()
        what = f"rwkv_scan_bwd {case}"
        check([t.dtype for t in got[:4]] == [dt] * 3 + [wdt] and got[4].dtype == torch.float32
              and (got[5] is None) == (s0 is None),
              f"{what}: gradient dtypes {[None if t is None else t.dtype for t in got]}")
        check(all(torch.equal(a, b) for a, b in zip(got, again) if a is not None),
              f"{what}: two calls on the same inputs differ")
        errs, abs_errs = {}, {}
        tol = RWKV_BWD_TOL[dtype]
        for oracle, plain in (("reverse recurrence", want), ("autograd", auto)):
            for gname, g, pl in zip(("dr", "dk", "dv", "dw", "du", "dstate0"), got, plain):
                if g is None:
                    continue
                scale = pl.float().abs().max().item()
                err = (g.float() - pl.float()).abs().max().item()
                check(math.isfinite(err) and err <= tol * scale,
                      f"{what} (decays {how or 'sigmoid'}): {gname} max |err| {err} against "
                      f"the {oracle} beyond {tol} x max |grad| {scale}")
                errs[gname] = max(errs.get(gname, 0.0), err / max(scale, 1e-30))
                abs_errs[gname] = max(abs_errs.get(gname, 0.0), err)
        del got, again, want, auto
        flops, nbytes = rwkv_bwd_work(B, S, H, N, r.element_size(), w.element_size(),
                                      with_state, with_dstate, with_state)
        t_ops = flops / flop_rate(name, "3xtf32") * 1e3
        t_bytes = nbytes / rate * 1e3
        rec = {"kernel": "rwkv_scan_bwd", "role": role, "case": list(case), "dtype": dtype,
               "decays": how or "sigmoid", "max_abs_err": max(abs_errs.values()),
               "max_rel_err": max(errs.values()), "max_rel_err_by_grad": errs,
               "flops": flops, "bytes": nbytes,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "bytes_bound_ms": t_bytes,
               "fma_ops_bound_ms": flops / flop_rate(name, "float32") * 1e3,
               "library_ms": None, **launched}
        iters = {"test": 5, "main": 20}[role]
        call = cuda_ms(torch, kernel, iters)
        traced = []
        dev_ms = device_ms(torch, kernel, iters, "rwkv_scan_bwd",
                           per_call=len(launched["kernels"]), names=traced)
        rec.update(ms=call if dev_ms is None else dev_ms,
                   ms_from="events" if dev_ms is None else "profiler", call_ms=call)
        # The kernels again, from the names the profiler traced.
        rec["traced_kernels"] = sorted({kn for kn in rs.BWD_KERNELS
                                        if any(kn in t for t in traced)})
        check(set(rec["traced_kernels"]) <= set(launched["kernels"])
              and all(any(kn in t for kn in rs.BWD_KERNELS) for t in traced),
              f"rwkv_scan_bwd {case}: the trace ran {sorted(set(traced))}, not the "
              f"kernels {launched['kernels']} the C entry reported")
        if role == "main":
            def plain():
                return ref.reference_rwkv_backward(r, k, v, w, u, s0, dy, ds)

            pcall = cuda_ms(torch, plain, 1, reps=3, warmup=1)
            pdev = device_ms(torch, plain, 1)
            rec.update(plain_ms=pcall if pdev is None else pdev,
                       plain_ms_from="events" if pdev is None else "profiler",
                       plain_call_ms=pcall)
            main = rec
        records.append(rec)
        print(f"  rwkv_scan_bwd {role} {case} ({launched['ranges']} ranges of "
              f"{launched['range_len']}, {launched['blocks']} blocks, "
              f"{len(launched['kernels'])} kernels): max rel err "
              f"{({g: float(f'{e:.3g}') for g, e in errs.items()})}, device "
              f"{rec['ms'] * 1e3:.1f} us ({rec['ms_from']}), per call "
              f"{rec['call_ms'] * 1e3:.1f} us"
              + (f", plain {rec['plain_ms'] * 1e3:.1f} us ({rec['plain_ms_from']})"
                 if role == "main" else "")
              + f", bound {rec['bound_ms'] * 1e3:.2f} us ({rec['bound_by']}; bytes "
              f"{t_bytes * 1e3:.2f} us, operations {t_ops * 1e3:.2f} us at 3xTF32, "
              f"{rec['fma_ops_bound_ms'] * 1e3:.2f} us at the f32 FMA rate); "
              f"{flops / (rec['ms'] * 1e-3) / 1e12:.2f} TFLOP/s, "
              f"{nbytes / (rec['ms'] * 1e-3) / 1e12:.3f} TB/s")
        del r, k, v, w, u, dy, s0, ds
        torch.cuda.empty_cache()
    summary = {
        "name": "rwkv_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv_scan_bwd.cu",
        # The gradient of B4 (src/repro/kernels/rwkv_scan.py:94), which the JAX
        # package takes through XLA's autodiff of its model's scan.
        "replaces": "src/repro/kernels/rwkv_scan.py:94",
        "max_abs_err": max(r["max_abs_err"] for r in records
                           if r["kernel"] == "rwkv_scan_bwd"),
        "max_rel_err": max(r["max_rel_err"] for r in records
                           if r["kernel"] == "rwkv_scan_bwd"),
        # One call at the training shape (bf16 r/k/v/dy, f32 decays).
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "bytes_bound_ms": main["bytes_bound_ms"],
        "fma_ops_bound_ms": main["fma_ops_bound_ms"], "library_ms": None,
        # The range plan at the training shape, as the C entry reported it.
        "range_len": main["range_len"], "ranges": main["ranges"], "blocks": main["blocks"],
        "kernels_per_call": len(main["kernels"]),
    }
    print(f"kernel rwkv_scan_bwd: max |err| {summary['max_abs_err']:.3g} ("
          f"{summary['max_rel_err']:.3g} of max |grad|), "
          f"training shape {summary['ms'] * 1e3:.1f} us a call on the device (plain "
          f"{summary['plain_ms'] * 1e3:.1f} us, no one-call library equivalent, bound "
          f"{summary['bound_ms'] * 1e3:.2f} us, {summary['bound_by']})")
    return summary


#: The training phase: tinyllama-1.1b at its published widths, cut to 8 of
#: its 22 layers (all 22 need ~88 GB at M = 4 with f32 momenta), M = 4
#: workers, 4 sequences of 512 tokens a worker in 2 micro-batches.
TRAIN_LAYERS = 8
TRAIN_WORKERS = 4
TRAIN_SEQ = 512
TRAIN_BATCH = 4
TRAIN_ROUNDS = 12
TRAIN_MONITOR_EVERY = 4
TRAIN_LR = 0.02
#: Profiled rounds at the end (for the device's busy share).
TRAIN_PROFILED = 2


def mix_groups(params) -> int:
    """Tree launches of the gossip mix a round: one per dtype group of up to
    ``MAX_LEAVES`` leaves (tinyllama's tree is all bf16; rwkv6-7b's keeps u
    and w0 in f32, an MoE its router)."""
    from repro_torch.kernels import gossip_mix as tk
    from repro_torch.tree import tree_leaves

    return sum(-(-n // tk.MAX_LEAVES) for n in collections.Counter(
        leaf.dtype for leaf in tree_leaves(params) if leaf.numel()).values())


def run_train_loop(torch, cfg, label, workers=TRAIN_WORKERS, batch=TRAIN_BATCH,
                   seq=TRAIN_SEQ, rounds=TRAIN_ROUNDS, make_loop=None):
    """The rounds of phases 13, 28 and 30-32: ``launch.train.TrainLoop`` at
    ``cfg`` (``workers`` workers, ``batch`` sequences of ``seq`` text tokens a
    worker), or the loop ``make_loop()`` builds with the same ``params``,
    ``step_cfg`` and ``round(r)`` (``SpecsLoop``), ``rounds`` rounds, the last
    TRAIN_PROFILED of them profiled.  The launch counters are zeroed just
    before the rounds and read just after; the first round's tree mix is
    held bit for bit against its plain version on the same tree.  Returns
    the measurements; the phases check their own launches."""
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.train import TrainLoop
    from repro_torch.tree import tree_flatten, tree_leaves
    from torch.profiler import ProfilerActivity, profile

    # The serving phases wrap ServeEngine.step in a closure over the engine's
    # own method, a reference cycle: collect it, or their weights (rwkv6-7b's
    # 15 GB) count in this phase's peak.
    held_gb = free_card(torch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if make_loop is None:
        loop = TrainLoop(cfg, workers=workers, seq=seq, batch_per_worker=batch,
                         lr=TRAIN_LR, algo="netmax", gossip="gather",
                         monitor_every=TRAIN_MONITOR_EVERY, device="cuda")
    else:
        loop = make_loop()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(loop.step_cfg.use_gossip_mix_kernel and loop.step_cfg.gossip_mode == "gather",
          f"{label}: the launcher's step config {loop.step_cfg}")
    n_params = sum(leaf.numel() for leaf in tree_leaves(loop.params))

    # The first round's tree mix, held bit for bit against its plain version
    # on the same tree (the plain version launches nothing).
    mix_tree = ops.gossip_mix_tree
    mix_check = {}

    def checked_mix(x_half, pulled, weights):
        out = mix_tree(x_half, pulled, weights)
        if not mix_check:
            xs, _ = tree_flatten(x_half)
            bad = [i for i, (x, p, o) in enumerate(zip(xs, tree_leaves(pulled),
                                                      tree_leaves(out)))
                   if not bits_equal(torch, o, ref.reference_gossip_mix_rows(x, None, p,
                                                                             weights))]
            mix_check.update(leaves=len(xs), bad=bad,
                             elements=sum(x.numel() for x in xs))
        return out

    losses, round_s, round_peak = [], [], []
    torch.cuda.synchronize()
    reset_all_launches()
    ops.gossip_mix_tree = checked_mix
    try:
        for r in range(rounds - TRAIN_PROFILED):
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            m = loop.round(r)
            losses.append(m["loss_per_worker"].tolist())
            torch.cuda.synchronize()
            round_s.append(time.perf_counter() - t)
            round_peak.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for r in range(rounds - TRAIN_PROFILED, rounds):
                m = loop.round(r)
                losses.append(m["loss_per_worker"].tolist())
            torch.cuda.synchronize()
            profiled_s = time.perf_counter() - t
    finally:
        ops.gossip_mix_tree = mix_tree
    launches = read_all_launches()
    round_peak.append(torch.cuda.max_memory_allocated())  # the profiled rounds
    # The first round's peak holds the mix check's plain version too.
    peak = max(round_peak[1:])
    check(all(math.isfinite(x) for row in losses for x in row),
          f"{label}: non-finite losses {losses}")
    check(mix_check.get("leaves") and not mix_check["bad"],
          f"{label}: the first round's gossip mix differs from its plain version at leaves "
          f"{mix_check.get('bad')} of {mix_check.get('leaves')}")
    groups = mix_groups(loop.params)
    check(launches["gossip_mix_rows"] == groups * rounds,
          f"{label}: gossip_mix_rows launched {launches['gossip_mix_rows']} times in "
          f"{rounds} rounds ({groups} tree launches a round, one a dtype group)")
    avg = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    device_s = sum(e.self_device_time_total for e in avg) * 1e-6
    by = {}
    for e in avg:
        kind = device_kind(e.key)
        by[kind] = by.get(kind, 0.0) + e.self_device_time_total * 1e-6
    top = [(e.key[:80], e.count, e.self_device_time_total * 1e-3) for e in avg[:10]]
    steady = round_s[1:]
    tokens = workers * batch * seq
    out = {
        "arch": cfg.name, "layers": cfg.n_layers, "workers": workers,
        "seq": seq, "batch_per_worker": batch,
        "microbatches": cfg.microbatches, "params_stacked": n_params, "init_s": init_s,
        "held_before_gb": held_gb,
        "round_s": round_s, "round_ms_median": statistics.median(steady) * 1e3,
        "round_ms_mean": statistics.mean(steady) * 1e3,
        "tokens_per_round": tokens,
        "tokens_per_s": tokens / statistics.median(steady),
        "first_round_s": round_s[0], "peak_memory_bytes": peak,
        "round_peak_memory_bytes": round_peak,
        "losses": losses, "launches": launches,
        "launches_per_round": {k: v / rounds for k, v in launches.items()},
        "mix_check": mix_check, "mix_launches_per_round": groups,
        "profile": {"rounds": TRAIN_PROFILED, "wall_s": profiled_s, "device_s": device_s,
                    "busy_share": device_s / profiled_s, "device_s_by": by,
                    "top_kernels": top},
    }
    print(f"{label}: {cfg.name} widths at {cfg.n_layers} layers, M={workers} "
          f"({n_params / 1e9:.3f} B params stacked, bf16), {batch}x{seq} tokens "
          f"a worker in {cfg.microbatches} micro-batches; init {init_s:.2f} s; first round "
          f"{round_s[0] * 1e3:.1f} ms, then median {out['round_ms_median']:.1f} ms "
          f"(mean {out['round_ms_mean']:.1f}) = {out['tokens_per_s']:.0f} tokens/s; peak "
          f"memory {peak / 1e9:.2f} GB (the first round, with the mix check, "
          f"{round_peak[0] / 1e9:.2f} GB; {held_gb:.2f} GB held before the loop); launches "
          f"a round {out['launches_per_round']}; mix bit-equal on {mix_check['leaves']} "
          f"leaves ({mix_check['elements']} elements)")
    print("  losses (mean over workers) by round: "
          + ", ".join(f"{statistics.mean(row):.4f}" for row in losses))
    print(f"  profile of {TRAIN_PROFILED} rounds: wall {profiled_s * 1e3:.1f} ms, device "
          f"{device_s * 1e3:.1f} ms ({out['profile']['busy_share']:.3f} busy); device ms "
          f"by kind {({k: round(v * 1e3, 2) for k, v in by.items()})}; top (name, count, ms):")
    for row in top:
        print(f"    {row}")
    del loop, prof
    torch.cuda.empty_cache()
    return out


def phase_train(torch):
    """NetMax training at the widths of tinyllama-1.1b through the
    launcher's loop (``launch.train.TrainLoop``): the launch counters are
    zeroed just before the rounds and read just after; losses finite, the
    flash forward and backward and the gossip-mix kernels launched, the
    first round's mix bit-equal to its plain version on the same tree."""
    from repro_torch.configs.base import get_arch

    cfg = dataclasses.replace(get_arch(LM_ARCH), n_layers=TRAIN_LAYERS)
    check((cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff, cfg.vocab_size,
           cfg.dtype, cfg.remat, cfg.microbatches)
          == (2048, 32, 4, 64, 5632, 32000, "bfloat16", True, 2),
          f"{LM_ARCH} is not the published width: {cfg}")
    out = run_train_loop(torch, cfg, "train")
    check_train_launches("train", cfg, out, TRAIN_WORKERS, TRAIN_BATCH, TRAIN_ROUNDS)
    return out


#: Phase 28: rwkv6-7b at its published widths, cut to 1 of its 32 layers
#: (at M = 4 one layer is 3.02 B stacked parameters, two 3.90 B: at phase
#: 13's ~18.6 bytes a parameter ~56 and ~72 GB), the rounds of phase 13.
SSM_TRAIN_LAYERS = 1


def phase_ssm_train(torch):
    """Phase 28: NetMax training at the widths of rwkv6-7b through the
    launcher's loop, as phase 13: a round launches the WKV forward twice
    and its backward once per worker, micro-batch and layer (remat), the
    gossip mix once per dtype group of the tree, nothing else, and runs no
    plain WKV step (the plain recurrence, its backward and the CPU's chunked
    scan are watched for the run and must not be called)."""
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv_scan as rs
    from repro_torch.models import rwkv as rwkv_mod

    full = get_arch(SSM_ARCH)
    cfg = dataclasses.replace(full, n_layers=SSM_TRAIN_LAYERS)
    check((cfg.family, full.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.vocab_size,
           cfg.rwkv.head_dim, cfg.rwkv.decay_lora, cfg.dtype, cfg.remat, cfg.microbatches)
          == ("ssm", 32, 4096, 64, 14336, 65536, 64, 64, "bfloat16", True, 4),
          f"{SSM_ARCH} is not the published width: {cfg}")
    plain_calls = {}
    watched = [(rwkv_mod, "chunked_scan"), (ref, "reference_rwkv_state"),
               (ref, "reference_rwkv_backward")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr in watched]

    def counted(attr, fn):
        def wrapper(*args, **kwargs):
            plain_calls[attr] = plain_calls.get(attr, 0) + 1
            return fn(*args, **kwargs)
        return wrapper

    for mod, attr, fn in saved:
        setattr(mod, attr, counted(attr, fn))
    try:
        out = run_train_loop(torch, cfg, "ssm train")
        dtypes = dict(rs.DTYPE_LAUNCHES)
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    launches = out["launches"]
    per_round = TRAIN_WORKERS * cfg.microbatches * cfg.n_layers
    check(not plain_calls, f"plain WKV steps on the ssm training path: {plain_calls}")
    check(launches["rwkv_scan_bwd"] == per_round * TRAIN_ROUNDS,
          f"rwkv_scan_bwd launched {launches['rwkv_scan_bwd']} times, {per_round} a round "
          "expected")
    check(launches["rwkv_scan"] == 2 * per_round * TRAIN_ROUNDS,
          f"rwkv_scan launched {launches['rwkv_scan']} times, {2 * per_round} a round "
          "expected (remat runs each block's forward twice)")
    check(dtypes["mixed"] == launches["rwkv_scan"],
          f"rwkv_scan launches by dtypes {dtypes}: every layer must pass its bf16 r/k/v "
          "and f32 decays uncast")
    others = {k: n for k, n in launches.items()
              if k not in ("rwkv_scan", "rwkv_scan_bwd", "gossip_mix_rows")}
    check(not any(others.values()), f"other kernels launched on the ssm training path: "
                                    f"{others}")
    out["rwkv_scan_dtypes"] = dtypes
    out["plain_wkv_calls"] = plain_calls
    return out


def device_kind(kernel: str) -> str:
    """The group a traced kernel's time is reported under in the training
    phase's breakdown (cuBLAS's Hopper GEMMs are named ``nvjet_*``)."""
    for kind, keys in (("flash_bwd", ("flash_bwd",)), ("flash_fwd", ("flash_fwd",)),
                       ("wkv_bwd", ("rwkv_scan_bwd",)), ("wkv_fwd", ("rwkv_scan_kernel",)),
                       ("gossip_mix", ("mix_tree_kernel",)),
                       ("gemm", ("nvjet", "gemm", "Gemm", "cutlass", "xmma")),
                       ("copy", ("Memcpy", "Memset", "copy_kernel")),
                       ("elementwise", ("elementwise", "reduce_kernel"))):
        if any(k in kernel for k in keys):
            return kind
    return "other"


#: Card vs CPU bound on the training cut, relative: f32 sums in other orders
#: (1e-4, the trainer's CPU parity bound against JAX); bf16 as LM_BF16_TOL.
TRAIN_PARITY_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def train_parity(torch, cfgs, rounds, label, seq=128):
    """``rounds`` rounds of the trainer on the card and on the CPU from the
    same params and draws, for each dtype -> cut config of ``cfgs``: losses
    and params within TRAIN_PARITY_TOL.  Returns, per dtype, the errors,
    the seconds on each device and the card's kernel launches."""
    import numpy as np

    from repro_torch.core.consensus import sample_round
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.optim import sgd
    from repro_torch.train.trainer import TrainStepConfig, init_stacked, make_train_step
    from repro_torch.tree import tree_leaves, tree_map

    M, lr = 4, TRAIN_LR
    res = {}
    for dtype, cfg in cfgs.items():
        opt = sgd(momentum=0.9, weight_decay=1e-4)
        step = make_train_step(cfg, opt, M, "netmax",
                               TrainStepConfig(use_gossip_mix_kernel=True))
        params, state = init_stacked(cfg, opt, M, torch.Generator().manual_seed(0))
        runs = {d: (tree_map(lambda t: t.to(d), params), tree_map(lambda t: t.to(d), state))
                for d in ("cpu", "cuda")}
        stream = TokenStream(cfg.vocab_size, seq, TRAIN_BATCH, seed=0)
        dmask = np.ones((M, M)) - np.eye(M)
        P = np.where(dmask > 0, 1.0 / (M - 1), 0.0)
        rng = np.random.default_rng(0)
        loss_err, secs = 0.0, {"cpu": 0.0, "cuda": 0.0}
        torch.cuda.synchronize()
        reset_all_launches()
        for r in range(rounds):
            batch = {k: np.stack([stream.batch(w, r)[k] for w in range(M)]).astype(np.int64)
                     for k in ("tokens", "labels")}
            nb, wts = sample_round(rng, P, lr, 0.5 / (2 * lr * (M - 1)), dmask)
            got = {}
            for d, (p, o) in runs.items():
                t = time.perf_counter()
                b = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
                p, o, m = step(p, o, b, {"neighbors": nb, "weights": wts, "lr": lr})
                got[d] = m["loss_per_worker"].cpu()
                secs[d] += time.perf_counter() - t
                runs[d] = (p, o)
            check(bool(torch.isfinite(got["cuda"]).all()), f"non-finite card losses {got}")
            rel = ((got["cuda"] - got["cpu"]).abs() / got["cpu"].abs()).max().item()
            loss_err = max(loss_err, rel)
        launches = read_all_launches()
        param_err = 0.0
        for a, b in zip(tree_leaves(runs["cpu"][0]), tree_leaves(runs["cuda"][0])):
            scale = a.float().abs().max().item()
            param_err = max(param_err,
                            (b.cpu().float() - a.float()).abs().max().item() / max(scale, 1e-30))
        tol = TRAIN_PARITY_TOL[dtype]
        check(loss_err <= tol, f"{label} {dtype}: losses differ by {loss_err} (relative)")
        check(param_err <= tol, f"{label} {dtype}: params differ by {param_err} "
                                "(of each leaf's max)")
        print(f"{label}: {dtype}, {cfg.n_layers} layers hd {cfg.hd}, {rounds} rounds: losses "
              f"within {loss_err:.3g}, params within {param_err:.3g} (relative; bound {tol}); "
              f"CPU {secs['cpu']:.2f} s, card {secs['cuda']:.2f} s; card launches "
              f"{({k: n for k, n in launches.items() if n})}")
        res[dtype] = {"loss_rel_err": loss_err, "param_rel_err": param_err,
                      "cpu_s": secs["cpu"], "card_s": secs["cuda"], "launches": launches}
        del runs
        torch.cuda.empty_cache()
    return res


def phase_train_parity(torch):
    """Three rounds of the trainer on the card and on the CPU from the same
    params and draws, at a cut of tinyllama-1.1b (2 layers, d_model 256,
    4/2 heads of 64, d_ff 512, vocab 512, remat), in f32 and bf16: losses
    and params within TRAIN_PARITY_TOL."""
    from repro_torch.configs.base import get_arch

    cfgs = {dtype: dataclasses.replace(get_arch(LM_ARCH), n_layers=2, d_model=256,
                                       n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512,
                                       vocab_size=512, dtype=dtype)
            for dtype in ("float32", "bfloat16")}
    return train_parity(torch, cfgs, 3, "train parity")


def phase_ssm_train_parity(torch):
    """Phase 29: two rounds of the trainer on the card (the WKV forward and
    backward kernels) and on the CPU (the plain recurrence under autograd)
    from the same params and draws, at a cut of rwkv6-7b (2 layers, d_model
    256, 4 heads of B4's N = 64, d_ff 512, vocab 512, remat, 4
    micro-batches), in f32 and in bf16 with the f32 decays: losses and
    params within TRAIN_PARITY_TOL; the card's backward launched once per
    worker, micro-batch and layer."""
    from repro_torch.configs.base import get_arch

    rounds = 2
    cfgs = {dtype: dataclasses.replace(get_arch(SSM_ARCH), n_layers=2, d_model=256,
                                       n_heads=4, n_kv_heads=4, head_dim=64, d_ff=512,
                                       vocab_size=512, dtype=dtype)
            for dtype in ("float32", "bfloat16")}
    res = train_parity(torch, cfgs, rounds, "ssm train parity")
    for dtype, cfg in cfgs.items():
        calls = rounds * 4 * cfg.microbatches * cfg.n_layers
        got = res[dtype]["launches"]
        check(cfg.rwkv.head_dim == 64 and got["rwkv_scan_bwd"] == calls
              and got["rwkv_scan"] == 2 * calls,
              f"ssm train parity {dtype}: WKV launches {got}, {calls} backward and "
              f"{2 * calls} forward expected")
    return res


# -- the network-dynamics and control-plane layer (phases 15-20) ------------

#: phase 15: bench_scenarios at M = 32 with its small timings (outage of the
#: last cluster over [5, 20) s, dead-link timeout 2 s, Monitor period 3 s);
#: 22,000 events pass t1 + (t1 - t0) = 35 s on the virtual clock (the clock
#: is host numpy, the same on every device).
SCEN_EVENTS = 22000
SCEN_PARITY_EVENTS = 1500


def hetero_times(M, seed=0, slow_factor=10.0):
    """Symmetric U(0.01, 0.05) link times, one link ``slow_factor`` x slower
    (none when ``slow_factor`` is None): the JAX package's serve and storms
    benches' instances (``benchmarks/run.py`` ``hetero_T``)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    T = rng.uniform(0.01, 0.05, size=(M, M))
    T = (T + T.T) / 2
    if slow_factor is not None:
        i, m = rng.choice(M, size=2, replace=False)
        T[i, m] = T[m, i] = T[i, m] * slow_factor
    np.fill_diagonal(T, 0.0)
    return T


def _sim_data(n_train, n_eval, M, seed=0):
    from repro_torch.data.partition import uniform_partition
    from repro_torch.data.synthetic import train_eval_split

    x, y, ex, ey = train_eval_split(n_train, n_eval, 32, 10, seed=seed)
    return x, y, uniform_partition(len(y), M, seed=seed), ex, ey


def _cross_mask(topo, dead_cluster):
    """Links touching ``dead_cluster`` across the WAN (bench_scenarios)."""
    import numpy as np

    cluster = np.array([topo.cluster_of(i) for i in range(topo.n_workers)])
    touch = cluster == dead_cluster
    return (touch[:, None] | touch[None, :]) & (cluster[:, None] != cluster[None, :])


def _first_reroute(res, t0, cross):
    """(time, refreshes) of the first publish at/after ``t0`` with no mass
    on ``cross`` (bench_scenarios' rule); (None, n) when none."""
    n = 0
    for tq, _rho, P in res.policy_log:
        if tq >= t0:
            n += 1
            if float(P[cross].sum()) <= 1e-12:
                return tq, n
    return None, n


def _run_counted(torch, fn):
    """``fn()`` on the card with the launch counters zeroed just before and
    read just after; (result, wall seconds, launches)."""
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, read_all_launches()


def _check_mix_launches(res, launches, what):
    check(launches["gossip_mix_rows"] == res.cohorts,
          f"{what}: gossip_mix_rows launched {launches['gossip_mix_rows']} times for "
          f"{res.cohorts} cohorts (need exactly one per cohort)")
    check(launches["rwkv_scan"] == 0 and launches["flash_attention"] == 0,
          f"{what}: an LM kernel launched on the simulator's path: {launches}")


def phase_scenarios(torch, card):
    """bench_scenarios on the card: netmax, batched engine, the mix kernel,
    through a cluster outage; B1 once a cohort, the dead cluster's
    selection mass at 0 within one Monitor period, events/s; then a cut of
    the run card against CPU."""
    import numpy as np

    from repro_torch.core.nettime import LinkTimeModel, Topology
    from repro_torch.scenarios import presets
    from repro_torch.train.simulator import SimConfig, simulate

    M = N_WORKERS
    topo = Topology.multi_cluster(M)
    dead = topo.n_clusters - 1
    cross = _cross_mask(topo, dead)
    t0, t1, timeout, period = 5.0, 20.0, 2.0, 3.0
    horizon = t1 + (t1 - t0)
    data = _sim_data(4000, 800, M)

    def run(events, dev, trace=False):
        link = LinkTimeModel(topo, jitter=0.02, seed=5,
                             scenario=presets.cluster_outage(dead, t0, t1),
                             dead_link_timeout=timeout)
        cfg = SimConfig(algorithm="netmax", n_workers=M, total_events=events, lr=0.05,
                        batch_size=16, monitor_period=period, seed=0, engine="batched",
                        use_mix_kernel=True, trace=trace)
        return simulate(cfg, link, *data, record_every=max(50, events // 100), device=dev)

    res, secs, launches = _run_counted(torch, lambda: run(SCEN_EVENTS, "cuda"))
    _check_mix_launches(res, launches, "scenarios")
    check(res.times[-1] >= horizon,
          f"scenarios: the virtual clock reached {res.times[-1]:.2f} s < {horizon} s")
    check(res.failed_pulls, "scenarios: the outage failed no pull")
    check(all(map(math.isfinite, res.losses)) and res.losses[-1] < res.losses[0],
          f"scenarios: losses {res.losses}")
    reroute_t, refreshes = _first_reroute(res, t0, cross)
    check(reroute_t is not None and reroute_t - t0 <= period,
          f"scenarios: the dead cluster's selection mass reached 0 at {reroute_t} "
          f"(outage at {t0} s, Monitor period {period} s)")
    ts, ev = np.asarray(res.times), np.asarray(res.events)

    def rate(a, b):
        ea, eb = np.interp([a, b], ts, ev)
        return float((eb - ea) / (b - a))

    vrates = {"pre": rate(0.0, t0), "outage": rate(t0, t1), "post": rate(t1, horizon)}
    n = res.events[-1]
    print(f"[{card}] scenarios: netmax M = {M}, {n} events, {res.cohorts} cohorts, "
          f"virtual {res.times[-1]:.2f} s, {len(res.failed_pulls)} failed pulls, reroute "
          f"{reroute_t - t0:.3f} s after the outage ({refreshes} refresh), events per "
          f"virtual s pre/outage/post {vrates['pre']:.1f}/{vrates['outage']:.1f}/"
          f"{vrates['post']:.1f}; {secs:.3f} s wall on the card = {n / secs:.1f} events/s; "
          f"B1 launches {launches['gossip_mix_rows']}")
    cut = {dev: run(SCEN_PARITY_EVENTS, dev, trace=True) for dev in ("cuda", "cpu")}
    host_outputs_equal(cut["cuda"], cut["cpu"], "scenarios parity")
    diff = losses_close(cut["cuda"], cut["cpu"], "scenarios parity")
    print(f"scenarios parity ({SCEN_PARITY_EVENTS} events, traced): host-side outputs "
          f"bit-equal, max |loss diff| {diff:.3g}")
    return {"events": n, "seconds": secs, "events_per_s": n / secs,
            "cohorts": res.cohorts, "virtual_s": res.times[-1],
            "failed_pulls": len(res.failed_pulls), "reroute_s": reroute_t - t0,
            "events_per_virtual_s": vrates, "launches": launches,
            "parity_loss_diff": diff}


def phase_storms(torch, card):
    """bench_storms' throughput and failover sections on the card, each
    run also on the CPU: host outputs bit-equal, losses within 5e-4."""
    import numpy as np

    from repro_torch.core.nettime import LinkTimeModel, Topology
    from repro_torch.scenarios import presets, storm
    from repro_torch.train.simulator import SimConfig, simulate

    M = 12
    topo = Topology(n_workers=M, workers_per_host=2, hosts_per_pod=2,
                    pods_per_cluster=1)  # 3 clusters of 4
    cluster = np.array([topo.cluster_of(i) for i in range(M)])
    data = _sim_data(3000, 600, M)

    def run(algo, timeline, events, dev, *, timeout, period=1.0, failover=False):
        link = LinkTimeModel(topo, jitter=0.02, seed=5, scenario=timeline(),
                             dead_link_timeout=timeout)
        kw = {}
        if algo == "netmax":
            kw = dict(monitor_period=period, monitor_home_cluster=0,
                      monitor_failover=failover)
        cfg = SimConfig(algorithm=algo, n_workers=M, total_events=events, lr=0.05,
                        seed=3, engine="batched", use_mix_kernel=True, trace=True, **kw)
        return simulate(cfg, link, *data, record_every=max(50, events // 20), device=dev)

    def storm_tl():
        return storm(topo, seed=7, horizon=40.0, intensity=2.0, trigger_cluster=0,
                     trigger_time=0.8)

    out, evps = {}, {}
    t_out = 1.0

    def outage_tl():
        return presets.cluster_outage(0, t_out, 1e9)

    cases = {"netmax": ("netmax", storm_tl, 2000, dict(timeout=0.5, failover=True)),
             "adpsgd": ("adpsgd", storm_tl, 2000, dict(timeout=0.5)),
             "failover": ("netmax", outage_tl, 1200,
                          dict(timeout=0.4, period=0.5, failover=True))}
    runs = {}
    for name, (algo, tl, events, kw) in cases.items():
        res, secs, launches = _run_counted(
            torch, lambda: run(algo, tl, events, "cuda", **kw))
        _check_mix_launches(res, launches, f"storms {name}")
        cpu = run(algo, tl, events, "cpu", **kw)
        host_outputs_equal(res, cpu, f"storms {name} parity")
        check(res.leader_log == cpu.leader_log
              and res.skipped_refreshes == cpu.skipped_refreshes,
              f"storms {name} parity: Monitor failover differs")
        diff = losses_close(res, cpu, f"storms {name} parity")
        check(all(map(math.isfinite, res.losses)), f"storms {name}: losses {res.losses}")
        runs[name] = res
        evps[name] = events / res.times[-1]
        out[name] = {"events": events, "seconds": secs, "events_per_s": events / secs,
                     "virtual_s": res.times[-1], "events_per_virtual_s": evps[name],
                     "failed_pulls": len(res.failed_pulls),
                     "failovers": len(res.leader_log), "cohorts": res.cohorts,
                     "launches": launches, "parity_loss_diff": diff}
        print(f"[{card}] storms {name}: {events} events, virtual {res.times[-1]:.3f} s = "
              f"{evps[name]:.2f} events per virtual s, {len(res.failed_pulls)} failed "
              f"pulls, {len(res.leader_log)} failovers; {secs:.3f} s wall on the card = "
              f"{events / secs:.1f} events/s; B1 launches {launches['gossip_mix_rows']}; "
              f"card vs CPU host outputs bit-equal, max |loss diff| {diff:.3g}")
    check(runs["netmax"].leader_log, "storms: the storm's home-cluster strike elected "
                                     "no standby Monitor")
    # The failover case: a standby is elected, and after the handoff no far-
    # side worker pulls from the dead home cluster (bench_storms' rule).
    fo = runs["failover"]
    check(fo.leader_log, "storms failover: no standby Monitor was elected")
    t_elect = fo.leader_log[0][0]
    late = [t for t, i, m in fo.failed_pulls
            if cluster[i] != 0 and cluster[m] == 0 and t > t_elect + 2 * 0.5 + 0.4]
    reroute_t, refreshes = _first_reroute(fo, t_out, _cross_mask(topo, 0))
    check(reroute_t is not None and not late,
          f"storms failover: reroute at {reroute_t}, {len(late)} dead-cluster pulls "
          "after the handoff")
    ratio = evps["netmax"] / evps["adpsgd"]
    print(f"storms: netmax/adpsgd events per virtual s {ratio:.4f}; failover elected "
          f"cluster {fo.leader_log[0][1]} at {t_elect:.3f} s, rerouted after {refreshes} "
          "refreshes, no dead-cluster pull after the handoff")
    out["netmax_vs_adpsgd_evps"] = ratio
    out["failover"].update(elected_t=t_elect, refreshes_to_reroute=refreshes)
    return out


def phase_serve_chaos(card):
    """bench_storms' serving section on the port's PolicyServer (host
    numpy): a 35%-fault stream all served; a blackout where the breaker
    trips and every request gets the uniform fallback; a probe that closes
    it once the faults clear."""
    import numpy as np

    from repro_torch.scenarios import ChaosInjector
    from repro_torch.serve import PolicyServer

    serve_M = 16
    bases = [hetero_times(serve_M, seed=s, slow_factor=None) for s in range(3)]
    rng = np.random.default_rng(11)
    chaos = ChaosInjector(seed=3, solver_fail_rate=0.35)
    srv = PolicyServer(alpha=0.1, K=6, R=6, quant=0.05, deadline_ms=2000.0,
                       max_retries=2, backoff_ms=1.0, breaker_threshold=3,
                       breaker_probe_every=4, chaos=chaos)
    served = n = 0
    t0 = time.perf_counter()
    for _ in range(6):
        B = bases[int(rng.integers(len(bases)))]
        snapshot = B + rng.uniform(-1e-4, 1e-4, B.shape)
        for _ in range(30):
            n += 1
            if srv.request(snapshot + rng.uniform(-1e-9, 1e-9, B.shape),
                           tenant="stream") is not None:
                served += 1
    wall = time.perf_counter() - t0
    st = srv.stats.snapshot()
    check(served == n and chaos.n_solver_faults > 0,
          f"serve chaos: {served}/{n} served, {chaos.n_solver_faults} faults injected")
    blackout = ChaosInjector(seed=4, solver_fail_rate=1.0)
    srv2 = PolicyServer(alpha=0.1, K=6, R=6, quant=0.05, deadline_ms=2000.0,
                        max_retries=1, backoff_ms=1.0, breaker_threshold=2,
                        breaker_probe_every=3, chaos=blackout)
    dark = 0
    for _ in range(12):
        res = srv2.request(bases[0] + rng.uniform(-1e-4, 1e-4, bases[0].shape),
                           tenant="dark")
        dark += res is not None and not res.ok
    tripped = srv2.stats.n_breaker_trips
    blackout.solver_fail_rate = 0.0
    recovered = None
    for k in range(2 * srv2.breaker_probe_every):
        res = srv2.request(bases[0] + rng.uniform(-1e-4, 1e-4, bases[0].shape),
                           tenant="dark")
        if res is not None and res.ok:
            recovered = k + 1
            break
    check(dark == 12 and tripped >= 1,
          f"serve chaos: blackout {dark}/12 served uniform, {tripped} breaker trips")
    check(recovered is not None and srv2.stats.n_breaker_recoveries >= 1,
          "serve chaos: no probe closed the breaker once the faults cleared")
    print(f"[{card}] serve chaos (host): {served}/{n} served under 35% solver faults "
          f"({chaos.n_solver_faults} injected, {st['n_retries']} retries, "
          f"{st['n_stale_served']} stale, {st['n_uniform_fallbacks']} uniform) in "
          f"{wall:.3f} s, p50 {srv.stats.latency_ms(0.5):.4f} ms, p99 "
          f"{srv.stats.latency_ms(0.99):.4f} ms; blackout 12/12 uniform, breaker "
          f"tripped {tripped}x, closed by a probe after {recovered} requests")
    return {"requests": n, "served": served, "faults": chaos.n_solver_faults,
            "stats": {k: v for k, v in st.items()}, "wall_s": wall,
            "blackout_trips": tripped, "requests_to_recover": recovered}


def phase_trace(torch, card):
    """The trace layer on the card: the fixture's configuration traced on
    the card and the CPU (JSONL bytes equal); bench_trace's netmax run (M =
    8, 3000 events) exported, read back, calibrated and replayed on the
    card (the replay exact); one what-if query."""
    from repro_torch.core.nettime import LinkTimeModel, Topology
    from repro_torch.scenarios import ClusterOutage, Timeline
    from repro_torch.trace import (
        UpgradeLink,
        WhatIf,
        calibrate,
        from_sim_result,
        read_jsonl,
        replay_model,
        write_jsonl,
    )
    from repro_torch.train.simulator import SimConfig, simulate

    M = 8
    out_dir = HERE / "build" / "trace_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    # scripts/make_trace_fixture.py's configuration.
    fix_data = _sim_data(1600, 400, M)
    blobs = {}
    for dev in ("cuda", "cpu"):
        topo = Topology.multi_cluster(M, workers_per_host=2, hosts_per_pod=1,
                                      pods_per_cluster=2)
        link = LinkTimeModel(topo, jitter=0.05, seed=5,
                             scenario=Timeline([ClusterOutage(1, 2.0, 4.0)]),
                             dead_link_timeout=2.0)
        cfg = SimConfig(algorithm="netmax", n_workers=M, total_events=600, lr=0.05,
                        monitor_period=1.5, seed=0, trace=True, use_mix_kernel=True)
        res = simulate(cfg, link, *fix_data, record_every=200, device=dev)
        path = out_dir / f"fixture_{dev}.jsonl"
        write_jsonl(from_sim_result(res, cfg=cfg, link_model=link), path)
        blobs[dev] = path.read_bytes()
    check(blobs["cuda"] == blobs["cpu"],
          "trace: the card's trace at the fixture's configuration differs from the CPU's")
    # bench_trace's configuration.
    topo = Topology(n_workers=M, workers_per_host=4, hosts_per_pod=1)
    data = _sim_data(4000, 800, M)
    events = 3000

    def run(link):
        cfg = SimConfig(algorithm="netmax", n_workers=M, total_events=events, lr=0.01,
                        monitor_period=10.0, seed=0, trace=True, use_mix_kernel=True)
        return simulate(cfg, link, *data, record_every=events // 20, device="cuda"), cfg

    link = LinkTimeModel(topo, jitter=0.02, seed=5, slowdown_range=(2.0, 100.0),
                         slow_interval=120.0)
    (res, cfg), secs, launches = _run_counted(torch, lambda: run(link))
    _check_mix_launches(res, launches, "trace")
    path = out_dir / "netmax_M8.jsonl"
    trace = from_sim_result(res, cfg=cfg, link_model=link)
    write_jsonl(trace, path)
    back = read_jsonl(path)
    check(back.records == trace.records and back.meta == trace.meta,
          "trace: the JSONL round trip changed records")
    cal = calibrate(back)
    (rep, _), rsecs, rlaunches = _run_counted(torch, lambda: run(replay_model(back, cal)))
    _check_mix_launches(rep, rlaunches, "trace replay")
    check(rep.trace_events == res.trace_events and rep.times == res.times,
          "trace: the replay is not exact")
    session = WhatIf(back, cal, cfg, data, record_every=events // 20, device="cuda")
    t0 = time.perf_counter()
    up = session.query(UpgradeLink(0, M // 2, speedup=4.0))
    wsecs = time.perf_counter() - t0
    check(up.baseline_wall_clock == rep.times[-1],
          "trace: the what-if baseline is not the replay")
    print(f"[{card}] trace: fixture configuration card == CPU ({len(blobs['cuda'])} "
          f"bytes of JSONL); netmax M = {M}, {events} events traced in {secs:.3f} s on "
          f"the card ({events / secs:.1f} events/s), {len(back.records)} records read "
          f"back from {path.relative_to(HERE)}; calibration accuracy "
          f"{1.0 - cal.residual:.6f} ({cal.n_pulls} pulls); replay exact "
          f"({rsecs:.3f} s); what-if '{up.mutation}': wall clock "
          f"{up.baseline_wall_clock:.3f} -> {up.mutated_wall_clock:.3f} virtual s "
          f"({up.wall_clock_speedup:.4f}x) in {wsecs:.3f} s; B1 launches "
          f"{launches['gossip_mix_rows']} + {rlaunches['gossip_mix_rows']} (replay)")
    return {"fixture_bytes": len(blobs["cuda"]), "events": events, "seconds": secs,
            "events_per_s": events / secs, "calibration_accuracy": 1.0 - cal.residual,
            "replay_exact": True, "replay_s": rsecs,
            "whatif": {"mutation": up.mutation, "speedup": up.wall_clock_speedup,
                       "seconds": wsecs},
            "launches": launches, "replay_launches": rlaunches}


def phase_policy_service(card):
    """The port's PolicyService over a loopback socket: a 4-shard router
    behind admission control, served graphs of M = 32, 600 requests from 4
    client threads; every request answered."""
    import threading

    import numpy as np

    from repro_torch.serve import (
        AdmissionController,
        PolicyClient,
        PolicyService,
        ShardRouter,
    )

    M, n_requests, n_clients = 32, 600, 4

    def ring_d(chord):
        d = np.zeros((M, M))
        for i in range(M):
            d[i, (i + 1) % M] = d[(i + 1) % M, i] = 1.0
        d[chord[0], chord[1]] = d[chord[1], chord[0]] = 1.0
        return d

    edge_sets = [None] + [ring_d((0, 2 + k)) for k in range(7)]
    insts = [hetero_times(M, seed=j) for j in range(len(edge_sets))]
    router = ShardRouter.build(4, 0.1, K=8, R=8, quant=0.05)
    adm = AdmissionController(router, max_queue=64, workers=4)
    svc = PolicyService(adm).start()
    per_client = n_requests // n_clients
    lat = [[] for _ in range(n_clients)]
    answered = [0] * n_clients

    def drive(k):
        with PolicyClient(svc.address) as cli:
            for i in range(per_client):
                j = (k * per_client + i) % len(edge_sets)
                t = time.perf_counter()
                res = cli.request(insts[j], d=edge_sets[j], tenant=f"c{k}-e{j}",
                                  deadline_ms=30_000.0)
                lat[k].append((time.perf_counter() - t) * 1e3)
                answered[k] += res is not None

    t0 = time.perf_counter()
    threads = [threading.Thread(target=drive, args=(k,)) for k in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    svc.stop()
    adm.close()
    ms = np.concatenate([np.asarray(v) for v in lat])
    st = router.stats()
    check(sum(answered) == n_requests,
          f"policy service: {sum(answered)}/{n_requests} requests answered")
    p50, p99 = float(np.percentile(ms, 50)), float(np.percentile(ms, 99))
    print(f"[{card}] policy service (host, loopback): 4 shards + admission, M = {M}, "
          f"{n_requests}/{n_requests} answered by {n_clients} clients in {wall:.3f} s = "
          f"{n_requests / wall:.1f} requests/s; round trip p50 {p50:.3f} ms, p99 "
          f"{p99:.3f} ms; {st['n_solves']} solves, hit rate {st['hit_rate']:.4f}, "
          f"{adm.stats.n_shed} shed")
    return {"requests": n_requests, "answered": sum(answered), "wall_s": wall,
            "requests_per_s": n_requests / wall, "p50_ms": p50, "p99_ms": p99,
            "solves": st["n_solves"], "hit_rate": st["hit_rate"],
            "shed": adm.stats.n_shed}


#: phase 20: the batched Eq.-14 sweep's sizes; K = R = 8, alpha 0.1.
LP_SIZES = (16, 32, 64, 128)


def phase_device_lp(torch, card):
    """``generate_policy_matrix_batched(backend="torch")`` on the card
    against ``backend="numpy"``, both timed: the same chosen (rho, t_bar)
    at M = 16..128.  On the sweep's own LP stack (``policy._eq14_grid_stack``)
    the device simplex and the numpy simplex give the same status per grid
    point; pivot counts equal on tests/test_revised.py:675's fixture."""
    import numpy as np

    from repro_torch.core import policy
    from repro_torch.solver import batch, batch_torch

    # Warm-up: the sweep's kernels and the inverse's solver libraries
    # (first loaded at the first scheduled refactor otherwise).
    policy.generate_policy_matrix_batched(0.1, 8, 8, hetero_times(8), backend="torch")
    torch.linalg.inv_ex(torch.eye(4, dtype=torch.float64, device="cuda")[None])
    torch.cuda.synchronize()
    rows = {}
    for M in LP_SIZES:
        T = hetero_times(M)
        res, secs = {}, {}
        for key in ("numpy", "torch"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[key] = policy.generate_policy_matrix_batched(0.1, 8, 8, T, backend=key)
            secs[key] = time.perf_counter() - t0
        check((res["torch"].rho, res["torch"].t_bar) == (res["numpy"].rho, res["numpy"].t_bar),
              f"device LP M = {M}: chosen grid points differ")
        inst, _, _, b, lb, _ = policy._eq14_grid_stack(0.1, 8, 8, T, np.ones((M, M)) - np.eye(M))
        a = batch.solve_lp_batch(inst.c, inst.A, b, lb_stack=lb, ub_stack=inst.ub)
        sol = batch_torch.make_solver(inst.c, inst.A, b, lb, inst.ub)
        _, status, pivots = sol.solve()
        got = [(batch._STATUS[int(st)], int(pv)) for st, pv in zip(status.cpu(), pivots.cpu())]
        check([r.status for r in a] == [g[0] for g in got],
              f"device LP M = {M}: statuses differ per grid point")
        mism = [s for s, (r, g) in enumerate(zip(a, got)) if r.pivots != g[1]]
        rows[M] = {"instances": len(a), "numpy_s": secs["numpy"], "torch_s": secs["torch"],
                   "pivots": res["numpy"].n_pivots, "pivot_mismatches": mism,
                   "max_pivots": max(r.pivots for r in a), "iterations": sol.iterations,
                   "readbacks": sol.readbacks, "rollbacks": sol.rollbacks}
        print(f"[{card}] device LP M = {M}: {len(a)} grid LPs, {res['numpy'].n_pivots} "
              f"pivots (most {rows[M]['max_pivots']} in one), numpy "
              f"{secs['numpy']:.3f} s, torch on the card {secs['torch']:.3f} s "
              f"({secs['numpy'] / secs['torch']:.2f}x); {sol.iterations} iterations, "
              f"{sol.readbacks} read-backs, {sol.rollbacks} windows rolled back; statuses "
              f"and grid point equal; pivot-count mismatches: {mism or 'none'}")
    rng = np.random.default_rng(23)
    n, m, S = 10, 4, 12
    A = rng.normal(size=(m, n))
    c = rng.normal(size=n)
    b = np.stack([A @ rng.uniform(0.1, 0.9, size=n) for _ in range(S - 2)]
                 + [rng.normal(size=m), rng.normal(size=m)])
    lb = np.zeros((S, n))
    lb[3] = 0.05
    ub = np.ones((S, n))
    ref = batch.solve_lp_batch(c, A, b, lb_stack=lb, ub_stack=ub)
    got = batch_torch.solve_lp_batch_torch(c, A, b, lb_stack=lb, ub_stack=ub)
    check([r.status for r in got] == [r.status for r in ref]
          and [r.pivots for r in got] == [r.pivots for r in ref]
          and all(abs(g.fun - r.fun) <= 1e-9 * max(1.0, abs(r.fun))
                  for g, r in zip(got, ref) if r.ok),
          "device LP: the rng-23 fixture differs from numpy in status, pivots or "
          "objective")
    print(f"device LP: rng-23 fixture (n 10, m 4, S 12) statuses, pivot counts "
          f"{[r.pivots for r in got]} and objectives equal to numpy")
    return {"sizes": rows, "rng23_pivots": [r.pivots for r in got]}


# -- the remaining LM families (phases 21-26) --------------------------------

#: Phases 21-25: (phase, arch, layers kept of the published depth (None:
#: all), the published widths checked before the run).  Depth is cut where
#: one card cannot hold the full model: phi3.5 to 8 of 32 layers (10.67 B
#: parameters), llama4 to one every_2 period (2 of 48; 18.43 B), Jamba to
#: one period (8 of 32: 7 mamba, 1 attention, 4 MoE; 13.30 B).
FAMILY_PHASES = [
    ("moe", "phi3.5-moe-42b-a6.6b", 8,
     dict(n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, hd=128, d_ff=6400,
          vocab_size=32064, experts=(16, 2, 1.25, "all"))),
    ("moe every_2", "llama4-maverick-400b-a17b", 2,
     dict(n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, hd=128, d_ff=8192,
          vocab_size=202048, experts=(128, 1, 1.25, "every_2"))),
    ("hybrid", "jamba-v0.1-52b", 8,
     dict(n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, hd=128, d_ff=14336,
          vocab_size=65536, experts=(16, 2, 1.25, "every_2"))),
    ("audio", "whisper-small", None,
     dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, hd=64, d_ff=3072,
          vocab_size=51865, experts=None)),
    ("vlm", "internvl2-1b", None,
     dict(n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, hd=64, d_ff=4864,
          vocab_size=151655, experts=None)),
]
#: Serving shapes of phases 21-25: a prefill of 4 x 512 text tokens (whisper:
#: 4 x 64 tokens against 4 x 1500 frames; internvl2: 256 vision tokens before
#: the text), capture_prefill of 4 x 64 tokens into a 128-token cache, and 4
#: requests of 32 prompt tokens, 16 new, in a 64-token cache.
FAMILY_BATCH, FAMILY_TEXT, AUDIO_TEXT = 4, 512, 64
FAMILY_CAPTURE, FAMILY_CAPTURE_SEQ = 64, 128
FAMILY_PROMPT, FAMILY_NEW, FAMILY_SERVE_SEQ = 32, 16, 64


def attention_layers(cfg) -> int:
    """Flash-attention launches a prefill makes: one per attention mixer;
    whisper's encoder and its decoder's self- and cross-attention."""
    if cfg.family == "audio":
        return cfg.n_enc_layers + 2 * cfg.n_layers
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_period
    if cfg.family == "ssm":
        return 0
    return cfg.n_layers


def attention_bodies(cfg) -> dict:
    """Launches a prefill makes by body: an f32 model runs the 3xTF32 body
    of its head dim throughout (``flash_attention.forward_body``: wgmma at
    hd 32/64); a bf16 whisper runs its encoder and cross-attention on f32
    operands (the f32 frames, promoted as JAX does) on that body and its
    self-attention on the bf16 body; any other bf16 model the bf16 body
    throughout."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    n = attention_layers(cfg)
    counts = dict.fromkeys(fa.BODY_LAUNCHES, 0)
    f32 = fa.forward_body(torch.float32, cfg.hd)
    if cfg.dtype == "float32":
        counts[f32] = n
    elif cfg.family == "audio":
        counts["bf16_wgmma"] = cfg.n_layers
        counts[f32] = cfg.n_enc_layers + cfg.n_layers
    else:
        counts["bf16_wgmma"] = n
    return counts


def family_batch(torch, cfg, gen, B, S):
    """tokens (B, S) and the family's f32 frames or vision tokens, drawn
    from ``gen`` (the frontend stubs of ``models/frontends.py``)."""
    from repro_torch.models import frontends

    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                     device=gen.device, dtype=torch.int32)}
    stub = frontends.frontend_for(cfg)
    if stub is not None:
        batch["frames" if cfg.family == "audio" else "vis_embeds"] = stub(gen, cfg, B)
    return batch


def expert_bytes(cfg) -> int:
    """Bytes of expert weights one MoE decode step reads: its (E, D, F)
    einsums take every expert at any batch (C = top_k slots each)."""
    if cfg.moe is None:
        return 0
    from repro_torch.models import transformer

    if cfg.family == "hybrid":
        moe_layers = transformer.n_blocks(cfg) * ((cfg.attn_period + 1) // 2)
    elif transformer._moe_interleaved(cfg):
        moe_layers = transformer.n_blocks(cfg)
    else:
        moe_layers = cfg.n_layers
    return moe_layers * 3 * cfg.moe.n_experts * cfg.d_model * cfg.d_ff * 2


def free_card(torch):
    """Drop what earlier phases left on the card; returns the GB still
    allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() / 1e9


def hook_route(run, hook):
    """``run()`` with every ``moe.route`` call going through ``hook(inner,
    p, x, cfg)``, for this run only; returns run's result."""
    from repro_torch.models import moe

    inner = moe.route
    moe.route = lambda p, x, cfg: hook(inner, p, x, cfg)
    try:
        return run()
    finally:
        moe.route = inner


def count_drops(run):
    """(dropped, total) (token, pick) slots at capacity over the MoE layers
    ``run()`` goes through."""
    seen = [0, 0]

    def hook(inner, p, x, cfg):
        out = inner(p, x, cfg)
        pos, C = out[3], out[4]
        seen[0] += int((pos == C).sum())
        seen[1] += pos.numel()
        return out

    hook_route(run, hook)
    return tuple(seen)


def replay_routes(choices):
    """A ``hook_route`` hook: each MoE layer takes the next of the expert
    choices ``choices`` recorded elsewhere (its gates the router's own
    probabilities at those experts, renormalised)."""
    from repro_torch.models import moe

    it = iter(choices)

    def pin(inner, p, x, c):
        probs = inner(p, x, c)[0]
        idx = next(it, None)
        check(idx is not None and tuple(idx.shape) == tuple(probs.shape[:-1]) + (c.moe.top_k,),
              "pinned routing: the run routes other tokens than the recorded one")
        idx = idx.to(x.device)
        return (probs, idx) + moe.place(probs.gather(-1, idx), idx, c)

    pin.left = lambda: sum(1 for _ in it)
    return pin


def record_routes(into):
    """A ``hook_route`` hook that appends each MoE layer's expert choices to
    ``into`` (on the CPU)."""
    def hook(inner, p, x, c):
        res = inner(p, x, c)
        into.append(res[1].cpu())
        return res
    return hook


def phase_family(torch, card, phase, arch, layers, widths):
    """Serving one family at its published widths on random weights from
    seed 0 (bf16), depth cut to ``layers``: ``lm.prefill_logits`` twice,
    ``capture_prefill`` (the families that capture; audio and vlm raise,
    ROADMAP C8) and ``ServeEngine.run``.  The launch counters are zeroed just
    before and read just after: flash attention launches
    ``attention_layers`` times a forward in the bodies of
    ``attention_bodies``, nothing else launches."""
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine, capture_prefill

    full = get_arch(arch)
    got = dict(n_layers=full.n_layers, d_model=full.d_model, n_heads=full.n_heads,
               n_kv_heads=full.n_kv_heads, hd=full.hd, d_ff=full.d_ff,
               vocab_size=full.vocab_size,
               experts=None if full.moe is None else (
                   full.moe.n_experts, full.moe.top_k, full.moe.capacity_factor,
                   full.moe.layout))
    check(got == widths and full.dtype == "bfloat16",
          f"{arch} is not the published width: {got}")
    cfg = full if layers is None else dataclasses.replace(full, n_layers=layers)
    left = free_card(torch)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n_params = lm.param_count(cfg)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    B = FAMILY_BATCH
    text = AUDIO_TEXT if cfg.family == "audio" else FAMILY_TEXT
    batch = family_batch(torch, cfg, gen, B, text)
    captures = cfg.family not in ("audio", "vlm")
    reqs = lm_requests(cfg.vocab_size, prompt=FAMILY_PROMPT, max_new=FAMILY_NEW)
    decode_s = [0.0]
    cache = None

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    with torch.inference_mode():
        prefill_s = []
        for _ in range(2):  # the first call warms cuBLAS and the allocator
            t0 = time.perf_counter()
            logits = lm.prefill_logits(params, batch, cfg)
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t0)
        capture_s = None
        if captures:
            t0 = time.perf_counter()
            cap_logits, cache = capture_prefill(cfg, params,
                                                batch["tokens"][:, :FAMILY_CAPTURE],
                                                FAMILY_CAPTURE_SEQ)
            torch.cuda.synchronize()
            capture_s = time.perf_counter() - t0
        eng = ServeEngine(cfg, params, batch_capacity=B, max_seq=FAMILY_SERVE_SEQ)
        step = eng.step

        def timed_step(*args, **kwargs):
            t = time.perf_counter()
            try:
                return step(*args, **kwargs)
            finally:
                decode_s[0] += time.perf_counter() - t

        eng.step = timed_step
        t0 = time.perf_counter()
        done = eng.run(reqs)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    launches = read_all_launches()
    bodies = dict(fa.BODY_LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    forwards = 3 if captures else 2
    per_forward = attention_layers(cfg)
    want_bodies = {k: v * forwards for k, v in attention_bodies(cfg).items()}
    check(launches["flash_attention"] == per_forward * forwards,
          f"{phase}: flash_attention launched {launches['flash_attention']} times for "
          f"{forwards} forwards of {per_forward} attention layers")
    check(bodies == want_bodies, f"{phase}: flash_attention by body {bodies}, "
                                 f"{want_bodies} expected")
    others = {k: n for k, n in launches.items() if k != "flash_attention"}
    check(not any(others.values()), f"{phase}: other kernels launched: {others}")
    check(tuple(logits.shape) == (B, cfg.vocab_size) and logits.dtype == torch.float32,
          f"{phase}: prefill logits {tuple(logits.shape)} {logits.dtype}")
    check(bool(torch.isfinite(logits).all()), f"{phase}: non-finite prefill logits")
    if captures:
        check(bool(torch.isfinite(cap_logits).all()),
              f"{phase}: non-finite capture_prefill logits")
        if cfg.family == "hybrid":  # pos0 is a mamba layer, the last attention
            last = f"pos{cfg.attn_period - 1}"
            leaves = {"k": cache[last]["k"], "ssm": cache["pos0"]["ssm"],
                      "conv": cache["pos0"]["conv"]}
        else:  # every_2 stacks (pos0, pos1) caches
            leaves = {"k": cache["pos0"]["k"] if "pos0" in cache else cache["k"]}
        for key, t in leaves.items():
            check(bool(torch.isfinite(t).all()) and bool(t.ne(0).any()),
                  f"{phase}: the captured {key} is not finite or is all zero")
    check(len(done) == len(reqs) and all(len(r.out) == r.max_new for r in done),
          f"{phase}: ServeEngine.run finished {len(done)} of {len(reqs)} requests")
    check(all(0 <= t < cfg.vocab_size for r in done for t in r.out),
          f"{phase}: a generated token lies outside the vocab")
    drops = None
    if cfg.moe is not None:
        with torch.inference_mode():
            drops = count_drops(lambda: lm.prefill_logits(params, batch, cfg))
    gen_tokens = sum(len(r.out) for r in done)
    decode_steps = max(len(r.out) for r in done)
    seq = text + (cfg.n_vis_tokens or 0)
    out = {
        "phase": phase, "arch": cfg.name, "layers": cfg.n_layers,
        "published_layers": full.n_layers, "params": n_params,
        "param_gb": n_params * 2 / 1e9, "gb_left_before": left, "init_s": init_s,
        "init_peak_gb": init_peak, "prefill_batch": [B, seq], "prefill_s": prefill_s,
        "prefill_tokens_per_s": B * seq / prefill_s[-1],
        "capture_prefill_batch": [B, FAMILY_CAPTURE] if captures else None,
        "capture_prefill_s": capture_s,
        "serve_requests": len(reqs), "serve_prompt": FAMILY_PROMPT,
        "serve_run_s": run_s, "serve_decode_s": decode_s[0],
        "generated_tokens": gen_tokens, "decode_steps": decode_steps,
        "decode_tokens_per_s": gen_tokens / decode_s[0], "peak_gb": peak,
        "launches": launches, "flash_attention_bodies": bodies,
        "flash_attention_per_forward": per_forward,
        "dropped_slots": drops, "decode_expert_gb": expert_bytes(cfg) / 1e9,
    }
    print(f"[{card}] {phase}: {cfg.name} at {cfg.n_layers} of {full.n_layers} layers "
          f"({n_params / 1e9:.3f} B params, {out['param_gb']:.1f} GB bf16; "
          f"{left:.2f} GB left allocated before) init {init_s:.2f} s (peak "
          f"{init_peak:.1f} GB: lecun_normal draws each tensor in f32, then casts); "
          f"prefill {B}x{seq} in {prefill_s[-1] * 1e3:.1f} ms (first "
          f"{prefill_s[0] * 1e3:.1f} ms) = {out['prefill_tokens_per_s']:.0f} tok/s; "
          + (f"capture_prefill {B}x{FAMILY_CAPTURE} {capture_s:.2f} s; " if captures
             else "capture_prefill raises (C8); ")
          + f"ServeEngine.run {len(reqs)} requests in {run_s:.2f} s, {gen_tokens} "
          f"tokens in {decode_steps} decode steps ({decode_s[0]:.3f} s) = "
          f"{out['decode_tokens_per_s']:.1f} tok/s; peak {peak:.1f} GB; launches "
          f"{launches}, flash_attention by body {bodies}")
    if drops is not None:
        print(f"[{card}] {phase}: a {B}x{seq} prefill dropped {drops[0]} of {drops[1]} "
              f"(token, pick) slots at capacity factor {cfg.moe.capacity_factor}; a "
              f"decode step reads {out['decode_expert_gb']:.2f} GB of expert weights")
    with torch.inference_mode():
        if cache is None:
            cache = lm.init_cache(cfg, B, FAMILY_CAPTURE_SEQ, device=dev)
        out["profile"] = lm_profile(torch, cfg, params, batch["tokens"][:, :FAMILY_CAPTURE],
                                    cache, "flash_attention", "flash_fwd", batch=batch,
                                    card=card)
    del params, cache, eng, batch, logits
    free_card(torch)
    return out


#: Phase 26's parity bound on logits, in units of max |logit|, by dtype.
FAMILY_PARITY_TOL = {"float32": 1e-3, "bfloat16": LM_BF16_TOL}
FAMILY_PARITY_SEQ = 64


def family_cut(cfg, dtype):
    """Phase 26's cut: the arch's reduced() config (its layers, period,
    encoder, experts and capacity factor 2.0) at d_model 256 and head_dim
    64, a head dim the flash kernel has (reduced()'s 16 is not one)."""
    return dataclasses.replace(cfg.reduced(), d_model=256, head_dim=64, dtype=dtype)


def no_drop(cfg):
    """``cfg`` with the capacity factor at n_experts / top_k, where C = S and
    no (token, pick) slot can drop.  A prefill drops slots at capacity and a
    one-token decode never does, so decode matches prefill only without
    drops: reduced()'s 2.0 is that factor at top_k 2 of 4 experts, but at
    llama4's top_k 1 it gives C = S / 2 (its cut drops 6 of 128 slots at
    S = 64)."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


def pinned_prefill(params, batch, cfg, choices):
    """``lm.prefill_logits`` with each MoE layer taking the expert choices
    ``choices`` recorded elsewhere (``replay_routes``)."""
    from repro_torch.models import lm

    return hook_route(lambda: lm.prefill_logits(params, batch, cfg), replay_routes(choices))


def phase_family_parity(torch, card):
    """Each of the five archs at ``family_cut``, in f32 then bf16: prefill
    logits on the card and on the CPU within ``FAMILY_PARITY_TOL`` of max
    |logit|, and flash attention's launches a prefill on the card equal to
    ``attention_layers`` of the cut in the bodies of ``attention_bodies``.
    In bf16 an MoE's router input differs between the devices by rounding,
    and where two experts' probabilities are that close the choice flips
    and the token's output moves by a large share of the logits: there the
    bound holds the CPU prefill with every MoE layer pinned to the card's
    expert choices (``pinned_prefill``), and the flips and the unpinned gap
    are printed.  For the archs that capture, on the card, the decode of
    token P-1 after ``capture_prefill`` of tokens 0..P-2 against the
    prefill logits of tokens 0..P-1 at the ``no_drop`` capacity: within
    the f32 bound in f32; in bf16 the gap is printed, not bounded (the two
    paths round the router's input differently too)."""
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm
    from repro_torch.serve.engine import capture_prefill

    dev = torch.device("cuda")
    out = {}
    for _, arch, _, _ in FAMILY_PHASES:
        for dtype in ("float32", "bfloat16"):
            cfg = family_cut(get_arch(arch), dtype)
            gen = torch.Generator(device=dev).manual_seed(0)
            P = FAMILY_PARITY_SEQ
            drops = d_dec = None
            card_choices, cpu_choices = [], []
            with torch.inference_mode():
                params = lm.init_params(cfg, gen)
                batch = family_batch(torch, cfg, gen, 2, P)
                fa.reset_launches()
                on_card = hook_route(lambda: lm.prefill_logits(params, batch, cfg),
                                     record_routes(card_choices))
                torch.cuda.synchronize()
                bodies = dict(fa.BODY_LAUNCHES)
                cpu_params, cpu_batch = _tree_to(params, "cpu"), _tree_to(batch, "cpu")
                on_cpu = hook_route(lambda: lm.prefill_logits(cpu_params, cpu_batch, cfg),
                                    record_routes(cpu_choices))
                held = on_cpu
                if cfg.moe is not None and dtype == "bfloat16":
                    held = pinned_prefill(cpu_params, cpu_batch, cfg, card_choices)
                if cfg.moe is not None:
                    drops = count_drops(lambda: lm.prefill_logits(params, batch, cfg))
                if cfg.family not in ("audio", "vlm"):
                    nd = no_drop(cfg)
                    full = lm.prefill_logits(params, batch, nd)
                    _, cache = capture_prefill(nd, params, batch["tokens"][:, :P - 1], P)
                    dec, _ = lm.decode_step(params, cache, batch["tokens"][:, P - 1],
                                            P - 1, nd)
                    d_dec = (dec - full).abs().max().item()
            tol = FAMILY_PARITY_TOL[dtype]
            scale = on_cpu.abs().max().item()
            d_cpu = (on_card.cpu() - on_cpu).abs().max().item()
            d_held = (on_card.cpu() - held).abs().max().item()
            flips = sum(int((a.sort(-1)[0] != b.sort(-1)[0]).any(-1).sum())
                        for a, b in zip(card_choices, cpu_choices))
            pinned = held is not on_cpu
            check(bodies == attention_bodies(cfg),
                  f"family parity {arch} {dtype}: flash_attention by body {bodies}, "
                  f"{attention_bodies(cfg)} expected")
            check(bool(torch.isfinite(on_card).all()),
                  f"family parity {arch} {dtype}: non-finite logits")
            check(d_held <= tol * scale,
                  f"family parity {arch} {dtype}: card vs CPU prefill logits"
                  + (" (routing pinned to the card's)" if pinned else "")
                  + f" differ by {d_held} (max |logit| {scale})")
            if d_dec is not None and dtype == "float32":
                check(d_dec <= tol * scale, f"family parity {arch} {dtype}: decode at P-1 "
                                            f"vs prefill logits differ by {d_dec} (max "
                                            f"|logit| {scale})")
            out[f"{arch}/{dtype}"] = {"card_vs_cpu": d_cpu, "card_vs_cpu_held": d_held,
                                      "routing_pinned": pinned, "routing_flips": flips,
                                      "decode_vs_prefill": d_dec, "max_logit": scale,
                                      "bodies": bodies, "dropped_slots": drops}
            print(f"[{card}] family parity {arch} {dtype} (d_model 256, hd 64, "
                  f"{cfg.n_layers} layers, S = {P}"
                  + (f" + {cfg.n_vis_tokens} vision" if cfg.n_vis_tokens else "")
                  + (f", {cfg.enc_seq_len} frames" if cfg.family == "audio" else "")
                  + f"): card vs CPU {d_cpu:.3g}"
                  + (f", with the CPU's routing pinned to the card's {d_held:.3g}"
                     if pinned else "")
                  + f"; max |logit| {scale:.3g} (bound {tol} of it)"
                  + (f"; {flips} expert choices differ card vs CPU" if cfg.moe else "")
                  + (f"; prefill dropped {drops[0]} of {drops[1]} slots" if drops else "")
                  + (f"; decode vs prefill without drops {d_dec:.3g}"
                     + (" (not bounded in bf16)" if dtype == "bfloat16" else "")
                     if d_dec is not None else "")
                  + f"; flash by body {bodies}")
            del params, batch, cpu_params, cpu_batch
    free_card(torch)
    return out


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


# -- training the PR 19 families (phases 30-33) --------------------------------

#: Bytes a stacked parameter takes in a training round at its peak (bf16
#: params, f32 momenta, the f32 micro-batch sums, the update, the pulled
#: and mixed copies): phase 28's 59.13 GB over rwkv6-7b's 3.02 B stacked
#: parameters is 19.6; PERF.md section 4 sizes the depth cuts with ~18.6.
BYTES_PER_STACKED_PARAM = 18.6
CARD_BYTES = 80e9
#: Phases 30-32: (phase, arch, layers kept (None: all), workers, sequences a
#: worker, text tokens a sequence).  phi3.5-moe at 1 of 32 layers, M = 2,
#: through the launcher's loop; whisper-small and internvl2-1b whole, M = 4,
#: through ``make_train_step`` with a ``train_batch_specs`` batch (C10).
FAMILY_TRAIN = [("moe train", "phi3.5-moe-42b-a6.6b", 1, 2, 8, 512),
                ("audio train", "whisper-small", None, 4, 4, 64),
                ("vlm train", "internvl2-1b", None, 4, 4, 512)]
FAMILY_TRAIN_ROUNDS = 8
#: The archs phase 33 trains only at ``family_cut``: one period of each at its
#: published widths holds more parameters than one card holds replicas of.
CUT_ONLY = ("llama4-maverick-400b-a17b", "jamba-v0.1-52b")


class SpecsLoop:
    """``launch.train.TrainLoop``'s round for the families its batches cannot
    feed (ROADMAP C10): the same optimizer, strategy, step config and gossip
    draws (``sample_round`` on the uniform pull matrix, as its round before
    the Monitor's first policy), and a batch shaped by
    ``launch.specs.train_batch_specs``, filled from a generator seeded
    ``seed``: token ids uniform over the vocab, frames and vision tokens
    normal at the frontend stubs' RMS of 0.02."""

    def __init__(self, torch, cfg, workers, seq, batch_per_worker, lr=TRAIN_LR,
                 device="cuda", seed=0):
        import numpy as np

        from repro_torch.configs.base import ShapeSpec
        from repro_torch.launch.specs import train_batch_specs
        from repro_torch.optim import sgd
        from repro_torch.train.trainer import TrainStepConfig, init_stacked, make_train_step

        M = workers
        self.torch, self.cfg, self.M, self.lr = torch, cfg, M, lr
        opt = sgd(momentum=0.9, weight_decay=1e-4)
        self.step_cfg = TrainStepConfig(gossip_mode="gather", use_gossip_mix_kernel=True)
        self.step_fn = make_train_step(cfg, opt, M, "netmax", self.step_cfg)
        shape = ShapeSpec("train", seq + (cfg.n_vis_tokens or 0), M * batch_per_worker,
                          "train")
        self.specs = train_batch_specs(cfg, shape, M)
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.device = device
        self.params, self.opt_state = init_stacked(cfg, opt, M, self.gen)
        self.d = np.ones((M, M)) - np.eye(M)
        self.P = np.where(self.d > 0, 1.0 / max(M - 1, 1), 0.0)
        self.rho = 0.5 / (2 * lr * max(M - 1, 1))
        self.rng = np.random.default_rng(seed)

    def batch(self, r: int) -> dict:
        torch = self.torch
        out = {}
        for k, spec in self.specs.items():
            if spec.dtype.is_floating_point:
                out[k] = 0.02 * torch.randn(spec.shape, generator=self.gen, dtype=spec.dtype,
                                            device=self.device)
            else:
                out[k] = torch.randint(0, self.cfg.vocab_size, spec.shape, generator=self.gen,
                                       dtype=spec.dtype, device=self.device)
        return out

    def round(self, r: int) -> dict:
        import numpy as np

        from repro_torch.core.consensus import sample_round

        batch = self.batch(r)
        nb, wts = sample_round(self.rng, self.P, self.lr, self.rho, self.d)
        gi = {"neighbors": nb, "weights": wts, "lr": np.float32(self.lr)}
        self.params, self.opt_state, m = self.step_fn(self.params, self.opt_state, batch, gi)
        return {**m, "neighbors": nb, "weights": wts}


def stacked_gb(cfg, M) -> tuple[int, float]:
    """(parameters of one replica, GB of M stacked at BYTES_PER_STACKED_PARAM)."""
    from repro_torch.models import lm

    n = lm.param_count(cfg)
    return n, n * M * BYTES_PER_STACKED_PARAM / 1e9


def train_launches_expected(cfg, workers, batch) -> dict:
    """B3's forward and backward launches a round: one backward per worker,
    micro-batch and attention call, and two forwards (remat runs each
    block's forward again)."""
    per = workers * min(cfg.microbatches, batch) * attention_layers(cfg)
    return {"flash_attention": 2 * per, "flash_attention_bwd": per}


def check_train_launches(label, cfg, out, workers, batch, rounds):
    """The round's B3 launches against ``train_launches_expected``; no WKV or
    single-replica mix kernel; printed beside the count worked out."""
    want = train_launches_expected(cfg, workers, batch)
    got = {k: out["launches"][k] / rounds for k in want}
    print(f"{label}: launches a round {got} (expected {want} from {workers} workers x "
          f"{min(cfg.microbatches, batch)} micro-batches x {attention_layers(cfg)} attention "
          f"calls, x 2 forwards under remat); gossip_mix_rows "
          f"{out['launches']['gossip_mix_rows'] / rounds} (one a dtype group: "
          f"{out['mix_launches_per_round']})")
    check(got == want, f"{label}: B3 launches a round {got}, {want} expected")
    others = {k: n for k, n in out["launches"].items()
              if k not in ("flash_attention", "flash_attention_bwd", "gossip_mix_rows")}
    check(not any(others.values()), f"{label}: other kernels launched: {others}")
    out["launches_expected_per_round"] = want


def phase_family_train(torch, card, phase, arch, layers, workers, batch, seq):
    """Phases 30-32: one family at its published widths (bf16, random weights
    from seed 0), depth cut to ``layers``: through ``launch.train.TrainLoop``
    where the launcher feeds the family, else through ``SpecsLoop`` (audio
    and vlm, C10); FAMILY_TRAIN_ROUNDS rounds of ``run_train_loop`` and its
    checks, B3's launches a round as the config works out."""
    from repro_torch.configs.base import get_arch

    widths = {row[1]: row[3] for row in FAMILY_PHASES}[arch]
    full = get_arch(arch)
    got = dict(n_layers=full.n_layers, d_model=full.d_model, n_heads=full.n_heads,
               n_kv_heads=full.n_kv_heads, hd=full.hd, d_ff=full.d_ff,
               vocab_size=full.vocab_size,
               experts=None if full.moe is None else (
                   full.moe.n_experts, full.moe.top_k, full.moe.capacity_factor,
                   full.moe.layout))
    check(got == widths and full.dtype == "bfloat16" and full.remat,
          f"{arch} is not the published width: {got}")
    cfg = full if layers is None else dataclasses.replace(full, n_layers=layers)
    n, gb = stacked_gb(cfg, workers)
    print(f"[{card}] {phase}: {cfg.name} at {cfg.n_layers} of {full.n_layers} layers: "
          f"{n / 1e9:.3f} B params a replica, M = {workers} stacks {n * workers / 1e9:.3f} B, "
          f"~{gb:.1f} GB at {BYTES_PER_STACKED_PARAM} bytes a stacked parameter"
          + (f"; M = {2 * workers} would need ~{2 * gb:.1f} GB" if layers else ""))
    make_loop = None
    if cfg.family == "audio" or cfg.n_vis_tokens:
        def make_loop():
            return SpecsLoop(torch, cfg, workers, seq, batch)
    out = run_train_loop(torch, cfg, f"[{card}] {phase}", workers=workers, batch=batch,
                         seq=seq, rounds=FAMILY_TRAIN_ROUNDS, make_loop=make_loop)
    check_train_launches(f"[{card}] {phase}", cfg, out, workers, batch, FAMILY_TRAIN_ROUNDS)
    check(out["peak_memory_bytes"] < CARD_BYTES,
          f"{phase}: peak {out['peak_memory_bytes'] / 1e9:.2f} GB")
    out.update(phase=phase, published_layers=full.n_layers, params_a_replica=n,
               stacked_gb_estimate=gb, through="TrainLoop" if make_loop is None
               else "make_train_step (SpecsLoop)",
               vision_tokens=cfg.n_vis_tokens or 0,
               frames=cfg.enc_seq_len if cfg.family == "audio" else 0)
    free_card(torch)
    return out


def cut_only_arithmetic(card):
    """Why llama4 and jamba train only at their cut: one period at published
    widths, M = 1, against one card, at BYTES_PER_STACKED_PARAM."""
    from repro_torch.configs.base import get_arch

    rows = {}
    for arch in CUT_ONLY:
        full = get_arch(arch)
        period = 2 if full.family != "hybrid" else full.attn_period
        n, gb = stacked_gb(dataclasses.replace(full, n_layers=period), 1)
        rows[arch] = {"period_layers": period, "params": n, "gb_m1": gb, "gb_m2": 2 * gb}
        print(f"[{card}] family train parity: {arch} at published widths, one period "
              f"({period} of {full.n_layers} layers) is {n / 1e9:.2f} B params, ~{gb:.0f} GB "
              f"to train at M = 1 ({2 * gb:.0f} GB at M = 2) against {CARD_BYTES / 1e9:.0f} "
              "GB: trained here at its cut only (ROADMAP A6b, A7)")
        check(gb * 1e9 > CARD_BYTES, f"{arch}: one period would fit one card")
    return rows


def family_train_parity(torch, cfg, dtype, M, batch, seq, devices=("cpu", "cuda"),
                        seed=0):
    """One round of the trainer (remat, the fused mix) on ``devices[1]`` and on
    ``devices[0]`` from the same params, batch and gossip draws, at ``cfg``:
    losses and params within TRAIN_PARITY_TOL.  In bf16 an MoE's CPU run takes
    the card's recorded expert choices in every MoE layer, the remat
    recomputation included (``replay_routes``); the unpinned CPU round runs
    too, and its gap and the choices that differ are reported."""
    import numpy as np

    from repro_torch.core.consensus import sample_round
    from repro_torch.optim import sgd
    from repro_torch.train.trainer import TrainStepConfig, init_stacked, make_train_step
    from repro_torch.tree import tree_leaves, tree_map

    ref_dev, dev = devices
    opt = sgd(momentum=0.9, weight_decay=1e-4)
    step = make_train_step(cfg, opt, M, "netmax", TrainStepConfig(use_gossip_mix_kernel=True))
    params, state = init_stacked(cfg, opt, M, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    b = {k: rng.integers(0, cfg.vocab_size, size=(M, batch, seq)).astype(np.int64)
         for k in ("tokens", "labels")}
    if cfg.n_vis_tokens:
        b["vis_embeds"] = 0.02 * rng.standard_normal(
            (M, batch, cfg.n_vis_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        b["frames"] = 0.02 * rng.standard_normal(
            (M, batch, cfg.enc_seq_len, cfg.d_model)).astype(np.float32)
    dmask = np.ones((M, M)) - np.eye(M)
    nb, wts = sample_round(rng, np.where(dmask > 0, 1.0 / (M - 1), 0.0), TRAIN_LR,
                           0.5 / (2 * TRAIN_LR * (M - 1)), dmask)
    gi = {"neighbors": nb, "weights": wts, "lr": TRAIN_LR}
    pin = cfg.moe is not None and dtype == "bfloat16"

    def one(device, hook=None):
        p, o = tree_map(lambda t: t.to(device), params), tree_map(lambda t: t.to(device), state)
        bt = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        t = time.perf_counter()
        run = lambda: step(p, o, bt, gi)  # noqa: E731
        p, _, m = run() if hook is None else hook_route(run, hook)
        if device != "cpu":
            torch.cuda.synchronize()
        return m["loss_per_worker"].cpu(), tree_map(lambda t: t.cpu(), p), time.perf_counter() - t

    card_choices, free_choices = [], []
    reset_all_launches()
    loss_card, p_card, card_s = one(dev, record_routes(card_choices) if cfg.moe else None)
    launches = read_all_launches()
    loss_free, p_free, cpu_s = one(ref_dev, record_routes(free_choices) if cfg.moe else None)
    loss_held, p_held = loss_free, p_free
    if pin:
        hook = replay_routes(card_choices)
        loss_held, p_held, _ = one(ref_dev, hook)
        check(hook.left() == 0, "pinned routing: recorded choices left over")
    check(bool(torch.isfinite(loss_card).all()), f"non-finite card losses {loss_card}")

    def gaps(loss, p):
        """(loss gap, param gap, the leaf of the param gap), relative."""
        lerr = ((loss_card - loss).abs() / loss.abs()).max().item()
        perr, where = max(((c.float() - a.float()).abs().max().item()
                           / max(a.float().abs().max().item(), 1e-30), path)
                          for (path, a), c in zip(leaf_paths(p), tree_leaves(p_card)))
        return lerr, perr, where

    loss_err, param_err, worst = gaps(loss_held, p_held)
    flips = sum(int((a.sort(-1)[0] != c.sort(-1)[0]).any(-1).sum())
                for a, c in zip(card_choices, free_choices) if a.shape == c.shape)
    res = {"loss_rel_err": loss_err, "param_rel_err": param_err, "worst_leaf": worst,
           "routing_pinned": pin,
           "card_s": card_s, "cpu_s": cpu_s, "launches": launches,
           "routing_flips": flips if cfg.moe else None,
           "route_calls": len(card_choices), "mix_groups": mix_groups(params)}
    if pin:
        res["unpinned_loss_rel_err"], res["unpinned_param_rel_err"], _ = gaps(loss_free,
                                                                               p_free)
    return res


def leaf_paths(tree, prefix=""):
    """(path, leaf) of a tree of dicts, in ``tree_leaves``' order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in leaf_paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree) for pl in leaf_paths(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def phase_family_train_parity(torch, card):
    """Phase 33: each of the five families at ``family_cut`` with remat on,
    one round of the trainer (M = 2, the config's micro-batches of one
    sequence of FAMILY_PARITY_SEQ text tokens each, or two sequences where it
    has one micro-batch) on the card and on the CPU, in f32 and in bf16:
    losses and params within TRAIN_PARITY_TOL (bf16 MoE routing pinned to the
    card's), and the card's B3 launches as ``train_launches_expected``."""
    from repro_torch.configs.base import get_arch

    out = {"cut_only": cut_only_arithmetic(card)}
    M = 2
    for _, arch, _, _ in FAMILY_PHASES:
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(family_cut(get_arch(arch), dtype), remat=True)
            batch = max(cfg.microbatches, 2)
            res = family_train_parity(torch, cfg, dtype, M, batch, FAMILY_PARITY_SEQ)
            tol = TRAIN_PARITY_TOL[dtype]
            want = train_launches_expected(cfg, M, batch)
            got = {k: res["launches"][k] for k in want}
            label = f"[{card}] family train parity {arch} {dtype}"
            print(f"{label} (d_model 256, hd 64, {cfg.n_layers} layers, M = {M}, {batch} x "
                  f"{FAMILY_PARITY_SEQ} tokens a worker in {min(cfg.microbatches, batch)} "
                  f"micro-batches): losses within {res['loss_rel_err']:.3g}, params within "
                  f"{res['param_rel_err']:.3g} (relative, at {res['worst_leaf']}; bound {tol})"
                  + (f" with the CPU's routing pinned to the card's ({res['route_calls']} "
                     f"route calls); unpinned {res['unpinned_loss_rel_err']:.3g} / "
                     f"{res['unpinned_param_rel_err']:.3g}" if res["routing_pinned"] else "")
                  + (f"; {res['routing_flips']} expert choices differ card vs unpinned CPU"
                     if cfg.moe else "")
                  + f"; B3 launches {got} (expected {want}); card {res['card_s']:.2f} s, "
                  f"CPU {res['cpu_s']:.2f} s")
            check(res["loss_rel_err"] <= tol, f"{label}: losses differ by "
                                              f"{res['loss_rel_err']} (relative)")
            check(res["param_rel_err"] <= tol, f"{label}: params differ by "
                                               f"{res['param_rel_err']} (of each leaf's max)")
            check(got == want, f"{label}: B3 launches {got}, {want} expected")
            check(res["launches"]["gossip_mix_rows"] == res["mix_groups"],
                  f"{label}: gossip_mix_rows launched {res['launches']['gossip_mix_rows']} "
                  f"times, {res['mix_groups']} (one a dtype group) expected")
            others = {k: n for k, n in res["launches"].items()
                      if k not in ("flash_attention", "flash_attention_bwd", "gossip_mix_rows")}
            check(not any(others.values()), f"{label}: other kernels launched: {others}")
            out[f"{arch}/{dtype}"] = res
    free_card(torch)
    return out


# -- the multi-card layer in a one-rank group (phases 34-35) -----------------

#: Phase 34's rounds of each run.
SHARDED_ROUNDS = 3


@contextlib.contextmanager
def nccl_group(torch):
    """A one-rank NCCL default group over a FileStore in a temporary
    directory, destroyed on exit.  NCCL failing fails the phase: there is
    no fall-back to gloo or to the CPU."""
    import tempfile

    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(str(Path(tmp) / "store"), 1)
        torch.cuda.set_device(0)
        try:
            dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                                    device_id=torch.device("cuda:0"))
        except Exception as e:  # noqa: BLE001 -- any failure fails the phase
            raise SmokeError(f"NCCL did not initialise a one-rank group: {e!r}") from e
        try:
            check(dist.get_backend() == "nccl", f"the group's backend is {dist.get_backend()}")
            yield
        finally:
            dist.destroy_process_group()


@contextlib.contextmanager
def deterministic(torch):
    """Deterministic algorithms (warnings only where there is none), without
    filling fresh allocations.  The embedding's gradient (``index_select``'s
    backward, an atomic ``index_add_`` on CUDA) otherwise differs between
    two runs of one step in its last bits."""
    import torch.utils.deterministic as det

    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(), det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        det.fill_uninitialized_memory = was[2]


def phase_sharded_train(torch, card):
    """Phase 34: phase 13's cut trained unsharded and through the sharded
    ``make_train_step`` on a (1, 1) mesh, from the same params and draws,
    both under ``deterministic``: params bit-equal, losses within 1e-6, B3
    and B1 launched by the sharded rounds as phase 13 counts them."""
    import numpy as np

    from repro_torch.configs.base import get_arch
    from repro_torch.core.consensus import sample_round
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.optim import sgd

    cfg = dataclasses.replace(get_arch(LM_ARCH), n_layers=TRAIN_LAYERS)
    M, lr, rounds = TRAIN_WORKERS, TRAIN_LR, SHARDED_ROUNDS
    opt = sgd(momentum=0.9, weight_decay=1e-4)
    stream = TokenStream(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    dmask = np.ones((M, M)) - np.eye(M)
    P = np.where(dmask > 0, 1.0 / (M - 1), 0.0)
    draws_rng = np.random.default_rng(0)
    draws = [sample_round(draws_rng, P, lr, 0.5 / (2 * lr * (M - 1)), dmask)
             for _ in range(rounds)]
    mesh = make_debug_mesh(1, 1)
    print(f"[{card}] sharded train: one rank holds all M = {M} workers; ppermute "
          f"cannot engage (it needs {M} worker ranks, one a worker)")
    held_gb = free_card(torch)
    out = {"held_before_gb": held_gb}
    with deterministic(torch):
        for mode in ("gather", "masked_psum"):
            out[mode] = sharded_train_mode(torch, card, cfg, opt, stream, draws, mesh, mode,
                                           held_gb)
    return out


def sharded_train_mode(torch, card, cfg, opt, stream, draws, mesh, mode, held_gb):
    """One pull mode of phase 34: the unsharded rounds, their params moved
    to the host and freed, then the sharded rounds; the checks."""
    import numpy as np

    from repro_torch.train.trainer import TrainStepConfig, init_stacked, make_train_step
    from repro_torch.tree import tree_leaves

    M, lr, rounds = TRAIN_WORKERS, TRAIN_LR, SHARDED_ROUNDS
    step_cfg = TrainStepConfig(gossip_mode=mode, use_gossip_mix_kernel=True)
    runs = {}
    for sharded in (False, True):
        kw = dict(mesh=mesh, worker_axes=("data",)) if sharded else {}
        step = make_train_step(cfg, opt, M, "netmax", step_cfg, **kw)
        params, state = init_stacked(cfg, opt, M,
                                     torch.Generator(device="cuda").manual_seed(0), **kw)
        losses, round_s = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_all_launches()
        for r in range(rounds):
            batch = {k: torch.from_numpy(np.stack(
                [stream.batch(w, r)[k] for w in range(M)]).astype(np.int64)).cuda()
                for k in ("tokens", "labels")}
            nb, wts = draws[r]
            t = time.perf_counter()
            params, state, m = step(params, state, batch,
                                    {"neighbors": nb, "weights": wts, "lr": lr})
            losses.append(m["loss_per_worker"].tolist())
            torch.cuda.synchronize()
            round_s.append(time.perf_counter() - t)
        launches = read_all_launches()
        peak = torch.cuda.max_memory_allocated()
        host = [leaf.cpu() for leaf in tree_leaves(params)]
        del params, state, m, step, batch
        free_card(torch)
        runs[sharded] = {"losses": losses, "round_s": round_s, "peak_memory_bytes": peak,
                         "launches": launches, "params": host}
    plain, shard = runs[False], runs[True]
    check(all(math.isfinite(x) for row in shard["losses"] for x in row),
          f"sharded train {mode}: non-finite losses {shard['losses']}")
    loss_rel = max(abs(a - b) / abs(b) for ra, rb in zip(shard["losses"], plain["losses"])
                   for a, b in zip(ra, rb))
    check(loss_rel <= 1e-6, f"sharded train {mode}: losses differ by {loss_rel} (relative)")
    bad = [i for i, (a, b) in enumerate(zip(shard["params"], plain["params"]))
           if not bits_equal(torch, a, b)]
    check(not bad, f"sharded train {mode}: params differ at leaves {bad} of "
                   f"{len(plain['params'])}")
    want = train_launches_expected(cfg, M, TRAIN_BATCH)
    want["gossip_mix_rows"] = mix_groups({"x": plain["params"]})
    got = {k: shard["launches"][k] / rounds for k in want}
    check(got == want, f"sharded train {mode}: launches a round {got}, {want} expected")
    others = {k: n for k, n in shard["launches"].items() if k not in want and n}
    check(not others, f"sharded train {mode}: other kernels launched: {others}")
    row = {}
    for name, run in (("unsharded", plain), ("sharded", shard)):
        row[name] = {"round_s": run["round_s"],
                     "round_ms_median": statistics.median(run["round_s"][1:]) * 1e3,
                     "peak_memory_bytes": run["peak_memory_bytes"],
                     "losses": run["losses"], "launches": run["launches"]}
    row.update(loss_rel_err=loss_rel, params_bit_equal=True, launches_per_round=got)
    print(f"[{card}] sharded train ({mode}): {cfg.name} widths at {cfg.n_layers} layers, "
          f"M={M}, {rounds} rounds, deterministic algorithms; ms a round (after the first) "
          f"unsharded {row['unsharded']['round_ms_median']:.1f}, sharded "
          f"{row['sharded']['round_ms_median']:.1f}; peak "
          f"{plain['peak_memory_bytes'] / 1e9:.2f} / {shard['peak_memory_bytes'] / 1e9:.2f} "
          f"GB ({held_gb:.2f} GB held before); params bit-equal on "
          f"{len(plain['params'])} leaves, losses within {loss_rel:.3g}; sharded launches "
          f"a round {got}")
    return row


def phase_sharded_main(torch, card):
    """Phase 35: phase 4's ``simulate`` with ``shard_workers=True`` in the
    one-rank group against the unsharded run: host results bit-equal,
    losses within 5e-4, dispatches different, B1 once a cohort."""
    from repro_torch.train.simulator import simulate

    out = {}
    for shard in (False, True):
        cfg, link, (x, y, parts, ex, ey) = sim_setup(3000, trace=True)
        cfg = dataclasses.replace(cfg, shard_workers=shard)
        torch.cuda.synchronize()
        reset_all_launches()
        t0 = time.perf_counter()
        res = simulate(cfg, link, x, y, parts, ex, ey, record_every=500, device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_all_launches()
        check(launches["gossip_mix_rows"] == res.cohorts,
              f"sharded main path (shard_workers={shard}): gossip_mix_rows launched "
              f"{launches['gossip_mix_rows']} times for {res.cohorts} cohorts")
        ev = res.events[-1]
        out["sharded" if shard else "unsharded"] = res
        print(f"[{card}] sharded main path, shard_workers={shard}: {ev} events, "
              f"{res.cohorts} cohorts, {res.dispatches} dispatches in {secs:.3f} s: "
              f"{ev / secs:.1f} events/s; losses {[round(v, 4) for v in res.losses]}")
        out[f"{'sharded' if shard else 'unsharded'}_stats"] = {
            "events": ev, "seconds": secs, "events_per_s": ev / secs,
            "cohorts": res.cohorts, "dispatches": res.dispatches,
            "losses": res.losses, "launches": launches}
    a, b = out.pop("sharded"), out.pop("unsharded")
    check(a.times == b.times and a.events == b.events, "sharded main path: times differ")
    check(a.trace_events == b.trace_events, "sharded main path: trace_events differ")
    check(a.comm_time == b.comm_time and a.compute_time == b.compute_time,
          "sharded main path: comm/compute time differs")
    check(len(a.policy_log) == len(b.policy_log)
          and all(ta == tb and ra == rb and (Pa == Pb).all()
                  for (ta, ra, Pa), (tb, rb, Pb) in zip(a.policy_log, b.policy_log)),
          "sharded main path: policy_log differs")
    check(a.cohorts == b.cohorts and a.dispatches != b.dispatches,
          f"sharded main path: cohorts {a.cohorts}/{b.cohorts}, dispatches "
          f"{a.dispatches}/{b.dispatches} (the same cohorts, other dispatches expected)")
    diff = losses_close(a, b, "sharded main path")
    print(f"[{card}] sharded main path: host results bit-equal, max |loss diff| {diff:.3g}")
    out["max_loss_diff"] = diff
    return out


#: Phase 36: the dry-run's cells, (arch, shape, multi-pod): every shape
#: tinyllama-1.1b and rwkv6-7b support on 16x16 (tinyllama's long_500k is
#: an explicit skip), phi3.5-moe's and jamba's train_4k on 16x16 (one
#: worker a pod: each micro-batch's rows shared out over 'data', ROADMAP
#: C22), and one 2x16x16 cell.
#: In groups of about equal time: each group's cells, and the unsharded
#: counts of its 16x16 cells' programs (``dryrun.unsharded_flops``), run in
#: two subprocesses of their own, all of them at once.
DRYRUN_GROUPS = [[("tinyllama-1.1b", s, False) for s in
                  ("train_4k", "prefill_32k", "decode_32k", "long_500k")]
                 + [("rwkv6-7b", s, False) for s in
                    ("train_4k", "prefill_32k", "decode_32k", "long_500k")]
                 + [("tinyllama-1.1b", "train_4k", True)],
                 [("phi3.5-moe-42b-a6.6b", "train_4k", False)],
                 [("jamba-v0.1-52b", "train_4k", False)]]
DRYRUN_CELLS = [cell for group in DRYRUN_GROUPS for cell in group]
DRYRUN_TIMEOUT_S = 600
_DRYRUN_SCRIPT = """
import json, sys
from repro_torch.configs.base import SHAPES, all_archs
from repro_torch.launch import dryrun
cells = json.loads(sys.argv[2])
if sys.argv[1] == "cells":
    for arch, shape, multi_pod in cells:
        rec = dryrun.run_cell(arch, shape, multi_pod, "ppermute", quiet=True)
        print("RECORD " + json.dumps(rec), flush=True)
else:
    for arch, shape, multi_pod in cells:
        cfg = all_archs()[arch]
        if not multi_pod and cfg.supports(SHAPES[shape]):
            flops = dryrun.unsharded_flops(cfg, shape)
            print("UNSHARDED " + json.dumps([arch, shape, flops]), flush=True)
"""


def phase_dryrun(card):
    """Phase 36: ``launch.dryrun.run_cell`` on every cell of DRYRUN_CELLS
    at full width, in subprocesses (a fake process group of 256 / 512 ranks
    cannot share a process with phase 34's NCCL group), one a group of
    DRYRUN_GROUPS, beside one a group that counts its 16x16 cells'
    programs unsharded: each cell
    ``ok`` or an explicit unsupported-shape skip, its per-rank FLOPs, bytes
    and collective bytes by kind, argument and temp GB, per-rank FLOPs x
    ranks over the unsharded count, the roofline's dominant term (H100
    rates, ``analysis.roofline``) and its seconds; each 16x16 cell that
    ``dryrun.PLAN_BOUNDS`` names within it and ``dryrun.PLAN_RATIO``.  A
    cell whose rows stay whole on a mesh dim (rwkv6-7b's long_500k, a
    global batch of 1 on 'data') is printed with that reason and not held to
    the ratio."""
    from repro_torch.analysis.roofline import from_record
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.dryrun import PLAN_BOUNDS, PLAN_RATIO

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(SRC), env.get("PYTHONPATH", "")])
    t0 = time.perf_counter()
    procs = {(kind, i): subprocess.Popen(
        [sys.executable, "-c", _DRYRUN_SCRIPT, kind, json.dumps(group)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i, group in enumerate(DRYRUN_GROUPS) for kind in ("cells", "unsharded")}
    outs = {}
    try:
        for key, proc in procs.items():
            left = max(DRYRUN_TIMEOUT_S - (time.perf_counter() - t0), 1)
            out, err = proc.communicate(timeout=left)
            outs[key] = (proc.returncode, out, err)
    except subprocess.TimeoutExpired:
        raise SmokeError(f"dry-run: not done in {DRYRUN_TIMEOUT_S} s") from None
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    secs = time.perf_counter() - t0
    lines = [line for (_, out, _) in outs.values() for line in out.splitlines()]
    recs = [json.loads(line[7:]) for line in lines if line.startswith("RECORD ")]
    unsharded = {(a, s): f for a, s, f in (json.loads(line[10:]) for line in lines
                                           if line.startswith("UNSHARDED "))}
    for (kind, i), (rc, _, err) in outs.items():
        check(rc == 0, f"dry-run {kind} {i}: exit {rc}; {err[-2000:]}")
    check(len(recs) == len(DRYRUN_CELLS),
          f"dry-run: {len(recs)} of {len(DRYRUN_CELLS)} records")
    print(f"dry-run: {len(recs)} cells in {secs:.1f} s ({len(procs)} subprocesses; {card})")
    for rec in recs:
        cell = f"{rec['mesh']}|{rec['arch']}|{rec['shape']}"
        if rec["skipped"]:
            print(f"  {cell}: skipped ({rec['reason']})")
            continue
        check(rec["ok"], f"dry-run {cell}: {rec.get('error')}")
        roof = from_record(rec, SHAPES[rec["shape"]])
        mem = rec["memory_analysis"]
        coll = sum(rec["collective_bytes_per_device"].values())
        base = unsharded.get((rec["arch"], rec["shape"])) if rec["mesh"] == "16x16" else None
        ratio = None if base is None else rec["hlo_flops_per_device"] * rec["chips"] / base
        rec["unsharded_flops"], rec["ratio_to_unsharded"] = base, ratio
        print(f"  {cell}: ok, {rec['t_trace_s']} s; per rank {rec['hlo_flops_per_device']:.4g} "
              f"FLOPs (x ranks / unsharded "
              f"{'-' if ratio is None else f'{ratio:.4f}'}), "
              f"{rec['hlo_bytes_per_device']:.4g} bytes, collective bytes {coll:.4g} "
              f"{ {k: f'{v:.4g}' for k, v in rec['collective_bytes_per_device'].items()} }; "
              f"argument {mem['argument_size_in_bytes'] / 1e9:.3f} GB, temp "
              f"{mem['temp_size_in_bytes'] / 1e9:.3f} GB; roofline compute "
              f"{roof.compute_s * 1e3:.2f} ms, memory {roof.memory_s * 1e3:.2f} ms, collective "
              f"{roof.collective_s * 1e3:.2f} ms: {roof.dominant}; kernel calls "
              f"{rec['kernel_calls']}; rows split over {rec['rows_split_over']}")
        if rec["rows_whole_over"]:
            print(f"    {cell}: its {SHAPES[rec['shape']].global_batch} rows do not split "
                  f"over {rec['rows_whole_over']}, so each rank there runs them all: not "
                  f"held to PLAN_RATIO")
        bounds = PLAN_BOUNDS.get((rec["arch"], rec["shape"]))
        if bounds is not None and rec["mesh"] == "16x16":
            lo, hi = PLAN_RATIO
            check(ratio is not None and lo <= ratio <= hi,
                  f"dry-run {cell}: per-rank FLOPs x ranks / unsharded {ratio}, "
                  f"not in [{lo}, {hi}]")
            check(coll <= bounds.get("collective", math.inf),
                  f"dry-run {cell}: collective bytes {coll:.4g} > {bounds.get('collective')}")
            check(mem["temp_size_in_bytes"] <= bounds.get("temp", math.inf),
                  f"dry-run {cell}: temp {mem['temp_size_in_bytes']:.4g} > "
                  f"{bounds.get('temp')}")
    check(any(r["mesh"] == "2x16x16" and r["ok"] for r in recs), "dry-run: no 2x16x16 cell")
    return {"seconds": secs, "records": recs}


#: Phase 37: the rounds counted (phase 13's cut, one warm round first).
COST_ROUNDS = 2


def phase_cost(torch, card):
    """Phase 37: ``analysis.cost.CostCounter`` around COST_ROUNDS rounds of
    phase 13's cut (tinyllama-1.1b widths, 8 layers, M = 4) under the
    profiler (again, up to PROFILE_ATTEMPTS traces, when CUPTI drops
    kernels): the counter's kernel calls equal the launch counters and the
    profiler's kernels (B3 128, B3 bwd 64 and B1 1 a round); its FLOPs
    beside 6 N D plus the remat forward and the attention products; the
    compute and memory terms at this card's rates beside the round time
    measured without the counter."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.analysis.cost import CostCounter, attention_work
    from repro_torch.analysis.roofline import HBM_BW, PEAK_FLOPS
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.train import TrainLoop
    from repro_torch.models import lm

    free_card(torch)
    cfg = dataclasses.replace(get_arch(LM_ARCH), n_layers=TRAIN_LAYERS)
    loop = TrainLoop(cfg, workers=TRAIN_WORKERS, seq=TRAIN_SEQ, batch_per_worker=TRAIN_BATCH,
                     lr=TRAIN_LR, algo="netmax", gossip="gather",
                     monitor_every=TRAIN_MONITOR_EVERY, device="cuda")
    loop.round(0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    loop.round(1)
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t
    want = {k: v * COST_ROUNDS for k, v in
            {**train_launches_expected(cfg, TRAIN_WORKERS, TRAIN_BATCH),
             "gossip_mix_rows": mix_groups(loop.params)}.items()}
    r0 = 2
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        reset_all_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof, \
                CostCounter(log_ops=False) as cc:
            for r in range(r0, r0 + COST_ROUNDS):
                loop.round(r)
            torch.cuda.synchronize()
        r0 += COST_ROUNDS
        launches = read_all_launches()
        names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
        # One body kernel a forward call (a split f32 walk adds a merge).
        profiled = {"flash_attention": sum("flash_fwd" in n and "merge" not in n
                                           for n in names),
                    "flash_attention_bwd": sum("flash_bwd_dkdv" in n for n in names),
                    "gossip_mix_rows": sum("mix_tree_kernel" in n for n in names)}
        rep = cc.report
        counted = {k: rep.kernel_calls.get(k, 0) for k in profiled}
        print(f"cost: {COST_ROUNDS} rounds of phase 13's cut (attempt {attempt}); kernel "
              f"calls counted {counted}, launch counters { {k: launches[k] for k in profiled} }"
              f", profiler kernels {profiled}, expected {want}")
        check(counted == want and {k: launches[k] for k in profiled} == want,
              f"cost: kernel calls {counted} / launches {launches} against {want}")
        if profiled == want:
            break
        # CUPTI drops events from some traces (PR 20): trace the rounds again.
    check(profiled == want, f"cost: the profiler's kernels {profiled} against {want} in "
                            f"each of {PROFILE_ATTEMPTS} traces")
    # 6 N D (N the model's parameters, D the round's tokens), the remat
    # forward of the blocks (2 N_blocks D), and the attention products the
    # kernel formulas count (forward twice, backward once).
    N = lm.param_count(cfg)
    n_blocks = sum(t.numel() for t in torch.utils._pytree.tree_leaves(
        lm.init_params(cfg, device="meta")["blocks"]))
    D = TRAIN_WORKERS * TRAIN_BATCH * TRAIN_SEQ
    mb = TRAIN_BATCH // min(cfg.microbatches, TRAIN_BATCH)
    attn_f, _ = attention_work(mb, TRAIN_SEQ, TRAIN_SEQ, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                               True, 2)
    calls_fwd = want["flash_attention"] // COST_ROUNDS
    analytic = 6 * N * D + 2 * n_blocks * D + attn_f * (calls_fwd + calls_fwd // 2 * 10 / 4)
    per_round = {"flops": rep.flops / COST_ROUNDS, "bytes": rep.bytes_accessed / COST_ROUNDS}
    compute_ms = per_round["flops"] / PEAK_FLOPS * 1e3
    memory_ms = per_round["bytes"] / HBM_BW * 1e3
    print(f"cost: {per_round['flops']:.4g} FLOPs a round counted against {analytic:.4g} "
          f"analytic (6 N D = {6 * N * D:.4g}, N = {N}, D = {D} tokens; remat forward "
          f"{2 * n_blocks * D:.4g}; attention products); {per_round['bytes']:.4g} bytes a "
          f"round; compute term {compute_ms:.2f} ms, memory term {memory_ms:.2f} ms at "
          f"{PEAK_FLOPS:.3g} FLOP/s and {HBM_BW:.3g} B/s, against a measured round of "
          f"{round_s * 1e3:.1f} ms without the counter ({card}); peak of live bytes "
          f"counted {cc.peak_bytes / 1e9:.2f} GB")
    check(0.8 <= per_round["flops"] / analytic <= 1.5,
          f"cost: counted FLOPs {per_round['flops']:.4g} far from the analytic {analytic:.4g}")
    del loop, prof
    torch.cuda.empty_cache()
    return {"round_ms": round_s * 1e3, "kernel_calls": counted, "launches": launches,
            "profiled_kernels": profiled, "flops_per_round": per_round["flops"],
            "bytes_per_round": per_round["bytes"], "analytic_flops": analytic,
            "compute_ms": compute_ms, "memory_ms": memory_ms,
            "peak_live_bytes": cc.peak_bytes}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for chip_smoke_kernels.json (per-case numbers)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a card",
              file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    try:
        card = phase_card(torch)
        name = torch.cuda.get_device_name(0)
        build_info = phase_build()
        summaries, records = phase_kernels(torch, hbm_rate(name))
        summaries.append(phase_flash(torch, hbm_rate(name), name, records))
        summaries.append(phase_rwkv(torch, hbm_rate(name), name, records))
        main_path = phase_main(torch)
        main_path["profile"] = phase_profile(torch, main_path)
        phase_parity(torch)
        algos = phase_algos(torch)
        algos["parity"] = phase_algo_parity(torch)
        lm_path = phase_lm(torch)
        lm_path["parity"] = phase_lm_parity(torch)
        ssm_path = phase_ssm(torch)
        ssm_path["parity"] = phase_ssm_parity(torch)
        summaries.append(phase_flash_bwd(torch, hbm_rate(name), name, records))
        train_path = phase_train(torch)
        train_path["parity"] = phase_train_parity(torch)
        dynamics = {"scenarios": phase_scenarios(torch, card),
                    "storms": phase_storms(torch, card),
                    "serve_chaos": phase_serve_chaos(card),
                    "trace": phase_trace(torch, card),
                    "policy_service": phase_policy_service(card),
                    "device_lp": phase_device_lp(torch, card)}
        families = {phase: phase_family(torch, card, phase, arch, layers, widths)
                    for phase, arch, layers, widths in FAMILY_PHASES}
        families["parity"] = phase_family_parity(torch, card)
        summaries.append(phase_rwkv_bwd(torch, hbm_rate(name), name, records))
        ssm_train_path = phase_ssm_train(torch)
        ssm_train_path["parity"] = phase_ssm_train_parity(torch)
        family_train = {row[0]: phase_family_train(torch, card, *row) for row in FAMILY_TRAIN}
        family_train["parity"] = phase_family_train_parity(torch, card)
        with nccl_group(torch):
            sharded = {"train": phase_sharded_train(torch, card),
                       "main": phase_sharded_main(torch, card)}
        analysis = {"dryrun": phase_dryrun(card), "cost": phase_cost(torch, card)}
    except SmokeError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    # Each kernel's launches on its own path.
    path_of = {"gossip_mix_rows": main_path, "gossip_mix": main_path,
               "flash_attention": lm_path, "rwkv_scan": ssm_path,
               "flash_attention_bwd": train_path, "rwkv_scan_bwd": ssm_train_path}
    for s in summaries:
        s["launches"] = path_of[s["name"]]["launches"][s["name"]]
    # B1 on the network-dynamics paths (phases 15, 16 and 18), each run's
    # counts zeroed just before it and read just after.
    storms, tr = dynamics["storms"], dynamics["trace"]
    b1_paths = {"scenarios": dynamics["scenarios"]["launches"],
                **{f"storms_{k}": storms[k]["launches"]
                   for k in ("netmax", "adpsgd", "failover")},
                "trace": tr["launches"], "trace_replay": tr["replay_launches"]}
    # B3 on the families' serving paths (phases 21-25), each zeroed just
    # before its run and read just after.
    for s in summaries:
        if s["name"] == "flash_attention":
            s["launches_families"] = {
                phase: families[phase]["launches"]["flash_attention"]
                for phase, *_ in FAMILY_PHASES}
    # B3, its backward and B1 on the families' training paths (phases 30-32).
    for s in summaries:
        if s["name"] in ("flash_attention", "flash_attention_bwd", "gossip_mix_rows"):
            s["launches_family_training"] = {
                row[0]: family_train[row[0]]["launches"][s["name"]] for row in FAMILY_TRAIN}
    # B3, its backward and B1 on the sharded trainer's path (phase 34), the
    # sharded rounds' counts zeroed just before them and read just after.
    for s in summaries:
        if s["name"] in ("flash_attention", "flash_attention_bwd", "gossip_mix_rows"):
            s["launches_sharded_training"] = {
                mode: sharded["train"][mode]["sharded"]["launches"][s["name"]]
                for mode in ("gather", "masked_psum")}
    for s in summaries:
        if s["name"] == "gossip_mix_rows":
            s["launches_network_dynamics"] = {
                k: v["gossip_mix_rows"] for k, v in b1_paths.items()}
    order = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms"]
    # The contract's keys in order, then a kernel's own (B1: u given, and the
    # six-launch way beside the tree launch).
    kernels = [{**{k: s[k] for k in order}, **{k: v for k, v in s.items() if k not in order}}
               for s in summaries]
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "chip_smoke_kernels.json").write_text(json.dumps(
            {"card": card, "device": name, "build": build_info, "kernels": kernels,
             "cases": records,
             "main_path": main_path, "algos": algos, "lm_path": lm_path,
             "ssm_path": ssm_path, "train_path": train_path,
             "ssm_train_path": ssm_train_path,
             "network_dynamics": dynamics, "families": families,
             "family_train": family_train, "sharded": sharded,
             "analysis": analysis},
            indent=1))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
