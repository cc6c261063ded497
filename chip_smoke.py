#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. card    — require CUDA; print nvidia-smi's name and power limit line;
2. build   — compile every CUDA source of the port with nvcc (one process
             per source, all started together), print the seconds and, per
             kernel, the tensor-core instructions (HMMA / HGMMA) that
             ``cuobjdump -sass`` lists: every bf16 flash-attention forward,
             every tensor-core backward kernel (``*mma_kernel``) and every
             WKV instantiation must have some;
3. kernels — every hand-written kernel against its plain torch version on
             the card, at the test shapes, the main path's shapes and a
             large shape.  The gossip mix also as a tree launch (one launch
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
             S != Sk both ways, hd 32/64/128/160, ragged lengths, and the
             training shape (2 x 512 tokens, 32/4 heads, hd 64); max |err|
             of dq, dk and dv within 1e-4 (f32) / 2e-2 (bf16) of max
             |grad|; per case the device time a call against the bound,
             and at the training shape against SDPA's backward;
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

Prints one ``{"kernels": [...]}`` JSON line, then, last, the
``{"ok": true, "device": {...}}`` line.  With ``--out DIR`` the per-case
kernel numbers and the paths' numbers also go to
``DIR/chip_smoke_kernels.json``.  It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
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
ATTN_MAIN = (4, 512, 512, 32, 4, 64, True, "bfloat16")
ATTN_LARGE = (1, 8192, 8192, 32, 4, 64, True, "bfloat16")
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
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
#: Kernels that must hold tensor-core instructions (a substring of their
#: symbol in ``cuobjdump -sass``), by library.
TENSOR_CORE_KERNELS = {"flash_attention": "flash_fwd_bf16_mma_kernel",
                       "flash_attention_bwd": "mma_kernel",
                       "rwkv_scan": "rwkv_scan_kernel"}


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
#: (an H100 run traced 65 of 200 launches in one trace, and another traced
#: none of a WKV case's), so a trace that misses launches is taken again.
PROFILE_ATTEMPTS = 4


def traced_device_us(events, match=None):
    """(launches, device µs) of the profiler's ``key_averages()`` rows whose
    kernel name contains ``match`` (all rows without it)."""
    found = [e for e in events if match is None or match in e.key]
    return (sum(e.count for e in found),
            sum(e.self_device_time_total for e in found))


def device_ms(torch, fn, iters, match=None, per_call=1):
    """Device time (ms) from a torch.profiler (CUPTI) trace of ``iters``
    calls of ``fn``: with ``match``, the time of the traced kernels whose
    name contains it over the calls they account for (``fn`` launches
    ``per_call`` of them a call; a trace may hold fewer launches than calls
    were made, so the sum over calls would read low), and when no trace of
    ``PROFILE_ATTEMPTS`` holds one the phase fails; without, the device time
    of all kernels per call, or None when no trace holds device time.  A
    trace short of the launches made is taken again; the fullest is used."""
    profiler = torch.profiler
    fn()
    torch.cuda.synchronize()
    want = iters * per_call
    best = (0, 0.0)
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profiler.profile(activities=[profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        n, us = traced_device_us(prof.key_averages(), match)
        if us > 0 and n > best[0]:
            best = (n, us)
        if us > 0 and (match is None or n >= want):
            break
    n, us = best
    if attempt > 1:
        print(f"  (profiler: {attempt} traces of {match or 'all kernels'}, "
              f"the fullest held {n} launches)")
    if match is None:
        return us / iters / 1e3 if us > 0 else None
    check(us > 0, f"the profiler traced no device time for kernels named *{match}* "
                  f"in {PROFILE_ATTEMPTS} traces")
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
    sass = {name: tensor_core_counts(build, path) for name, path in libs.items()}
    for name, counts in sass.items():
        print(f"  sass {name}: {sum(counts.values())} HMMA/HGMMA in {len(counts)} kernels")
        for fn, n in sorted(counts.items()):
            print(f"    {n:6d}  {fn[:100]}")
        want = TENSOR_CORE_KERNELS.get(name)
        if want is not None:
            mine = {fn: n for fn, n in counts.items() if want in fn}
            check(mine and all(mine.values()),
                  f"{name}: kernels {want}* without tensor-core instructions: {mine}")
    return {"seconds": secs, "sass_tensor_core": sass}


def tensor_core_counts(build, path):
    """Kernel symbol -> count of HMMA / HGMMA instructions in the library's
    SASS (``cuobjdump -sass``, from the toolkit beside nvcc)."""
    exe = Path(build.nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(exe), "-sass", str(path)], capture_output=True, text=True,
                         timeout=300)
    check(out.returncode == 0, f"cuobjdump -sass {path} failed: {out.stderr[-2000:]}")
    counts = sass_tensor_core_counts(out.stdout)
    check(counts, f"cuobjdump -sass {path} lists no kernel")
    return counts


def sass_tensor_core_counts(sass: str) -> dict:
    """Kernel symbol -> HMMA / HGMMA instructions, from ``cuobjdump -sass``
    text (a ``Function : <symbol>`` line opens each kernel)."""
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and re.search(r"\bH(G)?MMA\.", line):
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
        nbytes = 4 * x.numel() * x.element_size() + 4 * n_w
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
    nbytes = {"tree": 3 * n_el * 4 + 4 * N_WORKERS, "tree_u": 4 * n_el * 4 + 4 * N_WORKERS}
    out = {}
    for key, (fn, match, per_call) in ways.items():
        rec = {"kernel": "gossip_mix_rows", "role": "main_tree", "way": key,
               "ms": device_ms(torch, fn, iters, match, per_call)}
        check(rec["ms"] is not None, f"main tree {key}: the profiler traced no device time")
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
        print(f"  main tree {key}: device {rec['ms'] * 1e3:.2f} us"
              + (f", per call {rec['call_ms'] * 1e3:.2f} us, host {rec['host_ms'] * 1e3:.2f}"
                 " us" if "call_ms" in rec else "")
              + (f", bound {rec['bound_ms'] * 1e3:.3f} us "
                 f"({rec['bytes'] / (rec['ms'] * 1e-3) / 1e12:.3f} TB/s)"
                 if "bound_ms" in rec else ""))
        records.append(rec)
    return out


def attn_work(B, S, Sk, H, Hk, hd, causal, itemsize):
    """(flops, bytes) of one attention call: 4 * hd flops per visible
    (query head, key) pair -- QK^T and PV, 2 each -- and q, k, v read once,
    the output written once."""
    if causal:  # query s sees keys 0..min(s, Sk-1)
        pairs = sum(min(s + 1, Sk) for s in range(S))
    else:
        pairs = S * Sk
    flops = 4 * B * H * hd * pairs
    nbytes = (2 * B * S * H + 2 * B * Sk * Hk) * hd * itemsize
    return flops, nbytes


def phase_flash(torch, rate, name, records):
    """Flash attention against ``ref.reference_attention`` on every case;
    per case the profiler's device time, the time per call, the plain
    version's, SDPA's (main and large shapes) and the bound.  Appends to
    ``records``; returns the kernel's summary at the main shape."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}
    for role, cases in (("test", ATTN_CASES), ("main", [ATTN_MAIN]),
                        ("large", [ATTN_LARGE])):
        for case in cases:
            B, S, Sk, H, Hk, hd, causal, dtype = case
            dt = getattr(torch, dtype)
            q = torch.randn((B, S, H, hd), generator=gen, device=dev).to(dt)
            k = torch.randn((B, Sk, Hk, hd), generator=gen, device=dev).to(dt)
            v = torch.randn((B, Sk, Hk, hd), generator=gen, device=dev).to(dt)
            got = fa.flash_attention(q, k, v, causal=causal)
            want = ref.reference_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
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
            t_ops = flops / flop_rate(name, dtype) * 1e3
            t_bytes = nbytes / rate * 1e3
            rec = {"kernel": "flash_attention", "role": role, "case": list(case),
                   "dtype": dtype, "max_abs_err": err, "flops": flops, "bytes": nbytes,
                   "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
            fns = {"": lambda: fa.flash_attention(q, k, v, causal=causal),
                   "plain_": lambda: ref.reference_attention(q, k, v, causal=causal)}
            if role != "test":
                qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
                fns["library_"] = lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True)
            iters = {"test": 10, "main": 20, "large": 2}[role]
            for key, fn in fns.items():
                call = cuda_ms(torch, fn, iters)
                dev_ms = device_ms(torch, fn, iters,
                                   "flash_fwd" if key == "" else None)
                rec[key + "ms"] = call if dev_ms is None else dev_ms
                rec[key + "ms_from"] = "events" if dev_ms is None else "profiler"
                rec[key + "call_ms"] = call
            rec.setdefault("library_ms", None)
            records.append(rec)
            out.setdefault(role, []).append(rec)
            print(f"  flash_attention {role} {case}: max|err| {err:.3g}, device "
                  f"{rec['ms'] * 1e3:.1f} us ({rec['ms_from']}), per call "
                  f"{rec['call_ms'] * 1e3:.1f} us, plain {rec['plain_ms'] * 1e3:.1f} us, "
                  + (f"sdpa {rec['library_ms'] * 1e3:.1f} us, " if rec["library_ms"] else "")
                  + f"bound {rec['bound_ms'] * 1e3:.2f} us ({rec['bound_by']}); "
                  f"{flops / (rec['ms'] * 1e-3) / 1e12:.2f} TFLOP/s")
            del q, k, v
            torch.cuda.empty_cache()
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
    }
    print(f"kernel flash_attention: max|err| {summary['max_abs_err']:.3g}, main-path "
          f"launch {summary['ms'] * 1e3:.1f} us on the device (plain "
          f"{summary['plain_ms'] * 1e3:.1f} us, sdpa {summary['library_ms'] * 1e3:.1f} "
          f"us, bound {summary['bound_ms'] * 1e3:.2f} us, {summary['bound_by']})")
    return summary


def rwkv_work(B, S, H, N, chunk, itemsize, w_itemsize, state_in):
    """(flops, bytes) of one WKV call in the kernel's chunk form.  Per
    sub-chunk of c tokens and head: 8 c N elementwise ops (log decay, its
    cumulative sum, two exp, four products) and N exp; c (c - 1) / 2 scores
    and c diagonal terms of 2 N each; y = r_dec S and P v, 2 c N^2 and
    c (c + 1) N; the state update, (2 c + 1) N^2.  Bytes: r, k, v (at
    ``itemsize``) and w (at ``w_itemsize``) read once, y (at ``itemsize``)
    written once, u, the initial state (when given) read and the final state
    written."""
    chunk = min(chunk, S)
    sub = min(16, chunk)
    per_head = 0
    for c0 in range(0, S, chunk):
        c_end = min(c0 + chunk, S)
        for t0 in range(c0, c_end, sub):
            c = min(sub, c_end - t0)
            per_head += (8 * c * N + N + c * (c - 1) * N + 2 * c * N
                         + 2 * c * N * N + c * (c + 1) * N + (2 * c + 1) * N * N)
    flops = B * H * per_head
    nbytes = (B * S * H * N * (4 * itemsize + w_itemsize) + 4 * H * N
              + (2 if state_in else 1) * 4 * B * H * N * N)
    return flops, nbytes


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
    check(bodies == {"tensor_core": cfg.n_layers * forwards, "fma": 0},
          f"flash_attention launches by body {bodies}: every prefill layer must run "
          "the tensor-core body")
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


def lm_profile(torch, cfg, params, tokens, cache, kernel, match, steps=8):
    """One prefill and ``steps`` decode steps (positions after the prompt)
    under torch.profiler, after an unprofiled run of each: device busy
    share of the wall, ``kernel``'s share of the device time (device
    kernels whose name holds ``match``), and the kernels that hold the
    device longest."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import lm

    B, P = tokens.shape

    def prefill():
        lm.prefill_logits(params, {"tokens": tokens}, cfg)

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
        top = [(e.key[:80], e.count, e.self_device_time_total * 1e-3) for e in avg[:6]]
        res[name] = {"wall_s": wall, "device_s": device_s, "busy_share": device_s / wall,
                     f"{kernel}_device_s": kernel_s, "top_kernels": top}
        print(f"{cfg.name} profile {name}: wall {wall * 1e3:.2f} ms, device "
              f"{device_s * 1e3:.2f} ms ({device_s / wall:.3f} of the wall), {kernel} "
              f"{kernel_s * 1e3:.2f} ms; top kernels (name, count, ms):")
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
        n0 = fa.BODY_LAUNCHES["tensor_core"]
        on_card16 = lm.prefill_logits(params, {"tokens": tokens}, cfg16)
        torch.cuda.synchronize()
        tc_launches = fa.BODY_LAUNCHES["tensor_core"] - n0
        on_cpu16 = lm.prefill_logits(_tree_to(params, "cpu"), {"tokens": tokens.cpu()},
                                     cfg16)
    scale16 = on_cpu16.abs().max().item()
    d16 = (on_card16.cpu() - on_cpu16).abs().max().item()
    check(tc_launches == cfg16.n_layers,
          f"bf16 parity prefill ran the tensor-core body {tc_launches} times")
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
#: ways, hd 64 and 128 (and 32, 160), ragged lengths; then the training shape,
#: one tinyllama-1.1b layer of a 2 x 512 micro-batch.  Each in f32 and bf16.
ATTN_BWD_CASES = [(1, 128, 128, 4, 4, 64, True), (1, 200, 200, 32, 4, 64, True),
                  (2, 128, 128, 8, 1, 64, True), (2, 100, 37, 8, 2, 128, True),
                  (1, 64, 150, 4, 2, 128, True), (2, 128, 256, 4, 4, 64, False),
                  (1, 96, 96, 4, 2, 32, True), (1, 100, 100, 4, 2, 160, False)]
ATTN_BWD_MAIN = (2, 512, 512, 32, 4, 64, True)
#: max |err| of dq, dk and dv against the plain version's max |grad|.
ATTN_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def attn_bwd_work(B, S, Sk, H, Hk, hd, causal, itemsize):
    """(flops, bytes) of one attention backward: five products of 2 * hd
    flops per visible (query head, key) pair (q k^T again, dO v^T, dv, dk,
    dq); q, k, v, o, dO and the f32 lse read once, dq, dk, dv written once."""
    flops, _ = attn_work(B, S, Sk, H, Hk, hd, causal, itemsize)  # 4 hd per pair
    flops = flops // 4 * 10
    nbytes = ((4 * B * S * H + 4 * B * Sk * Hk) * hd * itemsize + 4 * B * H * S)
    return flops, nbytes


def phase_flash_bwd(torch, rate, name, records):
    """The backward kernels against the plain version's autograd gradient on
    every case, in f32 and bf16; per case the device time per call (its
    ``BWD_KERNELS_PER_CALL`` kernels), the plain version's, SDPA's backward (training shape) and the
    bound.  Returns the summary at the training shape (bf16)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    main = None
    for role, cases in (("test", ATTN_BWD_CASES), ("main", [ATTN_BWD_MAIN])):
        for case in cases:
            for dtype in ("float32", "bfloat16"):
                B, S, Sk, H, Hk, hd, causal = case
                dt = getattr(torch, dtype)
                q, do = (torch.randn((B, S, H, hd), generator=gen, device=dev).to(dt)
                         for _ in range(2))
                k, v = (torch.randn((B, Sk, Hk, hd), generator=gen, device=dev).to(dt)
                        for _ in range(2))
                out, lse = fa._forward(q, k, v, causal, with_lse=True)
                got = fa.flash_attention_backward(q, k, v, out, do, lse, causal=causal)
                want = ref.reference_attention_backward(q, k, v, do, causal=causal)
                torch.cuda.synchronize()
                errs = {}
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
                t_ops = flops / flop_rate(name, dtype) * 1e3
                t_bytes = nbytes / rate * 1e3
                rec = {"kernel": "flash_attention_bwd", "role": role, "case": list(case),
                       "dtype": dtype, "max_abs_err": max(errs.values()), "errs": errs,
                       "flops": flops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
                       "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                       "kernels_per_call": fa.BWD_KERNELS_PER_CALL}
                fns = {"": lambda: fa.flash_attention_backward(q, k, v, out, do, lse,
                                                               causal=causal),
                       "plain_": lambda: ref.reference_attention_backward(q, k, v, do,
                                                                          causal=causal)}
                if role == "main":
                    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                                  for t in (q, k, v))
                    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                              enable_gqa=True)
                    dot = do.transpose(1, 2).contiguous()
                    fns["library_"] = lambda: torch.autograd.grad(
                        sdpa_out, (qt, kt, vt), dot, retain_graph=True)
                iters = {"test": 5, "main": 20}[role]
                for key, fn in fns.items():
                    call = cuda_ms(torch, fn, iters)
                    dev_ms = device_ms(torch, fn, iters, "flash_bwd" if key == "" else None,
                                       per_call=fa.BWD_KERNELS_PER_CALL if key == "" else 1)
                    rec[key + "ms"] = call if dev_ms is None else dev_ms
                    rec[key + "ms_from"] = "events" if dev_ms is None else "profiler"
                    rec[key + "call_ms"] = call
                rec.setdefault("library_ms", None)
                records.append(rec)
                print(f"  flash_attention_bwd {role} {case} {dtype}: max|err| "
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
        "kernels_per_call": fa.BWD_KERNELS_PER_CALL,
    }
    print(f"kernel flash_attention_bwd: max|err| {summary['max_abs_err']:.3g}, training "
          f"shape {summary['ms'] * 1e3:.1f} us a call on the device (plain "
          f"{summary['plain_ms'] * 1e3:.1f} us, sdpa bwd {summary['library_ms'] * 1e3:.1f} "
          f"us, bound {summary['bound_ms'] * 1e3:.2f} us, {summary['bound_by']})")
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


def phase_train(torch):
    """NetMax training at the widths of tinyllama-1.1b through the
    launcher's loop (``launch.train.TrainLoop``): the launch counters are
    zeroed just before the rounds and read just after; losses finite, the
    flash forward and backward and the gossip-mix kernels launched, the
    first round's mix bit-equal to its plain version on the same tree."""
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.train import TrainLoop
    from repro_torch.tree import tree_flatten, tree_leaves
    from torch.profiler import ProfilerActivity, profile

    cfg = dataclasses.replace(get_arch(LM_ARCH), n_layers=TRAIN_LAYERS)
    check((cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff, cfg.vocab_size,
           cfg.dtype, cfg.remat, cfg.microbatches)
          == (2048, 32, 4, 64, 5632, 32000, "bfloat16", True, 2),
          f"{LM_ARCH} is not the published width: {cfg}")
    # The serving phases wrap ServeEngine.step in a closure over the engine's
    # own method, a reference cycle: collect it, or their weights (rwkv6-7b's
    # 15 GB) count in this phase's peak.
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loop = TrainLoop(cfg, workers=TRAIN_WORKERS, seq=TRAIN_SEQ,
                     batch_per_worker=TRAIN_BATCH, lr=TRAIN_LR, algo="netmax",
                     gossip="gather", monitor_every=TRAIN_MONITOR_EVERY, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(loop.step_cfg.use_gossip_mix_kernel and loop.step_cfg.gossip_mode == "gather",
          f"the launcher's step config {loop.step_cfg}")
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
        for r in range(TRAIN_ROUNDS - TRAIN_PROFILED):
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
            for r in range(TRAIN_ROUNDS - TRAIN_PROFILED, TRAIN_ROUNDS):
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
    check(all(math.isfinite(x) for row in losses for x in row), f"non-finite losses {losses}")
    check(mix_check.get("leaves") and not mix_check["bad"],
          f"the first round's gossip mix differs from its plain version at leaves "
          f"{mix_check.get('bad')} of {mix_check.get('leaves')}")
    per_round = TRAIN_WORKERS * cfg.microbatches * cfg.n_layers
    check(launches["gossip_mix_rows"] == TRAIN_ROUNDS,
          f"gossip_mix_rows launched {launches['gossip_mix_rows']} times in "
          f"{TRAIN_ROUNDS} rounds (one tree launch a round)")
    check(launches["flash_attention_bwd"] == per_round * TRAIN_ROUNDS,
          f"flash_attention_bwd launched {launches['flash_attention_bwd']} times, "
          f"{per_round} a round expected")
    check(launches["flash_attention"] == 2 * per_round * TRAIN_ROUNDS,
          f"flash_attention launched {launches['flash_attention']} times, "
          f"{2 * per_round} a round expected (remat runs each block's forward twice)")
    check(launches["rwkv_scan"] == 0 and launches["gossip_mix"] == 0,
          f"unexpected launches on the training path: {launches}")
    avg = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    device_s = sum(e.self_device_time_total for e in avg) * 1e-6
    by = {}
    for e in avg:
        kind = device_kind(e.key)
        by[kind] = by.get(kind, 0.0) + e.self_device_time_total * 1e-6
    top = [(e.key[:80], e.count, e.self_device_time_total * 1e-3) for e in avg[:10]]
    steady = round_s[1:]
    tokens = TRAIN_WORKERS * TRAIN_BATCH * TRAIN_SEQ
    out = {
        "arch": cfg.name, "layers": cfg.n_layers, "workers": TRAIN_WORKERS,
        "seq": TRAIN_SEQ, "batch_per_worker": TRAIN_BATCH,
        "microbatches": cfg.microbatches, "params_stacked": n_params, "init_s": init_s,
        "round_s": round_s, "round_ms_median": statistics.median(steady) * 1e3,
        "round_ms_mean": statistics.mean(steady) * 1e3,
        "tokens_per_round": tokens,
        "tokens_per_s": tokens / statistics.median(steady),
        "first_round_s": round_s[0], "peak_memory_bytes": peak,
        "round_peak_memory_bytes": round_peak,
        "losses": losses, "launches": launches,
        "launches_per_round": {k: v / TRAIN_ROUNDS for k, v in launches.items()},
        "mix_check": mix_check,
        "profile": {"rounds": TRAIN_PROFILED, "wall_s": profiled_s, "device_s": device_s,
                    "busy_share": device_s / profiled_s, "device_s_by": by,
                    "top_kernels": top},
    }
    print(f"train: {cfg.name} widths at {cfg.n_layers} layers, M={TRAIN_WORKERS} "
          f"({n_params / 1e9:.3f} B params stacked, bf16), {TRAIN_BATCH}x{TRAIN_SEQ} tokens "
          f"a worker in {cfg.microbatches} micro-batches; init {init_s:.2f} s; first round "
          f"{round_s[0] * 1e3:.1f} ms, then median {out['round_ms_median']:.1f} ms "
          f"(mean {out['round_ms_mean']:.1f}) = {out['tokens_per_s']:.0f} tokens/s; peak "
          f"memory {peak / 1e9:.2f} GB (the first round, with the mix check, "
          f"{round_peak[0] / 1e9:.2f} GB); launches a round "
          f"{out['launches_per_round']}; mix bit-equal on {mix_check['leaves']} leaves "
          f"({mix_check['elements']} elements)")
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


def device_kind(kernel: str) -> str:
    """The group a traced kernel's time is reported under in the training
    phase's breakdown (cuBLAS's Hopper GEMMs are named ``nvjet_*``)."""
    for kind, keys in (("flash_bwd", ("flash_bwd",)), ("flash_fwd", ("flash_fwd",)),
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


def phase_train_parity(torch):
    """Three rounds of the trainer on the card and on the CPU from the same
    params and draws, at a cut of tinyllama-1.1b (2 layers, d_model 256,
    4/2 heads of 64, d_ff 512, vocab 512, remat), in f32 and bf16: losses
    and params within TRAIN_PARITY_TOL."""
    import numpy as np

    from repro_torch.configs.base import get_arch
    from repro_torch.core.consensus import sample_round
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.optim import sgd
    from repro_torch.train.trainer import TrainStepConfig, init_stacked, make_train_step
    from repro_torch.tree import tree_leaves, tree_map

    M, lr, rounds, seq = 4, TRAIN_LR, 3, 128
    res = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_arch(LM_ARCH), n_layers=2, d_model=256, n_heads=4,
                                  n_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
                                  dtype=dtype)
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
        param_err = 0.0
        for a, b in zip(tree_leaves(runs["cpu"][0]), tree_leaves(runs["cuda"][0])):
            scale = a.float().abs().max().item()
            param_err = max(param_err,
                            (b.cpu().float() - a.float()).abs().max().item() / max(scale, 1e-30))
        tol = TRAIN_PARITY_TOL[dtype]
        check(loss_err <= tol, f"train parity {dtype}: losses differ by {loss_err} (relative)")
        check(param_err <= tol, f"train parity {dtype}: params differ by {param_err} "
                                "(of each leaf's max)")
        print(f"train parity: {dtype}, 2 layers hd 64, {rounds} rounds: losses within "
              f"{loss_err:.3g}, params within {param_err:.3g} (relative; bound {tol}); CPU "
              f"{secs['cpu']:.2f} s, card {secs['cuda']:.2f} s")
        res[dtype] = {"loss_rel_err": loss_err, "param_rel_err": param_err,
                      "cpu_s": secs["cpu"], "card_s": secs["cuda"]}
        del runs
        torch.cuda.empty_cache()
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


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


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
    except SmokeError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    # Each kernel's launches on its own path.
    path_of = {"gossip_mix_rows": main_path, "gossip_mix": main_path,
               "flash_attention": lm_path, "rwkv_scan": ssm_path,
               "flash_attention_bwd": train_path}
    for s in summaries:
        s["launches"] = path_of[s["name"]]["launches"][s["name"]]
    # B1 on the network-dynamics paths (phases 15, 16 and 18), each run's
    # counts zeroed just before it and read just after.
    storms, tr = dynamics["storms"], dynamics["trace"]
    b1_paths = {"scenarios": dynamics["scenarios"]["launches"],
                **{f"storms_{k}": storms[k]["launches"]
                   for k in ("netmax", "adpsgd", "failover")},
                "trace": tr["launches"], "trace_replay": tr["replay_launches"]}
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
             "network_dynamics": dynamics},
            indent=1))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
