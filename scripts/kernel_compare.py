"""Time one kernel of the port in two source trees, in turns, on one card.

    python3 scripts/kernel_compare.py --kernel KERNEL --before DIR [--after DIR]
                                      [--cases NAME,...] [--out FILE]
    python3 scripts/kernel_compare.py --kernel KERNEL --variant NAME [...]

``DIR`` is the root of a checkout of the repo (``git archive <commit> | tar
-x -C DIR``); ``--after`` defaults to this checkout.  ``--variant NAME``
compares this checkout (or ``--before``) with a copy of ``--after``'s
``src/`` under ``build/variants/NAME`` carrying the edits ``VARIANTS[NAME]``.
Each tree is timed in a process of its own, in turns (before, after, after,
before), through its own wrappers, with its kernels built from its own
sources into its own ``build/``.  The timers are ``chip_smoke.py``'s:
``device_ms`` (torch.profiler, the fullest of up to four traces, None when
none holds the kernels), ``cuda_ms`` (CUDA events around back-to-back calls)
and ``host_ms``.  Kernels (``CASES``):

- ``mix``: the cohort's gossip mix, ``kernels.ops.gossip_mix_tree`` on the
  simulator's MLP tree [32, 128, 64, 10] stacked over 32 rows (f32, u = 0),
  one replica's six leaves through ``gossip_mix`` beside ``torch.lerp``, and
  ``gossip_mix_rows`` / ``gossip_mix`` at large shapes; device time of all
  kernels a call.
- ``attn_fwd``: ``flash_attention.flash_attention`` at ``chip_smoke.py``'s
  ``ATTN_FAMILY_CASES`` and ``ATTN_MAIN`` (whisper's f32 encoder and
  cross-attention, the bf16 families' layers, tinyllama's prefill layer),
  ``ATTN_LARGE`` (one 8192-token causal prefill layer) and ``ATTN_FWD_EXTRA``
  (stablelm-12b's hd 160 layer); device time of the kernels named
  ``flash_fwd*`` a call (the body, and the merge kernel where the f32 walk
  is split), the key ranges, max |err| against ``ref.reference_attention``,
  the host time a call spends enqueueing (``least_host_ms``; bf16 calls
  make their TMA maps there), and SDPA's time on the same inputs in the
  same process, by the same clock (``library_ms``: profiler device time of
  all its kernels a call) and by CUDA events around the calls
  (``library_call_ms``).
- ``attn_bwd``: ``flash_attention.flash_attention_backward`` at the shapes
  the training phases of ``chip_smoke.py`` run; device time of the kernels
  named ``flash_bwd*`` a call (as many a call as its C entry reports it
  launched, ``BWD_LAUNCHED["kernels"]``; 4 in a tree before that report),
  and of each kernel of ``ATTN_BWD_KINDS`` the call launched, each over its
  own traced launches, its host time, and SDPA's backward on the same
  inputs by both clocks, as for ``attn_fwd``.
- ``wkv_bwd``: ``rwkv_scan.rwkv_scan_backward`` at the training shape of
  ``chip_smoke.py``'s phase 28 (one rwkv6-7b layer of a 1 x 512
  micro-batch, bf16 r/k/v/dy with f32 decays, from the zero state), with
  trained decays and with log w = -8 and w = 1e-30 (the score tiles'
  pairwise branch); device time of the kernels named ``rwkv_scan_bwd*`` a
  call, and of each kernel of ``rwkv_scan.BWD_KERNELS`` over its own traced
  launches; each case's gradients against ``ref.reference_rwkv_backward``
  (each gradient's max |err| over its max |.|, within ``chip_smoke``'s
  ``RWKV_BWD_TOL``, or the run fails unless the tree is a variant).

Prints one line per run and case, and the card's name and power limit; with
``--out`` also writes the numbers as JSON.  Needs a card; imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

MLP_DIMS = [32, 128, 64, 10]
ROWS = 32
#: mix: name -> (entry point, shape, dtype, iterations) of the large cases.
MIX_LARGE = {"rows_f32": ("gossip_mix_rows", (8, 2 ** 24), "float32", 5),
             "rows_bf16": ("gossip_mix_rows", (8, 2 ** 24), "bfloat16", 5),
             "scalar_f32": ("gossip_mix", (2 ** 27,), "float32", 5)}
#: attn_bwd: name -> ((B, S, Sk, H, Hk, hd, causal), dtype), the training
#: phases' shapes and llama4's and stablelm-12b's layers.
ATTN_BWD_SHAPES = {
    "tinyllama_bf16": ((2, 512, 512, 32, 4, 64, True), "bfloat16"),
    "tinyllama_f32": ((2, 512, 512, 32, 4, 64, True), "float32"),
    "internvl2_bf16": ((4, 768, 768, 14, 2, 64, True), "bfloat16"),
    "whisper_enc_f32": ((4, 1500, 1500, 12, 12, 64, False), "float32"),
    "whisper_cross_f32": ((4, 64, 1500, 12, 12, 64, False), "float32"),
    "phi35_bf16": ((1, 512, 512, 32, 8, 128, True), "bfloat16"),
    "llama4_bf16": ((1, 512, 512, 40, 8, 128, True), "bfloat16"),
    "stablelm_bf16": ((1, 512, 512, 32, 8, 160, True), "bfloat16"),
}
ATTN_BWD_ITERS = 20
ATTN_FWD_ITERS = 20
#: attn_fwd cases beside chip_smoke's: stablelm-12b's layer (32/8 heads of
#: 160, causal, bf16) at the LM phase's batch.
ATTN_FWD_EXTRA = [(4, 512, 512, 32, 8, 160, True, "bfloat16")]
#: attn_fwd / attn_bwd host time: the least of HOST_REPEATS readings of
#: HOST_ITERS calls (the host clock of a shared machine only adds to a
#: call's own cost).
HOST_ITERS = 100
HOST_REPEATS = 5
#: wkv_bwd: name -> ((B, S, H, N), dtype name, decays as chip_smoke's
#: ``strong_decays`` takes them, None for trained ones).
WKV_BWD_SHAPES = {
    "train_mixed": ((1, 512, 64, 64), "mixed", None),
    "train_mixed_w8": ((1, 512, 64, 64), "mixed", "-8"),
    "train_mixed_1e-30": ((1, 512, 64, 64), "mixed", "1e-30"),
}
WKV_BWD_ITERS = 20
#: The backward's kernels, by the part of their names after ``flash_bwd_``;
#: the reduce runs only where there are shares or partials to sum.
ATTN_BWD_KINDS = ("dot", "dkdv", "dq", "reduce")
#: name -> (kernel, file under src/, text, replacement[, file, text,
#: replacement ...]): edits of a tree.
VARIANTS = {
    # The bf16 forward's K/V tiles at 128 keys at every head dim, which the
    # consumers' 240 registers hold (64 at hd 128 and 160 measured faster).
    "fwd_keys_128": ("attn_fwd", "repro_torch/kernels/csrc/flash_attention.cu",
                     "static constexpr int kKeys = HD <= 64 ? 128 : 64;",
                     "static constexpr int kKeys = 128;"),
    # The bf16 forward with one block a row tile instead of a persistent grid.
    "fwd_not_persistent": ("attn_fwd", "repro_torch/kernels/csrc/flash_attention.cu",
                           "const int blocks = sms > 0 && sms < items ? sms : items;",
                           "const int blocks = items;",
                           "repro_torch/kernels/flash_attention.py",
                           '"fwd_blocks": min(row_tiles * B * Hk, sms),',
                           '"fwd_blocks": row_tiles * B * Hk,'),
    # The bf16 forward's TMA maps encoded by the driver at every call, none
    # kept (host time).
    "fwd_maps_uncached": ("attn_fwd", "repro_torch/kernels/csrc/hopper_wgmma.cuh",
                          "constexpr bool kCacheMaps = true;",
                          "constexpr bool kCacheMaps = false;"),
    "bwd_maps_uncached": ("attn_bwd", "repro_torch/kernels/csrc/hopper_wgmma.cuh",
                          "constexpr bool kCacheMaps = true;",
                          "constexpr bool kCacheMaps = false;"),
    # The bf16 dK/dV kernel streaming 32 query rows a tile at every head dim.
    "bwd_dkdv_rows_32": ("attn_bwd", "repro_torch/kernels/csrc/flash_attention_bwd.cu",
                         "static constexpr int kRows = HD <= 64 ? 64 : 32;",
                         "static constexpr int kRows = 32;"),
    # The bf16 dK/dV kernel as one consumer warpgroup and a producer warp at
    # every head dim, two blocks an SM where the registers allow it (hd <=
    # 128), the head groups planned for that.
    "bwd_dkdv_two_blocks": ("attn_bwd", "repro_torch/kernels/csrc/flash_attention_bwd.cu",
                            "static constexpr int kConsumers = HD <= 64 ? 2 : 1;",
                            "static constexpr int kConsumers = 1;",
                            "repro_torch/kernels/csrc/flash_attention_bwd.cu",
                            "__launch_bounds__(DkdvTile<HD>::kThreads, 1)",
                            "__launch_bounds__(DkdvTile<HD>::kThreads, HD <= 128 ? 2 : 1)",
                            "repro_torch/kernels/flash_attention.py",
                            "    return 2 if hd <= 64 else 1\n", "    return 1\n",
                            "repro_torch/kernels/flash_attention.py",
                            "/ (sms * C)", "/ (sms * C * (2 if hd <= 128 else 1))"),
    # The bf16 dK/dV grid with one head a block, G shares.
    "bwd_dkdv_heads_each": ("attn_bwd", "repro_torch/kernels/flash_attention.py",
                            "    return -(-G // per)\n", "    return G\n"),
    # The range kernel of the WKV backward free of the two-blocks-an-SM
    # register cap (one block an SM, no spill).
    "wkv_bwd_one_block": ("wkv_bwd", "repro_torch/kernels/csrc/rwkv_scan_bwd.cu",
                          "__launch_bounds__(Geo<N>::kThreads, 2)\nrwkv_scan_bwd_range_kernel(",
                          "__launch_bounds__(Geo<N>::kThreads)\nrwkv_scan_bwd_range_kernel("),
    # Ranges of at most 32 tokens (twice the blocks).
    "wkv_bwd_range_32": ("wkv_bwd", "repro_torch/kernels/rwkv_scan.py",
                         "BWD_MAX_SUBS = 4\n", "BWD_MAX_SUBS = 2\n"),
    # Ablation: the range kernel without its token walk (dw and the adjoint
    # are then wrong, which the run prints).
    "wkv_bwd_no_walk": ("wkv_bwd", "repro_torch/kernels/csrc/rwkv_scan_bwd.cu",
                        "for (int sl = 0; sl < Gm::kSlabs; ++sl) {",
                        "for (int sl = 0; sl < 0; ++sl) {"),
}


def mix_cases(torch, src: Path, only) -> dict:
    from repro_torch.kernels import gossip_mix as tk
    from repro_torch.kernels import ops

    assert Path(tk.__file__).resolve().is_relative_to(src.resolve()), tk.__file__
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def draw(shape, dt=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    h, p = ([{"w": draw((ROWS, a, b)), "b": draw((ROWS, b))}
             for a, b in zip(MLP_DIMS[:-1], MLP_DIMS[1:])] for _ in range(2))
    w = torch.rand(ROWS, generator=gen, device=dev)
    out = {}

    def case(name, fn, iters):
        if only and name not in only:
            return
        tk.reset_launches()
        fn()
        torch.cuda.synchronize()
        out[name] = {"launches_a_call": sum(tk.LAUNCHES.values()),
                     "device_ms": cs.device_ms(torch, fn, iters),
                     "call_ms": cs.cuda_ms(torch, fn, iters),
                     "host_ms": cs.host_ms(torch, fn, iters)}

    case("tree", lambda: ops.gossip_mix_tree(h, p, w), 200)
    # One replica's six leaves through the scalar entry point, one call each,
    # and torch.lerp on the same leaves (u = 0 only; a yardstick).
    leaves = [(layer[k], pl[k]) for layer, pl in zip(h, p) for k in layer]
    replica = [(x[0].contiguous(), q[0].contiguous(), torch.zeros_like(x[0]))
               for x, q in leaves]
    case("replica", lambda: [tk.gossip_mix(x, z, q, 0.3) for x, q, z in replica], 200)
    case("replica_lerp", lambda: [torch.lerp(x, q, 0.3) for x, q, _ in replica], 200)
    for name, (entry, shape, dt, iters) in MIX_LARGE.items():
        x, u, q = (draw(shape, getattr(torch, dt)) for _ in range(3))
        if entry == "gossip_mix_rows":
            wr = torch.linspace(0.0, 1.0, shape[0], device=dev)
            case(name, lambda: tk.gossip_mix_rows(x, u, q, wr), iters)
        else:
            case(name, lambda: tk.gossip_mix(x, u, q, 0.3), iters)
        del x, u, q
        torch.cuda.empty_cache()
    return out


def least_host_ms(torch, fn) -> float:
    return min(cs.host_ms(torch, fn, HOST_ITERS) for _ in range(HOST_REPEATS))


def attn_fwd_cases(torch, src: Path, only) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    assert Path(fa.__file__).resolve().is_relative_to(src.resolve()), fa.__file__
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for case in [*cs.ATTN_FAMILY_CASES, cs.ATTN_MAIN, cs.ATTN_LARGE, *ATTN_FWD_EXTRA]:
        B, S, Sk, H, Hk, hd, causal, dtype = case
        name = f"{dtype}_{B}x{S}x{Sk}_{H}-{Hk}_hd{hd}{'_causal' if causal else ''}"
        if only and name not in only:
            continue
        dt = getattr(torch, dtype)
        q = torch.randn((B, S, H, hd), generator=gen, device=dev).to(dt)
        k, v = (torch.randn((B, Sk, Hk, hd), generator=gen, device=dev).to(dt)
                for _ in range(2))

        def fn():
            return fa.flash_attention(q, k, v, causal=causal)

        err = (fn().float() - ref.reference_attention(q, k, v, causal=causal).float()
               ).abs().max().item()
        launched = dict(getattr(fa, "FWD_LAUNCHED", {}))
        per_call = 2 if launched.get("key_splits", 1) > 1 else 1
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        it = ATTN_FWD_ITERS

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)

        out[name] = {
            "device_ms": cs.device_ms(torch, fn, it, "flash_fwd", per_call=per_call),
            "call_ms": cs.cuda_ms(torch, fn, it),
            "host_ms": least_host_ms(torch, fn),
            "library_ms": cs.device_ms(torch, sdpa, it),
            "library_call_ms": cs.cuda_ms(torch, sdpa, it),
            "max_abs_err": err,
            "launched": launched,
        }
        if per_call == 2:
            out[name]["kinds_ms"] = {kind: cs.device_ms(torch, fn, it, f"flash_fwd_{kind}")
                                     for kind in ("tf32x3", "merge")}
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return out


def attn_bwd_cases(torch, src: Path, only) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    assert Path(fa.__file__).resolve().is_relative_to(src.resolve()), fa.__file__
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, ((B, S, Sk, H, Hk, hd, causal), dtype) in ATTN_BWD_SHAPES.items():
        if only and name not in only:
            continue
        dt = getattr(torch, dtype)
        q, do = (torch.randn((B, S, H, hd), generator=gen, device=dev).to(dt) for _ in range(2))
        k, v = (torch.randn((B, Sk, Hk, hd), generator=gen, device=dev).to(dt)
                for _ in range(2))
        o, lse = fa._forward(q, k, v, causal, with_lse=True)

        def fn():
            return fa.flash_attention_backward(q, k, v, o, do, lse, causal=causal)

        fn()
        launched = dict(getattr(fa, "BWD_LAUNCHED", {}))
        per_call = launched.get("kernels") or 4
        kinds = ATTN_BWD_KINDS if per_call == 4 else ATTN_BWD_KINDS[:per_call]
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                  enable_gqa=True)
        dot = do.transpose(1, 2).contiguous()
        it = ATTN_BWD_ITERS

        def sdpa():
            return torch.autograd.grad(sdpa_out, (qt, kt, vt), dot, retain_graph=True)

        out[name] = {
            "device_ms": cs.device_ms(torch, fn, it, "flash_bwd", per_call=per_call),
            "kinds_ms": {kind: cs.device_ms(torch, fn, it, f"flash_bwd_{kind}_")
                         for kind in kinds},
            "call_ms": cs.cuda_ms(torch, fn, it),
            "host_ms": least_host_ms(torch, fn),
            "library_ms": cs.device_ms(torch, sdpa, it),
            "library_call_ms": cs.cuda_ms(torch, sdpa, it),
            "launched": launched,
        }
        del q, k, v, do, o, lse, qt, kt, vt, sdpa_out, dot
        torch.cuda.empty_cache()
    return out


def wkv_bwd_cases(torch, src: Path, only) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv_scan as rs

    assert Path(rs.__file__).resolve().is_relative_to(src.resolve()), rs.__file__
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    per_call = getattr(rs, "BWD_KERNELS_PER_CALL", 1)
    out = {}
    for name, (shape, dtype, how) in WKV_BWD_SHAPES.items():
        if only and name not in only:
            continue
        dt, wdt = (getattr(torch, d) for d in cs.RWKV_DTYPES[dtype])
        r, k = ((torch.randn(shape, generator=gen, device=dev) * 0.5).to(dt) for _ in range(2))
        v, dy = (torch.randn(shape, generator=gen, device=dev).to(dt) for _ in range(2))
        w = torch.sigmoid(torch.randn(shape, generator=gen, device=dev) + 2.0).to(wdt)
        if how is not None:
            w = cs.strong_decays(torch, w, how, gen)
        u = torch.randn((shape[2], shape[3]), generator=gen, device=dev) * 0.1

        def fn():
            return rs.rwkv_scan_backward(r, k, v, w, u, None, dy, None, with_dstate0=False)

        it = WKV_BWD_ITERS
        got = fn()
        want = ref.reference_rwkv_backward(r, k, v, w, u, None, dy, None)
        errs = {g: ((a.float() - b.float()).abs().max()
                    / b.float().abs().max().clamp_min(1e-30)).item()
                for g, a, b in zip(("dr", "dk", "dv", "dw", "du"), got, want)}
        del got, want
        launched = getattr(rs, "BWD_LAUNCHED", None)
        if launched is not None:
            per_call = len(launched["kernels"])
        out[name] = {
            "device_ms": cs.device_ms(torch, fn, it, "rwkv_scan_bwd", per_call=per_call),
            "call_ms": cs.cuda_ms(torch, fn, it),
            "kernels_per_call": per_call,
            "max_rel_err": errs,
            "within_tol": all(e <= cs.RWKV_BWD_TOL[dtype] for e in errs.values()),
        }
        if launched is not None:
            out[name]["launched"] = dict(launched)
            out[name]["kinds_ms"] = {kn: cs.device_ms(torch, fn, it, kn)
                                     for kn in launched["kernels"]}
        del r, k, v, w, u, dy
        torch.cuda.empty_cache()
    return out


CASES = {"mix": mix_cases, "attn_fwd": attn_fwd_cases, "attn_bwd": attn_bwd_cases,
         "wkv_bwd": wkv_bwd_cases}


def run_one(kernel: str, src: Path, only) -> dict:
    """Time one tree's kernel in this process (``src``: its ``src/``)."""
    sys.path.insert(0, str(src))
    import torch

    return CASES[kernel](torch, src, only)


def make_variant(name: str, base: Path) -> Path:
    """``base``'s ``src/`` copied to ``build/variants/NAME`` with the edits."""
    edits = VARIANTS[name][1:]
    root = ROOT / "build" / "variants" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(base / "src", root / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, old, new in zip(edits[::3], edits[1::3], edits[2::3]):
        path = root / "src" / rel
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{rel} no longer holds {old!r} once")
        path.write_text(text.replace(old, new))
    return root


def _fmt(ms):
    return "    n/a" if ms is None else f"{ms * 1e3:9.2f}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(CASES), required=True)
    ap.add_argument("--before", type=Path, help="root of the earlier checkout")
    ap.add_argument("--after", type=Path, default=ROOT, help="root of the later checkout")
    ap.add_argument("--variant", choices=sorted(VARIANTS), default=None,
                    help="time --after with this edit against --before (default: here)")
    ap.add_argument("--cases", default="", help="comma-separated case names (default: all)")
    ap.add_argument("--out", type=Path, default=None, help="JSON file for the numbers")
    ap.add_argument("--one", type=Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    only = [c for c in args.cases.split(",") if c]
    if args.one is not None:  # a child: time one tree, print its JSON
        print(json.dumps(run_one(args.kernel, args.one, only)))
        return 0
    if args.variant is not None:
        if VARIANTS[args.variant][0] != args.kernel:
            ap.error(f"variant {args.variant} edits {VARIANTS[args.variant][0]}")
        args.before = args.before or ROOT
        args.after = make_variant(args.variant, args.after)
    if args.before is None:
        ap.error("--before (or --variant) is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip()
    print(card)
    runs, wrong = [], []
    for label, root in (("before", args.before), ("after", args.after),
                        ("after", args.after), ("before", args.before)):
        proc = subprocess.run([sys.executable, __file__, "--kernel", args.kernel,
                               "--cases", args.cases, "--one", str(root / "src")],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n")
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append({"label": label, "root": str(root), "cases": res})
        for name, r in res.items():
            extra = ""
            if "kinds_ms" in r:
                extra = " (" + " ".join(f"{k} {_fmt(v).strip()}"
                                        for k, v in r["kinds_ms"].items()) + ")"
            if "launched" in r:
                extra += f" {r['launched']}"
            if "library_ms" in r:
                extra += f"  sdpa {_fmt(r['library_ms'])} us"
                if "library_call_ms" in r:
                    extra += f" (events {_fmt(r['library_call_ms']).strip()})"
            if "launches_a_call" in r:
                extra = f"  launches {r['launches_a_call']:2d}"
            if "host_ms" in r:
                extra += f"  host {_fmt(r['host_ms'])} us"
            if "max_rel_err" in r:
                extra += f"  max rel err {max(r['max_rel_err'].values()):.3g}"
                if not r["within_tol"]:
                    extra += " BEYOND TOLERANCE"
                    if not (label == "after" and args.variant):
                        wrong.append((label, name))
            print(f"{label:6s} {name:18s} device {_fmt(r['device_ms'])} us{extra}  "
                  f"per call {_fmt(r['call_ms'])} us")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "kernel": args.kernel,
                                        "variant": args.variant, "runs": runs}, indent=1))
    if wrong:
        print(f"gradients beyond tolerance: {wrong}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
