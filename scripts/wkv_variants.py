"""Time the WKV-scan kernel against variants of itself, on one NVIDIA card.

    python3 scripts/wkv_variants.py [--before DIR]

Each variant is ``src/repro_torch/kernels/csrc/rwkv_scan.cu`` with one edit,
built with the port's nvcc flags (all at once) and called through the same
wrapper at the ssm LM shape (4, 512, 64 heads, N 64), in the model's dtypes
(bf16 r/k/v, f32 w) and in f32, with CUDA events, the unedited kernel timed
first and last, and once more on decays of log w = -8 a step, where every
sub-chunk forms its scores pairwise.  With ``--before DIR`` (the root of an
earlier checkout, ``git archive <commit> | tar -x -C DIR``) that tree's
kernel is built and timed too, before and after the rest; a kernel from
before the pairwise branch takes the clamp bound, and is given 75 / 16 as
its wrapper gave it.  The ablations compute wrong values; they show what
each part of a sub-chunk costs:

- ``cvt_split``: the 3xTF32 split by two ``cvt.rna.tf32.f32``;
- ``no_exp_log``: the decay pass without its exp and log;
- ``no_scores``: without the score products and P v;
- ``no_y_products``: without r_dec S;
- ``no_state_update``: without the state update's products;
- ``no_pairwise``: without the pairwise branch (every sub-chunk
  factorised), what the exact branch costs the trained range.

Needs ``nvcc`` and a card; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import rwkv_scan as rs  # noqa: E402

SPLIT = """  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));"""
CVT_SPLIT = """  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(rest));"""
# Whole statements of the kernel, matched whatever their indentation.
SCORES = "mma3(pacc[jt], plo[jt], a, FragB(kr[0], kr[4]));"
P_V = "mma3(yacc[nt], ylo[nt], a, vb[kk][nt]);"
Y_PRODUCTS = "mma3(yacc[nt], ylo[nt], a, FragB(sr[0], sr[4 * kSS]));"
PAIRWISE = "const bool pairwise = Wide[idx % 3] != 0;"
NO_PAIRWISE = "const bool pairwise = false;"
STATE = "for (int nt = 0; nt < kNT; ++nt) mma3(sacc[mt][nt], slo[mt][nt], a, vb[kk][nt]);"


def _replace(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"rwkv_scan.cu no longer holds {old.strip()[:60]!r} once")
    return src.replace(old, new)
def variants(src: str) -> dict[str, str]:
    d0 = src.index("  auto log_decays = [&](int idx,")
    d1 = src.index("  // The ring:")
    no_exp_log = src[:d0] + src[d0:d1].replace("expf(", "(").replace("logf(", "(") + src[d1:]
    return {
        "kernel": src,
        "cvt_split": _replace(src, SPLIT, CVT_SPLIT),
        "no_exp_log": no_exp_log,
        "no_scores": _replace(_replace(src, SCORES, ""), P_V, ""),
        "no_y_products": _replace(src, Y_PRODUCTS, ""),
        "no_state_update": _replace(src, STATE, ""),
        "no_pairwise": _replace(src, PAIRWISE, NO_PAIRWISE),
    }


def ms_per_call(torch, fn, iters=20, reps=5) -> float:
    for _ in range(3):
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


class _WithBound:
    """A kernel library whose launch still takes the clamp bound (before the
    kernel was made exact): passes 75 / sub after ``sub``, as its wrapper
    did."""

    def __init__(self, lib):
        self.lib = lib
        self.rwkv_scan_error_string = lib.rwkv_scan_error_string

    def rwkv_scan_launch(self, *args):
        sub = args[13]
        return self.lib.rwkv_scan_launch(*args[:14], 75.0 / sub, *args[14:])


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--before", type=Path, default=None,
                    help="root of an earlier checkout whose kernel is timed too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wkv_variants: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    srcs = variants((build.CSRC / build.SOURCES["rwkv_scan"]).read_text())
    if args.before is not None:
        srcs["before"] = (args.before / "src/repro_torch/kernels/csrc/rwkv_scan.cu").read_text()
    base = rs._lib()
    with tempfile.TemporaryDirectory() as tmp:
        def compile_one(name):
            cu, so = Path(tmp) / f"{name}.cu", Path(tmp) / f"{name}.so"
            cu.write_text(srcs[name])
            p = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                               capture_output=True, text=True)
            if p.returncode:
                raise SystemExit(f"{name}: nvcc failed\n{p.stdout}{p.stderr}")
            lib = ctypes.CDLL(str(so))
            types = list(base.rwkv_scan_launch.argtypes)
            bounded = "lw_bound" in srcs[name]
            if bounded:
                types.insert(14, ctypes.c_float)
            lib.rwkv_scan_launch.argtypes = types
            lib.rwkv_scan_launch.restype = ctypes.c_int
            lib.rwkv_scan_error_string.argtypes = [ctypes.c_int]
            lib.rwkv_scan_error_string.restype = ctypes.c_char_p
            return name, _WithBound(lib) if bounded else lib

        with ThreadPoolExecutor(len(srcs)) as ex:
            libs = dict(ex.map(compile_one, srcs))
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(0)
        shape = (4, 512, 64, 64)
        for kind, rdt in (("bf16 r/k/v, f32 w", torch.bfloat16), ("f32", torch.float32)):
            r, k = ((torch.randn(shape, generator=gen, device=dev) * 0.5).to(rdt)
                    for _ in range(2))
            v = torch.randn(shape, generator=gen, device=dev).to(rdt)
            w = torch.sigmoid(torch.randn(shape, generator=gen, device=dev) + 2.0)
            u = torch.randn((64, 64), generator=gen, device=dev) * 0.1
            s0 = torch.zeros((4, 64, 64, 64), device=dev)
            w8 = torch.full(shape, float(torch.exp(torch.tensor(-8.0))), device=dev)
            first = ["before"] if "before" in srcs else []
            order = first + [n for n in srcs if n != "before"] + ["kernel"] + first
            res = {}
            for name in order:
                rs._LIB = libs[name]
                t = ms_per_call(torch, lambda: rs.rwkv_scan(r, k, v, w, u, state=s0))
                res.setdefault(name, []).append(t)
            strong = {}
            for name in first + ["kernel"]:
                rs._LIB = libs[name]
                strong[name] = ms_per_call(torch, lambda: rs.rwkv_scan(r, k, v, w8, u,
                                                                       state=s0))
            rs._LIB = base
            ref_us = statistics.mean(res["kernel"]) * 1e3
            print(f"{kind}, {shape}: kernel {res['kernel'][0] * 1e3:.2f} / "
                  f"{res['kernel'][1] * 1e3:.2f} us (first / last); at log w = -8 "
                  f"{strong['kernel'] * 1e3:.2f} us")
            if first:
                print(f"  before           {res['before'][0] * 1e3:.2f} / "
                      f"{res['before'][1] * 1e3:.2f} us (first / last); at log w = -8 "
                      f"{strong['before'] * 1e3:.2f} us (clamped)")
            for name in order[1 + len(first):-1 - len(first)]:
                us = res[name][0] * 1e3
                print(f"  {name:16s} {us:8.2f} us  ({(us - ref_us) / ref_us:+.1%})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
