"""Time the gossip-mix kernel against variants of itself, on one NVIDIA card.

    python3 scripts/mix_variants.py

Each variant is ``src/repro_torch/kernels/csrc/gossip_mix.cu`` with one edit,
built with the port's nvcc flags (all at once) and called through the same
wrapper, on the cohort's MLP tree (six leaves x 32 rows, f32, u absent: one
launch) and on one replica's six leaves (the scalar entry point, six
launches; and as six one-row launches without u, the operands lerp reads),
with ``torch.lerp`` on the same leaves beside them.  Device time
from torch.profiler (the kernel's launches only); each variant is timed
twice, in order and in reverse, the unedited kernel first and last.  All variants compute the same values:

- ``table_8``: a leaf table of 8 leaves (528 bytes of kernel parameters)
  instead of 48 (3088 bytes);
- ``no_one_leaf_path``: a one-leaf launch counts its leaf as a tree does;
- ``leaf_by_value``: the block's leaf copied out of the table, not read in
  place;
- ``threads_<t>_<k>_an_sm``: t threads a block (256, 128, 64), the plan
  aiming for k blocks an SM (2 or 4).

The large shape (8, 2^24) f32 with u is timed too, the bandwidth check.
Needs ``nvcc`` and a card; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import gossip_mix as tk  # noqa: E402

MLP_DIMS = [32, 128, 64, 10]
ONE_LEAF = """  if (t.count == 1) {  // one leaf: its fields are constants, no search
    mix_chunk<T, kHasU, kUnroll>(t, t.leaf[0], b);
    return;
  }
"""


def _replace(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"gossip_mix.cu no longer holds {old.strip()[:60]!r} once")
    return src.replace(old, new)


def variants(src: str) -> dict:
    """name -> (source, threads a block, blocks an SM the plan aims for)."""
    def threads(n):
        return src if n == tk.THREADS else _replace(
            src, f"constexpr int kThreads = {tk.THREADS};", f"constexpr int kThreads = {n};")

    return {
        "kernel": (src, tk.THREADS, tk.BLOCKS_PER_SM),
        "table_8": (_replace(src, "constexpr int kMaxLeaves = 48;",
                             "constexpr int kMaxLeaves = 8;"), tk.THREADS, tk.BLOCKS_PER_SM),
        "no_one_leaf_path": (_replace(src, ONE_LEAF, ""), tk.THREADS, tk.BLOCKS_PER_SM),
        "leaf_by_value": (_replace(src, "const Table& t, const Leaf& leaf, long long b)",
                                   "const Table& t, const Leaf leaf, long long b)"),
                          tk.THREADS, tk.BLOCKS_PER_SM),
        **{f"threads_{n}_{k}_an_sm": (threads(n), n, k) for n in (256, 128, 64)
           for k in (2, 4)},
    }


def device_us(torch, fn, per_call, iters=50) -> float:
    """Device time (us) a call of ``fn`` spends in the mix kernel (or in
    lerp), over the calls the traced launches account for (``fn`` makes
    ``per_call`` of them): a trace may hold fewer launches than were made."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    found = [e for e in prof.key_averages()
             if "mix_tree_kernel" in e.key or "lerp" in e.key]
    us, n = sum(e.self_device_time_total for e in found), sum(e.count for e in found)
    if us <= 0 or n == 0:
        raise SystemExit("the profiler traced no mix or lerp kernel")
    return us / (n / per_call)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mix_variants: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    srcs = variants((build.CSRC / build.SOURCES["gossip_mix"]).read_text())
    base = tk._lib()
    with tempfile.TemporaryDirectory() as tmp:
        def compile_one(name):
            cu, so = Path(tmp) / f"{name}.cu", Path(tmp) / f"{name}.so"
            cu.write_text(srcs[name][0])
            p = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                               capture_output=True, text=True)
            if p.returncode:
                raise SystemExit(f"{name}: nvcc failed\n{p.stdout}{p.stderr}")
            lib = ctypes.CDLL(str(so))
            for fn in ("gossip_mix_tree_launch", "gossip_mix_error_string"):
                getattr(lib, fn).argtypes = getattr(base, fn).argtypes
                getattr(lib, fn).restype = getattr(base, fn).restype
            return name, lib

        with ThreadPoolExecutor(len(srcs)) as ex:
            libs = dict(ex.map(compile_one, srcs))
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(0)
        shapes = [s for a, b in zip(MLP_DIMS[:-1], MLP_DIMS[1:]) for s in ((a, b), (b,))]
        xs = [torch.randn((32,) + s, generator=gen, device=dev) for s in shapes]
        ps = [torch.randn((32,) + s, generator=gen, device=dev) for s in shapes]
        w = torch.rand(32, generator=gen, device=dev)
        w1 = torch.full((1,), 0.3, device=dev)
        replica = [(x[0].contiguous(), p[0].contiguous(), torch.zeros_like(x[0]))
                   for x, p in zip(xs, ps)]
        big = [torch.randn((8, 2 ** 24), generator=gen, device=dev) for _ in range(3)]
        w8 = torch.rand(8, generator=gen, device=dev)
        cases = {  # name -> (call, kernel launches a call)
            "tree": (lambda: tk.gossip_mix_rows_tree(xs, None, ps, w), 1),
            "replica": (lambda: [tk.gossip_mix(x, z, p, 0.3) for x, p, z in replica], 6),
            # The same six launches without u: the operands lerp reads.
            "replica, u absent": (lambda: [tk.gossip_mix_rows(x[None], None, p[None], w1)
                                           for x, p, _ in replica], 6),
            "large (8, 2^24) f32": (lambda: tk.gossip_mix_rows(*big, w8), 1),
        }
        lerp = device_us(torch, lambda: [torch.lerp(x, p, 0.3) for x, p, _ in replica], 6)
        print(f"one replica's six leaves, six torch.lerp: {lerp:.2f} us")
        order = list(srcs) + list(reversed(srcs))  # each twice, the kernel first and last
        res = {}
        try:
            for name in order:
                tk._LIB = libs[name]
                _, tk.THREADS, tk.BLOCKS_PER_SM = srcs[name]
                tk.plan.cache_clear()
                for case, (fn, per_call) in cases.items():
                    got = fn()
                    want = ([torch.lerp(x, p, w.reshape((-1,) + (1,) * (x.ndim - 1)))
                             for x, p in zip(xs, ps)] if case == "tree" else None)
                    if want is not None and not all(
                            torch.allclose(g, v, atol=1e-6) for g, v in zip(got, want)):
                        raise SystemExit(f"{name}: the tree mix disagrees with lerp")
                    res.setdefault((name, case), []).append(device_us(torch, fn, per_call))
        finally:
            tk._LIB = base
            _, tk.THREADS, tk.BLOCKS_PER_SM = srcs["kernel"]
            tk.plan.cache_clear()
        for case in cases:
            k0, k1 = res[("kernel", case)]
            ref = (k0 + k1) / 2
            print(f"{case}: kernel {k0:.2f} / {k1:.2f} us (first / last)")
            for name in list(srcs)[1:]:
                a, b = res[(name, case)]
                print(f"  {name:20s} {a:8.2f} / {b:8.2f} us  ({(a + b) / 2 / ref - 1:+.1%})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
