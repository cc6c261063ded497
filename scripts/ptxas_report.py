"""Print what ptxas reports for every CUDA kernel of the PyTorch/CUDA port.

    python3 scripts/ptxas_report.py [--sass]

Compiles each source of ``repro_torch.kernels.build.SOURCES`` with the
port's own nvcc flags plus ``-Xptxas -v`` into a temporary directory, all
sources at once, and prints per kernel instantiation its registers, stack
frame and spill bytes, and every warning (ptxas's C7508 says it ignored a
``setmaxnreg``).  With ``--sass`` it also disassembles each library
(``cuobjdump -sass``) and prints per kernel the count of each instruction
family in ``SASS_OPS``: tensor-core products (HMMA of ``mma.sync``, HGMMA
of ``wgmma``), shared-memory fragment loads (LDSM), ``cp.async`` copies
(LDGSTS), TMA copies (UTMALDG / UTMASTG), block barriers (BAR) and
mbarrier operations (SYNCS).  Needs ``nvcc`` (a machine with the CUDA
toolkit); imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402


#: SASS instruction families counted by ``--sass``, by opcode prefix.
SASS_OPS = ("HGMMA", "HMMA", "LDSM", "LDGSTS", "UTMALDG", "UTMASTG", "BAR", "SYNCS")


def sass_counts(sass: str) -> dict:
    """Kernel symbol -> {family: count} from ``cuobjdump -sass`` text."""
    counts, fn = {}, None
    pattern = re.compile(r"\b(" + "|".join(SASS_OPS) + r")\b[.\s]")
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ", 1)[1].strip()
            counts[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn is not None:
            m = pattern.search(line)
            if m:
                counts[fn][m.group(1)] += 1
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass", action="store_true",
                    help="also count each kernel's SASS instruction families")
    args = ap.parse_args()
    exe = build.nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        procs = {
            name: subprocess.Popen(
                [exe, *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(Path(tmp) / f"{name}.so"),
                 str(build.CSRC / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name, src in build.SOURCES.items()
        }
        rc = 0
        for name, proc in procs.items():
            log, _ = proc.communicate()
            print(f"== {build.SOURCES[name]} (nvcc exit {proc.returncode})")
            rc |= proc.returncode
            for line in log.splitlines():
                if ("Compiling entry function" in line or "registers" in line
                        or "spill" in line or "warning" in line or proc.returncode):
                    print(line.strip())
        if args.sass and not rc:
            dump = Path(exe).parent / "cuobjdump"
            print("== SASS per kernel: " + " ".join(SASS_OPS))
            for name in procs:
                out = subprocess.run([str(dump), "-sass", str(Path(tmp) / f"{name}.so")],
                                     capture_output=True, text=True, timeout=600)
                rc |= out.returncode
                for fn, c in sorted(sass_counts(out.stdout).items()):
                    print(f"{fn} " + " ".join(f"{op}={c[op]}" for op in SASS_OPS))
    return 1 if rc else 0


if __name__ == "__main__":
    sys.exit(main())
