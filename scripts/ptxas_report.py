"""Print what ptxas reports for every CUDA kernel of the PyTorch/CUDA port.

    python3 scripts/ptxas_report.py

Compiles each source of ``repro_torch.kernels.build.SOURCES`` with the
port's own nvcc flags plus ``-Xptxas -v`` into a temporary directory, all
sources at once, and prints per kernel instantiation its registers, stack
frame and spill bytes.  Needs ``nvcc`` (a machine with the CUDA toolkit);
imports nothing of JAX.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402


def main() -> int:
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
                        or "spill" in line or proc.returncode):
                    print(line.strip())
    return 1 if rc else 0


if __name__ == "__main__":
    sys.exit(main())
