"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
by ``nvcc`` for Hopper (``sm_90a``) into ``lib<name>-<digest>.so`` under the
build directory, then loaded with ``ctypes``.  The digest covers the source
text, the headers beside it (``csrc/*.cuh``) and the flags, so an edited
source or header never meets a stale library.  A library that is missing is
built; nothing here falls back to anything else when ``nvcc`` is absent or
fails, it raises.

The build directory is ``build/torch_ext`` at the root of the checkout.
``build()`` starts one ``nvcc`` per source, all together, and waits for
them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"

#: Kernel library name -> CUDA source under ``csrc/``.
SOURCES = {"gossip_mix": "gossip_mix.cu", "flash_attention": "flash_attention.cu",
           "flash_attention_bwd": "flash_attention_bwd.cu", "rwkv_scan": "rwkv_scan.cu",
           "rwkv_scan_bwd": "rwkv_scan_bwd.cu"}

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_LOADED: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "torch_ext"


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default prefix.  Raises when none has it."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin): "
        "the CUDA kernels of repro_torch are built from source on first use"
    )


def library_path(name: str) -> Path:
    src = CSRC / SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # the headers the sources include
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, Path]:
    """Compile every missing library of ``names`` (default: all), one
    concurrent ``nvcc`` per source.  Returns name -> library path."""
    names = list(SOURCES) if names is None else list(names)
    out = {n: library_path(n) for n in names}
    todo = {n: p for n, p in out.items() if not p.is_file()}
    if not todo:
        return out
    build_dir().mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp, p)
    failed = []
    for n, (proc, tmp, p) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, p)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, building it first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LOADED[name] = lib
    return lib
