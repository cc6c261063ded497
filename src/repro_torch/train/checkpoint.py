"""Checkpoint/restart: atomic, sharded by worker, bit-exact resume.

A transcription of ``repro/train/checkpoint.py`` with the same layout, leaf
names and tree hash, so each package restores the other's checkpoints:

  <dir>/step_<N>/
    worker_<i>.npz     the param ("p/<name>") and optimizer ("o/<name>")
                       leaves of worker i
    monitor.json       Network Monitor state (policy, rho)
    manifest.json      step, M, data cursor, tree-structure hash

Leaf names join the path of dict keys and list indices with "/", leaves in
the trees' order (dicts by sorted key).  Write protocol: write into
step_<N>.tmp/, fsync the files, rename to step_<N>/, then update LATEST
(write a temporary file and rename it).  A crash mid-write leaves the
previous LATEST intact; partial .tmp directories are removed on the next
save.

bfloat16 leaves are stored as 2-byte void elements (``|V2``), the bytes of
each value, which is what numpy writes for the JAX package's ml_dtypes
bfloat16; on restore a 2-byte void leaf becomes a bfloat16 tensor again, so
neither side needs ml_dtypes.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from pathlib import Path

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_flatten, tree_unflatten

_BF16_VOID = np.dtype("V2")


def _named_leaves(tree, prefix=""):
    """[(name, leaf)] in the tree's leaf order; names as JAX's key paths."""
    if isinstance(tree, dict):
        return [nl for k in sorted(tree) for nl in _named_leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [nl for i, t in enumerate(tree) for nl in _named_leaves(t, f"{prefix}{i}/")]
    if tree is None:
        return []
    return [(prefix[:-1], tree)]


def _to_numpy(t) -> np.ndarray:
    t = torch.as_tensor(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_VOID)
    return t.numpy()


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, copy=True)
    if (a.dtype.kind == "V" and a.dtype.itemsize == 2) or a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _flatten_with_names(tree) -> dict:
    return {name: _to_numpy(leaf) for name, leaf in _named_leaves(tree)}


def _tree_hash(tree) -> str:
    names = sorted(name for name, _ in _named_leaves(tree))
    return hashlib.sha1("|".join(names).encode()).hexdigest()[:16]


def save(
    ckpt_dir: str | Path,
    step: int,
    params,
    opt_state,
    *,
    monitor_state: dict | None = None,
    data_cursor: dict | None = None,
    worker_sharded: bool = True,
):
    """params/opt_state leaves: (M, ...) stacked over workers."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    # Remove the temporary directories of crashed saves.
    for p in ckpt_dir.glob("step_*.tmp"):
        shutil.rmtree(p, ignore_errors=True)

    tmp = ckpt_dir / f"step_{step}.tmp"
    final = ckpt_dir / f"step_{step}"
    tmp.mkdir(parents=True)
    pflat = _flatten_with_names(params)
    oflat = _flatten_with_names(opt_state)
    M = next(iter(pflat.values())).shape[0] if (worker_sharded and pflat) else 1
    for i in range(M):
        blob = {}
        for k, v in pflat.items():
            blob[f"p/{k}"] = v[i] if worker_sharded else v
        for k, v in oflat.items():
            blob[f"o/{k}"] = v[i] if (worker_sharded and v.ndim > 0 and v.shape[:1] == (M,)) else v
        path = tmp / f"worker_{i}.npz"
        with open(path, "wb") as f:
            np.savez(f, **blob)
            f.flush()
            os.fsync(f.fileno())
    manifest = dict(
        step=step,
        n_workers=M,
        worker_sharded=worker_sharded,
        tree_hash=_tree_hash(params),
        data_cursor=data_cursor or {},
    )
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if monitor_state is not None:
        with open(tmp / "monitor.json", "w") as f:
            json.dump(monitor_state, f)
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    # LATEST pointer, atomically.
    lat_tmp = ckpt_dir / "LATEST.tmp"
    lat_tmp.write_text(str(step))
    os.replace(lat_tmp, ckpt_dir / "LATEST")
    return final


def latest_step(ckpt_dir: str | Path) -> int | None:
    p = Path(ckpt_dir) / "LATEST"
    if not p.exists():
        return None
    return int(p.read_text().strip())


def restore(ckpt_dir: str | Path, params_like, opt_like, step: int | None = None,
            device=None):
    """Returns (params, opt_state, manifest, monitor_state | None).

    params_like/opt_like: trees (current values, or the ``meta`` tensors of
    ``trainer.abstract_stacked``) that define the structure; the restored
    tensors replace their leaves, on ``device`` (CUDA unless the caller
    asks for the CPU)."""
    dev = resolve_device(device)
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = ckpt_dir / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    M = manifest["n_workers"]
    sharded = manifest["worker_sharded"]
    blobs = [np.load(d / f"worker_{i}.npz") for i in range(M)]

    def rebuild(tree, prefix):
        _, treedef = tree_flatten(tree)
        new_leaves = []
        for name, leaf in _named_leaves(tree):
            key = f"{prefix}/{name}"
            if sharded and blobs[0][key].ndim == leaf.ndim - 1:
                arr = np.stack([b[key] for b in blobs])
            else:
                arr = blobs[0][key]
            new_leaves.append(_to_tensor(arr, dev))
        return tree_unflatten(treedef, new_leaves)

    params = rebuild(params_like, "p")
    opt_state = rebuild(opt_like, "o")
    mon = None
    if (d / "monitor.json").exists():
        mon = json.loads((d / "monitor.json").read_text())
    return params, opt_state, manifest, mon
