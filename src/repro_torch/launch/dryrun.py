"""Multi-pod dry-run of the port: trace every (arch x shape x mesh) cell per rank.

The port of ``repro/launch/dryrun.py``.  No machine here has 256 cards, so
a cell runs as rank 0 of a *fake* process group (torch's
``FakeProcessGroup``: every collective returns at once and moves nothing)
of 256 or 512 ranks, on ``meta`` tensors (shapes and dtypes, no storage).
For each cell this driver:

  1. joins the fake group and builds the production mesh on it
     (``launch.mesh.PRODUCTION_SHAPE``: 16x16 single-pod, 2x16x16
     multi-pod), typed ``cuda`` so that DTensor picks the collectives NCCL
     would run (on a ``cpu`` mesh it would stand an all-gather and a chunk
     in for each all-to-all); a serving cell runs on its (data, model)
     sub-mesh, since serving replicates over 'pod';
  2. resolves the sharding plan (worker axes / TP -- ``dist.sharding``);
  3. runs the program once on rank 0's shards of ``launch.specs``' inputs
     (``dist.sharding.local_meta``): the training step
     (``train.trainer.make_train_step`` with the plan's specs: a worker's
     loss and grads as DTensors over 'model', the pulls and means over the
     worker ranks), or the serving prefill / decode step on DTensors over
     the whole mesh; every kernel takes its ``meta`` route
     (``kernels/ops.py``);
  4. counts it with ``analysis.cost.CostCounter``: per-rank FLOPs, bytes,
     collective bytes by kind, kernel calls, and the peak of the bytes the
     program allocates, which stands in for XLA's ``memory_analysis()``:
     the inputs are made before the counter, so the argument bytes stay
     out of the temp, as XLA counts them (with ``--save-ops``, the
     tensors live at that peak too, ``analysis.breakdown.peak_groups``);
  5. appends a JSON record under ``artifacts/dryrun_torch/`` (never
     ``artifacts/dryrun/``, the JAX sweep's).

The record keeps the JAX record's key names (``hlo_flops_per_device`` and
so on), so ``analysis.roofline.from_record`` reads both; ``t_trace_s``
stands where the JAX record has its lower and compile times.  A decode
step runs at position ``seq_len - 1`` (a Python int: the port's decode
writes the cache in place at a host position).

Usage (the CPU is enough):
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--gossip ppermute]
"""

from __future__ import annotations

import argparse
import gzip
import json
import time
import traceback
from contextlib import contextmanager
from dataclasses import asdict, replace
from pathlib import Path

import numpy as np
import torch
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.analysis.breakdown import peak_groups
from repro_torch.analysis.cost import CostCounter, CostReport, OpRecord
from repro_torch.configs.base import SHAPES, all_archs
from repro_torch.dist import sharding as shd
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import PRODUCTION_SHAPE, mesh_shape
from repro_torch.models import lm
from repro_torch.optim import sgd
from repro_torch.tree import tree_leaves

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
#: Backends of the fake group, by device type (meta too: point-to-point
#: pulls send meta tensors).
FAKE_BACKEND = "cpu:fake,cuda:fake,meta:fake"


@contextmanager
def fake_group(world: int):
    """A fake default process group of ``world`` ranks, this process rank 0,
    for the duration of the block."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry-run needs a process without a default group "
                           "(run it in a subprocess)")
    dist.init_process_group(FAKE_BACKEND, store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _opt_state_specs(opt_state, pspecs):
    """Momentum trees mirror params; scalars replicate."""
    return {k: pspecs if k in ("m", "v") else shd.P() for k in opt_state}


def _nbytes(tree) -> int:
    """The bytes this rank holds of a tree's tensors (a DTensor's local
    shard)."""
    local = [t.to_local() if hasattr(t, "placements") else t for t in tree_leaves(tree)
             if isinstance(t, torch.Tensor)]
    return sum(t.numel() * t.element_size() for t in local)


def build_traced(cfg, shape_name, mesh, gossip_mode="ppermute"):
    """Returns (args, run, meta) for one cell: ``args``, rank 0's meta
    shards of the program's inputs, made here (before any counter, as XLA
    counts arguments apart from temp), and ``run(*args)``, which executes
    the program once and returns its outputs; ``meta["row_layout"]()``
    says, once it has run, which mesh dims the program's rows were split
    over and on which they stayed whole.  The counterpart of the JAX
    ``build_lowered``."""
    shape = SHAPES[shape_name]
    optimizer = sgd(momentum=0.9, weight_decay=1e-4)

    if shape.kind == "train":
        from repro_torch.train.trainer import TrainStepConfig, make_train_step

        plan = shd.plan_for(cfg, mesh)
        M = max(plan.n_workers, 1)
        waxes = plan.worker_axes
        inputs = sp.input_specs(cfg, shape_name, M, optimizer)
        pspecs = shd.param_specs(cfg, inputs["params"], plan, stacked=True)
        ospecs = _opt_state_specs(inputs["opt_state"], pspecs)
        bspecs = shd.batch_specs(cfg, plan, shape, stacked=True)
        mode = gossip_mode if M > 1 else "none"
        perm = tuple((i + 1) % M for i in range(M)) if mode == "ppermute" else None
        train_step = make_train_step(cfg, optimizer, M, TrainStepConfig(gossip_mode=mode),
                                     mesh=mesh, worker_axes=waxes, param_specs=pspecs)
        rng = np.random.default_rng(0)
        gossip_in = {"neighbors": np.asarray(perm if perm else rng.permutation(M)),
                     "weights": np.full((M,), 0.5, np.float32), "lr": 0.1}

        def run(params, opt_state, batch):
            return train_step(params, opt_state, batch, gossip_in, perm=perm)

        args = (shd.local_meta(inputs["params"], pspecs, mesh),
                shd.local_meta(inputs["opt_state"], ospecs, mesh),
                shd.local_meta(inputs["batch"], bspecs, mesh))
        return args, run, dict(M=M, mode=mode, program="train_step",
                               row_layout=train_step.row_layout)

    from torch.distributed.tensor.experimental import implicit_replication

    # Serving replicates over 'pod': its cells run on the (data, model)
    # sub-mesh, the same program a rank runs (DTensor's propagation over
    # three mesh dims takes minutes an op at these widths).
    if "pod" in mesh.mesh_dim_names:
        mesh = mesh[tuple(n for n in mesh.mesh_dim_names if n != "pod")]
    plan = shd.plan_for(cfg, mesh, serve=True)
    inputs = sp.input_specs(cfg, shape_name, 1, optimizer)
    pspecs = shd.param_specs(cfg, inputs["params"], plan, stacked=False)

    def dtensors(tree, specs):
        return shd.distribute(shd.local_meta(tree, specs, mesh), specs, mesh)

    if shape.kind == "prefill":
        bspecs = shd.prefill_batch_specs(cfg, plan, inputs["batch"])

        def run(params, batch):
            with torch.no_grad(), implicit_replication():
                return lm.prefill_logits(params, batch, cfg)

        args = (dtensors(inputs["params"], pspecs), dtensors(inputs["batch"], bspecs))
        return args, run, dict(M=1, mode="serve", program="serve_prefill",
                               row_layout=_serve_rows(plan, bspecs["tokens"][0]))

    cspecs = shd.cache_specs(cfg, inputs["cache"], plan, shape.global_batch)
    tspec = shd.serve_batch_spec(plan, shape.global_batch)

    def run(params, cache, token):
        with torch.no_grad(), implicit_replication():
            return lm.decode_step(params, cache, token, shape.seq_len - 1, cfg)[0]

    args = (dtensors(inputs["params"], pspecs), dtensors(inputs["cache"], cspecs),
            dtensors(inputs["token"], tspec))
    return args, run, dict(M=1, mode="serve", program="serve_step",
                           row_layout=_serve_rows(plan, tspec[0]))


def _serve_rows(plan, entry):
    """``row_layout`` of a serving batch whose spec's first entry is
    ``entry``: split over the mesh dims it names, whole on the other dims
    of more than one rank that split no leaf."""
    from repro_torch.train.trainer import row_axes

    split = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
    free = row_axes(plan.mesh, (), (plan.model_axis,))
    return lambda: (split, tuple(a for a in free if a not in split))


#: The bounds on cells at full width on the 16x16 plan, by (arch, shape),
#: held by ``chip_smoke.py``'s phase 36 and ``tests/test_torch_dryrun.py``:
#: per-rank FLOPs x ranks within ``PLAN_RATIO`` of ``unsharded_flops``,
#: and a rank's collective bytes and temp at most ``PLAN_BOUNDS``'.
#: tinyllama-1.1b's (ROADMAP C16-C20): train_4k's collective bytes 1.5x the
#: JAX program's 1.15e11 a device.  rwkv6-7b's (C21) and phi3.5-moe's and
#: jamba's train_4k (C22): their measured values plus ~10%, the larger of
#: torch 2.13's and 2.11's (jamba's mamba layers follow DTensor's own
#: placements, whose collective bytes are 1.23e12 under 2.13 and 3.38e12
#: under 2.11; the JAX program's 4.58e12).
PLAN_RATIO = (1.0, 1.3)
PLAN_BOUNDS = {("tinyllama-1.1b", "train_4k"): {"collective": 1.73e11},
               ("tinyllama-1.1b", "prefill_32k"): {"collective": 1.5e10, "temp": 1.5e9},
               ("tinyllama-1.1b", "decode_32k"): {"collective": 1e6, "temp": 5e8},
               ("rwkv6-7b", "train_4k"): {"collective": 1.28e11, "temp": 3.2e9},
               ("rwkv6-7b", "prefill_32k"): {"collective": 4.0e10, "temp": 2.7e9},
               ("rwkv6-7b", "decode_32k"): {"collective": 2.1e6, "temp": 3.8e7},
               ("phi3.5-moe-42b-a6.6b", "train_4k"): {"collective": 4.8e11, "temp": 2.08e10},
               ("jamba-v0.1-52b", "train_4k"): {"collective": 3.72e12, "temp": 3.03e10}}


def unsharded_flops(cfg, shape_name) -> float:
    """The port's FLOPs of a cell's program on one device, with no mesh
    (``meta`` tensors, no group): the floor of what a plan's ranks do
    together, so per-rank FLOPs x ranks over it is the plan's overhead.
    Training runs M = 2 workers over the shape's global batch: the model's
    FLOPs are the batch's whatever M is, and the optimizer's share, which
    grows with M, stays under 0.1% (a 256-way plan's M = 16 takes a minute
    to count on a CPU)."""
    M = 2
    shape = SHAPES[shape_name]
    optimizer = sgd(momentum=0.9, weight_decay=1e-4)
    inputs = sp.input_specs(cfg, shape_name, M if shape.kind == "train" else 1, optimizer)
    with CostCounter(log_ops=False) as cc:
        if shape.kind == "train":
            from repro_torch.train.trainer import TrainStepConfig, make_train_step

            step = make_train_step(cfg, optimizer, M, TrainStepConfig(gossip_mode="gather"))
            gossip_in = {"neighbors": np.roll(np.arange(M), -1),
                         "weights": np.full((M,), 0.5, np.float32), "lr": 0.1}
            step(inputs["params"], inputs["opt_state"], inputs["batch"], gossip_in)
        else:
            with torch.no_grad():
                if shape.kind == "prefill":
                    lm.prefill_logits(inputs["params"], inputs["batch"], cfg)
                else:
                    lm.decode_step(inputs["params"], inputs["cache"], inputs["token"],
                                   shape.seq_len - 1, cfg)
    return cc.report.flops


def apply_opt_flags(cfg, opt: str):
    """Perf hillclimb variants, applied on top of the baseline config.

    noselect  -- the JAX package drops the redundant causal carry select of
                 its chunked attention scan; the port's attention is the
                 flash kernel, which has no such select, so this flag is
                 accepted and switches nothing
    padheads  -- zero-init inert heads to the next TP multiple (unlocks head
                 sharding for archs with H % 16 != 0: llama4/starcoder/
                 internvl/whisper)
    dpworkers -- enumerate workers over ALL mesh axes (pure NetMax-DP,
                 TP=1): no TP activation collectives, at the cost of a
                 whole replica per rank
    nogossip  -- ablation: local SGD only (``run_cell`` runs the step with
                 gossip mode "none")
    """
    for flag in filter(None, opt.split(",")):
        if flag in ("noselect", "nogossip"):
            pass
        elif flag == "dpworkers":
            cfg = replace(cfg, worker_axes=("pod", "data", "model"))
        elif flag == "padheads":
            tp = 16
            He = -(-cfg.n_heads // tp) * tp  # next multiple of tp
            if (He - cfg.n_heads) % cfg.n_kv_heads == 0:
                cfg = replace(cfg, pad_heads=He - cfg.n_heads)
            else:
                # MHA-style: pad q and kv together (whisper 12 -> 16).
                pkv = (-cfg.n_kv_heads) % tp
                g = cfg.n_heads // cfg.n_kv_heads
                cfg = replace(cfg, pad_heads=pkv * g, pad_kv_heads=pkv)
        else:
            raise ValueError(f"unknown opt flag {flag!r}")
    return cfg


def _ops_path(mesh_name, arch, shape_name, opt) -> Path:
    suffix = f"_{opt.replace(',', '+')}" if opt else ""
    return ARTIFACTS / f"{mesh_name}_{arch}_{shape_name}{suffix}.ops.jsonl.gz"


def _cost_fields(rep: CostReport) -> dict:
    return dict(hlo_flops_per_device=rep.flops, hlo_bytes_per_device=rep.bytes_accessed,
                collective_bytes_per_device=dict(rep.collective_bytes),
                collective_count=dict(rep.collective_count),
                kernel_calls=dict(rep.kernel_calls))


def run_cell(arch, shape_name, multi_pod, gossip_mode="ppermute", save_ops=False,
             quiet=False, opt="", cfg=None, mesh_spec=None):
    """One cell's record.  ``cfg`` overrides the registered config (a
    reduced one in tests) and ``mesh_spec`` the production mesh's
    ``(sizes, names)`` (a small fake group)."""
    cfg = all_archs()[arch] if cfg is None else cfg
    if opt:
        cfg = apply_opt_flags(cfg, opt)
    if "nogossip" in opt.split(","):
        gossip_mode = "none"
    shape = SHAPES[shape_name]
    sizes, names = mesh_spec or PRODUCTION_SHAPE[bool(multi_pod)]
    mesh_name = "x".join(str(n) for n in sizes)
    rec = dict(arch=arch, shape=shape_name, mesh=mesh_name, gossip=gossip_mode, opt=opt,
               ok=False, skipped=False)
    if not cfg.supports(shape):
        rec.update(skipped=True, reason="full-attention arch at 500k context (DESIGN.md §4)")
        return rec
    n_chips = int(np.prod(sizes))
    t0 = time.time()
    try:
        with fake_group(n_chips):
            # Typed cuda: DTensor then runs the all-to-all NCCL would.
            mesh = init_device_mesh("cuda", tuple(sizes), mesh_dim_names=tuple(names))
            args, run, meta = build_traced(cfg, shape_name, mesh, gossip_mode)
            with CostCounter(log_ops=save_ops) as cc:
                out = run(*args)
            arg_bytes, out_bytes = _nbytes(args), _nbytes(out)
            del out, args
            split, whole = meta["row_layout"]()
        t_trace = time.time() - t0
        rep = cc.report
        mem = dict(argument_size_in_bytes=arg_bytes, output_size_in_bytes=out_bytes,
                   temp_size_in_bytes=max(cc.peak_bytes - out_bytes, 0),
                   peak_live_bytes=cc.peak_bytes)
        if save_ops:  # what is live at the peak, by op, shape and scope
            mem["peak_buffers"] = [list(row) for row in peak_groups(cc.peak_buffers())]
        rec.update(ok=True, torch=torch.__version__, chips=n_chips,
                   mesh_axes=mesh_shape(mesh), M=meta["M"],
                   rows_split_over=list(split), rows_whole_over=list(whole),
                   program=meta["program"], t_trace_s=round(t_trace, 2),
                   memory_analysis=mem, **_cost_fields(rep),
                   params=lm.param_count(cfg), active_params=lm.active_param_count(cfg))
        if save_ops:
            ARTIFACTS.mkdir(parents=True, exist_ok=True)
            with gzip.open(_ops_path(mesh_name, arch, shape_name, opt), "wt") as f:
                for op in rep.ops:
                    f.write(json.dumps(asdict(op)) + "\n")
        if not quiet:
            print(f"[{mesh_name}|{arch}|{shape_name}] OK trace={t_trace:.1f}s "
                  f"flops/dev={rep.flops:.3e} bytes/dev={rep.bytes_accessed:.3e} "
                  f"coll={rep.collective_bytes}")
            print("  memory:", {k: v for k, v in mem.items() if k != "peak_buffers"})
            for nbytes, count, op, shape, scope in mem.get("peak_buffers", []):
                print(f"    at the peak: {nbytes / 1e9:8.3f} GB in {count:3d} x {op} "
                      f"{shape} ({scope.split('/')[-1]})")
            print("  kernel calls:", rep.kernel_calls)
    except Exception as e:  # noqa: BLE001 -- a failed cell is a record
        rec.update(error=f"{type(e).__name__}: {e}", traceback=traceback.format_exc()[-2000:])
        if not quiet:
            print(f"[{mesh_name}|{arch}|{shape_name}] FAIL: {type(e).__name__}: {e}")
    return rec


def report_from_ops(path) -> CostReport:
    """A CostReport rebuilt from a saved op log."""
    rep = CostReport()
    with gzip.open(path, "rt") as f:
        for line in f:
            op = OpRecord(**json.loads(line))
            rep.ops.append(op)
            rep.flops += op.flops
            rep.bytes_accessed += op.bytes
            if op.collective:
                rep.collective_bytes[op.collective] = (
                    rep.collective_bytes.get(op.collective, 0.0) + op.collective_bytes)
                if op.collective_bytes or not op.op.startswith("c10d.recv"):
                    rep.collective_count[op.collective] = (
                        rep.collective_count.get(op.collective, 0.0) + 1)
            if op.op.startswith("kernel."):
                name = op.op.removeprefix("kernel.")
                rep.kernel_calls[name] = rep.kernel_calls.get(name, 0) + 1
    return rep


def reanalyze(records_path: str) -> None:
    """Re-count saved op logs (``--save-ops``) into their records, no
    re-trace."""
    with open(records_path) as f:
        recs = [json.loads(line) for line in f]
    out = []
    for rec in recs:
        p = _ops_path(rec["mesh"], rec["arch"], rec["shape"], rec.get("opt", ""))
        if rec.get("ok") and p.exists():
            rep = report_from_ops(p)
            rec.update(_cost_fields(rep))
            print(f"reanalyzed {rec['mesh']}|{rec['arch']}|{rec['shape']}: "
                  f"flops={rep.flops:.3e} bytes={rep.bytes_accessed:.3e}")
        out.append(rec)
    with open(records_path, "w") as f:
        for rec in out:
            f.write(json.dumps(rec) + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--gossip", default="ppermute",
                    choices=["ppermute", "gather", "masked_psum", "none"])
    ap.add_argument("--save-ops", action="store_true",
                    help="write each cell's gzipped op log beside the records")
    ap.add_argument("--reanalyze", metavar="RECORDS")
    ap.add_argument("--opt", default="", help="comma-separated hillclimb flags")
    ap.add_argument("--out", default=str(ARTIFACTS / "records.jsonl"),
                    help="JSONL file the records are appended to")
    args = ap.parse_args(argv)

    if args.reanalyze:
        reanalyze(args.reanalyze)
        return 0

    cells = []
    archs = sorted(a for a in all_archs() if a != "netmax_paper")
    if args.all:
        for a in archs:
            for s in SHAPES:
                cells.append((a, s))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells.append((args.arch, args.shape))

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    records = []
    for mp in meshes:
        for a, s in cells:
            rec = run_cell(a, s, mp, args.gossip, args.save_ops, opt=args.opt)
            records.append(rec)
            if args.out:
                outp = Path(args.out)
                outp.parent.mkdir(parents=True, exist_ok=True)
                with open(outp, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    n_ok = sum(r["ok"] for r in records)
    n_skip = sum(r["skipped"] for r in records)
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped, "
          f"{len(records) - n_ok - n_skip} failed / {len(records)} cells")
    return 0 if n_ok + n_skip == len(records) else 1


if __name__ == "__main__":
    raise SystemExit(main())
