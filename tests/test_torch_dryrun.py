"""The port's dry-run (``repro_torch.launch.dryrun``) against the JAX
package's (``repro.launch.dryrun``), on the CPU.

The JAX side runs in one subprocess with 8 forced host devices: its
``build_lowered`` on an Auto (2, 4) ``data`` x ``model`` mesh with
``tinyllama-1.1b.reduced()``, counted by ``HloCostModel``, plus the
attention term of each program alone on one device at the per-device
shapes (the chunked scan, and its gradient for training).  The port's
``run_cell`` runs the same cells as rank 0 of an 8-rank fake (2, 4) group.

* ``params``, ``active_params`` and the roofline's ``model_flops`` are
  equal;
* per-rank FLOPs within 25% of the JAX package's, or else the difference
  is one named term, to 5% (``TERM_TOL``): prefill and training differ by
  the attention term (the kernel formula counts the causal pairs once, the
  JAX chunked scan computes all S^2 pairs); the decode step by the JAX
  program's elementwise FLOPs (XLA rewrites the whole stacked cache in each
  layer, 1 FLOP an element, where the port writes one position in place),
  its dots -- the cache attention split over 'model' included -- being the
  same;
* per-rank FLOPs x 8 within 1.0-1.3x of the port's unsharded count of the
  same program (``dryrun.unsharded_flops``: meta tensors, no mesh), for
  tinyllama's cells and the train cells of the configs with one worker a
  pod; and at full width on the 16x16 plan (tinyllama's cells and rwkv6-7b's
  prefill), port only, per-rank FLOPs x 256 likewise, with the collective
  bytes and the temp below the plan's bounds;
* rwkv6-7b's reduced train_4k moves no more collective bytes a rank than
  the JAX program;
* the train cell (M = 2) under ``--gossip ppermute`` has collective-permute
  bytes, as tests/test_system.py asks of the JAX records.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro.analysis.roofline import from_record as jax_from_record
from repro.configs.base import SHAPES as JSHAPES
from repro_torch.analysis import cost
from repro_torch.analysis.roofline import from_record
from repro_torch.configs.base import SHAPES, get_arch
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]
ARCH = "tinyllama-1.1b"
CELLS = ("train_4k", "prefill_32k", "decode_32k")
MESH = ((2, 4), ("data", "model"))
FLOPS_TOL = 0.25
#: How closely the named term explains a cell's difference from the JAX
#: program's count.
TERM_TOL = {"prefill_32k": 0.05, "train_4k": 0.05, "decode_32k": 0.05}
#: The port's dot ops (their FLOPs by ``flop_counter``'s formulas).
DOTS = ("aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm")

_JAX_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    assert len(jax.devices()) == 8  # before repro.launch.dryrun sets its own count
    from jax.sharding import AxisType
    from repro.analysis.hlo import HloCostModel

    class NoDots(HloCostModel):  # the count without its dots
        def _dot_flops(self, op, comp):
            return 0.0
    from repro.configs.base import get_arch
    from repro.launch import dryrun
    from repro.models import lm
    from repro.models.attention import chunked_attention
    from repro.models.transformer import _chunks_for

    mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    cfg = get_arch("tinyllama-1.1b").reduced()
    out = {"params": lm.param_count(cfg), "active_params": lm.active_param_count(cfg)}
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        lowered, meta = dryrun.build_lowered(cfg, shape, mesh, "ppermute")
        text = lowered.compile().as_text()
        rep = HloCostModel(text).entry_cost()
        out[shape] = {"flops": rep.flops, "collective_bytes": rep.collective_bytes,
                      "M": meta["M"], "elementwise": NoDots(text).entry_cost().flops}

    def attention_term(B, S, grad):
        # One device's attention call: its batch rows and one query head,
        # whose KV head it reads, at the model's chunks.
        qc, kc = _chunks_for(cfg, S)
        spec = jax.ShapeDtypeStruct((B, S, 1, cfg.hd), jnp.dtype(cfg.dtype))
        attn = lambda q, k, v: chunked_attention(q, k, v, causal=True, q_chunk=qc,
                                                 kv_chunk=kc)
        f = (jax.grad(lambda q, k, v: attn(q, k, v).astype(jnp.float32).sum(),
                      argnums=(0, 1, 2)) if grad else attn)
        text = jax.jit(f).lower(spec, spec, spec).compile().as_text()
        return HloCostModel(text).entry_cost().flops

    # prefill: 32 sequences over 'data' (16 a device); training: 256 over
    # M = 2 workers on 'data' (128 a device) in the config's micro-batches.
    micro = cfg.microbatches
    out["prefill_32k"]["attention"] = cfg.n_layers * attention_term(16, 32768, False)
    out["train_4k"]["attention"] = (cfg.n_layers * micro
                                    * attention_term(128 // micro, 4096, True))

    # rwkv6-7b's reduced train_4k: the collective bytes of the JAX program.
    lowered, _ = dryrun.build_lowered(get_arch("rwkv6-7b").reduced(), "train_4k", mesh,
                                      "ppermute")
    out["rwkv_train_4k"] = {"collective_bytes": HloCostModel(
        lowered.compile().as_text()).entry_cost().collective_bytes}
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
""")


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX subprocess, started before the port's cells run."""
    path = tmp_path_factory.mktemp("jax_dryrun") / "jax.json"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), env.get("PYTHONPATH", "")])
    proc = subprocess.Popen([sys.executable, "-c", _JAX_SCRIPT, str(path)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, cwd=ROOT)
    cache = {}

    def get():
        if not cache:
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            cache.update(json.loads(path.read_text()))
        return cache

    yield get
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def port_cells(jax_side, tmp_path_factory):
    """The port's reduced cells, each with the dot FLOPs of its op log."""
    cfg = get_arch(ARCH).reduced()
    cells = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dryrun, "ARTIFACTS", tmp_path_factory.mktemp("port_dryrun"))
        for s in CELLS:
            rec = dryrun.run_cell(ARCH, s, False, "ppermute", save_ops=True, quiet=True,
                                  cfg=cfg, mesh_spec=MESH)
            if rec["ok"]:
                ops = dryrun.report_from_ops(dryrun._ops_path(rec["mesh"], ARCH, s, "")).ops
                rec["dot_flops"] = sum(op.flops for op in ops if op.op in DOTS)
            cells[s] = rec
    return cells


@pytest.mark.parametrize("shape", CELLS)
def test_cell_is_ok_with_the_jax_params_and_model_flops(port_cells, jax_side, shape):
    rec, want = port_cells[shape], jax_side()
    assert rec["ok"], rec.get("traceback")
    assert (rec["params"], rec["active_params"]) == (want["params"], want["active_params"])
    assert rec["M"] == want[shape]["M"] and rec["chips"] == 8
    jrec = {**rec, "arch": ARCH, "mesh": "16x16"}
    assert (from_record(jrec, SHAPES[shape]).model_flops
            == jax_from_record(jrec, JSHAPES[shape]).model_flops)


def _port_attention(cfg, shape):
    """The kernel formulas' count of the port's attention calls on rank 0:
    its 16 (prefill) or 64 (a training micro-batch of 128 / 2) rows, one
    query head over its one KV head."""
    itemsize = torch.tensor([], dtype=getattr(torch, cfg.dtype)).element_size()
    if shape == "prefill_32k":
        return cfg.n_layers * cost.attention_work(16, 32768, 32768, 1, 1, cfg.hd, True,
                                                  itemsize)[0]
    b = 128 // cfg.microbatches
    calls = cfg.n_layers * cfg.microbatches
    fwd = cost.attention_work(b, 4096, 4096, 1, 1, cfg.hd, True, itemsize)[0]
    bwd = cost.attention_bwd_work(b, 4096, 4096, 1, 1, cfg.hd, True, itemsize)[0]
    return calls * (fwd + bwd)


@pytest.mark.parametrize("shape", CELLS)
def test_per_rank_flops_against_jax(port_cells, jax_side, shape):
    cfg = get_arch(ARCH).reduced()
    rec, want = port_cells[shape], jax_side()[shape]
    port, jax_flops = rec["hlo_flops_per_device"], want["flops"]
    if abs(port - jax_flops) <= FLOPS_TOL * jax_flops:
        return
    if shape in ("prefill_32k", "train_4k"):
        # The attention term: causal pairs once (kernel formula) against the
        # scan's S^2 pairs (HloCostModel of the JAX call at the same shapes).
        assert rec["kernel_calls"]["flash_attention"] == cfg.n_layers * (
            1 if shape == "prefill_32k" else cfg.microbatches)
        term = want["attention"] - _port_attention(cfg, shape)
        assert jax_flops - port == pytest.approx(term, rel=TERM_TOL[shape])
    else:
        # The elementwise term: the JAX program's count without its dots
        # (XLA's dynamic-update-slice and copies of the whole stacked cache
        # in each layer) against the port's (one position written in
        # place); the dots, the cache attention split over 'model' as GSPMD
        # splits it, are the same.
        term = want["elementwise"] - (port - rec["dot_flops"])
        assert jax_flops - port == pytest.approx(term, rel=TERM_TOL[shape])


@pytest.mark.parametrize("shape", CELLS)
def test_per_rank_flops_times_ranks_against_unsharded(port_cells, shape):
    cfg = get_arch(ARCH).reduced()
    ratio = (port_cells[shape]["hlo_flops_per_device"] * 8
             / dryrun.unsharded_flops(cfg, shape))
    assert 1.0 <= ratio <= 1.3, ratio


#: Full-width 16x16 cells held in tier-1: tinyllama-1.1b's three (ids by
#: shape alone, as before rwkv6-7b's prefill joined them, ROADMAP C21).
FULL_WIDTH_CELLS = [pytest.param(ARCH, s, id=s) for s in CELLS] + [
    pytest.param("rwkv6-7b", "prefill_32k", id="rwkv6-7b-prefill_32k")]


@pytest.mark.parametrize("arch,shape", FULL_WIDTH_CELLS)
def test_full_width_plan_against_unsharded(arch, shape):
    """A cell at full width on the production 16x16 plan, the port alone:
    per-rank FLOPs x 256 over the unsharded count (training's at M = 2 over
    the same global batch) within ``dryrun.PLAN_RATIO``, and the cell's
    collective bytes and temp within ``dryrun.PLAN_BOUNDS``."""
    rec = dryrun.run_cell(arch, shape, False, "ppermute", quiet=True)
    assert rec["ok"], rec.get("traceback")
    ratio = rec["hlo_flops_per_device"] * 256 / dryrun.unsharded_flops(get_arch(arch), shape)
    lo, hi = dryrun.PLAN_RATIO
    assert lo <= ratio <= hi, ratio
    bounds = dryrun.PLAN_BOUNDS[arch, shape]
    if "collective" in bounds:
        assert sum(rec["collective_bytes_per_device"].values()) <= bounds["collective"]
    if "temp" in bounds:
        assert rec["memory_analysis"]["temp_size_in_bytes"] <= bounds["temp"]


def test_train_cell_pulls_by_collective_permute(port_cells, jax_side):
    coll = port_cells["train_4k"]["collective_bytes_per_device"]
    assert coll.get("collective-permute", 0) > 0
    assert jax_side()["train_4k"]["collective_bytes"].get("collective-permute", 0) > 0


def test_records_and_op_logs_round_trip(tmp_path, monkeypatch):
    """``main`` writes a record to ``--out`` and an op log with
    ``--save-ops``; ``reanalyze`` recounts the log into the same totals; an
    unsupported shape is an explicit skip; a failing cell is a record with
    its error and makes ``main`` exit 1."""
    monkeypatch.setattr(dryrun, "ARTIFACTS", tmp_path)
    cfg = get_arch(ARCH).reduced()
    rec = dryrun.run_cell(ARCH, "prefill_32k", False, save_ops=True, quiet=True, cfg=cfg,
                          mesh_spec=MESH)
    records = tmp_path / "records.jsonl"
    records.write_text(json.dumps(rec) + "\n")
    before = dict(rec)
    dryrun.reanalyze(str(records))
    again = json.loads(records.read_text())
    for key in ("hlo_flops_per_device", "hlo_bytes_per_device", "kernel_calls"):
        assert again[key] == pytest.approx(before[key])
    assert again["collective_bytes_per_device"] == pytest.approx(
        before["collective_bytes_per_device"])
    skip = dryrun.run_cell(ARCH, "long_500k", False, quiet=True, cfg=cfg, mesh_spec=MESH)
    assert skip["skipped"] and not skip["ok"]
    monkeypatch.setattr(dryrun, "build_traced", lambda *a, **k: 1 / 0)
    out = tmp_path / "fail.jsonl"
    assert dryrun.main(["--arch", ARCH, "--shape", "decode_32k", "--out", str(out)]) == 1
    failed = json.loads(out.read_text())
    assert not failed["ok"] and "ZeroDivisionError" in failed["error"]


#: Cells whose DTensor paths needed a model change (ROADMAP C11-C15): the
#: MoE's batch-local dispatch and expert products (phi3.5, train), the
#: meta scan of the mamba layers under autograd (jamba, train), uneven
#: head splits (whisper's 12 heads, internvl2's 14, on 4 'model' ranks),
#: the WKV decode step on split heads (rwkv6); and the configs with one
#: worker a pod (phi3.5, jamba, llama4 every_2; ROADMAP C22), whose
#: micro-batch rows are shared out over 'data', on an (8, 1) plan too,
#: where no leaf is split and 'data' is the sub-mesh's one dim.
FAMILY_CELLS = [pytest.param(arch, shape, MESH, id=f"{arch}-{shape}") for arch, shape in (
    ("phi3.5-moe-42b-a6.6b", "train_4k"), ("jamba-v0.1-52b", "train_4k"),
    ("whisper-small", "decode_32k"), ("internvl2-1b", "prefill_32k"),
    ("rwkv6-7b", "decode_32k"), ("llama4-maverick-400b-a17b", "train_4k"))] + [
    pytest.param("phi3.5-moe-42b-a6.6b", "train_4k", ((8, 1), ("data", "model")),
                 id="phi3.5-moe-42b-a6.6b-train_4k-8x1")]


@pytest.mark.parametrize("arch,shape,mesh", FAMILY_CELLS)
def test_family_cells_trace(arch, shape, mesh):
    """Each cell traces on its plan of 8 ranks.  A plan with workers on
    'data' pulls point to point; one whose worker enumerates 'pod' alone
    (M = 1 here) shares each micro-batch's rows out over 'data', so its
    per-rank FLOPs x 8 are within ``dryrun.PLAN_RATIO`` of the unsharded
    count (the size of 'data' while every 'data' rank ran the whole
    step)."""
    cfg = get_arch(arch).reduced()
    rec = dryrun.run_cell(arch, shape, False, quiet=True, cfg=cfg, mesh_spec=mesh)
    assert rec["ok"], rec.get("traceback")
    assert rec["hlo_flops_per_device"] > 0 and rec["memory_analysis"]["peak_live_bytes"] > 0
    if rec["M"] > 1:  # a plan with workers on 'data' pulls point to point
        assert rec["collective_bytes_per_device"].get("collective-permute", 0) > 0
    if rec["program"] == "train_step" and cfg.worker_axes == ("pod",):
        assert (rec["rows_split_over"], rec["rows_whole_over"]) == (["data"], [])
        ratio = rec["hlo_flops_per_device"] * 8 / dryrun.unsharded_flops(cfg, shape)
        lo, hi = dryrun.PLAN_RATIO
        assert lo <= ratio <= hi, ratio


def test_rwkv_train_collective_bytes_against_jax(jax_side):
    """rwkv6-7b's reduced train_4k on the (2, 4) plan moves no more
    collective bytes a rank than the JAX program of the same specs (ROADMAP
    C21: its projections in Megatron's layout; 2x the JAX program's before)."""
    cfg = get_arch("rwkv6-7b").reduced()
    rec = dryrun.run_cell("rwkv6-7b", "train_4k", False, quiet=True, cfg=cfg, mesh_spec=MESH)
    assert rec["ok"], rec.get("traceback")
    port = sum(rec["collective_bytes_per_device"].values())
    want = sum(jax_side()["rwkv_train_4k"]["collective_bytes"].values())
    assert port <= want, (port, want)


def test_opt_flags():
    cfg = get_arch("whisper-small")
    padded = dryrun.apply_opt_flags(cfg, "padheads")
    assert padded.n_heads_eff % 16 == 0 and padded.n_kv_heads_eff % 16 == 0
    assert dryrun.apply_opt_flags(cfg, "dpworkers").worker_axes == ("pod", "data", "model")
    assert dryrun.apply_opt_flags(cfg, "noselect,nogossip") == cfg
    with pytest.raises(ValueError, match="unknown opt flag"):
        dryrun.apply_opt_flags(cfg, "fast")
