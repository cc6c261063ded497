"""The port's cost model and roofline (``repro_torch.analysis``) against the
JAX package's HLO cost model (``repro.analysis``), on the CPU.

* (a) ``CostCounter`` on tests/test_analysis.py's programs written in
  torch, on the CPU and on ``meta``: the scanned ``tanh(x @ w)`` and the
  nested loop within 5% of their matmul FLOPs (that file's tolerance), the
  relu MLP within 10% of ``HloCostModel``'s count of the JAX program (the
  tolerance that file holds it to against ``cost_analysis``);
* (b) collectives, in a fake process group made and torn down inside each
  test (``launch.dryrun.fake_group``): DTensor's sharding propagation is
  not a rank's memory (ROADMAP C18: the peak is the local outputs', the
  reduced decode cell's temp not its global caches); an ``all_reduce`` of
  an f32[4] is 16 bytes once; a column-parallel MLP's per-rank ``mm``
  FLOPs on 16x16 are the global FLOPs / 256 exactly; an all-to-all on the
  dry-run's (CUDA-typed) mesh is counted as one, not as an all-gather and
  a chunk;
* (c) the kernel formulas at the first shape of each PERF.md §6 row
  against that row's bound (bytes over 3.35 TB/s, operations over the
  row's rate), to 1%;
* (d) tests/test_analysis.py's two roofline tests with the port's H100
  constants, and ``model_flops`` equal to the JAX ``from_record``'s on the
  same records.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.analysis.hlo import HloCostModel
from repro.analysis.roofline import from_record as jax_from_record
from repro.configs.base import SHAPES as JSHAPES
from repro_torch.analysis import cost
from repro_torch.analysis.breakdown import Breakdown
from repro_torch.analysis.roofline import HBM_BW, LINK_BW, PEAK_FLOPS, from_record
from repro_torch.configs.base import SHAPES
from repro_torch.kernels import ops

DEVICES = ["cpu", "meta"]


def _randn(shape, device, seed=0):
    x = torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))
    return x.to(device)


# ------------------------------------------------------------------ (a) programs


@pytest.mark.parametrize("device", DEVICES)
def test_scan_flops_counted_once_a_step(device):
    """8 steps of tanh(x @ w): within 5% of 8 * 2 * 128 * 256 * 256, as
    HloCostModel counts the scanned JAX program."""
    x, ws = _randn((128, 256), device), _randn((8, 256, 256), device, 1)
    with cost.CostCounter() as cc:
        for i in range(8):
            x = torch.tanh(x @ ws[i])
    expect = 8 * 2 * 128 * 256 * 256
    assert cc.report.flops == pytest.approx(expect, rel=0.05)
    jx = jax.ShapeDtypeStruct((128, 256), jnp.float32)
    jws = jax.ShapeDtypeStruct((8, 256, 256), jnp.float32)
    body = lambda c, w: (jnp.tanh(c @ w), None)  # noqa: E731
    compiled = jax.jit(lambda c, w: jax.lax.scan(body, c, w)[0]).lower(jx, jws).compile()
    assert cc.report.flops == pytest.approx(HloCostModel(compiled.as_text()).entry_cost().flops,
                                            rel=0.05)


@pytest.mark.parametrize("device", DEVICES)
def test_nested_loop_flops(device):
    x, ws = _randn((64, 128), device), _randn((8, 128, 128), device, 1)
    with cost.CostCounter() as cc:
        for i in range(8):
            zs = torch.stack([ws[i]] * 4)
            for j in range(4):
                x = x + torch.tanh(x @ zs[j])
    assert cc.report.flops == pytest.approx(8 * 4 * 2 * 64 * 128 * 128, rel=0.05)


@pytest.mark.parametrize("device", DEVICES)
def test_relu_mlp_matches_hlo_cost_model(device):
    shapes = [(64, 128), (128, 256), (256, 32)]
    x, w1, w2 = (_randn(s, device, i) for i, s in enumerate(shapes))
    with cost.CostCounter() as cc:
        F.relu(x @ w1) @ w2
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    compiled = jax.jit(lambda x, w1, w2: jax.nn.relu(x @ w1) @ w2).lower(*args).compile()
    want = HloCostModel(compiled.as_text()).entry_cost().flops
    assert cc.report.flops == pytest.approx(want, rel=0.1)
    # bytes: the three ops' operands and outputs, f32
    assert cc.report.bytes_accessed == 4 * ((64 * 128 + 128 * 256 + 64 * 256)
                                            + 2 * 64 * 256
                                            + (64 * 256 + 256 * 32 + 64 * 32))


def test_views_are_free_and_slices_read_at_their_size():
    x = _randn((1024, 64), "cpu")
    with cost.CostCounter() as cc:
        v = x.T.reshape(64, 1024)[:, :16]
        y = v * 2.0
    logged = [op.op for op in cc.report.ops]
    assert not {"aten.t", "aten.view", "aten.slice", "aten._unsafe_view"} & set(logged)
    assert logged[-1] == "aten.mul"  # the reshape of the transpose copies first
    mul = cc.report.ops[-1]
    assert mul.flops == y.numel() and mul.bytes == 2 * 4 * y.numel()
    with cost.CostCounter() as cc:
        x.expand(4, 1024, 64) + 1.0
    assert cc.report.bytes_accessed == 4 * (1024 * 64 + 4 * 1024 * 64)


@pytest.mark.parametrize("device", DEVICES)
def test_kernels_counted_once_by_formula(device):
    """An attention call and its backward are counted by their formulas on
    every device (the plain version's inner ops are not), and the values
    under the counter are the plain version's."""
    q = _randn((1, 64, 4, 32), device).requires_grad_()
    k = _randn((1, 64, 2, 32), device, 1).requires_grad_()
    v = _randn((1, 64, 2, 32), device, 2).requires_grad_()
    with cost.CostCounter() as cc:
        out = ops.attention(q, k, v, causal=True)
        out.sum().backward()
    fwd = cost.attention_work(1, 64, 64, 4, 2, 32, True, 4)
    bwd = cost.attention_bwd_work(1, 64, 64, 4, 2, 32, True, 4)
    assert cc.report.kernel_calls == {"flash_attention": 1, "flash_attention_bwd": 1}
    summed = [op for op in cc.report.ops if op.op == "aten.sum"]
    assert cc.report.flops == fwd[0] + bwd[0] + sum(op.flops for op in summed)
    if device == "cpu":
        grads = [t.grad.clone() for t in (q, k, v)]
        for t in (q, k, v):
            t.grad = None
        want = ops.attention(q, k, v, causal=True)
        want.sum().backward()
        assert torch.equal(out, want)
        assert all(torch.equal(g, t.grad) for g, t in zip(grads, (q, k, v)))


def test_meta_scan_counts_every_step():
    """On meta a scan runs one step counted S times, backward included."""
    from repro_torch.models.scan_utils import chunked_scan

    def step(h, inp):
        (x,) = inp
        h = torch.tanh(h @ x)
        return h, h * 2.0

    mm = {}
    for device in DEVICES:
        h0 = _randn((4, 16), device).requires_grad_()
        xs = _randn((32, 16, 16), device, 1).requires_grad_()
        with cost.CostCounter() as cc:
            h, ys = chunked_scan(step, h0, (xs,), chunk=16)
            (h.sum() + ys.sum()).backward()
        assert ys.shape == (32, 4, 16) and xs.grad.shape == xs.shape
        mm[device] = sum(op.flops for op in cc.report.ops if op.op == "aten.mm")
    assert mm["cpu"] > 0 and mm["meta"] == mm["cpu"]


def test_breakdown_scopes_name_the_port_functions():
    from repro_torch.configs.base import get_arch
    from repro_torch.models import lm

    cfg = get_arch("tinyllama-1.1b").reduced()
    params = lm.init_params(cfg, device="meta")
    tokens = torch.zeros((2, 64), dtype=torch.int32, device="meta")
    with torch.no_grad(), cost.CostCounter() as cc:
        lm.prefill_logits(params, {"tokens": tokens}, cfg)
    tops = Breakdown(cc.report).top(5)
    assert tops["flops"][0].opcode in ("aten.mm", "kernel.flash_attention")
    assert tops["flops"][0].scope.startswith("lm.prefill_logits/transformer.prefill/")
    assert any(r.scope.endswith("attention.chunked_attention")
               for r in Breakdown(cc.report).top(100)["flops"])


# ------------------------------------------------------------------ (b) collectives


@pytest.fixture
def fake16():
    """A fake 16x16 group and the dry-run's mesh on it, torn down after."""
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import make_production_mesh

    with fake_group(256):
        yield make_production_mesh(device_type="cuda")


def test_all_reduce_counts_its_operand_once():
    import torch.distributed as dist

    from repro_torch.launch.dryrun import fake_group

    with fake_group(4):
        with cost.CostCounter() as cc:
            dist.all_reduce(torch.ones(4))
    assert cc.report.collective_bytes == {"all-reduce": 16.0}
    assert cc.report.collective_count == {"all-reduce": 1.0}
    assert cc.report.flops == 0


def test_dtensor_propagation_is_no_rank_memory():
    """ROADMAP C18: DTensor's sharding propagation allocates FakeTensors of
    the global shape with no tensor input (``empty_strided``); the peak
    counts the rank's own outputs only.  On 4 ranks, x of local f32 (8, 16,
    32) split on its last dim: x + x is one local output of 8 * 16 * 32 * 4
    bytes, and x.sum(-1), a partial sum, one of 8 * 16 * 4; the peak's only
    buffer is that output."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.launch.dryrun import fake_group

    with fake_group(4):
        mesh = init_device_mesh("cuda", (4,), mesh_dim_names=("model",))
        x = DTensor.from_local(torch.empty((8, 16, 32), device="meta"), mesh, [Shard(2)],
                               run_check=False)
        cases = ((lambda: x + x, 8 * 16 * 32 * 4, "aten.add", "f32[8,16,32]"),
                 (lambda: x.sum(-1), 8 * 16 * 4, "aten.sum", "f32[8,16]"))
        for fn, nbytes, op, shape in cases:
            with cost.CostCounter() as cc:
                y = fn()
            assert cc.peak_bytes == nbytes
            peak = [(b.op, b.shape, b.bytes) for b in cc.peak_buffers()]
            assert peak == [(op, shape, nbytes)]
            assert y.to_local().numel() * 4 == nbytes
            del y


def test_reduced_decode_cell_temp_is_not_the_global_caches():
    """ROADMAP C18: the reduced decode_32k cell on the (2, 4) plan holds
    half the global k and v caches a rank (the batch split over 'data';
    2 x 1.0738 GB globally); its temp, once those caches' global fakes,
    stays below 1.7 GB."""
    from repro_torch.configs.base import get_arch
    from repro_torch.launch import dryrun

    cfg = get_arch("tinyllama-1.1b").reduced()
    rec = dryrun.run_cell("tinyllama-1.1b", "decode_32k", False, quiet=True, cfg=cfg,
                          mesh_spec=((2, 4), ("data", "model")))
    assert rec["ok"], rec.get("traceback")
    assert rec["memory_analysis"]["temp_size_in_bytes"] <= 1.7e9


def test_column_parallel_mm_flops_are_global_over_256(fake16):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    B, D, Fd = 2048, 2048, 5632
    x = DTensor.from_local(torch.empty((B // 16, D), device="meta"), fake16,
                           [Shard(0), Replicate()], run_check=False)
    w = DTensor.from_local(torch.empty((D, Fd // 16), device="meta"), fake16,
                           [Replicate(), Shard(1)], run_check=False)
    with cost.CostCounter() as cc:
        y = x @ w
    mm = sum(op.flops for op in cc.report.ops if op.op == "aten.mm")
    assert mm * 256 == 2 * B * D * Fd
    assert tuple(y.to_local().shape) == (B // 16, Fd // 16)
    assert not cc.report.collective_bytes


def test_all_to_all_counted_as_one_on_the_dry_run_mesh(fake16):
    """On the CUDA-typed mesh DTensor runs its all-to-all, counted at the
    operand's local bytes; no all-gather stands in for it (which a CPU-typed
    mesh would do)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    local = torch.empty((64, 2048 // 16), device="meta")
    x = DTensor.from_local(local, fake16, [Replicate(), Shard(1)], run_check=False)
    with cost.CostCounter() as cc:
        y = x.redistribute(fake16, [Replicate(), Shard(0)])
    assert cc.report.collective_bytes == {"all-to-all": 64 * 128 * 4}
    assert cc.report.collective_count == {"all-to-all": 1.0}
    assert tuple(y.to_local().shape) == (4, 2048)


def test_point_to_point_counts_sends_as_collective_permute(fake16):
    import torch.distributed as dist

    t = torch.empty((8, 4), device="meta")
    with cost.CostCounter() as cc:
        ops_ = [dist.P2POp(dist.isend, t, 1), dist.P2POp(dist.irecv, torch.empty_like(t), 2)]
        for work in dist.batch_isend_irecv(ops_):
            work.wait()
    assert cc.report.collective_bytes == {"collective-permute": 128.0}
    assert cc.report.collective_count == {"collective-permute": 1.0}


# ------------------------------------------------------------------ (c) kernel formulas

H100_BF16, H100_F32, H100_3XTF32 = 989e12, 67e12, 495e12 / 3
MLP_LEAVES = [(32, 128), (128,), (128, 64), (64,), (64, 10), (10,)]


def _mlp_elements(rows=1):
    return rows * sum(int(np.prod(s)) for s in MLP_LEAVES)


def _b2_work():
    flops = nbytes = 0
    for s in MLP_LEAVES:
        n = int(np.prod(s))
        f, b = cost.mix_work(4 * n, n, 1, True)
        flops, nbytes = flops + f, nbytes + b
    return flops, nbytes


#: PERF.md §6's rows at their first shapes: (work, rate, bound µs, by).
KERNEL_ROWS = {
    "B1": (lambda: cost.mix_work(4 * _mlp_elements(32), _mlp_elements(32), 32, False),
           H100_F32, 1.505, "bytes"),
    "B2": (_b2_work, H100_F32, 0.063, "bytes"),
    "B3": (lambda: cost.attention_work(4, 512, 512, 32, 4, 64, True, 2), H100_BF16, 5.634,
           "bytes"),
    "B3 bwd": (lambda: cost.attention_bwd_work(2, 512, 512, 32, 4, 64, True, 2), H100_BF16,
               5.67, "bytes"),
    "B4": (lambda: cost.rwkv_work(4, 512, 64, 64, 2, 4, True), H100_3XTF32, 32.56, "bytes"),
    "B4 bwd": (lambda: cost.rwkv_bwd_work(1, 512, 64, 64, 2, 4, False), H100_3XTF32, 13.78,
               "bytes"),
}


@pytest.mark.parametrize("row", list(KERNEL_ROWS))
def test_kernel_formula_matches_the_perf_row(row):
    work, rate, bound_us, by = KERNEL_ROWS[row]
    flops, nbytes = work()
    t_bytes, t_ops = nbytes / 3.35e12 * 1e6, flops / rate * 1e6
    assert max(t_bytes, t_ops) == pytest.approx(bound_us, rel=0.01)
    assert ("bytes" if t_bytes >= t_ops else "operations") == by
    if row == "B4 bwd":  # the row's own figures: 46.2 MB, 1.908 GFLOP, 11.57 µs
        assert nbytes == pytest.approx(46.2e6, rel=0.01)
        assert flops == pytest.approx(1.908e9, rel=0.01)
        assert t_ops == pytest.approx(11.57, rel=0.01)


# ------------------------------------------------------------------ (d) roofline


def _train_record():
    return dict(ok=True, arch="a", shape="train_4k", mesh="16x16", chips=256,
                hlo_flops_per_device=1e12, hlo_bytes_per_device=1e11,
                collective_bytes_per_device={"all-reduce": 1e10}, active_params=1e9)


def _decode_record():
    return dict(ok=True, arch="a", shape="decode_32k", mesh="16x16", chips=256,
                hlo_flops_per_device=1e9, hlo_bytes_per_device=1e9,
                collective_bytes_per_device={}, active_params=1e9)


def test_roofline_terms_and_dominance():
    r = from_record(_train_record(), SHAPES["train_4k"])
    assert r.compute_s == pytest.approx(1e12 / PEAK_FLOPS)
    assert r.memory_s == pytest.approx(1e11 / HBM_BW)
    assert r.collective_s == pytest.approx(1e10 / LINK_BW)
    # 1.01 ms compute vs 29.9 ms memory vs 22.2 ms collective -> memory wins
    assert r.dominant == "memory"
    assert 0 < r.roofline_fraction <= 1.5
    assert r.model_flops == pytest.approx(6 * 1e9 * 4096 * 256)
    assert (PEAK_FLOPS, HBM_BW, LINK_BW) == (989e12, 3.35e12, 450e9)


def test_roofline_decode_tokens():
    r = from_record(_decode_record(), SHAPES["decode_32k"])
    # decode: 2*N*batch (one token per sequence)
    assert r.model_flops == pytest.approx(2 * 1e9 * 128)


@pytest.mark.parametrize("record", ["train", "decode"])
def test_model_flops_equal_the_jax_roofline(record):
    rec = {"train": _train_record, "decode": _decode_record}[record]()
    mine = from_record(rec, SHAPES[rec["shape"]])
    theirs = jax_from_record(rec, JSHAPES[rec["shape"]])
    assert mine.model_flops == theirs.model_flops
    assert mine.hlo_flops_total == theirs.hlo_flops_total
    assert mine.useful_ratio == theirs.useful_ratio
    assert from_record({"ok": False}, SHAPES["train_4k"]) is None
