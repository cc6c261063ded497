"""The port's CUDA kernels on the card (marker ``cuda``; skips without one).

The gossip-mix kernel repeats its plain version's f32 steps with every
rounding in the same place (no FMA contraction), so it is held to it
bit for bit, as one launch per parameter tree too (u given and absent).  The flash-attention and WKV kernels sum in another order than
their plain versions, so they are held to the tolerances of
``tests/test_kernels.py`` (attention 2e-5 in f32, 2e-2 in bf16; WKV 1e-4 in
f32 and 5e-2 in bf16, for any decay: the kernel does not clamp).  With bf16
r/k/v and f32 decays (the model's dtypes) the WKV output y is bf16 and held
to 5e-2, one bf16 step being 2^-8 of |y|, while the final state is f32,
computed from exactly widened inputs, and held to 1e-4.  This file imports no JAX, so it runs on a machine that has
only torch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gossip_mix as tk
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rwkv_scan as rs

# tests/test_kernels.py MIX_CASES / MIX_ROWS_CASES, plus main-path leaves.
MIX_CASES = [
    ((1024,), "float32", 0.25),
    ((127, 33), "float32", 0.8),
    ((8, 64, 32), "bfloat16", 0.5),
    ((70000,), "float32", 0.0),
    ((256,), "float32", 1.0),
]
MIX_ROWS_CASES = [
    ((4, 1024), "float32"),
    ((3, 127, 33), "float32"),
    ((8, 64, 32), "bfloat16"),
    ((1, 70000), "float32"),
    ((32, 10), "float32"),
    ((32, 64, 10), "float16"),
]


def _inputs(seed, shape, dtype, device):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    arrs[1] *= np.float32(0.01)
    return [torch.from_numpy(a).to(device=device, dtype=getattr(torch, dtype))
            for a in arrs]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only on the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,w", MIX_CASES)
def test_cuda_gossip_mix_equals_plain(cuda_device, shape, dtype, w):
    x, u, p = _inputs(0, shape, dtype, cuda_device)
    n0 = tk.LAUNCHES["gossip_mix"]
    got = tk.gossip_mix(x, u, p, w)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["gossip_mix"] == n0 + 1
    torch.testing.assert_close(got, ref.reference_gossip_mix(x, u, p, w),
                               atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", MIX_ROWS_CASES)
def test_cuda_gossip_mix_rows_equals_plain(cuda_device, shape, dtype):
    x, u, p = _inputs(1, shape, dtype, cuda_device)
    w = torch.linspace(0.0, 1.0, shape[0], device=cuda_device)
    n0 = tk.LAUNCHES["gossip_mix_rows"]
    got = ops.mix_rows(x, u, p, w)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["gossip_mix_rows"] == n0 + 1
    torch.testing.assert_close(got, ref.reference_gossip_mix_rows(x, u, p, w),
                               atol=0, rtol=0)


@pytest.mark.cuda
def test_cuda_wrapper_checks_operands(cuda_device):
    x = torch.zeros(4, 8, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        tk.gossip_mix_rows(x.t(), x.t(), x.t(), torch.zeros(8, device=cuda_device))
    with pytest.raises(ValueError, match="float32"):
        tk.gossip_mix_rows(x, x, x, torch.zeros(4, device=cuda_device,
                                                dtype=torch.float64))
    with pytest.raises(TypeError, match="dtype"):
        tk.gossip_mix(x.double(), x.double(), x.double(), 0.5)


# Trees mixed in one launch per dtype group (chip_smoke.py's tree_cases):
# name -> (R, trailing leaf shapes, dtype(s), leaves moved off 16 bytes).
_MLP = [(32, 128), (128,), (128, 64), (64,), (64, 10), (10,)]
TREE_CASES = {
    "mlp_f32": (32, _MLP, "float32", ()),
    "mlp_bf16": (32, _MLP, "bfloat16", ()),
    "mlp_f16": (32, _MLP, "float16", ()),
    "mixed_alignment": (4, [(127, 33), (10,), (1,), (64,), (70000,)], "float32", (0, 2, 4)),
    "mixed_alignment_bf16": (4, [(127, 33), (10,), (1,), (64,)], "bfloat16", (1, 3)),
    "rows_across_vectors": (32, [(10,), (1,), (3,), (5, 7), (64, 10)], "float16", ()),
    "rows_of_70000": (2, [(70000,), (127,)], "float32", ()),
    "one_row": (1, [(127, 33), (10,), (1,), (70000,)], "bfloat16", ()),
    "mixed_dtypes": (8, [(64,), (10,), (33,), (1,), (128, 64)],
                     ("float32", "bfloat16", "float32", "float16", "bfloat16"), ()),
    "more_leaves_than_a_table": (4, [(k,) for k in range(1, 51)], "float32", (7, 30)),
    "100_leaves_bf16": (3, [((k % 17) + 1, 3) for k in range(100)], "bfloat16", ()),
}


def _tree(seed, case, device):
    """Leaves from numpy draws (u scaled 0.01); row 0 (w = 0) starts with
    x = -0.0 and p < 0, where only x + 0.0 gives the plain version's +0.0."""
    R, shapes, dtypes, unaligned = case
    if isinstance(dtypes, str):
        dtypes = [dtypes] * len(shapes)
    rng = np.random.default_rng(seed)
    xs, us, ps = [], [], []
    for i, (trail, dt) in enumerate(zip(shapes, dtypes)):
        shape = (R,) + tuple(trail)
        numel = int(np.prod(shape))
        ops_ = []
        for scale in (1.0, 0.01, 1.0):
            a = rng.standard_normal(numel + 1).astype(np.float32) * np.float32(scale)
            flat = torch.from_numpy(a).to(device=device, dtype=getattr(torch, dt))
            ops_.append((flat[1:] if i in unaligned else flat[:numel]).view(shape))
        x, u, p = ops_
        x.view(R, -1)[0, :2] = -0.0
        p.view(R, -1)[0, :2] = -1.0
        xs.append(x)
        us.append(u)
        ps.append(p)
    return xs, us, ps, torch.linspace(0.0, 1.0, R, device=device)


def _assert_bits_equal(got, want):
    as_int = {4: torch.int32, 2: torch.int16}[want.element_size()]
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.contiguous().view(as_int), want.contiguous().view(as_int))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TREE_CASES))
@pytest.mark.parametrize("with_u", [True, False], ids=["u", "no_u"])
def test_cuda_gossip_mix_tree_equals_plain(cuda_device, name, with_u):
    xs, us, ps, w = _tree(5, TREE_CASES[name], cuda_device)
    if TREE_CASES[name][3]:
        assert any(x.data_ptr() % 16 for x in xs)
    n0 = tk.LAUNCHES["gossip_mix_rows"]
    got = tk.gossip_mix_rows_tree(xs, us if with_u else None, ps, w)
    torch.cuda.synchronize()
    # One launch per dtype group of up to MAX_LEAVES leaves.
    per_dtype = [sum(x.dtype == d for x in xs) for d in {x.dtype for x in xs}]
    assert tk.LAUNCHES["gossip_mix_rows"] - n0 == sum(-(-k // tk.MAX_LEAVES)
                                                      for k in per_dtype)
    for x, u, p, g in zip(xs, us, ps, got):
        _assert_bits_equal(g, ref.reference_gossip_mix_rows(x, u if with_u else None, p, w))


@pytest.mark.cuda
def test_cuda_engine_tree_mix_is_one_launch(cuda_device):
    """``ops.gossip_mix_tree`` (the batched engine's mix) on the MLP tree at
    32 rows: one launch, no zeros_like, bit-equal to the plain u-less form."""
    xs, _, ps, w = _tree(6, TREE_CASES["mlp_f32"], cuda_device)
    tree = lambda t: [{"w": t[i], "b": t[i + 1]} for i in range(0, len(t), 2)]  # noqa: E731
    n0 = tk.LAUNCHES["gossip_mix_rows"]
    got = ops.gossip_mix_tree(tree(xs), tree(ps), w)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["gossip_mix_rows"] == n0 + 1
    for gl, hl, pl in zip(got, tree(xs), tree(ps)):
        for k in gl:
            _assert_bits_equal(gl[k], ref.reference_gossip_mix_rows(hl[k], None, pl[k], w))


@pytest.mark.cuda
def test_cuda_tree_wrapper_checks_leaves(cuda_device):
    xs = [torch.zeros(4, 8, device=cuda_device), torch.zeros(4, 3, device=cuda_device)]
    w = torch.zeros(4, device=cuda_device)
    n0 = dict(tk.LAUNCHES)
    with pytest.raises(ValueError, match="contiguous"):
        tk.gossip_mix_rows_tree([xs[0].t().contiguous().t(), xs[1]], None, xs, w)
    with pytest.raises(ValueError, match="different row counts"):
        tk.gossip_mix_rows_tree([xs[0], xs[1][:3].contiguous()], None,
                                [xs[0], xs[1][:3].contiguous()], w)
    with pytest.raises(ValueError, match=r"\(4,\) tensor"):
        tk.gossip_mix_rows_tree(xs, None, xs, torch.zeros(3, device=cuda_device))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tk.gossip_mix_rows_tree(xs, None, [xs[0], xs[1].cpu()], w)
    assert tk.LAUNCHES == n0


# tests/test_kernels.py ATTN_CASES, a ragged causal case, a ragged S != Sk
# case with head_dim 160, and one tinyllama-1.1b layer of the LM serving
# phase of chip_smoke.py (B=4, S=512, 32 heads over 4 KV heads, hd 64).
ATTN_CASES = [
    # (B, S, Sk, H, Hk, hd, causal, dtype)
    (1, 128, 128, 4, 4, 64, True, "float32"),
    (2, 256, 256, 8, 2, 64, True, "float32"),
    (1, 128, 128, 4, 1, 32, True, "float32"),
    (2, 128, 256, 4, 4, 64, False, "float32"),
    (1, 256, 256, 2, 2, 128, True, "bfloat16"),
    (1, 512, 512, 4, 2, 64, True, "float32"),
    (1, 200, 200, 8, 2, 64, True, "float32"),
    (2, 100, 37, 8, 2, 160, True, "float32"),
    (4, 512, 512, 32, 4, 64, True, "bfloat16"),
]
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(seed, B, S, Sk, H, Hk, hd, dtype, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(device=device, dtype=getattr(torch, dtype))
            for s in ((B, S, H, hd), (B, Sk, Hk, hd), (B, Sk, Hk, hd))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_cuda_flash_attention_matches_plain(cuda_device, case):
    B, S, Sk, H, Hk, hd, causal, dtype = case
    q, k, v = _qkv(2, B, S, Sk, H, Hk, hd, dtype, cuda_device)
    n0 = fa.LAUNCHES["flash_attention"]
    got = ops.attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == n0 + 1
    assert got.shape == q.shape and got.dtype == q.dtype
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), ref.reference_attention(q, k, v, causal=causal)
                               .float(), atol=tol, rtol=tol)


# The tensor-core body (bf16): every head dim, ragged causal with 8 query
# heads a KV head, non-causal with S != Sk, and MQA.
ATTN_BF16_CASES = [
    (1, 256, 256, 4, 2, 32, True, "bfloat16"),
    (1, 256, 256, 4, 2, 64, True, "bfloat16"),
    (1, 256, 256, 2, 2, 128, True, "bfloat16"),
    (2, 100, 37, 8, 2, 160, True, "bfloat16"),
    (1, 200, 200, 32, 4, 64, True, "bfloat16"),
    (2, 128, 256, 4, 4, 64, False, "bfloat16"),
    (1, 128, 128, 4, 1, 32, True, "bfloat16"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ATTN_BF16_CASES, ids=lambda c: "-".join(map(str, c)))
def test_cuda_flash_attention_tensor_core_body(cuda_device, case):
    B, S, Sk, H, Hk, hd, causal, dtype = case
    q, k, v = _qkv(8, B, S, Sk, H, Hk, hd, dtype, cuda_device)
    n0 = dict(fa.BODY_LAUNCHES)
    got = ops.attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.BODY_LAUNCHES == {"tensor_core": n0["tensor_core"] + 1, "fma": n0["fma"]}
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref.reference_attention(q, k, v, causal=causal)
                               .float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_cuda_flash_f32_runs_the_fma_body(cuda_device):
    q, k, v = _qkv(9, 1, 64, 64, 4, 2, 64, "float32", cuda_device)
    n0 = dict(fa.BODY_LAUNCHES)
    fa.flash_attention(q, k, v)
    assert fa.BODY_LAUNCHES == {"tensor_core": n0["tensor_core"], "fma": n0["fma"] + 1}


@pytest.mark.cuda
def test_cuda_flash_wrapper_checks_operands(cuda_device):
    q, k, v = _qkv(3, 1, 64, 64, 4, 2, 64, "float32", cuda_device)
    n0 = fa.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention(q.cpu(), k.cpu(), v.cpu())
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(*_qkv(3, 1, 64, 64, 4, 2, 48, "float32", cuda_device))
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(*_qkv(3, 1, 64, 64, 4, 3, 64, "float32", cuda_device)[:1],
                           *_qkv(3, 1, 64, 64, 3, 3, 64, "float32", cuda_device)[1:])
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention(q.double(), k.double(), v.double())
    qb = torch.zeros(q.numel() + 1, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(qb[1:].view(q.shape), k.bfloat16(), v.bfloat16())
    assert fa.LAUNCHES["flash_attention"] == n0


# The backward kernels: GQA with G = 8, MQA, causal and not, S != Sk both
# ways, every head dim, ragged lengths, and the training shape (a
# micro-batch of 2 x 512 tokens of tinyllama-1.1b).  Tolerance: max |err| of
# dq, dk and dv within 1e-4 (f32) or 2e-2 (bf16) of the plain version's
# max |grad| (f32 sums in another order; bf16 inputs, f32 math, one
# rounding of each gradient, and the forward's bf16 output in D).
ATTN_BWD_CASES = [
    (1, 128, 128, 4, 4, 64, True),
    (1, 200, 200, 32, 4, 64, True),
    (2, 128, 128, 8, 1, 64, True),
    (2, 100, 37, 8, 2, 128, True),
    (1, 64, 150, 4, 2, 128, True),
    (2, 128, 256, 4, 4, 64, False),
    (1, 96, 96, 4, 2, 32, True),
    (1, 100, 100, 4, 2, 160, False),
    (2, 512, 512, 32, 4, 64, True),
]
ATTN_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_BWD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_cuda_flash_attention_backward_matches_plain(cuda_device, case, dtype):
    B, S, Sk, H, Hk, hd, causal = case
    q, k, v = (t.requires_grad_() for t in _qkv(11, B, S, Sk, H, Hk, hd, dtype, cuda_device))
    dout = _qkv(12, B, S, S, H, H, hd, dtype, cuda_device)[0]
    n0 = dict(fa.LAUNCHES)
    out = ops.attention(q, k, v, causal=causal)
    got = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_attention": n0["flash_attention"] + 1,
                           "flash_attention_bwd": n0["flash_attention_bwd"] + 1}
    want = ref.reference_attention_backward(q, k, v, dout, causal=causal)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        scale = w.float().abs().max().item()
        err = (g.float() - w.float()).abs().max().item()
        assert err <= ATTN_BWD_TOL[dtype] * scale, f"d{name}: {err} against max {scale}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_attention_lse(cuda_device, dtype):
    """The forward's log-sum-exp output, against the plain scores'."""
    B, S, Sk, H, Hk, hd = 2, 100, 37, 8, 2, 64
    q, k, v = _qkv(13, B, S, Sk, H, Hk, hd, dtype, cuda_device)
    out, lse = fa._forward(q, k, v, True, with_lse=True)
    G = H // Hk
    s = torch.einsum("bshgd,bkhd->bhgsk", q.float().reshape(B, S, Hk, G, hd),
                     k.float()) / hd ** 0.5
    mask = torch.arange(S, device=cuda_device)[:, None] >= torch.arange(Sk, device=cuda_device)
    want = torch.logsumexp(s.masked_fill(~mask, -1e30), dim=-1).reshape(B, H, S)
    torch.testing.assert_close(lse, want, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(out, fa._forward(q, k, v, True, with_lse=False)[0],
                               atol=0, rtol=0)


@pytest.mark.cuda
def test_cuda_flash_attention_no_grad_runs_forward_only(cuda_device):
    q, k, v = (t.requires_grad_() for t in _qkv(14, 1, 64, 64, 4, 2, 64, "bfloat16",
                                                 cuda_device))
    n0 = dict(fa.LAUNCHES)
    with torch.no_grad():
        out = ops.attention(q, k, v)
    assert not out.requires_grad and out.grad_fn is None
    assert fa.LAUNCHES == n0 | {"flash_attention": n0["flash_attention"] + 1}


def _tiny_hd64(dtype):
    from dataclasses import replace

    from repro_torch.configs.base import get_arch

    return replace(get_arch("tinyllama-1.1b").reduced(), vocab_size=512, n_layers=2,
                   d_model=256, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=256,
                   dtype=dtype, remat=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_train_step_matches_cpu(cuda_device, dtype):
    """Three rounds of the trainer (flash forward and backward kernels under
    remat, the gossip-mix tree kernel) on the card against the same rounds
    on the CPU (the plain attention, the plain mix)."""
    from repro_torch.core.consensus import sample_round
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.optim import sgd
    from repro_torch.train.trainer import TrainStepConfig, init_stacked, make_train_step
    from repro_torch.tree import tree_leaves, tree_map

    cfg, M, lr = _tiny_hd64(dtype), 4, 0.02
    opt = sgd(momentum=0.9, weight_decay=1e-4)
    step = make_train_step(cfg, opt, M, "netmax",
                           TrainStepConfig(use_gossip_mix_kernel=True))
    params, state = init_stacked(cfg, opt, M, torch.Generator().manual_seed(0))
    runs = {dev: (tree_map(lambda t: t.to(dev), params), tree_map(lambda t: t.to(dev), state))
            for dev in ("cpu", "cuda")}
    stream = TokenStream(cfg.vocab_size, 64, 4, seed=0)
    d = np.ones((M, M)) - np.eye(M)
    P = np.where(d > 0, 1.0 / (M - 1), 0.0)
    rng = np.random.default_rng(0)
    n0 = dict(fa.LAUNCHES)
    tol = {"float32": 1e-4, "bfloat16": 2e-2}[dtype]
    for r in range(3):
        batch = {k: np.stack([stream.batch(w, r)[k] for w in range(M)]).astype(np.int64)
                 for k in ("tokens", "labels")}
        nb, wts = sample_round(rng, P, lr, 0.5 / (2 * lr * (M - 1)), d)
        losses = {}
        for dev, (p, o) in runs.items():
            b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            p, o, m = step(p, o, b, {"neighbors": nb, "weights": wts, "lr": lr})
            runs[dev] = (p, o)
            losses[dev] = m["loss_per_worker"].cpu()
        torch.testing.assert_close(losses["cuda"], losses["cpu"], rtol=tol, atol=0)
    # Per round: M workers x 2 micro-batches x 2 layers backward calls, and
    # twice as many forwards (remat runs each block's forward again).
    calls = 3 * M * cfg.microbatches * cfg.n_layers
    assert fa.LAUNCHES["flash_attention_bwd"] - n0["flash_attention_bwd"] == calls
    assert fa.LAUNCHES["flash_attention"] - n0["flash_attention"] == 2 * calls
    for a, b in zip(tree_leaves(runs["cpu"][0]), tree_leaves(runs["cuda"][0])):
        scale = a.float().abs().max().item()
        assert (b.cpu().float() - a.float()).abs().max().item() <= tol * max(scale, 1e-6)


@pytest.mark.cuda
def test_cuda_ssm_training_raises(cuda_device):
    from repro_torch.configs.base import get_arch
    from repro_torch.optim import sgd
    from repro_torch.train.trainer import init_stacked, make_train_step

    cfg = get_arch("rwkv6-7b").reduced()
    opt = sgd()
    params, state = init_stacked(cfg, opt, 2, torch.Generator(device="cuda").manual_seed(0))
    batch = {k: torch.zeros((2, 1, 16), dtype=torch.int64, device="cuda")
             for k in ("tokens", "labels")}
    with pytest.raises(NotImplementedError, match=r"B4\(c\)"):
        make_train_step(cfg, opt, 2)(params, state, batch,
                                     {"neighbors": [1, 0], "weights": [0.5, 0.5], "lr": 0.1})


# tests/test_kernels.py RWKV_CASES, then ragged lengths (S not a multiple of
# the chunk or of 16) and one rwkv6-7b layer of a 4 x 512 prefill.
RWKV_CASES = [
    # (B, S, H, N, chunk, dtype)
    (1, 64, 2, 16, 16, "float32"),
    (2, 128, 4, 32, 32, "float32"),
    (1, 128, 2, 64, 64, "float32"),
    (1, 256, 2, 16, 64, "float32"),
    (1, 128, 2, 32, 32, "bfloat16"),
    (2, 100, 3, 64, 64, "float32"),
    (1, 7, 1, 16, 64, "bfloat16"),
    (4, 512, 64, 64, 64, "float32"),
]
RWKV_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _rwkv_inputs(seed, B, S, H, N, dtype, device):
    """The distributions of tests/test_kernels.py: decays in (0.7, 1.0)."""
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    r = rng.standard_normal((B, S, H, N)).astype(np.float32) * 0.5
    k = rng.standard_normal((B, S, H, N)).astype(np.float32) * 0.5
    v = rng.standard_normal((B, S, H, N)).astype(np.float32)
    w = 1.0 / (1.0 + np.exp(-(rng.standard_normal((B, S, H, N)) + 2.0)))
    u = rng.standard_normal((H, N)).astype(np.float32) * 0.1
    return ([torch.from_numpy(a).to(device=device, dtype=dt)
             for a in (r, k, v, w.astype(np.float32))]
            + [torch.from_numpy(u).to(device)])


def _assert_rwkv_close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", RWKV_CASES, ids=lambda c: "-".join(map(str, c)))
def test_cuda_rwkv_scan_matches_plain(cuda_device, case):
    B, S, H, N, chunk, dtype = case
    r, k, v, w, u = _rwkv_inputs(4, B, S, H, N, dtype, cuda_device)
    n0 = rs.LAUNCHES["rwkv_scan"]
    got = ops.rwkv(r, k, v, w, u, chunk=chunk)
    torch.cuda.synchronize()
    assert rs.LAUNCHES["rwkv_scan"] == n0 + 1
    assert got.shape == r.shape and got.dtype == r.dtype
    _assert_rwkv_close(got, ref.reference_rwkv(r, k, v, w, u), RWKV_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(2, 128, 4, 32, 32), (1, 100, 2, 64, 64)],
                         ids=lambda c: "-".join(map(str, c)))
def test_cuda_rwkv_scan_carries_the_state(cuda_device, case):
    """From a random initial state, y and the final state match the plain
    recurrence; two calls over the halves equal one call over the whole."""
    B, S, H, N, chunk = case
    r, k, v, w, u = _rwkv_inputs(5, B, S, H, N, "float32", cuda_device)
    s0 = torch.randn((B, H, N, N), device=cuda_device,
                     generator=torch.Generator(cuda_device).manual_seed(0))
    y, s1 = ops.rwkv(r, k, v, w, u, chunk=chunk, state=s0)
    want_y, want_s = ref.reference_rwkv_state(r, k, v, w, u, s0)
    _assert_rwkv_close(y, want_y, 1e-4)
    _assert_rwkv_close(s1, want_s, 1e-4)
    half = S // 2
    ya, sa = rs.rwkv_scan(*(t[:, :half].contiguous() for t in (r, k, v, w)), u,
                          chunk=chunk, state=s0)
    yb, sb = rs.rwkv_scan(*(t[:, half:].contiguous() for t in (r, k, v, w)), u,
                          chunk=chunk, state=sa)
    _assert_rwkv_close(torch.cat([ya, yb], dim=1), want_y, 1e-4)
    _assert_rwkv_close(sb, want_s, 1e-4)


@pytest.mark.cuda
def test_cuda_rwkv_scan_extreme_decay_clamped(cuda_device):
    """tests/test_kernels.py's extreme decays (w = 1e-30, which the Pallas
    wrapper clamps): the kernel does not clamp, stays finite and equals the
    plain recurrence on the decays as given, to the f32 tolerance."""
    r, k, v, _, u = _rwkv_inputs(6, 1, 32, 1, 16, "float32", cuda_device)
    w0 = torch.full_like(r, 1e-30)
    got, state = rs.rwkv_scan(r, k, v, w0, u, chunk=16)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(state).all())
    want, want_s = ref.reference_rwkv_state(r, k, v, w0, u)
    _assert_rwkv_close(got, want, 1e-4)
    _assert_rwkv_close(state, want_s, 1e-4)


def strong_decays(w, how):
    """Decays below the Pallas kernel's clamp (log w < -75/16 a step), in
    w's shape (B, S, H, N): ``"-5"`` and ``"-8"`` a constant log decay
    (times U(0.9, 1.1)); ``"mixed"`` keeps ``w`` but sets the first half of
    the columns of every other 16-token sub-chunk to log w = -8, so those
    sub-chunks straddle the factorised range (half their columns total
    -128, half stay above -75) and the rest lie inside it."""
    gen = torch.Generator(w.device).manual_seed(7)
    if how in ("-5", "-8"):
        jitter = 0.9 + 0.2 * torch.rand(w.shape, generator=gen, device=w.device)
        return torch.exp(float(how) * jitter).to(w.dtype)
    out = w.clone()
    S, N = w.shape[1], w.shape[3]
    for t0 in range(0, S, 32):
        out[:, t0:t0 + 16, :, :N // 2] = float(np.exp(-8.0))
    return out


# (B, S, H, N, chunk, dtype): f32 at N 16 and 64, and the model's dtypes
# (bf16 r/k/v, f32 w), ragged.
RWKV_STRONG_CASES = [(1, 64, 2, 16, 16, "float32"), (1, 128, 2, 64, 64, "float32"),
                     (2, 100, 3, 64, 64, "mixed")]


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["-5", "-8", "mixed"])
@pytest.mark.parametrize("case", RWKV_STRONG_CASES, ids=lambda c: "-".join(map(str, c)))
def test_cuda_rwkv_scan_exact_below_the_pallas_clamp(cuda_device, case, how):
    """Decays below the Pallas wrapper's clamp: the kernel against the
    unclamped plain recurrence, from a random state, y and the final state
    to the f32 tolerance (y to bf16's when it is bf16)."""
    B, S, H, N, chunk, dtype = case
    r, k, v, w, u = _rwkv_inputs(14, B, S, H, N, "float32", cuda_device)
    if dtype == "mixed":
        r, k, v, w, u = _mixed(r, k, v, w, u)
    w = strong_decays(w, how)
    s0 = torch.randn((B, H, N, N), device=cuda_device,
                     generator=torch.Generator(cuda_device).manual_seed(3))
    y, s1 = rs.rwkv_scan(r, k, v, w, u, chunk=chunk, state=s0)
    want_y, want_s = ref.reference_rwkv_state(r, k, v, w, u, s0)
    assert bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(s1).all())
    _assert_rwkv_close(y, want_y, 5e-2 if dtype == "mixed" else 1e-4)
    _assert_rwkv_close(s1, want_s, 1e-4)


# The model's dtypes: bf16 r/k/v, f32 w; N 16/32/64, ragged S, and one
# rwkv6-7b layer of a 4 x 512 prefill.
RWKV_MIXED_CASES = [
    # (B, S, H, N, chunk)
    (1, 64, 2, 16, 16),
    (2, 128, 4, 32, 32),
    (1, 128, 2, 64, 64),
    (2, 100, 3, 64, 64),
    (1, 37, 2, 32, 20),
    (4, 512, 64, 64, 64),
]


def _mixed(r, k, v, w, u):
    return r.bfloat16(), k.bfloat16(), v.bfloat16(), w, u


@pytest.mark.cuda
@pytest.mark.parametrize("case", RWKV_MIXED_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("with_state", [False, True])
def test_cuda_rwkv_scan_mixed_dtypes(cuda_device, case, with_state):
    B, S, H, N, chunk = case
    r, k, v, w, u = _mixed(*_rwkv_inputs(12, B, S, H, N, "float32", cuda_device))
    s0 = (torch.randn((B, H, N, N), device=cuda_device,
                      generator=torch.Generator(cuda_device).manual_seed(1))
          if with_state else None)
    n0 = dict(rs.DTYPE_LAUNCHES)
    y, s1 = rs.rwkv_scan(r, k, v, w, u, chunk=chunk, state=s0)
    torch.cuda.synchronize()
    assert rs.DTYPE_LAUNCHES["mixed"] == n0["mixed"] + 1
    assert y.dtype == torch.bfloat16 and s1.dtype == torch.float32
    want_y, want_s = ref.reference_rwkv_state(r, k, v, w, u, s0)
    _assert_rwkv_close(y, want_y, 5e-2)
    _assert_rwkv_close(s1, want_s, 1e-4)


@pytest.mark.cuda
def test_cuda_rwkv_mixed_equals_f32_on_widened_inputs(cuda_device):
    """The mixed instantiation computes the all-f32 function of the widened
    inputs: its f32 state matches the f32 kernel's to 1e-4 and its y is that
    y within one bf16 rounding."""
    r, k, v, w, u = _mixed(*_rwkv_inputs(13, 2, 100, 3, 64, "float32", cuda_device))
    y, s1 = rs.rwkv_scan(r, k, v, w, u)
    y32, s32 = rs.rwkv_scan(r.float(), k.float(), v.float(), w, u)
    _assert_rwkv_close(s1, s32, 1e-4)
    _assert_rwkv_close(y, y32, 5e-2)


@pytest.mark.cuda
def test_cuda_rwkv_wrapper_checks_operands(cuda_device):
    r, k, v, w, u = _rwkv_inputs(7, 1, 32, 2, 16, "float32", cuda_device)
    n0 = rs.LAUNCHES["rwkv_scan"]
    with pytest.raises(ValueError, match="contiguous"):
        rs.rwkv_scan(r.transpose(1, 2).contiguous().transpose(1, 2), k, v, w, u)
    with pytest.raises(ValueError, match="CUDA tensor"):
        rs.rwkv_scan(r.cpu(), k.cpu(), v.cpu(), w.cpu(), u.cpu())
    with pytest.raises(ValueError, match="head size"):
        rs.rwkv_scan(*_rwkv_inputs(7, 1, 32, 2, 8, "float32", cuda_device))
    with pytest.raises(TypeError, match="differ"):
        rs.rwkv_scan(r, k, v, w.bfloat16(), u)
    with pytest.raises(ValueError, match="u must be"):
        rs.rwkv_scan(r, k, v, w, u.bfloat16())
    with pytest.raises(ValueError, match="state must be"):
        rs.rwkv_scan(r, k, v, w, u, state=torch.zeros((1, 2, 16, 8), device=cuda_device))
    with pytest.raises(TypeError, match="differ"):
        rs.rwkv_scan(r.bfloat16(), k.bfloat16(), v.bfloat16(), w.half(), u)
    with pytest.raises(TypeError, match="differ"):
        rs.rwkv_scan(r.bfloat16(), k, v.bfloat16(), w, u)
    rb = torch.zeros(r.numel() + 1, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        rs.rwkv_scan(rb[1:].view(r.shape), k, v, w, u)
    with pytest.raises(RuntimeError, match="forward only"):
        rs.rwkv_scan(r.requires_grad_(), k, v, w, u)
    assert rs.LAUNCHES["rwkv_scan"] == n0


@pytest.mark.cuda
@pytest.mark.parametrize("piv_min", [None, 0.3], ids=["default", "tiny-pivots"])
def test_cuda_lp_device_walks_the_numpy_path(cuda_device, piv_min, monkeypatch):
    """The float64 device simplex on the card against the numpy lockstep
    simplex on tests/test_revised.py:675's fixture (rng 23, n 10, m 4,
    S 12): the same statuses and pivot counts, objectives within 1e-9;
    and by default (no ``device``) it runs on the card.  The witness is
    the port's numpy simplex (this file imports nothing of the JAX
    package), which tests/test_torch_lp_device.py holds bit-equal to the
    JAX package's.  With the tiny-pivot threshold raised to 0.3 in both,
    windows of the CUDA graph are rolled back and run again."""
    from repro_torch.solver import batch, batch_torch
    from repro_torch.solver.batch_torch import solve_lp_batch_torch

    if piv_min is not None:
        monkeypatch.setattr(batch, "_PIV_MIN", piv_min)
        monkeypatch.setattr(batch_torch, "_PIV_MIN", piv_min)
    rng = np.random.default_rng(23)
    n, m, S = 10, 4, 12
    A = rng.normal(size=(m, n))
    c = rng.normal(size=n)
    b = np.stack([A @ rng.uniform(0.1, 0.9, size=n) for _ in range(S - 2)]
                 + [rng.normal(size=m), rng.normal(size=m)])
    lb = np.zeros((S, n))
    lb[3] = 0.05
    ub = np.ones((S, n))
    ref = batch.solve_lp_batch(c, A, b, lb_stack=lb, ub_stack=ub)
    for dev in (cuda_device, None):
        got = solve_lp_batch_torch(c, A, b, lb_stack=lb, ub_stack=ub, device=dev)
        assert [g.status for g in got] == [r.status for r in ref]
        assert [g.pivots for g in got] == [r.pivots for r in ref]
        for g, r in zip(got, ref):
            if r.ok:
                assert g.fun == pytest.approx(r.fun, rel=1e-9, abs=1e-9)
    sol = batch_torch.make_solver(c, A, b, lb, ub, device=cuda_device)
    sol.solve()
    assert sol.graph is None and (sol.rollbacks > 0) == (piv_min is not None)
