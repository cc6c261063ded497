"""The port's CUDA kernels on the card (marker ``cuda``; skips without one).

The gossip-mix kernel repeats its plain version's f32 steps with every
rounding in the same place (no FMA contraction), so it is held to it
bit for bit, as one launch per parameter tree too (u given and absent).  The flash-attention and WKV kernels sum in another order than
their plain versions, so they are held to the tolerances of
``tests/test_kernels.py`` (attention 2e-5 in f32, 2e-2 in bf16; WKV 1e-4 in
f32 and 5e-2 in bf16, for any decay: the kernel does not clamp).  With bf16
r/k/v and f32 decays (the model's dtypes) the WKV output y is bf16 and held
to 5e-2, one bf16 step being 2^-8 of |y|, while the final state is f32,
computed from exactly widened inputs, and held to 1e-4.  The WKV backward
kernel is held to its plain reverse recurrence and to autograd through the
plain forward within 1e-4 (f32) / 2e-2 (bf16) of each gradient's max |.|,
as the flash-attention backward.  The trainer's round at each family's
reduced cut is held to the CPU's within 1e-4 (f32) / 2e-2 (bf16, the MoE
layers of the CPU's round taking the card's expert choices), and the MoE
layer's gradients repeat bit for bit and agree with the CPU's within 1e-5.
This file imports no JAX, so it runs on a machine that has only torch:

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
    # The families' shapes (chip_smoke.py's ATTN_FAMILY_CASES at B = 1):
    # whisper's encoder and cross-attention, llama4, internvl2, phi3.5/Jamba.
    (1, 1500, 1500, 12, 12, 64, False, "float32"),
    (1, 64, 1500, 12, 12, 64, False, "float32"),
    (1, 512, 512, 40, 8, 128, True, "bfloat16"),
    (1, 768, 768, 14, 2, 64, True, "bfloat16"),
    (1, 512, 512, 32, 8, 128, True, "bfloat16"),
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
# heads a KV head, non-causal with S != Sk, and MQA; then the wgmma body's
# padded folded tiles, G = 5 and 7 (60 and 63 real rows of 64) at every head
# dim, causal and not, ragged S and Sk.
ATTN_BF16_CASES = [
    (1, 256, 256, 4, 2, 32, True, "bfloat16"),
    (1, 256, 256, 4, 2, 64, True, "bfloat16"),
    (1, 256, 256, 2, 2, 128, True, "bfloat16"),
    (2, 100, 37, 8, 2, 160, True, "bfloat16"),
    (1, 200, 200, 32, 4, 64, True, "bfloat16"),
    (2, 128, 256, 4, 4, 64, False, "bfloat16"),
    (1, 128, 128, 4, 1, 32, True, "bfloat16"),
] + [(2, 300, 170, 5 * 2, 2, hd, causal, "bfloat16") for hd in fa.HEAD_DIMS
     for causal in (True, False)] + [(1, 77, 300, 7, 1, hd, True, "bfloat16")
                                     for hd in fa.HEAD_DIMS]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ATTN_BF16_CASES, ids=lambda c: "-".join(map(str, c)))
def test_cuda_flash_attention_tensor_core_body(cuda_device, case):
    """The wgmma body against the plain version (2e-2); the C entry reports
    it and the grid ``wgmma_plan`` gives."""
    B, S, Sk, H, Hk, hd, causal, dtype = case
    q, k, v = _qkv(8, B, S, Sk, H, Hk, hd, dtype, cuda_device)
    n0 = dict(fa.BODY_LAUNCHES)
    got = ops.attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.BODY_LAUNCHES == {**n0, "bf16_wgmma": n0["bf16_wgmma"] + 1}
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = fa.wgmma_plan(B, S, Sk, H, Hk, hd, causal=causal, sms=sms)
    assert fa.FWD_LAUNCHED == {"body": "bf16_wgmma", "key_splits": 1,
                               "grid": plan["fwd_grid"], "blocks": plan["fwd_blocks"]}
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref.reference_attention(q, k, v, causal=causal)
                               .float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_cuda_mixed_dtypes_promote_before_the_kernel(cuda_device):
    """whisper's cross-attention: a bf16 query against f32 keys and values
    runs the f32 (3xTF32 on wgmma at hd 64) body on the promoted operands,
    output in q's dtype."""
    from repro_torch.models import attention as attn

    q, _, _ = _qkv(10, 2, 64, 300, 4, 4, 64, "bfloat16", cuda_device)
    _, k, v = _qkv(11, 2, 64, 300, 4, 4, 64, "float32", cuda_device)
    n0 = dict(fa.BODY_LAUNCHES)
    got = attn.chunked_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert fa.BODY_LAUNCHES == {**n0, "tf32x3_wgmma": n0["tf32x3_wgmma"] + 1}
    assert got.dtype == torch.bfloat16
    want = ref.reference_attention(q.float(), k, v, causal=False).to(torch.bfloat16)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_cuda_flash_f32_runs_the_tensor_core_body(cuda_device):
    """f32 runs the 3xTF32 wgmma body at hd 64, its walk whole at this shape:
    one block of 128 folded rows (64 positions x 2 heads) a KV head."""
    q, k, v = _qkv(9, 1, 64, 64, 4, 2, 64, "float32", cuda_device)
    n0 = dict(fa.BODY_LAUNCHES)
    fa.flash_attention(q, k, v)
    assert fa.BODY_LAUNCHES == {**n0, "tf32x3_wgmma": n0["tf32x3_wgmma"] + 1}
    assert fa.FWD_LAUNCHED == {"body": "tf32x3_wgmma", "key_splits": 1, "grid": (1, 2),
                               "blocks": 2}


#: f32 at every head dim, causal with G = 2 and ragged, and non-causal with
#: S != Sk (hd 128 and 160 read Q's fragments from shared memory each tile).
ATTN_F32_HD_CASES = [(2, 100, 137, 4, 2, hd, causal)
                     for hd in fa.HEAD_DIMS for causal in (True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ATTN_F32_HD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_cuda_flash_f32_every_head_dim(cuda_device, case):
    """The 3xTF32 bodies, forward (2e-5) and backward (1e-4 of max |grad|),
    at every head dim, against the plain version."""
    B, S, Sk, H, Hk, hd, causal = case
    q, k, v = (t.requires_grad_() for t in _qkv(15, B, S, Sk, H, Hk, hd, "float32",
                                                 cuda_device))
    dout = _qkv(16, B, S, S, H, H, hd, "float32", cuda_device)[0]
    out = ops.attention(q, k, v, causal=causal)
    got = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert fa.FWD_LAUNCHED["body"] == ("tf32x3_wgmma" if hd <= 64 else "tf32x3_mma")
    assert fa.BWD_LAUNCHED["body"] == ("tf32x3_wgmma" if hd <= 64 else "tf32x3_wide_mma")
    torch.testing.assert_close(out, ref.reference_attention(q, k, v, causal=causal),
                               atol=2e-5, rtol=2e-5)
    for name, g, w in zip("qkv", got, ref.reference_attention_backward(q, k, v, dout,
                                                                       causal=causal)):
        scale = w.abs().max().item()
        err = (g - w).abs().max().item()
        assert err <= 1e-4 * scale, f"d{name}: {err} against max {scale}"


#: Short query sequences whose f32 walk is split on an H100 (``dq_splits``):
#: whisper's cross-attention (64 x 1500, 3 ranges at B = 4), and a causal
#: one whose later ranges hold no key its rows see.
ATTN_F32_SPLIT_CASES = [(4, 64, 1500, 12, 12, 64, False), (1, 16, 200, 2, 1, 64, True),
                        (1, 300, 300, 1, 1, 32, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ATTN_F32_SPLIT_CASES, ids=lambda c: "-".join(map(str, c)))
def test_cuda_flash_f32_split_walk(cuda_device, case):
    """The split walk against the plain version (2e-5) and its merged lse
    against one whole walk's; the C entry reports the ranges asked for."""
    B, S, Sk, H, Hk, hd, causal = case
    q, k, v = _qkv(17, B, S, Sk, H, Hk, hd, "float32", cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    splits = fa.forward_key_splits(torch.float32, B, S, Sk, H, Hk, sms)
    if splits == 1:
        pytest.skip(f"{sms} SMs: this shape's walk is whole")
    grid = fa.tf32_plan(B, S, Sk, H, Hk, hd)["fwd_grid"]
    out, lse = fa._forward(q, k, v, causal, with_lse=True)
    assert fa.FWD_LAUNCHED == {"body": "tf32x3_wgmma", "key_splits": splits, "grid": grid,
                               "blocks": grid[0] * grid[1] * splits}
    whole_out, whole_lse = fa._forward(q, k, v, causal, with_lse=True, key_splits=1)
    assert fa.FWD_LAUNCHED == {"body": "tf32x3_wgmma", "key_splits": 1, "grid": grid,
                               "blocks": grid[0] * grid[1]}
    torch.cuda.synchronize()
    want = ref.reference_attention(q, k, v, causal=causal)
    torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(whole_out, want, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(lse, whole_lse, atol=1e-5, rtol=1e-5)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()


@pytest.mark.cuda
def test_cuda_flash_bf16_maps_follow_the_tensors(cuda_device):
    """The bf16 bodies keep their TMA maps by address and geometry: calls on
    two sets of tensors of one shape, then on the first set rewritten in
    place, and the same storage seen as another shape, each read their own
    operands, forward and backward."""
    B, S, Sk, H, Hk, hd = 2, 96, 96, 8, 2, 64
    sets = [_qkv(seed, B, S, Sk, H, Hk, hd, "bfloat16", cuda_device) for seed in (31, 32)]
    rng = np.random.default_rng(33)
    dout = torch.from_numpy(rng.standard_normal((B, S, H, hd)).astype(np.float32)).to(
        device=cuda_device, dtype=torch.bfloat16)

    def check(q, k, v, dout):
        out, lse = fa._forward(q, k, v, True, with_lse=True)
        got = fa.flash_attention_backward(q, k, v, out, dout, lse, causal=True)
        torch.cuda.synchronize()
        want = ref.reference_attention(q, k, v, causal=True)
        tol = ATTN_TOL["bfloat16"]
        torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
        for g, w in zip(got, ref.reference_attention_backward(q, k, v, dout, causal=True)):
            scale = w.float().abs().max().item()
            err = (g.float() - w.float()).abs().max().item()
            assert err <= ATTN_BWD_TOL["bfloat16"] * scale, f"{err} against max {scale}"

    check(*sets[0], dout)
    check(*sets[1], dout)
    for t in sets[0]:
        t.copy_(t.flip(1))
    check(*sets[0], dout)
    q, k, v = sets[0]
    check(q.view(B, S // 2, 2 * H, hd), k.view(B, Sk // 2, 2 * Hk, hd),
          v.view(B, Sk // 2, 2 * Hk, hd), dout.view(B, S // 2, 2 * H, hd))


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
    qf = torch.zeros(q.numel() + 1, device=cuda_device, dtype=torch.float32)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(qf[1:].view(q.shape), k, v)
    assert fa.LAUNCHES["flash_attention"] == n0


# The backward kernels: GQA with G = 8, MQA, causal and not, S != Sk both
# ways, every head dim, ragged lengths, and the training shape (a
# micro-batch of 2 x 512 tokens of tinyllama-1.1b); the layers of a 1 x 512
# micro-batch of phi3.5-moe, llama4 (hd 128) and stablelm-12b (hd 160), bf16
# there on the wide tensor-core body; short query sequences whose dQ key
# walk is split on an H100 (``dq_splits`` > 1): whisper's cross-attention (64
# x 1500), and causal ones whose later key ranges see no key (zero
# partials); G = 5 and 7, whose bf16 dQ tiles hold padding rows.  Tolerance: max |err| of dq, dk and dv within 1e-4 (f32) or
# 2e-2 (bf16) of the plain version's max |grad| (f32 sums in another order;
# bf16 inputs, f32 math, one rounding of each gradient, and the forward's
# bf16 output in D).
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
    (1, 512, 512, 32, 8, 128, True),
    (1, 512, 512, 40, 8, 128, True),
    (1, 512, 512, 32, 8, 160, True),
    (2, 100, 37, 8, 2, 160, True),
    (1, 64, 150, 4, 2, 160, True),
    (4, 64, 1500, 12, 12, 64, False),
    (2, 64, 1000, 8, 4, 128, True),
    (2, 64, 1000, 8, 4, 160, True),
    (2, 150, 130, 10, 2, 64, True),
    (1, 90, 200, 7, 1, 128, False),
    (1, 130, 130, 14, 2, 160, True),
    (1, 70, 70, 5, 1, 32, True),
]
ATTN_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_BWD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_cuda_flash_attention_backward_matches_plain(cuda_device, case, dtype):
    """Within ``ATTN_BWD_TOL`` of the plain gradient; one launch a call;
    a second call gives bit-equal gradients; the C entry reports the body
    the dtype and head dim run and the ``dq_splits`` the wrapper asked for."""
    B, S, Sk, H, Hk, hd, causal = case
    q, k, v = (t.requires_grad_() for t in _qkv(11, B, S, Sk, H, Hk, hd, dtype, cuda_device))
    dout = _qkv(12, B, S, S, H, H, hd, dtype, cuda_device)[0]
    n0 = dict(fa.LAUNCHES)
    out = ops.attention(q, k, v, causal=causal)
    got = torch.autograd.grad(out, (q, k, v), dout, retain_graph=True)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_attention": n0["flash_attention"] + 1,
                           "flash_attention_bwd": n0["flash_attention_bwd"] + 1}
    again = torch.autograd.grad(out, (q, k, v), dout)
    assert fa.LAUNCHES["flash_attention_bwd"] == n0["flash_attention_bwd"] + 2
    want = ref.reference_attention_backward(q, k, v, dout, causal=causal)
    for name, g, a, w in zip("qkv", got, again, want):
        assert torch.equal(g, a), f"d{name} differs between two calls"
        assert g.shape == w.shape and g.dtype == w.dtype, name
        scale = w.float().abs().max().item()
        err = (g.float() - w.float()).abs().max().item()
        assert err <= ATTN_BWD_TOL[dtype] * scale, f"d{name}: {err} against max {scale}"
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    G = H // Hk
    if dtype == "bfloat16":
        plan = fa.wgmma_plan(B, S, Sk, H, Hk, hd, causal=causal, sms=sms)
        want = {"body": "wgmma", "dkdv_grid": plan["dkdv_grid"], "dq_grid": plan["dq_grid"]}
    else:
        plan = fa.tf32_plan(B, S, Sk, H, Hk, hd)
        want = {"body": "tf32x3_wgmma" if hd <= 64 else "tf32x3_wide_mma",
                "dkdv_grid": (-(-Sk // 64), B * Hk, G), "dq_grid": plan["dq_grid"]}
        assert plan["dkdv_grid"] == want["dkdv_grid"]
    want["dq_splits"] = fa.backward_dq_splits(getattr(torch, dtype), B, S, Sk, H, Hk, hd, sms)
    want["kernels"] = fa.bwd_kernels(getattr(torch, dtype), want["dkdv_grid"][2],
                                     want["dq_splits"], hd)
    assert fa.BWD_LAUNCHED == want


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


def _ssm_cut(dtype, layers=2):
    """The ssm training cut: rwkv6-7b's family at d_model 256 with B4's head
    size N = 64 (4 heads), d_ff 512, vocab 512, remat, its 4 micro-batches."""
    from dataclasses import replace

    from repro_torch.configs.base import get_arch

    return replace(get_arch("rwkv6-7b"), n_layers=layers, d_model=256, n_heads=4,
                   n_kv_heads=4, head_dim=64, d_ff=512, vocab_size=512, dtype=dtype)


def _ssm_rounds(cfg, devices, rounds, M=4, seq=64, batch=4):
    """``rounds`` rounds of the trainer from the same params and draws on
    each device -> ({device: per-round losses}, {device: params})."""
    from repro_torch.core.consensus import sample_round
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.optim import sgd
    from repro_torch.train.trainer import TrainStepConfig, init_stacked, make_train_step
    from repro_torch.tree import tree_map

    opt = sgd(momentum=0.9, weight_decay=1e-4)
    step = make_train_step(cfg, opt, M, "netmax", TrainStepConfig(use_gossip_mix_kernel=True))
    params, state = init_stacked(cfg, opt, M, torch.Generator().manual_seed(0))
    runs = {dev: (tree_map(lambda t: t.to(dev), params), tree_map(lambda t: t.to(dev), state))
            for dev in devices}
    stream = TokenStream(cfg.vocab_size, seq, batch, seed=0)
    d = np.ones((M, M)) - np.eye(M)
    P = np.where(d > 0, 1.0 / (M - 1), 0.0)
    rng = np.random.default_rng(0)
    losses = {dev: [] for dev in devices}
    for r in range(rounds):
        b = {k: np.stack([stream.batch(w, r)[k] for w in range(M)]).astype(np.int64)
             for k in ("tokens", "labels")}
        nb, wts = sample_round(rng, P, 0.02, 0.5 / (2 * 0.02 * (M - 1)), d)
        for dev, (p, o) in runs.items():
            bt = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
            p, o, m = step(p, o, bt, {"neighbors": nb, "weights": wts, "lr": 0.02})
            runs[dev] = (p, o)
            losses[dev].append(m["loss_per_worker"].cpu())
    return losses, {dev: p for dev, (p, _) in runs.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ssm_training_matches_cpu(cuda_device, dtype):
    """Two rounds of the ssm family's trainer (the WKV forward and backward
    kernels under remat, the gossip-mix tree kernel) on the card against
    the same rounds on the CPU (the plain recurrence under autograd): losses
    and params within 1e-4 (f32) / 2e-2 (bf16 weights, f32 decays)."""
    from repro_torch.tree import tree_leaves

    cfg = _ssm_cut(dtype)
    tol = {"float32": 1e-4, "bfloat16": 2e-2}[dtype]
    losses, params = _ssm_rounds(cfg, ("cpu", "cuda"), 2)
    for a, b in zip(losses["cpu"], losses["cuda"]):
        assert bool(torch.isfinite(b).all())
        torch.testing.assert_close(b, a, rtol=tol, atol=0)
    for a, b in zip(tree_leaves(params["cpu"]), tree_leaves(params["cuda"])):
        scale = a.float().abs().max().item()
        assert (b.cpu().float() - a.float()).abs().max().item() <= tol * max(scale, 1e-6)


@pytest.mark.cuda
def test_cuda_ssm_round_launches_the_wkv_backward_once_a_layer_and_micro_batch(cuda_device):
    """In one round: the WKV backward kernel once per worker, micro-batch and
    layer, its forward twice (remat runs each block's forward again), the
    tree mix once per dtype group of the tree (its bf16 leaves, and the f32
    ``u`` and ``w0``), and no attention kernel."""
    from repro_torch.tree import tree_leaves

    cfg = _ssm_cut("bfloat16", layers=3)
    rs.reset_launches()
    n0 = dict(fa.LAUNCHES), dict(tk.LAUNCHES)
    _, params = _ssm_rounds(cfg, ("cuda",), 1)
    torch.cuda.synchronize()
    calls = 4 * cfg.microbatches * cfg.n_layers
    assert rs.LAUNCHES == {"rwkv_scan": 2 * calls, "rwkv_scan_bwd": calls}
    assert rs.DTYPE_LAUNCHES["mixed"] == 2 * calls
    assert fa.LAUNCHES == n0[0]
    groups = {leaf.dtype for leaf in tree_leaves(params["cuda"])}
    assert groups == {torch.bfloat16, torch.float32}
    assert tk.LAUNCHES["gossip_mix_rows"] == n0[1]["gossip_mix_rows"] + len(groups)


#: The families chip_smoke.py's phase 33 trains card against CPU.
FAMILIES = ["phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b", "jamba-v0.1-52b",
            "whisper-small", "internvl2-1b"]


def _family_cut(name, dtype):
    """chip_smoke.py's ``family_cut`` with remat on: the arch's reduced()
    config (its layers, period, encoder, experts, micro-batches) at d_model
    256 and head_dim 64."""
    from dataclasses import replace

    from repro_torch.configs.base import get_arch

    return replace(get_arch(name).reduced(), d_model=256, head_dim=64, dtype=dtype,
                   remat=True)


def _routes(inner, record=None, replay=None):
    """A stand-in for ``moe.route`` (``inner``) that records each call's expert
    choices into ``record``, or takes them, call by call, from ``replay``."""
    from repro_torch.models import moe

    it = iter(replay or ())

    def route(p, x, cfg):
        probs, idx = inner(p, x, cfg)[:2]
        if replay is not None:
            idx = next(it).to(x.device)
        if record is not None:
            record.append(idx.cpu())
        return (probs, idx) + moe.place(probs.gather(-1, idx), idx, cfg)

    return route


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", FAMILIES)
def test_cuda_family_round_matches_cpu(cuda_device, name, dtype, monkeypatch):
    """One round of the trainer (M = 2, remat, the fused mix, the config's
    micro-batches) at each family's cut on the card against the CPU: losses
    and params within 1e-4 (f32) / 2e-2 (bf16); in bf16 the CPU's MoE layers
    take the card's expert choices, the remat recomputation's too. B3's
    backward once per worker, micro-batch and attention call, its forward
    twice."""
    from repro_torch.models import moe
    from repro_torch.optim import sgd
    from repro_torch.train.trainer import TrainStepConfig, init_stacked, make_train_step
    from repro_torch.tree import tree_leaves, tree_map

    cfg, M = _family_cut(name, dtype), 2
    b_per, seq = max(cfg.microbatches, 2), 64
    opt = sgd(momentum=0.9, weight_decay=1e-4)
    step = make_train_step(cfg, opt, M, "netmax", TrainStepConfig(use_gossip_mix_kernel=True))
    params, state = init_stacked(cfg, opt, M, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab_size, (M, b_per, seq)) for k in ("tokens", "labels")}
    if cfg.n_vis_tokens:
        batch["vis_embeds"] = 0.02 * rng.standard_normal((M, b_per, cfg.n_vis_tokens, 256))
    if cfg.family == "audio":
        batch["frames"] = 0.02 * rng.standard_normal((M, b_per, cfg.enc_seq_len, 256))
    gi = {"neighbors": np.array([1, 0]), "weights": np.array([0.3, 0.6], np.float32),
          "lr": 0.02}
    batch = {k: v.astype(np.float32 if v.dtype.kind == "f" else np.int64)
             for k, v in batch.items()}
    choices, real_route = [], moe.route
    out = {}
    n0 = dict(fa.LAUNCHES)
    for dev in ("cuda", "cpu"):
        if cfg.moe is not None and dtype == "bfloat16":
            monkeypatch.setattr(moe, "route", _routes(real_route, record=choices)
                                if dev == "cuda" else _routes(real_route, replay=choices))
        p, o = (tree_map(lambda t: t.to(dev), t) for t in (params, state))
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        p, _, m = step(p, o, b, gi)
        out[dev] = (m["loss_per_worker"].cpu(), [t.cpu() for t in tree_leaves(p)])
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = {k: fa.LAUNCHES[k] - n0[k] for k in n0}
    tol = {"float32": 1e-4, "bfloat16": 2e-2}[dtype]
    assert bool(torch.isfinite(out["cuda"][0]).all())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=tol, atol=0)
    for a, c in zip(out["cpu"][1], out["cuda"][1]):
        scale = a.float().abs().max().item()
        assert (c.float() - a.float()).abs().max().item() <= tol * max(scale, 1e-6)
    attn = (cfg.n_enc_layers + 2 * cfg.n_layers if cfg.family == "audio"
            else cfg.n_layers // cfg.attn_period if cfg.family == "hybrid" else cfg.n_layers)
    calls = M * min(cfg.microbatches, b_per) * attn
    assert launches == {"flash_attention": 2 * calls, "flash_attention_bwd": calls}


@pytest.mark.cuda
def test_cuda_moe_scatter_backward_repeats_and_matches_cpu(cuda_device):
    """The MoE layer's gradients (the scatter into expert buffers, the gather
    back through the zero pad, the gates and the aux loss) at a capacity
    that drops slots, so the overflow slot sums several tokens: two equal
    calls on the card give equal gradients, and they agree with the CPU's
    within 1e-5 of each gradient's max |.| in f32."""
    from dataclasses import replace

    from repro_torch.models import moe

    cfg = _family_cut("phi3.5-moe-42b-a6.6b", "float32")
    cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=1.0))
    gen = torch.Generator().manual_seed(0)
    p = moe.moe_init(gen, cfg, torch.float32)
    x = torch.randn((2, 64, 256), generator=gen)
    dy = torch.randn((2, 64, 256), generator=gen)

    def grads(dev):
        leaves = {k: v.to(dev).requires_grad_() for k, v in p.items()}
        xd = x.to(dev).requires_grad_()
        _, _, _, pos, C = moe.route(leaves, xd, cfg)
        y, aux = moe.moe_apply(leaves, xd, cfg)
        loss = (y * dy.to(dev)).sum() + aux
        gs = torch.autograd.grad(loss, [xd, *leaves.values()])
        return [g.cpu() for g in gs], int((pos == C).sum())

    first, drops = grads("cuda")
    again, _ = grads("cuda")
    on_cpu, cpu_drops = grads("cpu")
    assert drops > 0 and drops == cpu_drops
    for a, b, c in zip(first, again, on_cpu):
        assert torch.equal(a, b)
        assert (a - c).abs().max().item() <= 1e-5 * c.abs().max().item()


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
    assert rs.LAUNCHES["rwkv_scan"] == n0
    # Differentiable under autograd: through the backward kernel.
    y, _ = rs.rwkv_scan(r.requires_grad_(), k, v, w, u)
    assert y.grad_fn is not None and rs.LAUNCHES["rwkv_scan"] == n0 + 1
    nb = rs.LAUNCHES["rwkv_scan_bwd"]
    (g,) = torch.autograd.grad(y, [r], torch.ones_like(y))
    assert g.shape == r.shape and rs.LAUNCHES["rwkv_scan_bwd"] == nb + 1
    with pytest.raises(ValueError, match="dy must be"):
        rs.rwkv_scan_backward(r.detach(), k, v, w, u, None, y.detach().bfloat16(), None)
    with pytest.raises(ValueError, match="dstate must be"):
        rs.rwkv_scan_backward(r.detach(), k, v, w, u, None, y.detach(),
                              torch.zeros((1, 2, 16, 8), device=cuda_device))


# The WKV backward kernels' cases (B, S, H, N, dtype, decays, initial state,
# final-state gradient): the forward's test cases in the three dtype
# combinations, ragged lengths (S not a multiple of 8 or of 16, or below
# them), the extreme decays (w = 1e-30, log w = -5 and -8, sub-chunks
# straddling the factorised range), sequences cut into several ranges with a
# ragged last one (19 ranges of 16 tokens; 3 of 64, the last of 22), ranges
# of several sub-chunks at every N under the extreme decays (2 x 40 heads:
# four sub-chunks a range, straddling ones beside factorised ones in a
# block; 1 x 40 heads: ranges of 32), and the training shape (one rwkv6-7b
# layer of a 1 x 512 micro-batch).
RWKV_BWD_CASES = [
    (1, 64, 2, 16, "float32", "sigmoid", False, False),
    (2, 128, 4, 32, "float32", "sigmoid", True, True),
    (1, 128, 2, 64, "float32", "sigmoid", False, True),
    (2, 100, 3, 64, "float32", "sigmoid", True, False),
    (1, 128, 2, 32, "bfloat16", "sigmoid", False, False),
    (2, 100, 3, 64, "bfloat16", "sigmoid", True, True),
    (1, 64, 2, 16, "mixed", "sigmoid", True, False),
    (2, 128, 4, 32, "mixed", "sigmoid", False, True),
    (2, 100, 3, 64, "mixed", "sigmoid", True, True),
    (1, 7, 2, 16, "float32", "sigmoid", True, True),
    (1, 1, 2, 64, "mixed", "sigmoid", True, True),
    (2, 37, 2, 32, "mixed", "sigmoid", False, False),
    (1, 32, 1, 16, "float32", "1e-30", True, True),
    (1, 128, 2, 64, "float32", "-5", True, True),
    (1, 128, 2, 64, "float32", "-8", True, True),
    (1, 128, 2, 64, "float32", "mixed", True, True),
    (2, 100, 3, 64, "mixed", "mixed", False, True),
    (1, 300, 6, 64, "mixed", "sigmoid", True, True),
    (2, 150, 40, 64, "float32", "sigmoid", True, True),
    (2, 150, 40, 64, "mixed", "mixed", True, True),
    (2, 150, 40, 32, "mixed", "mixed", False, True),
    (2, 150, 40, 16, "bfloat16", "sigmoid", False, True),
    (2, 150, 40, 16, "float32", "mixed", True, True),
    (1, 150, 40, 64, "float32", "-8", True, True),
    (1, 100, 40, 32, "float32", "1e-30", True, True),
    (1, 512, 64, 64, "mixed", "sigmoid", False, False),
]
#: Each gradient's max |err| against the plain version's max |.|, as the
#: flash-attention backward is held.
RWKV_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2, "mixed": 2e-2}


def _rwkv_bwd_operands(case, device):
    B, S, H, N, dtype, decays, with_state, with_dstate = case
    r, k, v, w, u = _rwkv_inputs(15, B, S, H, N, "float32", device)
    if decays == "1e-30":
        w = torch.full_like(w, 1e-30)
    elif decays != "sigmoid":
        w = strong_decays(w, decays)
    dt, wdt = {"float32": (torch.float32,) * 2, "bfloat16": (torch.bfloat16,) * 2,
               "mixed": (torch.bfloat16, torch.float32)}[dtype]
    gen = torch.Generator(device).manual_seed(16)
    dy = torch.randn(r.shape, generator=gen, device=device).to(dt)
    s0 = (torch.randn((B, H, N, N), generator=gen, device=device) * 0.3
          if with_state else None)
    ds = torch.randn((B, H, N, N), generator=gen, device=device) if with_dstate else None
    return (r.to(dt), k.to(dt), v.to(dt), w.to(wdt), u, s0), dy, ds


@pytest.mark.cuda
@pytest.mark.parametrize("case", RWKV_BWD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_cuda_rwkv_scan_backward_matches_plain(cuda_device, case):
    """The WKV backward kernel against ``ref.reference_rwkv_backward`` and
    against torch autograd through ``ref.reference_rwkv_state``: every
    gradient in its operand's dtype, within 1e-4 (f32) / 2e-2 (bf16) of its
    max |.|, dw included at w = 1e-30; repeated calls bit-equal; the grids
    the C entry reports are the range plan's."""
    (r, k, v, w, u, s0), dy, ds = _rwkv_bwd_operands(case, cuda_device)
    B, S, H = case[:3]
    n0 = rs.LAUNCHES["rwkv_scan_bwd"]
    got = rs.rwkv_scan_backward(r, k, v, w, u, s0, dy, ds, with_dstate0=s0 is not None)
    torch.cuda.synchronize()
    assert rs.LAUNCHES["rwkv_scan_bwd"] == n0 + 1
    L = rs.bwd_range_len(B, S, H, torch.cuda.get_device_properties(
        cuda_device).multi_processor_count)
    n_ranges = -(-S // L)
    assert rs.BWD_LAUNCHED == {
        "range_len": L, "ranges": n_ranges, "blocks": B * H * n_ranges,
        "bound_blocks": B * H * (2 if n_ranges > 1 else 1) if S > rs.BWD_SUB else 0,
        "kernels": rs.BWD_KERNELS[0 if S > rs.BWD_SUB else 1:]}
    assert [t.dtype for t in got[:4]] == [r.dtype] * 3 + [w.dtype]
    assert got[4].dtype == torch.float32 and (got[5] is None) == (s0 is None)
    want = ref.reference_rwkv_backward(r, k, v, w, u, s0, dy, ds)
    leaves = [t.detach().clone().requires_grad_() for t in (r, k, v, w, u)]
    s0l = None if s0 is None else s0.clone().requires_grad_()
    y, final = ref.reference_rwkv_state(*leaves, s0l)
    outs, grads = ([y], [dy]) if ds is None else ([y, final], [dy, ds])
    auto = torch.autograd.grad(outs, leaves + ([] if s0l is None else [s0l]), grads)
    tol = RWKV_BWD_TOL[case[4]]
    for plain in (want, auto):
        for name, g, p in zip(("dr", "dk", "dv", "dw", "du", "dstate0"), got, plain):
            if g is None:
                continue
            scale = p.float().abs().max().item()
            err = (g.float() - p.float()).abs().max().item()
            assert err <= tol * scale, (name, err, scale)
    again = rs.rwkv_scan_backward(r, k, v, w, u, s0, dy, ds, with_dstate0=s0 is not None)
    assert all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)


@pytest.mark.cuda
def test_cuda_rwkv_autograd_through_the_kernels(cuda_device):
    """``ops.rwkv`` under autograd: gradients of y and the final state with
    respect to r, k, v, w, u and the initial state, through the forward and
    backward kernels, match the plain recurrence's autograd."""
    (r, k, v, w, u, s0), dy, ds = _rwkv_bwd_operands(
        (2, 100, 3, 64, "mixed", "sigmoid", True, True), cuda_device)
    ins = [t.clone().requires_grad_() for t in (r, k, v, w, u, s0)]
    plain = [t.clone().requires_grad_() for t in (r, k, v, w, u, s0)]
    y, final = ops.rwkv(*ins[:5], state=ins[5])
    yp, fp = ref.reference_rwkv_state(*plain)
    got = torch.autograd.grad([y, final], ins, [dy, ds])
    want = torch.autograd.grad([yp, fp], plain, [dy, ds])
    for g, p in zip(got, want):
        assert g.dtype == p.dtype
        scale = p.float().abs().max().item()
        assert (g.float() - p.float()).abs().max().item() <= 2e-2 * scale


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
