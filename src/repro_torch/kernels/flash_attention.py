"""GQA flash attention and its gradient: the CUDA kernels' wrappers.

    out = softmax(q k^T / sqrt(hd), causal mask) v        (per query head)

The kernel (``csrc/flash_attention.cu``, CUDA C++ for ``sm_90a``) replaces
the JAX package's Pallas kernel ``repro/kernels/flash_attention.py``.  One
block serves all G = H / Hk query heads of one KV head for tiles of 64
folded (position, group member) rows, so every K/V tile is read once; a
causal block stops at the last key its positions can see.  It has two
bodies, picked by dtype (``BODIES``; the C entry reports the one it ran).
bf16, the serving and training path, is Hopper's own route
(``csrc/hopper_wgmma.cuh``): ``wgmma`` products on tiles that TMA loads
into shared memory under mbarriers, a producer warpgroup keeping a ring of
K/V tiles full for two consumer warpgroups of 64 folded rows each and
handing them its registers (setmaxnreg), on a persistent grid of one
block an SM that walks the row tiles heaviest first.  TMA
loads a folded tile as one box of a 5-D view (hd, G, Hk, S, B) of q: P =
64 // G whole positions of all G heads, so for G = 5 or 7 a tile holds 60
or 63 real rows and padding that no box fills or stores
(``wgmma_plan``).  f32 (whisper's encoder and cross-attention, whose f32
frames JAX promotes) runs every product in 3xTF32 -- each operand split
into a TF32 big part and its remainder, big * big + big * small + small *
big in f32 -- which holds the f32 tolerance that one TF32 product does not:
at hd 32 and 64 on ``wgmma`` (``TF32_WGMMA_HEAD_DIMS``), its K and V tiles
landed by TMA and split once into their parts in shared memory by the
producer warpgroup (V transposed, since ``.tf32`` has no transposed
operand), two consumer warpgroups of 64 folded rows holding Q's split
fragments in registers; at hd 128 and 160 on ``mma.sync``, its K/V tiles
double-buffered by ``cp.async`` (``forward_body``).  Both dtypes keep f32
softmax statistics, masked scores at -1e30 and the row-sum floor of the
reference.  Where the f32 body's row tiles leave the grid below one
wave (whisper's 64 decoder positions against 1500 frames), ``dq_splits``
cuts each block's key walk into ranges whose f32 partials (output, running
max and sum) a merge kernel combines in range order (``FWD_LAUNCHED``).

The Pallas kernel is forward only; here the gradient is a kernel too
(``csrc/flash_attention_bwd.cu``, the FlashAttention-2 split: a row-dot
pass, dK/dV shares of head groups summed per KV head in f32, and a dQ
kernel; three or four launches a call, deterministic, no atomics).  Its
bodies (``BWD_LAUNCHED``) all run on the tensor cores: bf16 on ``wgmma``
fed by TMA at every head dim (dK/dV: two consumer warpgroups (one at hd
128 and 160) on 64 keys taking in turn the streamed query tiles of a
group of heads, ``dkdv_head_groups``, dk and dv written in bf16 where one
group holds all G heads; dQ: one consumer warpgroup of 64 folded rows in
the forward's padded boxes, K/V streamed), f32 in 3xTF32 on ``wgmma`` at
hd 32 and 64 (dK/dV: one consumer warpgroup on 64 keys split once, the
head's query rows streamed in tiles of 32 with their transposed copies;
dQ: two consumer warpgroups of 64 folded rows, 32-key tiles of k, v and
k^T streamed) and on ``mma.sync`` at hd 128 and 160 (8 warps;
``backward_body``).  Where a short query sequence leaves the dQ kernel's grid below one
wave, ``dq_splits`` cuts its key walk into ranges whose f32 partials the
last kernel sums in order.  Under autograd (grad enabled and an operand
that requires grad) ``flash_attention`` goes through ``FlashAttentionFn``:
its forward launches the forward kernel with a log-sum-exp output and
saves q, k, v, the output and the LSE, its backward launches the backward
kernels.  Otherwise (``no_grad``, serving) it launches the forward kernel
alone, without the LSE.

Takes CUDA tensors only and raises on anything else: ``kernels/ops.py``
sends CPU tensors to ``ref.reference_attention``, the plain version the
CPU tests hold against the JAX package; the kernels run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).  The wrappers count
their launches in ``LAUNCHES`` (raised only where a kernel is launched; a
call counts once, whatever kernels it launches), and the forward's in
``BODY_LAUNCHES`` by the body its C entry reports.  The libraries are
built by nvcc on first use (``kernels/build.py``), never at import.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: Launch counts of the forward and the backward; ``reset_launches()`` zeroes them.
LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}

#: The forward body each dtype runs, as the C entry names it
#: (``flash_attention_body_name``): ``flash_fwd_bf16_wgmma_kernel`` (wgmma
#: and TMA) and, at the f32 head dims of ``TF32_WGMMA_HEAD_DIMS``,
#: ``flash_fwd_tf32x3_wgmma_kernel`` (3xTF32 on wgmma, each operand split
#: once in shared memory); f32 at hd 128 and 160 runs ``F32_WIDE_BODY``
#: (``flash_fwd_tf32x3_mma_kernel``, 3xTF32 on mma.sync): ``forward_body``.
BODIES = {torch.bfloat16: "bf16_wgmma", torch.float32: "tf32x3_wgmma"}
F32_WIDE_BODY = "tf32x3_mma"

#: The forward's launches by the body its C entry reports.
BODY_LAUNCHES = {"bf16_wgmma": 0, "tf32x3_wgmma": 0, F32_WIDE_BODY: 0}

#: Head dims whose f32 bodies, forward and backward, run on wgmma; above
#: them shared memory holds no ring of two stages beside Q's (or k and
#: v's) split parts, and the f32 bodies stay on mma.sync.
TF32_WGMMA_HEAD_DIMS = (32, 64)

#: Folded rows of an f32 wgmma forward or dQ block: two consumer warpgroups
#: of 64 (``Tf32FwdTile`` / ``Tf32DqTile``).
TF32_WGMMA_ROWS = 128

#: What the last forward call launched, as its C entry reported it: the body,
#: the key ranges of its grid (above 1, the merge kernel followed), its
#: grid's row tiles and (batch, KV head) pairs, and the blocks it launched
#: (bf16: the persistent blocks walking those row tiles).
FWD_LAUNCHED = {"body": None, "key_splits": None, "grid": None, "blocks": None}

#: Head dims the kernel is instantiated for (the test cases' 32, 64 and 128;
#: tinyllama, qwen1.5 and starcoder2 use 64 or 128, stablelm-12b 160).
HEAD_DIMS = (32, 64, 128, 160)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535

#: What the last backward call launched, as its C entry reported it: the
#: body of its dK/dV and dQ kernels (``flash_attention_bwd_body_name``:
#: ``wgmma`` for bf16 at every head dim, ``tf32x3_wgmma`` / ``tf32x3_wide_mma``
#: for f32 at hd <= 64 / above: ``backward_body``), the key ranges of its dQ grid, the dK/dV
#: grid (its third dimension the head groups) and the dQ grid, and the
#: kernels it launched (``bwd_kernels``: row dot, dK/dV, dQ, and the reduce
#: where there are shares or partials to sum).
BWD_LAUNCHED = {"body": None, "dq_splits": None, "dkdv_grid": None, "dq_grid": None,
                "kernels": None}

#: Rows of an f32 mma.sync dQ (and forward) block, and keys of a forward
#: key tile: the units of ``dq_splits`` (and of ``key_range``'s ranges in
#: every f32 body; the wgmma dQ walks each range in 32-key tiles).
DQ_ROW_TILE = 64
DQ_KEY_TILE = 64

#: The fewest 64-key tiles a key range of a split walk holds.
DQ_MIN_RANGE_TILES = 2

#: The bf16 (wgmma) bodies' tiles that fix their grids: folded rows a
#: consumer warpgroup (one TMA box of P = 64 // G positions x G heads), the
#: forward's consumer warpgroups a block (its grid is persistent: at most
#: one block an SM walking the row tiles), the keys of a dK/dV block and its
#: consumer warpgroups (one dK/dV block an SM).  The C structs ``FwdTile``
#: and ``DkdvTile`` hold them; the C entries report the grids they launched.
WGMMA_ROWS = 64
FWD_CONSUMERS = 2
DKDV_KEYS = 64


def dkdv_rows(hd: int) -> int:
    """Query rows of one streamed tile of the bf16 dK/dV kernel
    (``DkdvTile::kRows``)."""
    return 64 if hd <= 64 else 32


def dkdv_consumers(hd: int) -> int:
    """Consumer warpgroups of a bf16 dK/dV block, taking its streamed tiles
    in turn (``DkdvTile::kConsumers``)."""
    return 2 if hd <= 64 else 1


def dkdv_head_groups(B: int, S: int, Sk: int, H: int, Hk: int, hd: int, causal: bool,
                     sms: int) -> int:
    """Head groups of the bf16 dK/dV grid, the third dimension of its grid:
    the fewest whose heaviest block -- all the streamed query tiles of its
    first key tile for its group's heads, shared by its
    ``dkdv_consumers`` warpgroups -- takes no more tiles than the grid's
    average per warpgroup slot (``sms`` x consumers).  Each group
    writes one f32 share of dk and dv for its heads; one group writes dk
    and dv themselves."""
    G = H // Hk
    rows = dkdv_rows(hd)
    q_tiles = -(-S // rows)
    walks = [max(0, q_tiles - (x * DKDV_KEYS // rows if causal else 0))
             for x in range(-(-Sk // DKDV_KEYS))]
    C = dkdv_consumers(hd)
    mean = G * B * Hk * sum(walks) / (sms * C)
    per = next((d for d in range(G, 1, -1) if -(-d * walks[0] // C) <= mean), 1)
    return -(-G // per)


def wgmma_plan(B: int, S: int, Sk: int, H: int, Hk: int, hd: int, *, causal: bool,
               sms: int) -> dict:
    """The bf16 bodies' boxes and grids, as their C entries compute them on
    a card of ``sms`` SMs.

    ``positions`` P = 64 // G per folded tile, ``rows`` P * G real rows of
    its 64, ``padding`` the rest (no box fills or stores them); the
    forward's row tiles of ``FWD_CONSUMERS`` * P positions for each of the
    B * Hk (batch, KV head) pairs (``fwd_grid``) and the persistent blocks
    that walk them (``fwd_blocks``, at most one an SM); the
    dK/dV grid (key tiles of ``DKDV_KEYS``, B * Hk, ``dkdv_head_groups``)
    with ``dkdv_heads`` heads a group (the last group the rest), and the dQ
    grid's row tiles and blocks (ceil(S / P), B * Hk), before its key
    ranges."""
    G = H // Hk
    P = WGMMA_ROWS // G
    row_tiles = -(-S // (FWD_CONSUMERS * P))
    groups = dkdv_head_groups(B, S, Sk, H, Hk, hd, causal, sms)
    return {"positions": P, "rows": P * G, "padding": WGMMA_ROWS - P * G,
            "fwd_grid": (row_tiles, B * Hk),
            "fwd_blocks": min(row_tiles * B * Hk, sms),
            "dkdv_grid": (-(-Sk // DKDV_KEYS), B * Hk, groups),
            "dkdv_heads": -(-G // groups),
            "dq_grid": (-(-S // P), B * Hk)}


def forward_body(dtype, hd: int) -> str:
    """The forward body the C entry runs for ``dtype`` at head dim ``hd``."""
    if dtype == torch.float32 and hd not in TF32_WGMMA_HEAD_DIMS:
        return F32_WIDE_BODY
    return BODIES[dtype]


def backward_body(dtype, hd: int) -> str:
    """The backward's dK/dV and dQ body (``BWD_LAUNCHED["body"]``): ``wgmma``
    for bf16; for f32 ``tf32x3_wgmma`` at ``TF32_WGMMA_HEAD_DIMS``, the 8-warp
    ``tf32x3_wide_mma`` above."""
    if dtype == torch.bfloat16:
        return "wgmma"
    return "tf32x3_wgmma" if hd in TF32_WGMMA_HEAD_DIMS else "tf32x3_wide_mma"


def tf32_plan(B: int, S: int, Sk: int, H: int, Hk: int, hd: int) -> dict:
    """The f32 bodies' grids before their key ranges, as their C entries
    report them: the forward's and dQ's row tiles of folded rows
    (``TF32_WGMMA_ROWS`` on wgmma, ``DQ_ROW_TILE`` on mma.sync) x B * Hk,
    and dK/dV's 64-key tiles x B * Hk x G (one query head a block)."""
    rows = TF32_WGMMA_ROWS if hd in TF32_WGMMA_HEAD_DIMS else DQ_ROW_TILE
    tiles = -(-S * (H // Hk) // rows)
    return {"fwd_grid": (tiles, B * Hk), "dq_grid": (tiles, B * Hk),
            "dkdv_grid": (-(-Sk // DKDV_KEYS), B * Hk, H // Hk)}


#: A block's shared memory on the card (227 KB), the budget of every plan.
SMEM_BYTES = 232448


def tf32_wgmma_tiles(hd: int) -> dict:
    """The f32 wgmma bodies' tiles at ``hd`` (32 or 64), as the C structs
    ``Tf32FwdTile``, ``Tf32DqTile`` and ``Tf32DkdvTile`` compute them: per
    kernel the consumer warpgroups, the keys (or query rows) of a streamed
    tile, the bytes of one split stage, the stages (as many as the budget
    leaves, up to 4) and the block's shared bytes (1024 of alignment
    slack, what the block holds whole, the stages, the raw ring, per-row
    statistics and mbarriers)."""
    if hd not in TF32_WGMMA_HEAD_DIMS:
        raise ValueError(f"the f32 wgmma bodies serve hd {TF32_WGMMA_HEAD_DIMS}, not {hd}")
    f32, most = 4, 4

    def plan(consumers, keys, fixed, stage, extra):
        stages = min(most, (SMEM_BYTES - 1024 - fixed - extra) // stage)
        return {"consumers": consumers, "keys": keys, "stage_bytes": stage, "stages": stages,
                "bytes": 1024 + fixed + stages * stage + extra}

    rows = 64 * hd * f32  # 64 rows of hd floats
    fwd = plan(2, 64, 2 * rows, 4 * rows, 8 * 3 * most + 64 * 2 * f32)  # + Q's small parts
    dq = plan(2, 32, 2 * 2 * rows, 6 * 32 * hd * f32, 8 * 3 * most)  # + q's and dO's small parts
    part = 32 * hd * f32
    raw = 2 * 2 * part  # two raw stages of q and dO
    dkdv = plan(1, 32, 4 * rows + raw, 8 * part, (most + 2) * 2 * 32 * f32 + 8 * (2 + 4 + 2 * most))
    return {"fwd": fwd, "dq": dq, "dkdv": dkdv}


_LIB = None
_BWD_LIB = None


def dq_splits(B: int, S: int, Sk: int, H: int, Hk: int, sms: int,
              row_tiles: int | None = None) -> int:
    """Key ranges the dQ kernel's walk, and the f32 forward's, is cut into:
    1 where its ``row_tiles * B * Hk`` blocks (by default ``ceil(S * G /
    64)`` row tiles, the f32 bodies'; the bf16 dQ body's are ``wgmma_plan``'s
    ``ceil(S / P)``) already fill the card's ``sms`` SMs (each block then
    walks all its keys and writes its rows itself), else enough to reach
    about one wave, with no range shorter than ``DQ_MIN_RANGE_TILES`` key
    tiles of 64."""
    if row_tiles is None:
        row_tiles = -(-S * (H // Hk) // DQ_ROW_TILE)
    blocks = row_tiles * B * Hk
    if blocks >= sms:
        return 1
    most = -(-Sk // DQ_KEY_TILE) // DQ_MIN_RANGE_TILES
    return max(1, min(-(-sms // blocks), most))


def backward_dq_splits(dtype, B: int, S: int, Sk: int, H: int, Hk: int, hd: int,
                       sms: int) -> int:
    """``dq_splits`` on the row tiles of the body ``dtype`` runs."""
    tiles = -(-S // (WGMMA_ROWS // (H // Hk))) if dtype == torch.bfloat16 else None
    return dq_splits(B, S, Sk, H, Hk, sms, row_tiles=tiles)


def backward_head_groups(dtype, B: int, S: int, Sk: int, H: int, Hk: int, hd: int,
                         causal: bool, sms: int) -> int:
    """The dK/dV grid's head groups: ``dkdv_head_groups`` for bf16, G (one
    head a block) for the f32 bodies."""
    if dtype == torch.bfloat16:
        return dkdv_head_groups(B, S, Sk, H, Hk, hd, causal, sms)
    return H // Hk


def dkdv_writes_grads(dtype, groups: int, hd: int) -> bool:
    """Whether the dK/dV kernel writes dk and dv itself, no f32 share to
    reduce: at one head group, in the bf16 body and the f32 wgmma body
    (``TF32_WGMMA_HEAD_DIMS``; whisper's G = 1)."""
    return groups == 1 and (dtype == torch.bfloat16 or hd in TF32_WGMMA_HEAD_DIMS)


def bwd_kernels(dtype, groups: int, splits: int, hd: int) -> int:
    """Kernels a backward call launches: row dot, dK/dV, dQ, and the reduce
    unless the dK/dV kernel wrote dk and dv itself (``dkdv_writes_grads``)
    and dQ's walk is whole."""
    return 3 if dkdv_writes_grads(dtype, groups, hd) and splits == 1 else 4


def forward_key_splits(dtype, B: int, S: int, Sk: int, H: int, Hk: int, sms: int) -> int:
    """Key ranges of the forward's walk: ``dq_splits`` for the f32 body, 1
    for bf16 (its body walks whole)."""
    return dq_splits(B, S, Sk, H, Hk, sms) if dtype == torch.float32 else 1


def reset_launches() -> None:
    for counts in (LAUNCHES, BODY_LAUNCHES):
        for k in counts:
            counts[k] = 0


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("flash_attention")
        lib.flash_attention_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k, v
            ctypes.c_void_p, ctypes.c_void_p,  # out, lse (or NULL)
            ctypes.c_void_p, ctypes.c_void_p,  # the ranges' partials (scratch, or NULL)
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, S, Sk
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # H, Hk, hd
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # dtype, causal, key ranges
            ctypes.c_void_p,  # launched: int[5], written by the call
            ctypes.c_int, ctypes.c_void_p,  # device, stream
        ]
        lib.flash_attention_launch.restype = ctypes.c_int
        for fn in (lib.flash_attention_error_string, lib.flash_attention_body_name):
            fn.argtypes = [ctypes.c_int]
            fn.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _bwd_lib():
    global _BWD_LIB
    if _BWD_LIB is None:
        lib = build.load("flash_attention_bwd")
        lib.flash_attention_bwd_launch.argtypes = [
            *[ctypes.c_void_p] * 5,  # q, k, v, o, dout
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # lse, D, shares (scratch)
            ctypes.c_void_p,  # dq's partials (scratch, or NULL)
            *[ctypes.c_void_p] * 3,  # dq, dk, dv
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, S, Sk
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # H, Hk, hd
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # dtype, causal, dq_splits
            ctypes.c_int,  # the dK/dV grid's head groups
            ctypes.c_void_p,  # launched: int[8], written by the call
            ctypes.c_int, ctypes.c_void_p,  # device, stream
        ]
        lib.flash_attention_bwd_launch.restype = ctypes.c_int
        for fn in (lib.flash_attention_bwd_error_string, lib.flash_attention_bwd_body_name):
            fn.argtypes = [ctypes.c_int]
            fn.restype = ctypes.c_char_p
        _BWD_LIB = lib
    return _BWD_LIB


def _check_operands(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(
                f"flash_attention: {name} must be a CUDA tensor (got "
                f"{getattr(t, 'device', type(t))}); kernels/ops.py routes CPU "
                "tensors to the plain version"
            )
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"flash_attention: {name} has dtype {t.dtype}; the "
                            "kernel takes float32 or bfloat16")
        if t.ndim != 4:
            raise ValueError(f"flash_attention: {name} must be 4-D, got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must start on a 16-byte boundary "
                             "(TMA's rule for a tensor's base, and the f32 bodies copy "
                             "16-byte chunks)")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: operands lie on different devices")
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} (B, S, H, hd) does not "
                         f"match k {tuple(k.shape)} / v {tuple(v.shape)} (B, Sk, Hk, hd)")
    Sk, Hk = k.shape[1], k.shape[2]
    if min(B, S, H, Sk, Hk) <= 0:
        raise ValueError(f"flash_attention: empty operand, q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if H % Hk:
        raise ValueError(f"flash_attention: {H} query heads are not a multiple of "
                         f"{Hk} KV heads")
    if q.dtype == torch.bfloat16 and H // Hk > WGMMA_ROWS:
        raise ValueError(f"flash_attention: {H // Hk} query heads a KV head; the bf16 body "
                         f"folds at most {WGMMA_ROWS} into a tile")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} is not one of {HEAD_DIMS}")
    if B * Hk > _MAX_GRID_Y:
        raise ValueError(f"flash_attention: B * Hk = {B * Hk} exceeds {_MAX_GRID_Y}")


def _forward(q, k, v, causal: bool, with_lse: bool, key_splits: int | None = None):
    """Launch the forward kernel -> (out, lse (B, H, S) f32 or None).  The
    f32 body's key walk is cut into ``key_splits`` ranges (by default
    ``forward_key_splits`` on this card's SM count), their partials
    allocated here."""
    B, S, H, hd = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    splits = key_splits
    if splits is None:
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        splits = forward_key_splits(q.dtype, B, S, Sk, H, Hk, sms)
    o_part = stat_part = None
    if splits > 1:
        o_part = torch.empty((splits, B * S * H * hd), dtype=torch.float32, device=q.device)
        stat_part = torch.empty((2, splits, B * H * S), dtype=torch.float32, device=q.device)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    launched = (ctypes.c_int * 5)()
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        None if o_part is None else o_part.data_ptr(),
        None if stat_part is None else stat_part.data_ptr(),
        B, S, Sk, H, Hk, hd, _DTYPE_CODE[q.dtype], int(bool(causal)), splits,
        ctypes.addressof(launched), q.device.index, stream,
    )
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention: kernel launch failed: CUDA error {err} "
                           f"({msg})")
    body = lib.flash_attention_body_name(launched[0]).decode()
    LAUNCHES["flash_attention"] += 1
    BODY_LAUNCHES[body] += 1
    FWD_LAUNCHED.update(body=body, key_splits=launched[1], grid=(launched[2], launched[3]),
                        blocks=launched[4])
    return out, lse


def flash_attention_backward(q, k, v, out, dout, lse, *, causal: bool = True):
    """The backward kernels -> (dq, dk, dv) in q's dtype.

    q/out/dout: (B,S,H,hd); k/v: (B,Sk,Hk,hd); lse: the forward's (B,H,S)
    f32 log-sum-exp.  f32 math; dk and dv sum over their KV head's G query
    heads in f32 before the one cast (head after head inside a head group,
    ``backward_head_groups``, the groups' shares in group order), and dq
    over its key ranges (``backward_dq_splits``) in range order, both on
    this card's SM count."""
    _check_operands(q, k, v)
    for name, t in (("out", out), ("dout", dout)):
        if (t.device != q.device or t.dtype != q.dtype or t.shape != q.shape
                or not t.is_contiguous()):
            raise ValueError(f"flash_attention_backward: {name} must be a contiguous "
                             f"{q.dtype} tensor of q's shape {tuple(q.shape)} on "
                             f"{q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention_backward: {name} must start on a 16-byte "
                             "boundary (TMA's rule for a tensor's base)")
    B, S, H, hd = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    if (lse.device != q.device or lse.dtype != torch.float32
            or lse.shape != (B, H, S) or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_backward: lse must be a contiguous float32 "
                         f"({B}, {H}, {S}) tensor on {q.device}")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    D = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits = backward_dq_splits(q.dtype, B, S, Sk, H, Hk, hd, sms)
    groups = backward_head_groups(q.dtype, B, S, Sk, H, Hk, hd, causal, sms)
    shares = (None if dkdv_writes_grads(q.dtype, groups, hd)
              else torch.empty((2, groups, B * Sk * Hk * hd), dtype=torch.float32,
                               device=q.device))
    dq_part = (torch.empty((splits, B * S * H * hd), dtype=torch.float32, device=q.device)
               if splits > 1 else None)
    lib = _bwd_lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    launched = (ctypes.c_int * 8)()
    err = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), D.data_ptr(), None if shares is None else shares.data_ptr(),
        None if dq_part is None else dq_part.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(),
        B, S, Sk, H, Hk, hd, _DTYPE_CODE[q.dtype], int(bool(causal)), splits, groups,
        ctypes.addressof(launched), q.device.index, stream,
    )
    if err != 0:
        msg = lib.flash_attention_bwd_error_string(err).decode()
        raise RuntimeError(f"flash_attention_backward: kernel launch failed: CUDA error "
                           f"{err} ({msg})")
    LAUNCHES["flash_attention_bwd"] += 1
    BWD_LAUNCHED.update(body=lib.flash_attention_bwd_body_name(launched[0]).decode(),
                        dq_splits=launched[1], dkdv_grid=tuple(launched[2:5]),
                        dq_grid=tuple(launched[5:7]), kernels=launched[7])
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its gradient: the forward kernel (with LSE) on
    the way forward, the backward kernels on the way back."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _forward(q, k, v, causal, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, dout.contiguous(), lse,
                                              causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal: bool = True):
    """GQA attention on CUDA. q: (B,S,H,hd); k/v: (B,Sk,Hk,hd) -> (B,S,H,hd).

    f32 or bf16, contiguous, 16-byte aligned, H % Hk == 0 (at most 64 query
    heads a KV head for bf16), hd in ``HEAD_DIMS``; f32 softmax and
    accumulation (bf16 products on ``wgmma`` for bf16, 3xTF32 ones for f32,
    on ``wgmma`` at hd 32 and 64 and ``mma.sync`` above), the output in q's
    dtype.  Causal positions align
    from 0 for any S and Sk.  Under autograd it is differentiable through
    the backward kernels."""
    _check_operands(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, bool(causal))
    return _forward(q, k, v, causal, with_lse=False)[0]
