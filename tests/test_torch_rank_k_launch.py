"""Launch arithmetic of the rank-k kernels (``ops/kernels.py::dots_plan`` and
``axpy_plan``) on the CPU: the chunks (or tiles) that the blocks of the plan
the wrapper hands ``rank_k.cu`` take cover P exactly once; pass 1's copies
(the bulk copy of each operand's aligned interior, the ends its producer
warp loads from global memory) cover every row of V and g exactly once at
any alignment, every bulk copy is 16-byte aligned and stays inside its
operand; the grid and ring stay within the resident blocks and the shared
memory of one block; each alignment class takes its path, and each plan is
made once per device, dtype, k, P and address mod 16.  The kernels
themselves are checked on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

from hessian_llm_vision_tpu_torch.ops import kernels
from hessian_llm_vision_tpu_torch.utils import cuda_timing

SMS = 132  # H100 SXM
BLOCK_SMEM = 232_448  # 227 KB
TX_LIMIT = 1 << 20  # bytes one mbarrier phase can count
DOTS_KS = [1, 3, 10, 17, 35]
# V's and g's bases in the alignment sweeps: 256-byte aligned allocations,
# moved by whole elements as views and slices are
V_BASE, G_BASE = 1 << 20, 1 << 24


def _h100_resident(aligned: bool, smem: int) -> int:
    """Resident ring blocks per SM as the occupancy API would count them:
    2048 threads and 228 KB (1 KB reserved per block) per SM."""
    return min(2048 // 288, 233_472 // (smem + kernels._DOTS_STATIC_SMEM + 1024))


def _plan(k, p, dtype, resident=_h100_resident, ptrs=(0, 1 << 20)):
    return kernels.dots_plan(k, p, dtype, ptrs=ptrs, sms=SMS, blocks_per_sm=resident)


def _es(dtype):
    return torch.empty((), dtype=dtype).element_size()


def _copies(plan, p):
    """Per block, the (start, size) of each chunk its producer takes (of g
    and of every row of V), in the kernel's order: b, b + grid, ..."""
    nchunks = -(-p // plan.chunk)
    out = []
    for b in range(plan.nblocks):
        starts = np.arange(b, nchunks, plan.nblocks, dtype=np.int64) * plan.chunk
        out.append((starts, np.minimum(starts + plan.chunk, p) - starts))
    return out


def _pieces(base, es, pos, n):
    """rank_k.cu::piece of one operand (``es``-byte elements from byte
    address ``base``) at chunks [pos, pos + n): its address mod 16, the
    elements before its first 16-byte boundary, and the whole 16-byte
    vectors after them (bytes), over all chunks at once."""
    a = base + pos * es
    shift = a % 16
    head = np.minimum((16 - shift) % 16 // es, n)
    nbytes = (n - head) * es // 16 * 16
    return shift, head, nbytes


def _check_ring(plan, k, p, dtype, v_base, g_base):
    """Model pass 1's producer (rank_k.cu::rank_k_dots_kernel) on every
    chunk of every sweep: returns the number of elements of g and V that the
    producer warp loads from global memory."""
    es = _es(dtype)
    vec = 16 // es
    assert plan.aligned == (p % vec == 0 and v_base % 16 == 0 and g_base % 16 == 0)
    assert plan.vec == vec and plan.chunk * es % 128 == 0  # whole 128-byte lines of each row and g
    pad = 0 if plan.aligned else kernels._SHIFT_PAD
    g_slot, v_slot = 4 * plan.chunk + pad, plan.chunk * es + pad
    stage = g_slot + plan.rows * v_slot
    assert stage == kernels.dots_stage_bytes(plan.chunk, plan.rows, es, plan.aligned)
    # the ring fits one block's shared memory; a stage fits one barrier phase
    assert plan.smem_bytes == plan.stages * stage and 1 <= plan.stages <= 8
    assert plan.smem_bytes + kernels._DOTS_STATIC_SMEM <= BLOCK_SMEM and stage < TX_LIMIT
    assert stage % 128 == 0 and g_slot % 128 == 0 and v_slot % 128 == 0  # slots start 128-aligned
    pos = np.arange(-(-p // plan.chunk), dtype=np.int64) * plan.chunk
    n = np.minimum(plan.chunk, p - pos)
    ends = 0
    for r0 in range(0, k, plan.rows):
        nr = min(plan.rows, k - r0)
        tx = np.zeros_like(pos)
        # (operand's base, element bytes, its slot's offset in the stage)
        operands = [(g_base, 4, 0)] + [(v_base + (r0 + r) * p * es, es, g_slot + r * v_slot)
                                       for r in range(nr)]
        for base, e, slot in operands:
            shift, head, nbytes = _pieces(base, e, pos, n)
            assert np.all(shift == base % 16)  # one shift in every chunk
            tail = n - head - nbytes // e
            assert np.all((head >= 0) & (head < 16 // e) & (tail >= 0) & (tail < 16 // e))
            if plan.aligned:
                assert not head.any() and not tail.any() and not shift.any()
            ends += int(head.sum() + tail.sum())
            # the chunk's ends and interior tile the operand's [0, P) exactly once
            first = pos + head  # first element of the interior
            spans = np.concatenate([np.stack([pos, first], 1), np.stack([first, first + nbytes // e], 1),
                                    np.stack([first + nbytes // e, pos + n], 1)])
            spans = spans[spans[:, 1] > spans[:, 0]]
            spans = spans[np.argsort(spans[:, 0])]
            assert spans[0, 0] == 0 and spans[-1, 1] == p
            assert np.all(spans[:-1, 1] == spans[1:, 0])
            # every bulk copy: source, destination and size 16-byte aligned,
            # the destination where the consumers read element e
            # (rank_k.cu::slot_offset + e * es of the slot; on the shifted
            # ring lying against 128-byte lines as its source does), the
            # source inside the operand's bytes
            live = nbytes > 0
            src = base + first * e
            at = (base + pos * e) % 128 if not plan.aligned else np.zeros_like(pos)  # slot_offset
            assert np.all(at == at[0])  # the same place in every chunk
            dst = slot + at + head * e
            assert np.all(src[live] % 16 == 0) and np.all(dst[live] % 16 == 0)
            assert plan.aligned or np.all((dst[live] - src[live]) % 128 == 0)
            assert np.all(nbytes % 16 == 0)
            assert np.all(src >= base) and np.all(src + nbytes <= base + p * e)
            # the slot holds the chunk from its offset; a shifted slot reads
            # 4- or 8-byte words where its shift allows, 16 where it is 0
            assert np.all(at + n * e <= (g_slot if slot == 0 else v_slot))
            assert np.all((slot + at) % 16 == shift)
            tx += nbytes
        assert np.all(tx < TX_LIMIT)
    return ends


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 3, 10, 35])
@pytest.mark.parametrize("p", [124_046_592, 33_638_218, 14_913_093, 16384, 20000, 20001, 7, 1])
def test_dots_plan_covers_p_once_with_aligned_copies(p, k, dtype):
    """Every P takes the ring: its blocks' chunks tile [0, P) exactly once,
    and each row's copies cover it once (V and g at aligned bases; rows of a
    P that is not whole vectors lie off 16 bytes)."""
    es = _es(dtype)
    plan = _plan(k, p, dtype)
    assert 1 <= plan.nblocks <= plan.blocks_per_sm * SMS
    assert 1 <= plan.rows <= 16 and -(-k // plan.rows) == -(-k // 16)  # fewest sweeps
    assert plan.vec * es == 16 and plan.aligned == (p * es % 16 == 0)
    copies = _copies(plan, p)
    assert all(len(starts) > 0 for starts, _ in copies)  # no idle block
    starts = np.concatenate([s for s, _ in copies])
    sizes = np.concatenate([n for _, n in copies])
    # the blocks' chunks tile [0, P) exactly once, each within one stage
    order = np.argsort(starts)
    ends = starts[order] + sizes[order]
    assert starts[order][0] == 0 and ends[-1] == p and np.all(ends[:-1] == starts[order][1:])
    assert np.all((sizes > 0) & (sizes <= plan.chunk))
    assert np.all(starts * es % 16 == 0) and np.all(starts * 4 % 16 == 0)  # whole vectors
    # every chunk of each row (of the first 10 at a large P: their shifts
    # repeat within 8 rows)
    loaded = _check_ring(plan, min(k, 10) if p > 1 << 22 else k, p, dtype, 0, 1 << 20)
    assert (loaded == 0) == plan.aligned


@pytest.mark.parametrize("resident", [1, 2, 7])
@pytest.mark.parametrize("p", [124_046_592, 2_000_001])  # aligned, shifted ring
def test_dots_plan_grid_never_exceeds_resident_blocks(p, resident):
    plan = _plan(10, p, torch.float32, resident=lambda aligned, smem: resident)
    assert plan.blocks_per_sm == resident and plan.aligned == (p % 4 == 0)
    assert plan.nblocks == resident * SMS  # P is large enough to fill one wave


@pytest.mark.parametrize("ptrs", [(8, 0), (0, 4), (2,)])
def test_dots_plan_unaligned_pointer_takes_shifted_ring(ptrs):
    """A V or g off 16 bytes takes the shifted ring (slack in every slot),
    with the aligned ring's chunk, stages and grid."""
    plan = _plan(10, 16384, torch.bfloat16, ptrs=ptrs)
    aligned = _plan(10, 16384, torch.bfloat16, ptrs=(0, 16, 4096))
    assert aligned.aligned and not plan.aligned
    assert (plan.chunk, plan.stages, plan.nblocks) == (aligned.chunk, aligned.stages, aligned.nblocks)
    assert plan.smem_bytes == aligned.smem_bytes + 2 * kernels._SHIFT_PAD * (plan.rows + 1)


def _alignment_classes():
    """(dtype, P mod vec) for both dtypes: every class of P a 16-byte vector
    of V leaves over."""
    return [pytest.param(dtype, cls, id=f"{name}-P{cls}")
            for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16"))
            for cls in range(16 // _es(dtype))]


@pytest.mark.parametrize("k", DOTS_KS)
@pytest.mark.parametrize("dtype, p_class", _alignment_classes())
def test_dots_ring_covers_rows_once_at_any_alignment(dtype, p_class, k):
    """V's base off 16 bytes by every element offset, g's by 0-3 elements,
    P = p_class (mod vec) a few chunks long, and P = 1 + p_class: the
    producer's bulk copies and loaded ends cover each row of V and g once,
    aligned, inside the operands, in slots that fit the plan's stages."""
    es = _es(dtype)
    vec = 16 // es
    for p in (3 * 2048 + 5 * vec + p_class, 1 + p_class):
        for v_off in range(vec):
            for g_off in range(4):
                v_base, g_base = V_BASE + v_off * es, G_BASE + 4 * g_off
                plan = _plan(k, p, dtype, ptrs=(v_base, g_base))
                assert plan.nblocks == -(-p // plan.chunk)  # a small P: one chunk a block
                loaded = _check_ring(plan, k, p, dtype, v_base, g_base)
                assert (loaded == 0) == plan.aligned


@pytest.mark.parametrize(
    "k, dtype, chunk",
    [(10, torch.float32, 2048), (35, torch.float32, 2048), (16, torch.float32, 1024),
     (16, torch.bfloat16, 2048)],
    ids=["f32-k10", "f32-k35", "f32-k16", "bf16-k16"],
)
def test_dots_plan_ring_is_two_stages_halved_until_they_fit(k, dtype, chunk):
    """Two stages of 2048 elements; f32 with 16 rows a sweep (2 x 139,264
    bytes) does not fit 227 KB, so its chunk halves once, on the shifted
    ring too (2 x 141,440 bytes)."""
    es = _es(dtype)
    for p, pad in ((1 << 20, 0), ((1 << 20) + 1, kernels._SHIFT_PAD)):
        plan = _plan(k, p, dtype)
        assert (plan.chunk, plan.stages, plan.aligned) == (chunk, 2, pad == 0)
        assert plan.smem_bytes == 2 * (chunk * (4 + plan.rows * es) + pad * (plan.rows + 1))


def test_dots_plan_raises_when_no_block_fits():
    for p in (1 << 20, (1 << 20) + 1):  # the aligned and the shifted ring
        with pytest.raises(RuntimeError, match="fits an SM"):
            _plan(10, p, torch.float32, resident=lambda aligned, smem: 0)


def test_ptxas_usage_reads_registers_and_spills_by_kernel():
    log = (
        "ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z3fooPf\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 1 barriers, 640 bytes smem\n"
        "ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'\n"
        "ptxas info    : Used 12 registers, 380 bytes cmem[0]\n"
    )
    usage = list(kernels.ptxas_usage(log).values())
    assert usage == [{"registers": 40, "spill_bytes": 12}, {"registers": 12, "spill_bytes": 0}]


def test_smi_summary_takes_min_and_max_and_skips_bad_lines():
    lines = ["1980, 650.12, 700.00, 61", "1755, 698.40, 700.00, 64", "[N/A], 1, 2, 3", "junk"]
    out = cuda_timing._smi_summary(lines)
    assert out["samples"] == 2
    assert out["clocks_sm_mhz"] == [1755.0, 1980.0]
    assert out["power_draw_w"] == [650.12, 698.4]
    assert out["power_limit_w"] == [700.0, 700.0]
    assert out["temperature_gpu_c"] == [61.0, 64.0]


# ---- pass 2: axpy_plan ------------------------------------------------------

P_124M = 124_046_592
VGG16_P = 33_638_218  # VGG-16 at 10 classes: 2 mod 8
STATIC_SMEM = 1024  # ring barriers (128 bytes), rounded up as the plan does


def _axpy_resident(ring: bool, smem: int) -> int:
    """Resident pass-2 blocks per SM as the occupancy API would count them."""
    if not ring:
        return min(2048 // 256, 233_472 // (smem + 1024))
    return min(2048 // 288, 233_472 // (smem + 1024 + 1024))


def _aplan(k, p, dtype, resident=_axpy_resident, ptrs=(0, 1 << 20), ring=None):
    return kernels.axpy_plan(k, p, dtype, ptrs=ptrs, sms=SMS, blocks_per_sm=resident, ring=ring)


def _ring_chunks(plan, p):
    """Per block, the (start, size) of each chunk, in the kernel's order."""
    nchunks = -(-p // plan.chunk)
    out = []
    for b in range(plan.nblocks):
        starts = np.arange(b, nchunks, plan.nblocks, dtype=np.int64) * plan.chunk
        out.append((starts, np.minimum(starts + plan.chunk, p) - starts))
    return out


def _direct_elements(plan, p):
    """Every element the direct kernel writes, in the kernel's tiles: block b
    takes tiles b, b + grid, ... of UNROLL x 256 groups of ``vec``; the grid's
    last block takes the last P mod vec elements one by one."""
    ngroups = p // plan.vec
    tile = kernels._AXPY_UNROLL * kernels._THREADS
    ntiles = -(-ngroups // tile)
    written = []
    for b in range(plan.nblocks):
        for t in range(b, ntiles, plan.nblocks):
            groups = np.arange(t * tile, min((t + 1) * tile, ngroups), dtype=np.int64)
            written.append((groups[:, None] * plan.vec + np.arange(plan.vec)).ravel())
    written.append(np.arange(ngroups * plan.vec, p, dtype=np.int64))  # the tail
    return np.concatenate(written), ntiles


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 4, 10, 35])
@pytest.mark.parametrize("p", [P_124M, 38_597_376, 2_359_296, 20000, 20001, 7, 1])
def test_axpy_plan_covers_p_once(p, k, dtype):
    es = _es(dtype)
    plan = _aplan(k, p, dtype)
    assert plan.vec * es == 16 and 1 <= plan.nblocks <= plan.blocks_per_sm * SMS
    if not plan.ring:
        assert plan.rows == k and plan.smem_bytes == 4 * k
        elems, ntiles = _direct_elements(plan, p)
        assert plan.nblocks <= max(1, ntiles)  # no idle block
        assert np.array_equal(np.sort(elems), np.arange(p))
        return
    assert p % plan.vec == 0 and p >= kernels._RING_MIN_P
    copies = _ring_chunks(plan, p)
    assert all(len(starts) > 0 for starts, _ in copies)  # no idle block
    starts = np.concatenate([s for s, _ in copies])
    sizes = np.concatenate([n for _, n in copies])
    order = np.argsort(starts)
    ends = starts[order] + sizes[order]
    assert starts[order][0] == 0 and ends[-1] == p and np.all(ends[:-1] == starts[order][1:])
    assert np.all((sizes > 0) & (sizes <= plan.chunk) & (sizes % plan.vec == 0))
    # every bulk copy of g (f32) and of each row of V starts and ends 16-byte aligned
    for elem in (4, es):
        assert np.all(starts * elem % 16 == 0) and np.all((starts + sizes) * elem % 16 == 0)
    assert np.all(np.arange(k, dtype=np.int64) * p * es % 16 == 0)
    # the sweeps of a chunk take every row once
    sweeps = [(r0, min(plan.rows, k - r0)) for r0 in range(0, k, plan.rows)]
    assert sum(n for _, n in sweeps) == k


@pytest.mark.parametrize("resident", [1, 2, 7])
@pytest.mark.parametrize("ring", [True, False], ids=["ring", "direct"])
def test_axpy_plan_grid_never_exceeds_resident_blocks(ring, resident):
    plan = _aplan(10, P_124M, torch.float32, resident=lambda r, smem: resident, ring=ring)
    assert plan.ring == ring and plan.blocks_per_sm == resident
    assert plan.nblocks == resident * SMS  # P is large enough to fill one wave


@pytest.mark.parametrize(
    "k, p, dtype, nblocks",
    [(4, 2_359_296, torch.bfloat16, 576), (4, 2_359_296, torch.float32, 1056),
     (10, 768, torch.float32, 1), (4, 20000, torch.bfloat16, 5)],
    ids=["leaf-bf16", "leaf-f32", "tiny", "small"],
)
def test_axpy_plan_small_p_grid_is_sized_to_p(k, p, dtype, nblocks):
    """Below the ring's P a block takes one tile (512 groups), so the grid
    is P's tiles, up to one wave of resident blocks (8 x 132)."""
    plan = _aplan(k, p, dtype)
    assert not plan.ring and plan.nblocks == nblocks
    assert plan.nblocks == min(8 * SMS, -(-(p // plan.vec) // (2 * 256)))


@pytest.mark.parametrize("offset", range(8))
@pytest.mark.parametrize("p", [P_124M, 2_359_296])
def test_axpy_plan_g_alignment_is_per_operand(p, offset):
    """Aligned V with g at an offset of 0-7 elements of a flat vector: V stays
    in 16-byte vectors (and on the ring at a large P); only g's loads drop
    to one element at a time where g is not 16-byte aligned."""
    plan = _aplan(4, p, torch.bfloat16, ptrs=(0, (1 << 20) + 4 * offset))
    assert plan.vec_v and plan.vec_g == (offset % 4 == 0)
    assert plan.ring == (p == P_124M)


@pytest.mark.parametrize(
    "k, p, v_ptr, vec_v",
    [(4, 2_359_296, 8, False), (4, 20001, 0, False), (1, 20001, 0, True), (1, 20001, 2, False),
     (4, 20000, 16, True)],
    ids=["V-unaligned", "rows-unaligned", "one-row", "one-row-unaligned", "aligned"],
)
def test_axpy_plan_v_alignment_picks_its_loads(k, p, v_ptr, vec_v):
    plan = _aplan(k, p, torch.bfloat16, ptrs=(v_ptr, 0))
    assert plan.vec_v == vec_v and not plan.ring and plan.vec_g
    if not vec_v:
        with pytest.raises(ValueError, match="no ring"):
            _aplan(k, p, torch.bfloat16, ptrs=(v_ptr, 0), ring=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 4, 10, 16, 35, 300, 4096, 12288])
@pytest.mark.parametrize("g_aligned", [True, False])
def test_axpy_ring_fits_one_block(k, dtype, g_aligned):
    """w, then the stages: within 227 KB with the static barriers, at least
    two stages, no stage past one barrier phase's byte count."""
    es = _es(dtype)
    plan = _aplan(k, 1 << 24, dtype, ptrs=(0, 0 if g_aligned else 4), ring=True)
    stage = (4 * plan.chunk if g_aligned else 0) + plan.rows * plan.chunk * es
    w_bytes = -(-4 * k // 128) * 128
    assert plan.ring and plan.vec_g == g_aligned and plan.chunk == 2 * 256 * plan.vec
    assert plan.smem_bytes == w_bytes + plan.stages * stage
    assert plan.smem_bytes + STATIC_SMEM <= BLOCK_SMEM
    assert 2 <= plan.stages <= kernels._RING_STAGES and stage < TX_LIMIT
    assert 1 <= plan.rows <= k


@pytest.mark.parametrize(
    "k, p, dtype",
    [(4096, 1 << 24, torch.float32), (12288, 1 << 24, torch.bfloat16), (35, P_124M, torch.float32)],
    ids=["4096-f32", "12288-bf16", "35-f32"],
)
def test_axpy_plan_many_rows_take_row_sweeps(k, p, dtype):
    """Where a stage cannot hold all k rows of a chunk, the ring sweeps the
    chunk in balanced groups of rows (the sums of out stay in registers)."""
    plan = _aplan(k, p, dtype)
    sweeps = -(-k // plan.rows)
    assert plan.ring and 1 <= plan.rows < k and sweeps > 1
    assert -(-k // sweeps) == plan.rows  # balanced


def test_axpy_plan_direct_takes_every_k():
    """ef_apply's most rows (12288) keep w in the direct kernel's 48 KB."""
    plan = _aplan(kernels._MAX_K, 4096, torch.float32)
    assert not plan.ring and plan.smem_bytes == 4 * kernels._MAX_K == 48 * 1024
    with pytest.raises(ValueError, match="does not fit"):
        _aplan(kernels._MAX_K + 1, 4096, torch.float32)


@pytest.mark.parametrize("ring", [True, False], ids=["ring", "direct"])
def test_axpy_plan_raises_when_no_block_fits(ring):
    with pytest.raises(RuntimeError, match="fits an SM"):
        _aplan(10, P_124M, torch.float32, resident=lambda r, smem: 0, ring=ring)


def test_plans_are_cached_per_device_dtype_k_p_and_alignment(monkeypatch):
    """The launch path makes each plan once: the SM count and the occupancy
    are asked only for a new (device, dtype, k, P, address mod 16 of V and
    g, path)."""
    asked = []
    monkeypatch.setattr(kernels, "_plans", {})
    monkeypatch.setattr(kernels, "_sms", lambda index: asked.append(("sms", index)) or SMS)
    monkeypatch.setattr(kernels, "_occupancy",
                        lambda kernel, index, dtype, flag, smem: asked.append(kernel) or 1)
    f32, bf16 = torch.float32, torch.bfloat16
    first = kernels._plan("axpy", 0, f32, 4, P_124M, (0, 16))
    n = len(asked)
    assert kernels._plan("axpy", 0, f32, 4, P_124M, (4096, 512)) is first  # same alignment
    assert len(asked) == n
    others = [("axpy", 1, f32, 4, P_124M, (0, 16)), ("axpy", 0, bf16, 4, P_124M, (0, 16)),
              ("axpy", 0, f32, 5, P_124M, (0, 16)), ("axpy", 0, f32, 4, P_124M - 8, (0, 16)),
              ("axpy", 0, f32, 4, P_124M, (0, 4)), ("axpy", 0, f32, 4, P_124M, (8, 16)),
              ("dots", 0, f32, 4, P_124M, (0, 16))]
    plans = [kernels._plan(*key) for key in others]
    assert all(p is not first for p in plans) and len(kernels._plans) == 1 + len(others)
    assert kernels._plan("axpy", 0, f32, 4, P_124M, (0, 16), ring=False) is not first
    assert kernels._plan("axpy", 0, f32, 4, P_124M, (0, 4)).vec_g is False
    assert isinstance(kernels._plan("dots", 0, f32, 4, P_124M, (0, 16)), kernels.DotsPlan)
    assert len(kernels._plans) == 2 + len(others)
    # pass 1: one plan per address mod 16 of V and of g, and per P (P mod vec
    # decides the shifts of the rows); the same residues share a plan
    dots = kernels._plan("dots", 0, bf16, 10, VGG16_P, (2, 4))
    assert not dots.aligned
    # the key rank_k_dots looks up before it calls _plan
    assert kernels._plans[("dots", 0, bf16, 10, VGG16_P, (2, 4))] is dots
    assert kernels._plan("dots", 0, bf16, 10, VGG16_P, (4096 + 2, 1 << 20 | 4)) is dots
    shifted = [kernels._plan("dots", 0, bf16, 10, VGG16_P, ptrs)
               for ptrs in ((4, 4), (2, 8), (0, 0), (2, 0))]
    assert len({id(p) for p in shifted + [dots]}) == 5
    assert [p.aligned for p in shifted] == [False] * 4  # P = 2 mod 8: rows off 16 bytes
    assert kernels._plan("dots", 0, bf16, 10, VGG16_P - 2, (0, 0)).aligned
    assert len(kernels._plans) == 2 + len(others) + 6


def test_dots_scratch_is_per_device_and_stream_and_grows(monkeypatch):
    """Pass 1's scratch (the finished-block count, then the partials) is
    zeroed once per (device, stream) and reused; a call that needs more
    floats gets a new zeroed buffer of at least twice the old."""
    made, real_zeros = [], torch.zeros

    def zeros(n, dtype, device):
        made.append((n, device.index))
        return real_zeros(n, dtype=dtype)

    monkeypatch.setattr(kernels, "_scratch", {})
    monkeypatch.setattr(kernels.torch, "zeros", zeros)
    first = kernels._dots_scratch(0, 7, 40)
    assert kernels._dots_scratch(0, 7, 40) == first and kernels._dots_scratch(0, 7, 10) == first
    assert made == [(44, 0)]
    kernels._dots_scratch(0, 8, 40)  # another stream
    kernels._dots_scratch(1, 7, 40)  # another device
    assert made[1:] == [(44, 0), (44, 1)]
    assert kernels._dots_scratch(0, 7, 50) != first and made[-1] == (4 + 80, 0)
    assert kernels._dots_scratch(0, 7, 80) == kernels._dots_scratch(0, 7, 50)
    assert len(made) == 4 and kernels._scratch[(0, 7)][1] == 80


def test_dots_launch_ints_are_the_plan_in_the_c_order(monkeypatch):
    """rank_k_dots_* take the plan as one int array (k, nblocks, aligned,
    chunk, stages, rows, smem_bytes), made once per plan."""
    monkeypatch.setattr(kernels, "_dots_args", {})
    for ptrs, aligned in (((0, 16), 1), ((2, 16), 0)):
        plan = _plan(10, 16384, torch.bfloat16, ptrs=ptrs)
        ints = kernels._dots_launch_ints(plan, 10)
        assert list(ints) == [10, plan.nblocks, aligned, plan.chunk, plan.stages, plan.rows,
                              plan.smem_bytes]
        assert kernels._dots_launch_ints(plan, 10) is ints


def test_f32_operand_is_copied_only_when_needed():
    w = torch.arange(6, dtype=torch.float32)
    cpu = torch.device("cpu")
    assert kernels._f32_on(w, cpu) is w
    for other in (w.to(torch.bfloat16), w[::2], w.double()):
        out = kernels._f32_on(other, cpu)
        assert out is not other and out.dtype == torch.float32 and out.is_contiguous()
        torch.testing.assert_close(out, other.float())
