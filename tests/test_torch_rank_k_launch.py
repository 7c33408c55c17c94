"""Launch arithmetic of the rank-k kernels (``ops/kernels.py::dots_plan`` and
``axpy_plan``) on the CPU: the chunks (or tiles) that the blocks of the plan
the wrapper hands ``rank_k.cu`` take cover P exactly once, every bulk copy
is 16-byte aligned, and the grid and ring stay within the resident blocks
and the shared memory of one block; each alignment class takes its path,
and each plan is made once per device, dtype, k, P and alignment.  The
kernels themselves are checked on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

from hessian_llm_vision_tpu_torch.ops import kernels
from hessian_llm_vision_tpu_torch.utils import cuda_timing

SMS = 132  # H100 SXM
BLOCK_SMEM = 232_448  # 227 KB
TX_LIMIT = 1 << 20  # bytes one mbarrier phase can count


def _h100_resident(bulk: bool, smem: int) -> int:
    """Resident blocks per SM as the occupancy API would count them: 2048
    threads and 228 KB (1 KB reserved per block) per SM."""
    if not bulk:
        return 2048 // 256
    return min(2048 // 288, 233_472 // (smem + 1024 + 1024))


def _plan(k, p, dtype, resident=_h100_resident, ptrs=(0, 1 << 20)):
    return kernels.dots_plan(k, p, dtype, ptrs=ptrs, sms=SMS, blocks_per_sm=resident)


def _copies(plan, p):
    """Per block, the (start, size) of each chunk its producer thread copies
    (of g and of every row of V), in the kernel's order: b, b + grid, ..."""
    nchunks = -(-p // plan.chunk)
    out = []
    for b in range(plan.nblocks):
        starts = np.arange(b, nchunks, plan.nblocks, dtype=np.int64) * plan.chunk
        out.append((starts, np.minimum(starts + plan.chunk, p) - starts))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 3, 10, 35])
@pytest.mark.parametrize("p", [124_046_592, 16384, 20000, 20001, 7, 1])
def test_dots_plan_covers_p_once_with_aligned_copies(p, k, dtype):
    es = torch.empty((), dtype=dtype).element_size()
    plan = _plan(k, p, dtype)
    assert 1 <= plan.nblocks <= plan.blocks_per_sm * SMS
    assert 1 <= plan.rows <= 16 and -(-k // plan.rows) == -(-k // 16)  # fewest sweeps
    if p * es % 16:  # V's rows are not 16-byte aligned: the scalar kernel
        assert not plan.bulk and plan.vec == 1 and plan.smem_bytes == 0
        return
    assert plan.bulk and plan.vec * es == 16
    copies = _copies(plan, p)
    assert all(len(starts) > 0 for starts, _ in copies)  # no idle block
    starts = np.concatenate([s for s, _ in copies])
    sizes = np.concatenate([n for _, n in copies])
    # the blocks' chunks tile [0, P) exactly once, each within one stage
    order = np.argsort(starts)
    ends = starts[order] + sizes[order]
    assert starts[order][0] == 0 and ends[-1] == p and np.all(ends[:-1] == starts[order][1:])
    assert np.all((sizes > 0) & (sizes <= plan.chunk))
    leftover = p - int(sizes.sum())  # what consumers would read from global memory
    assert leftover == 0 < plan.vec
    # every copy of g (f32) and of each row of V starts and ends 16-byte aligned
    for elem in (4, es):
        assert np.all(starts * elem % 16 == 0) and np.all((starts + sizes) * elem % 16 == 0)
    assert np.all(np.arange(k, dtype=np.int64) * p * es % 16 == 0)  # row starts
    # the ring fits one block's shared memory; a stage fits one barrier phase
    stage = plan.chunk * (4 + plan.rows * es)
    assert plan.smem_bytes == plan.stages * stage and 1 <= plan.stages <= 8
    assert plan.smem_bytes + 1024 <= BLOCK_SMEM and stage < TX_LIMIT


@pytest.mark.parametrize("resident", [1, 2, 7])
@pytest.mark.parametrize("p", [124_046_592, 2_000_001])  # ring, scalar
def test_dots_plan_grid_never_exceeds_resident_blocks(p, resident):
    plan = _plan(10, p, torch.float32, resident=lambda bulk, smem: resident)
    assert plan.blocks_per_sm == resident
    assert plan.nblocks == resident * SMS  # P is large enough to fill one wave


@pytest.mark.parametrize("ptrs", [(8, 0), (0, 4), (2,)])
def test_dots_plan_unaligned_pointer_takes_scalar_kernel(ptrs):
    assert not _plan(10, 16384, torch.bfloat16, ptrs=ptrs).bulk
    assert _plan(10, 16384, torch.bfloat16, ptrs=(0, 16, 4096)).bulk


@pytest.mark.parametrize(
    "k, dtype, chunk",
    [(10, torch.float32, 2048), (35, torch.float32, 2048), (16, torch.float32, 1024),
     (16, torch.bfloat16, 2048)],
    ids=["f32-k10", "f32-k35", "f32-k16", "bf16-k16"],
)
def test_dots_plan_ring_is_two_stages_halved_until_they_fit(k, dtype, chunk):
    """Two stages of 2048 elements; f32 with 16 rows a sweep (2 x 139,264
    bytes) does not fit 227 KB, so its chunk halves once."""
    es = torch.empty((), dtype=dtype).element_size()
    plan = _plan(k, 1 << 20, dtype)
    assert (plan.chunk, plan.stages) == (chunk, 2)
    assert plan.smem_bytes == 2 * chunk * (4 + plan.rows * es)


def test_dots_plan_raises_when_no_block_fits():
    with pytest.raises(RuntimeError, match="fits an SM"):
        _plan(10, 1 << 20, torch.float32, resident=lambda bulk, smem: 0)


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
STATIC_SMEM = 1024  # ring barriers (128 bytes), rounded up as the plan does


def _axpy_resident(ring: bool, smem: int) -> int:
    """Resident pass-2 blocks per SM as the occupancy API would count them."""
    if not ring:
        return min(2048 // 256, 233_472 // (smem + 1024))
    return min(2048 // 288, 233_472 // (smem + 1024 + 1024))


def _aplan(k, p, dtype, resident=_axpy_resident, ptrs=(0, 1 << 20), ring=None):
    return kernels.axpy_plan(k, p, dtype, ptrs=ptrs, sms=SMS, blocks_per_sm=resident, ring=ring)


def _es(dtype):
    return torch.empty((), dtype=dtype).element_size()


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
    are asked only for a new (device, dtype, k, P, alignment, path)."""
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


def test_f32_operand_is_copied_only_when_needed():
    w = torch.arange(6, dtype=torch.float32)
    cpu = torch.device("cpu")
    assert kernels._f32_on(w, cpu) is w
    for other in (w.to(torch.bfloat16), w[::2], w.double()):
        out = kernels._f32_on(other, cpu)
        assert out is not other and out.dtype == torch.float32 and out.is_contiguous()
        torch.testing.assert_close(out, other.float())
