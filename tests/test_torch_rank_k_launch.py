"""Launch arithmetic of the pass-1 rank-k kernel (``ops/kernels.py::dots_plan``)
on the CPU: the chunks that the blocks of the plan the wrapper hands
``rank_k.cu`` copy cover P exactly once, every bulk copy is 16-byte
aligned, and the grid and ring stay within the resident blocks and the
shared memory of one block; unaligned rows take the scalar kernel.  The
kernel itself is checked on the card by chip_smoke.py."""

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
