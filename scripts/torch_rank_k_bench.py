"""Time the rank-k kernel pair of the PyTorch port on one CUDA card, pass 2's
two paths included, beside the one-call library yardsticks.

    python3 scripts/torch_rank_k_bench.py [--other DIR] [--shape K,P ...] [--out FILE]

At (10, P), (4, P) and (35, P) with P = 124,046,592 (GPT-2 124M), the MLP
leaf (4, 2,359,296), ``wte`` (4, 38,597,376) and the rows that are not
16-byte aligned -- VGG-16's (10, 33,638,218), ResNet-50's (10, 23,528,522)
and the forget CLI's VGG-16 (10, 14,913,093) -- (or only the ``--shape``s
given), with bf16 and f32 bases, in turns (A B ... B A, CUDA events, 20
calls a timing):

* pass 2: ``rank_k_axpy`` as planned, forced onto its ring (aligned rows
  only) and onto its direct kernel, and ``torch.addmv``; at (10, P) and (35, P) also the ring
  with one and with two 16-byte groups of a stage row per consumer;
* pass 1: ``rank_k_dots`` and ``torch.mv``, and at aligned V and g the
  shifted ring forced onto them (the path unaligned inputs take);
* with ``--other DIR`` (the root of another checkout of the repository,
  e.g. the parent commit unpacked by ``git archive``) also that checkout's
  ``rank_k_axpy`` and ``rank_k_dots``, built from its own sources.

Every pass-2 candidate's output is compared with the planned one's, bit
for bit.  For every candidate the host and device time of one call
(``chip_smoke.call_costs``: ``perf_counter`` over back-to-back calls, the
kernel rows of a ``torch.profiler`` trace), and PyTorch's copy, add and
sum over f32 vectors of P as the card's streaming rates.  Prints one JSON
line per shape and the card line, and writes the lines to ``--out``
(default ``runs/rank_k_bench.json``, git-ignored).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from hessian_llm_vision_tpu_torch.ops import kernels  # noqa: E402
from hessian_llm_vision_tpu_torch.utils.cuda_timing import in_turns  # noqa: E402

P = chip_smoke.P_124M
SHAPES = ((10, P), (4, P), (35, P), (4, 2_359_296), (4, 38_597_376), (10, 33_638_218),
          (10, 23_528_522), (10, 14_913_093))
DTYPES = (torch.bfloat16, torch.float32)


def load_other(root: str):
    """The other checkout's ``ops/kernels.py`` as a module of its own."""
    path = os.path.join(root, "hessian_llm_vision_tpu_torch", "ops", "kernels.py")
    spec = importlib.util.spec_from_file_location("other_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def ring_groups(n: int) -> None:
    """Plan pass 2's ring with ``n`` 16-byte groups of a stage row per consumer."""
    kernels._RING_GROUPS = n
    kernels._plans.clear()


def shifted_ring(g, V, w):
    """``rank_k_dots`` with pass 1's shifted ring forced onto aligned V and
    g (its plan made as for a V off 16 bytes, at the same k and P)."""
    k, p = V.shape
    index, ptrs = V.get_device(), (V.data_ptr(), g.data_ptr())
    aligned = kernels._plan("dots", index, V.dtype, k, p, ptrs)
    key = ("dots", index, V.dtype, k, p, (ptrs[0] & 15, ptrs[1] & 15))
    shifted = kernels.dots_plan(
        k, p, V.dtype, ptrs=(2, 0), sms=kernels._sms(index),
        blocks_per_sm=lambda a, smem: kernels._occupancy("rank_k_dots", index, V.dtype, a, smem))

    def run():
        kernels._plans[key] = shifted
        try:
            return kernels.rank_k_dots(g, V, w)
        finally:
            kernels._plans[key] = aligned
    return run


def summary(t: dict) -> dict:
    return {n: {"ms": r["ms"], "min": r["min"], "max": r["max"]} for n, r in t.items()}


def bench(dtype, k, p, gen, other) -> dict:
    dev = torch.device("cuda")
    V = torch.randn((k, p), generator=gen, device=dev, dtype=dtype).mul_(1.0 / math.sqrt(p))
    g = torch.randn(p, generator=gen, device=dev)
    w = torch.randn(k, generator=gen, device=dev)
    gl, wl = g.to(dtype), w.to(dtype)  # torch.mv / addmv take one dtype
    ptrs = (V.data_ptr(), g.data_ptr())
    axpy = {"rank_k_axpy": lambda: kernels.rank_k_axpy(g, V, w),
            "addmv": lambda: torch.addmv(gl, V.t(), wl),
            "direct": lambda: kernels.rank_k_axpy(g, V, w, ring=False)}
    if p % (16 // V.element_size()) == 0:  # the ring takes only aligned rows
        axpy["ring"] = lambda: kernels.rank_k_axpy(g, V, w, ring=True)
    dots = {"rank_k_dots": lambda: kernels.rank_k_dots(g, V, w), "mv": lambda: torch.mv(V, gl)}
    if kernels.dots_launch_plan(k, p, dtype, dev, ptrs).aligned:
        dots["shifted"] = shifted_ring(g, V, w)
    if other is not None:
        axpy["other_rank_k_axpy"] = lambda: other.rank_k_axpy(g, V, w)
        dots["other_rank_k_dots"] = lambda: other.rank_k_dots(g, V, w)
    out = axpy["rank_k_axpy"]()
    same_bits = {n: bool(torch.equal(axpy[n](), out)) for n in axpy if n != "addmv"}
    es = V.element_size()
    res = {"dtype": str(dtype).removeprefix("torch."), "k": k, "P": p, "same_bits": same_bits,
           "axpy_plan": {f: getattr(kernels.axpy_launch_plan(k, p, dtype, dev, ptrs), f)
                         for f in ("ring", "vec_v", "vec_g", "rows", "chunk", "stages",
                                   "nblocks")},
           "axpy_bound_ms": chip_smoke.bound_ms(k * p * es + 8 * p + 4 * k, 2 * k * p + p)[0],
           "dots_bound_ms": chip_smoke.bound_ms(k * p * es + 4 * p + 8 * k, 2 * k * p)[0],
           "axpy": summary(in_turns(axpy, rounds=3, iters=20, warmup=5)),
           "dots": summary(in_turns(dots, rounds=3, iters=20, warmup=5))}
    costs = chip_smoke.call_costs({**axpy, **dots}, calls=200 if p < P else 50)
    for part in ("axpy", "dots"):
        for name, r in res[part].items():
            r.update(costs[name])
    if p == P and k != 4:
        groups, default = {}, kernels._RING_GROUPS
        for n in (1, 2):
            ring_groups(n)
            plan = kernels.axpy_launch_plan(k, p, dtype, dev, ptrs, ring=True)
            t = in_turns({"ring": lambda: kernels.rank_k_axpy(g, V, w, ring=True),
                          "addmv": axpy["addmv"]}, rounds=2, iters=20, warmup=3)
            groups[f"groups{n}"] = {"rows": plan.rows, "stages": plan.stages,
                                    "ms": t["ring"]["ms"], "addmv_ms": t["addmv"]["ms"]}
        ring_groups(default)
        res["ring_groups"] = groups
    del V, g, w, gl, wl, out
    torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="root of another checkout whose kernels to time alongside")
    ap.add_argument("--shape", action="append", metavar="K,P",
                    help="time only this (k, P) (repeatable; default: every shape above)")
    ap.add_argument("--out", default=os.path.join(ROOT, "runs", "rank_k_bench.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_rank_k_bench: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    kernels.build()
    other = None
    if args.other:
        other = load_other(args.other)
        other.build()
    gen = torch.Generator(device="cuda").manual_seed(2024)
    lines = []
    shapes = [tuple(int(x) for x in sh.split(",")) for sh in args.shape] if args.shape else SHAPES
    for dtype in DTYPES:
        for k, p in shapes:
            lines.append({"rank_k_bench": bench(dtype, k, p, gen, other)})
            print(json.dumps(lines[-1]), flush=True)
    lines.append({"streaming_rate_tb_s": chip_smoke.streaming_rates_torch(),
                  "card": chip_smoke.card_line(), "seconds": time.perf_counter() - t0})
    print(json.dumps(lines[-1]))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        for line in lines:
            f.write(json.dumps(line) + "\n")
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
