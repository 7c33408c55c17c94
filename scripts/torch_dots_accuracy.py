"""How far pass 1 of the rank-k pair (``rank_k_dots``) lies from a float64
w at Pythia-1.4B's (4, 1,414,647,808) bf16 basis, beside cuBLAS's f32 sum
(the plain version), on several random draws.

    python3 scripts/torch_dots_accuracy.py [--other DIR] [--out FILE]

The draws: the two that ``chip_smoke.py`` phase 3 gives this shape (its
generator after the earlier shapes of the phase, and after phase 14's
shapes as well), and two of their own seeds.  For each draw: w from this
checkout's kernel, from ``--other``'s (the root of another checkout, e.g.
the parent commit unpacked by ``git archive``, built from its own sources)
and from the plain version, each against w summed in float64 over column
slices (rel-L2), and against each other.  Then both checkouts' kernels
timed in turns with ``torch.mv`` at the shapes phase 3 times.  Prints one
JSON line per draw and per timed shape and the card line, and writes the
lines to ``--out`` (default ``runs/dots_accuracy.json``, git-ignored).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from hessian_llm_vision_tpu_torch.ops import kernels, spectral  # noqa: E402
from hessian_llm_vision_tpu_torch.utils.cuda_timing import in_turns  # noqa: E402
from torch_rank_k_bench import load_other  # noqa: E402

SEEDS = (1, 2)
TIMED = ((torch.bfloat16, 4, chip_smoke.PYTHIA_P), (torch.bfloat16, 10, chip_smoke.P_124M),
         (torch.float32, 10, chip_smoke.P_124M), (torch.bfloat16, 4, 2_359_296),
         *((dt, k, p) for dt in chip_smoke.TIMED_DTYPES for k, p in chip_smoke.VISION_SHAPES))


def draw(dtype, k, p, gen, g_offset: int = 0):
    """check_rank_k's draws, in its order."""
    V = torch.randn((k, p), generator=gen, device="cuda", dtype=dtype).mul_(1.0 / math.sqrt(p))
    g = torch.randn(p + g_offset, generator=gen, device="cuda")[g_offset:]
    c = torch.randn(k, generator=gen, device="cuda")
    return V, g, c


def w_float64(V, g, c) -> torch.Tensor:
    step = 1 << 26
    return sum(c.double() * (V[:, s:s + step].double() @ g[s:s + step].double())
               for s in range(0, V.shape[1], step))


def readings(name: str, V, g, c, other) -> dict:
    w64 = w_float64(V, g, c)
    ws = {"kernel": kernels.rank_k_dots(g, V, c)}
    if other is not None:
        ws["other_kernel"] = other.rank_k_dots(g, V, c)
    ws["plain"] = spectral.rank_k_dots_reference(g, V, c)
    torch.cuda.synchronize()
    out = {"draw": name, "w_norm": float(torch.linalg.vector_norm(w64)),
           **{f"rel_l2_{n}_vs_f64": chip_smoke.rel_l2(w, w64) for n, w in ws.items()},
           **{f"max_abs_{n}_vs_f64": float((w.double() - w64).abs().max()) for n, w in ws.items()},
           **{f"rel_l2_{n}_vs_plain": chip_smoke.rel_l2(ws[n], ws["plain"])
              for n in ws if n != "plain"}}
    out["kernel_over_plain_distance"] = out["rel_l2_kernel_vs_f64"] / out["rel_l2_plain_vs_f64"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="root of another checkout whose kernel to read alongside")
    ap.add_argument("--out", default=os.path.join(ROOT, "runs", "dots_accuracy.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_dots_accuracy: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    kernels.build()
    other = None
    if args.other:
        other = load_other(args.other)
        other.build()
    lines = []

    def emit(line: dict) -> None:
        lines.append(line)
        print(json.dumps(line), flush=True)

    dt, k, p = chip_smoke.PYTHIA_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.PHASE3_SEED)
    for sdt, sk, sp, off, _ in chip_smoke.phase3_shapes():  # advance as phase 3 does
        draw(sdt, sk, sp, gen, off)
        torch.cuda.empty_cache()
    s0 = gen.get_state()
    for sdt in chip_smoke.TIMED_DTYPES:
        for sk, sp in chip_smoke.VISION_SHAPES:
            draw(sdt, sk, sp, gen)
    torch.cuda.empty_cache()
    draws = [("phase 3, after phase 14's shapes", gen), ("phase 3, before phase 14's shapes", s0)]
    draws += [(f"seed {s}", torch.Generator(device="cuda").manual_seed(s)) for s in SEEDS]
    for name, src in draws:
        if isinstance(src, torch.Tensor):
            gen.set_state(src)
            src = gen
        V, g, c = draw(dt, k, p, src)
        emit({"dots_accuracy": readings(name, V, g, c, other)})
        del V, g, c
        torch.cuda.empty_cache()

    tgen = torch.Generator(device="cuda").manual_seed(2024)
    for sdt, sk, sp in TIMED:
        V, g, c = draw(sdt, sk, sp, tgen)
        gl = g.to(sdt)  # torch.mv takes one dtype
        fns = {"kernel": lambda: kernels.rank_k_dots(g, V, c), "mv": lambda: torch.mv(V, gl)}
        if other is not None:
            fns["other_kernel"] = lambda: other.rank_k_dots(g, V, c)
        big = sp > 4 * chip_smoke.P_124M
        t = in_turns(fns, rounds=2 if big else 3, iters=5 if big else 20, warmup=2 if big else 5)
        emit({"dots_timing": {"dtype": str(sdt).removeprefix("torch."), "k": sk, "P": sp,
                              **{n: {"ms": r["ms"], "min": r["min"], "max": r["max"]}
                                 for n, r in t.items()},
                              "bound_ms": chip_smoke.bound_ms(
                                  sk * sp * V.element_size() + 4 * sp + 8 * sk, 2 * sk * sp)[0]}})
        del V, g, gl, c, fns
        torch.cuda.empty_cache()
    emit({"card": chip_smoke.card_line(), "seconds": time.perf_counter() - t0})
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        for line in lines:
            f.write(json.dumps(line) + "\n")
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
