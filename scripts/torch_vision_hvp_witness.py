"""How far the vision models' f32 HVP lies from a float64 HVP, on the card
and on the CPU, on the same weights, batch and vector.

    python3 scripts/torch_vision_hvp_witness.py [--out FILE] [--batch_size N]
        [--configs NAME ...] [--cpu_only] [--diagnose]

The configurations are ``chip_smoke.py``'s: 14c's one batch of bs128
random images (VGG-16, ResNet-50 in BN eval and in train mode, the CLI's
first probe vector) and 14e's bs4 runs of VGG-16 and ResNet-50 (BN eval).
Both data directories point at an empty temporary directory, so the
loaders fall back to random images as the CLI does; the weights are drawn
on the CPU from the seed, so the card and the CPU start from the same
ones.  For each configuration: the f32 HVP (precision "high") and the
float64 HVP (the model on float64 params) on each device, and their rel-L2
distances; with ``--diagnose`` also where the two devices' float64 HVPs
part (inputs, loss, gradient, the largest parts by leaf).
``--batch_size`` overrides every batch size (a quick run on the CPU);
``--cpu_only`` skips the card.  Prints one JSON line per configuration and
writes the lines to ``--out`` (default ``runs/vision_hvp_witness.json``,
git-ignored).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from hessian_llm_vision_tpu_torch.cli import spectrum as spectrum_cli  # noqa: E402
from hessian_llm_vision_tpu_torch.cli.workloads import build_workload  # noqa: E402
from hessian_llm_vision_tpu_torch.curvature.operators import DatasetHessianOperator  # noqa: E402
from hessian_llm_vision_tpu_torch.krylov.lanczos import start_vector  # noqa: E402

_TINY = ["--num_batches", "1", "--vector_seed", "5"]
CONFIGS = {
    "vgg16_bs128": ["--model", "vgg16"] + chip_smoke.VISION_FD_BASE,
    "resnet50_eval_bs128": ["--model", "resnet50"] + chip_smoke.VISION_FD_BASE,
    "resnet50_train_bs128": ["--model", "resnet50", "--bn_train_mode"] + chip_smoke.VISION_FD_BASE,
    "vgg16_bs4": chip_smoke.VISION_TINY["vgg16"][0] + _TINY,
    "resnet50_eval_bs4": chip_smoke.VISION_TINY["resnet50"][0] + _TINY,
}


def hvps(argv: list[str], dev: torch.device) -> dict:
    """The f32 and float64 HVPs of ``argv``'s workload on ``dev``, on the
    CLI's start vector (drawn on the CPU), back on the CPU."""
    args = spectrum_cli.build_parser().parse_args(argv)
    wl = build_workload(args, dev)
    dim = sum(p.numel() for p in wl.params.values())
    v0 = torch.randn(dim, generator=torch.Generator().manual_seed(args.vector_seed)).to(dev)
    q = start_vector(v0, None, dim)
    t0 = time.perf_counter()
    f32 = DatasetHessianOperator(wl.loss_fn, wl.params, wl.batches, normalization="mean",
                                 precision="high").matvec(q).cpu()
    f64 = DatasetHessianOperator(wl.loss_fn, {n: t.double() for n, t in wl.params.items()},
                                 wl.batches, normalization="mean",
                                 precision=None).matvec(q.double()).cpu()
    return {"f32": f32, "f64": f64, "seconds": time.perf_counter() - t0, "P": dim}


def card_vs_cpu(argv: list[str]) -> dict:
    """Where the card's float64 HVP parts from the CPU's: the inputs (params,
    images, vector), the loss and gradient, and the HVP's largest parts by
    leaf (rel-L2 of the leaf's difference, over the whole HVP's norm)."""
    from hessian_llm_vision_tpu_torch.curvature.hvp import grad_and_loss
    from hessian_llm_vision_tpu_torch.utils.flatten import Flattener

    got = {}
    for d, dev in (("cpu", torch.device("cpu")), ("card", torch.device("cuda"))):
        args = spectrum_cli.build_parser().parse_args(argv + (["--cpu"] if d == "cpu" else []))
        wl = build_workload(args, dev)
        p64 = {n: t.double() for n, t in wl.params.items()}
        dim = sum(t.numel() for t in p64.values())
        v0 = torch.randn(dim, generator=torch.Generator().manual_seed(args.vector_seed)).to(dev)
        q = start_vector(v0, None, dim)
        loss, grad = grad_and_loss(wl.loss_fn, p64, wl.batches[0])
        hv = DatasetHessianOperator(wl.loss_fn, p64, wl.batches, normalization="mean",
                                    precision=None).matvec(q.double())
        fl = Flattener(wl.params)
        got[d] = {"params": {n: t.cpu() for n, t in wl.params.items()},
                  "images": torch.cat([b["image"].cpu() for b in wl.batches]),
                  "q": q.cpu(), "loss": float(loss), "grad": fl.flatten(grad).double().cpu(),
                  "hv": {n: t.double().cpu() for n, t in fl.unflatten(hv).items()},
                  "hv_flat": hv.double().cpu()}
    a, b = got["card"], got["cpu"]
    norm = float(torch.linalg.vector_norm(b["hv_flat"]))
    parts = sorted(((float(torch.linalg.vector_norm(a["hv"][n] - b["hv"][n])) / norm, n)
                    for n in b["hv"]), reverse=True)
    return {"params_max_abs": max(float((a["params"][n] - b["params"][n]).abs().max())
                                  for n in b["params"]),
            "images_max_abs": float((a["images"] - b["images"]).abs().max()),
            "q_rel_l2": chip_smoke.rel_l2(a["q"], b["q"]),
            "loss_rel": abs(a["loss"] / b["loss"] - 1),
            "grad_f64_rel_l2": chip_smoke.rel_l2(a["grad"], b["grad"]),
            "hvp_f64_rel_l2": chip_smoke.rel_l2(a["hv_flat"], b["hv_flat"]),
            "hvp_f64_largest_parts": [[n, r] for r, n in parts[:6]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "runs", "vision_hvp_witness.json"))
    ap.add_argument("--batch_size", type=int, default=None)
    ap.add_argument("--configs", nargs="*", default=list(CONFIGS), choices=list(CONFIGS))
    ap.add_argument("--cpu_only", action="store_true")
    ap.add_argument("--diagnose", action="store_true",
                    help="also where the card's float64 HVP parts from the CPU's")
    args = ap.parse_args(argv)
    if not args.cpu_only and not torch.cuda.is_available():
        print("torch_vision_hvp_witness: no CUDA device (pass --cpu_only)", file=sys.stderr)
        return 2
    devices = {"cpu": torch.device("cpu")}
    if not args.cpu_only:
        devices["card"] = torch.device("cuda")
    lines = []
    with tempfile.TemporaryDirectory() as empty, chip_smoke.vision_data(empty, empty):
        for name in args.configs:
            cli = CONFIGS[name] + (["--batch_size", str(args.batch_size)] if args.batch_size
                                   else [])
            got = {d: hvps(cli + (["--cpu"] if d == "cpu" else []), dev)
                   for d, dev in devices.items()}
            line = {"config": name, "argv": cli, "P": got["cpu"]["P"],
                    "hv_norm": float(torch.linalg.vector_norm(got["cpu"]["f64"])),
                    **{f"{d}_seconds": r["seconds"] for d, r in got.items()},
                    **{f"rel_l2_{d}_f32_vs_{d}_f64": chip_smoke.rel_l2(r["f32"], r["f64"])
                       for d, r in got.items()}}
            if "card" in got:
                for prec in ("f32", "f64"):
                    line[f"rel_l2_card_{prec}_vs_cpu_{prec}"] = chip_smoke.rel_l2(
                        got["card"][prec], got["cpu"][prec])
                line["rel_l2_card_f32_vs_cpu_f64"] = chip_smoke.rel_l2(got["card"]["f32"],
                                                                       got["cpu"]["f64"])
            del got
            if args.diagnose and not args.cpu_only:
                line["card_vs_cpu"] = card_vs_cpu(cli)
            lines.append({"vision_hvp_witness": line})
            print(json.dumps(lines[-1]), flush=True)
    if not args.cpu_only:
        lines.append({"card": chip_smoke.card_line()})
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        for line in lines:
            f.write(json.dumps(line) + "\n")
    if not args.cpu_only:
        print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
