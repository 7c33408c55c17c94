"""--layerwise spectrum paths (port of ``cli/spectrum_layerwise.py``):
per-leaf or per-block sweeps, on the host loop over one masked HVP or in
core with one operator and a CGS2 Lanczos per block, the shared outputs
and the per-block stem-plot grid (drawn without matplotlib where it is
not installed)."""

from __future__ import annotations

import re
import struct
import zlib

import numpy as np
import torch

from hessian_llm_vision_tpu_torch.curvature.operators import LayerHessianOperator
from hessian_llm_vision_tpu_torch.io import spectra
from hessian_llm_vision_tpu_torch.krylov.driver import layerwise_spectrum_host
from hessian_llm_vision_tpu_torch.krylov.lanczos import lanczos
from hessian_llm_vision_tpu_torch.krylov.slq import ritz_decomposition
from hessian_llm_vision_tpu_torch.utils import trees


def layerwise_main(args, wl, device: torch.device) -> dict:
    """Per-leaf (or per-block, ``--layerwise_group block``) spectra on the
    first batch, ``{label: Spectrum}``.  Start vectors come from one CPU
    generator seeded with ``--vector_seed``: on the host loop each block
    draws its own entries, in label order; in core each block draws a
    full P-vector, as the operator's dimension is P."""
    group_regex = args.group_regex
    if group_regex is None and args.layerwise_group == "block":
        group_regex = trees.BLOCK_GROUP_REGEX
    gen = torch.Generator().manual_seed(args.vector_seed)
    if args.host_loop:
        # one masked HVP serves every block
        results_t = layerwise_spectrum_host(
            wl.loss_fn, wl.params, wl.batches[0], args.lanczos_iters, generator=gen,
            normalization="mean", batch_size=wl.batch_size, precision=args.hvp_precision,
            progress=True, group_regex=group_regex,
        )
        results = {label: ritz_decomposition(res) for label, res in results_t.items()}
        if not results:
            raise SystemExit("--layerwise grouping matched no parameter leaves "
                             f"(group_regex={group_regex!r})")
        layerwise_outputs(args, results)
        return results

    labels, spans = trees.partition_labels(wl.params)
    if group_regex is not None:
        labels, spans = trees.group_spans(labels, spans, group_regex)
        if not labels:
            raise SystemExit(f"--layerwise grouping regex {group_regex!r} matches no "
                             "parameter leaves")
        pat = re.compile(group_regex)

        def make_pred(target):
            def pred(name):
                m = pat.search(name)
                return bool(m) and (m.group(1) if m.groups() else m.group(0)) == target
            return pred
    else:
        def make_pred(target):
            return lambda name: name == target
    results = {}
    for label, (_, size) in zip(labels, spans):
        if size < 2:
            continue
        mask = trees.subtree_mask(wl.params, make_pred(label))
        op = LayerHessianOperator(wl.loss_fn, wl.params, wl.batches[0], mask,
                                  normalization="mean", batch_size=wl.batch_size)
        v0 = torch.randn(op.dim, generator=gen).to(device)
        spec = ritz_decomposition(lanczos(op.matvec, op.dim, min(args.lanczos_iters, size),
                                          v0=v0, reorth=True))
        results[label] = spec
        print(f"{label:60s} P={size:9d} max={float(spec.eigvals.max()):10.4f} "
              f"min={float(spec.eigvals.min()):10.4f}")
    layerwise_outputs(args, results)
    return results


def layerwise_outputs(args, results: dict) -> None:
    """``--out_spectrum`` / ``--plot`` for both layerwise paths: one npz per
    block, ``<out>_<label with / -> .>.npz``."""
    if args.out_spectrum:
        for label, spec in results.items():
            spectra.save_spectrum(f"{args.out_spectrum}_{label.replace('/', '.')}", spec)
        print(f"{len(results)} block spectra -> {args.out_spectrum}_*.npz")
    if args.plot:
        plot_layer_grid(results, args.plot)


def plot_layer_grid(results: dict, path: str) -> None:
    """Grid of per-block stem plots of the Ritz values and their weights,
    log y.  Without matplotlib the grid is drawn by :func:`_stem_grid`."""
    labels = list(results)
    if not labels:
        raise ValueError("no spectra to plot")
    try:
        import matplotlib
    except ImportError:
        _stem_grid(results, path)
        print(f"layer grid plot -> {path} (no matplotlib: stems only, labels in its Title)")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(labels)
    ncols = 2 if n > 1 else 1
    nrows = (n + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows=nrows, ncols=ncols, figsize=(7 * ncols, 2.5 * nrows),
                             squeeze=False)
    flat_axes = axes.flatten()
    for ax, label in zip(flat_axes, labels):
        spec = results[label]
        ax.stem(spec.eigvals.cpu().numpy(), np.maximum(spec.gammas.cpu().numpy(), 1e-12))
        ax.set_yscale("log")
        ax.set_title(f"{label} eigenvalues")
    for ax in flat_axes[n:]:
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    print(f"layer grid plot -> {path}")


def _stem_grid(results: dict, path: str, pw: int = 400, ph: int = 140) -> None:
    """The grid as a grey PNG with no plotting library: one ``pw`` x ``ph``
    panel per block, two per row in label order; a stem per Ritz value at
    its eigenvalue (x, the panel's own range) up to its weight (y, log
    scale from 1e-12 to 1).  The labels go into the PNG's Title text."""
    ncols = 2 if len(results) > 1 else 1
    nrows = -(-len(results) // ncols)
    img = np.full((nrows * ph, ncols * pw), 255, np.uint8)
    for i, spec in enumerate(results.values()):
        y0, x0 = (i // ncols) * ph, (i % ncols) * pw
        base = y0 + ph - 10
        img[base, x0 + 10:x0 + pw - 10] = 0
        ev = spec.eigvals.double().cpu().numpy()
        ga = np.clip(spec.gammas.double().cpu().numpy(), 1e-12, 1.0)
        span = (ev.max() - ev.min()) or 1.0
        xs = x0 + 10 + np.round((ev - ev.min()) / span * (pw - 21)).astype(int)
        tops = base - np.round((np.log10(ga) + 12) / 12 * (ph - 20)).astype(int)
        for x, top in zip(xs, tops):
            img[top:base, x] = 0
    _write_png(path, img, " | ".join(results))


def _write_png(path: str, img: np.ndarray, title: str) -> None:
    """An (H, W) uint8 grey image as PNG, ``title`` in a tEXt chunk."""
    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    h, w = img.shape
    raw = b"".join(b"\x00" + row.tobytes() for row in img)  # filter 0 per scanline
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"tEXt", b"Title\x00" + title.encode("latin-1", "replace"))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
