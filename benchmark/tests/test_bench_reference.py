"""The plain reference against the program at tiny sizes on the CPU: the
loss, the HVP of the dataset mean, the CGS2 Lanczos and the T-only Lanczos
with bf16 vectors.  (The test imports both; the reference imports nothing
of the program.)"""

import ast
import glob
import os

import pytest
import torch

from benchmark.harness import family, inputs
from benchmark.reference import lanczos as ref
from benchmark.tests import tiny

CPU = torch.device("cpu")


def setup(name):
    base = {"gpt2": ("gpt2-124m", tiny.GPT2), "neox": ("pythia-1.4b", tiny.NEOX)}[name]
    cfg = {**tiny.load(os.path.join(tiny.BENCH, "configs", base[0] + ".json")), **base[1]}
    refmod = family.reference(tiny.REPO, cfg)
    shapes = refmod.shapes(cfg)
    weights = inputs.weights(3, shapes, 0.02, CPU)
    ids = inputs.token_batches(3, 3, 2, 16, cfg["vocab_size"], CPU)
    return cfg, refmod, shapes, weights, ids


def rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


@pytest.mark.parametrize("name", ["gpt2", "neox"])
def test_loss_and_dataset_hvp(name):
    from hessian_llm_vision_tpu_torch.curvature.operators import DatasetHessianOperator
    from hessian_llm_vision_tpu_torch.utils.flatten import Flattener

    cfg, refmod, shapes, weights, ids = setup(name)
    _, loss_fn = family.build(tiny.REPO, cfg, shapes)
    for b in ids:
        assert float(loss_fn(weights, {"input_ids": b})) == pytest.approx(
            float(refmod.loss(weights, b, cfg)), rel=1e-6)
    op = DatasetHessianOperator(loss_fn, weights, [{"input_ids": b} for b in ids],
                                batch_size=2, remat=False)
    v = inputs.start_vector(3, 0, shapes, CPU)
    fl = Flattener(weights)
    layout = ref.flat_layout(shapes)
    got = ref.flatten(fl.unflatten(op.matvec(fl.flatten(v))), layout)
    want = ref.dataset_matvec(lambda w, b: refmod.loss(w, b, cfg), weights, list(ids),
                              layout)(ref.flatten(v, layout))
    assert rel(got, want) < 1e-5


def test_cgs2_lanczos_t():
    from hessian_llm_vision_tpu_torch.curvature.operators import DatasetHessianOperator
    from hessian_llm_vision_tpu_torch.krylov.lanczos import lanczos
    from hessian_llm_vision_tpu_torch.utils.flatten import Flattener

    cfg, refmod, shapes, weights, ids = setup("gpt2")
    _, loss_fn = family.build(tiny.REPO, cfg, shapes)
    op = DatasetHessianOperator(loss_fn, weights, [{"input_ids": b} for b in ids],
                                batch_size=2, remat=False)
    v = inputs.start_vector(3, 0, shapes, CPU)
    res = lanczos(op.matvec, op.dim, 6, v0=Flattener(weights).flatten(v))
    layout = ref.flat_layout(shapes)
    a, b, _ = ref.lanczos_cgs2(ref.dataset_matvec(lambda w, x: refmod.loss(w, x, cfg), weights,
                                                  list(ids), layout), ref.flatten(v, layout), 6)
    assert (res.alphas - a).abs().max() / a.abs().max() < 1e-5
    assert (res.betas - b[:5]).abs().max() / b.abs().max() < 1e-5


def test_bigmodel_t_with_bf16_vectors():
    from hessian_llm_vision_tpu_torch.krylov.driver import bigmodel_spectrum_host

    cfg, refmod, shapes, weights, ids = setup("neox")
    _, loss_fn = family.build(tiny.REPO, cfg, shapes)
    v = inputs.start_vector(3, 0, shapes, CPU)
    res = bigmodel_spectrum_host(loss_fn, weights, {"input_ids": ids[0]}, 4, v0=v,
                                 batch_size=2, q_dtype=torch.bfloat16)
    layout = ref.flat_layout(shapes)
    a, b = ref.lanczos_stored(ref.dataset_matvec(lambda w, x: refmod.loss(w, x, cfg), weights,
                                                 [ids[0]], layout),
                              ref.flatten(v, layout), 4, torch.bfloat16)
    # bf16 roundings that fall differently move T by far less than 1e-3 here
    assert (res.alphas - a).abs().max() / a.abs().max() < 1e-3
    assert (res.betas - b[:3]).abs().max() / b.abs().max() < 1e-3


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(tiny.BENCH, "reference", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] in ("torch", "benchmark", "__future__", "contextlib",
                                           "typing", "math"), (path, n)
