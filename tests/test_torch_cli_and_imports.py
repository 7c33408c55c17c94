"""Port train CLI on the CPU, its data generators against the JAX package's,
and the rule that the port (and chip_smoke.py) never imports JAX."""

import ast
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from hessian_llm_vision_tpu.data import synthetic as jsynthetic
from hessian_llm_vision_tpu_torch.cli import train
from hessian_llm_vision_tpu_torch.data import synthetic


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread avoids oversubscribing the CPU
    when several test workers run at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "transformers", "hessian_llm_vision_tpu"}
TINY = ["--model", "gpt2-tiny", "--batch_size", "2", "--max_length", "16", "--k", "3",
        "--delta", "1e-2", "--refresh_every", "2", "--lanczos_momentum", "0.5"]


def test_cli_runs_two_steps_on_cpu(capsys):
    records = []
    final = train.main(TINY + ["--max_steps", "2", "--cpu"],
                       on_step=lambda step, rec: records.append(rec))
    assert len(records) == 2
    assert all(math.isfinite(v) for r in records for v in r.values())
    assert final == records[-1]["loss"]
    # init loss of a random model is about ln(vocab)
    assert abs(records[0]["loss"] - math.log(256)) < 0.5
    assert capsys.readouterr().out.strip().splitlines()[-1] == repr(final)


def test_cli_markov_dataset_and_f32_default_below_1e8(capsys):
    train.main(TINY + ["--dataset", "markov", "--max_steps", "1", "--cpu"])
    assert "bf16 Ritz basis" not in capsys.readouterr().out


def test_cli_without_cpu_flag_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card error cannot occur")
    with pytest.raises(SystemExit, match="no CUDA device"):
        train.main(TINY + ["--max_steps", "1"])


@pytest.mark.parametrize("flag,value", [
    ("--model", "pythia-70m"), ("--optimiser", "adam"), ("--dataset", "wikipedia"),
])
def test_cli_unported_choices_exit(flag, value):
    with pytest.raises(SystemExit, match="not ported yet"):
        train.main(TINY + [flag, value, "--cpu"])


@pytest.mark.parametrize("gen", ["random_token_batches", "markov_token_batches"])
def test_synthetic_batches_equal_jax_package(gen):
    ours = getattr(synthetic, gen)(3, 2, 12, 97, seed=5)
    ref = getattr(jsynthetic, gen)(3, 2, 12, 97, seed=5)
    assert ours.keys() == ref.keys()
    for key in ref:
        np.testing.assert_array_equal(ours[key], ref[key])


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_and_chip_smoke_import_no_jax():
    files = sorted((ROOT / "hessian_llm_vision_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    bad = [
        (str(f.relative_to(ROOT)), mod)
        for f in files
        for mod in _imported_modules(f)
        if mod.split(".")[0] in FORBIDDEN  # exact top-level name, not a prefix
    ]
    assert not bad, bad
