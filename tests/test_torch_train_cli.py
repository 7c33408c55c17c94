"""Port train CLI against the JAX train CLI on the CPU: the same Orbax /
port checkpoint through both CLIs gives the same per-step losses and EMAs
(Adam, also with accumulation and linear decay); ``--max_steps`` counts
steps inside ``--epochs`` as JAX does; save and resume continue bit for bit
with JAX's step count; the defaults, refusals and run directories."""

import argparse
import glob
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from hessian_llm_vision_tpu.cli import train as jtrain
from hessian_llm_vision_tpu.cli.workloads import build_workload as jbuild_workload
from hessian_llm_vision_tpu.io import load_checkpoint as jload_checkpoint
from hessian_llm_vision_tpu.io import run_dir_name as jrun_dir_name
from hessian_llm_vision_tpu.io import save_checkpoint as jsave_checkpoint
from hessian_llm_vision_tpu.obs.loggers import PickleStatsLogger as JPickleStatsLogger
from hessian_llm_vision_tpu_torch.cli import train
from hessian_llm_vision_tpu_torch.io.checkpoints import load_checkpoint, save_checkpoint
from hessian_llm_vision_tpu_torch.models.convert import gpt2_params_from_jax
from hessian_llm_vision_tpu_torch.models.precision import PRESETS
from hessian_llm_vision_tpu_torch.obs.loggers import PickleStatsLogger


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread avoids oversubscribing the CPU
    when several test workers run at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = ["--model", "gpt2-tiny", "--batch_size", "4", "--max_length", "16", "--cpu"]


def _corpus(tmp_path):
    """A directory of text files: 2 x 900 bytes -> 112 sequences of 16."""
    root = tmp_path / "corpus"
    (root / "sub").mkdir(parents=True)
    rng = np.random.RandomState(0)
    for name in ("a.txt", "sub/b.py"):
        (root / name).write_bytes(bytes(rng.randint(32, 127, size=900).astype(np.uint8)))
    return str(root)


def _stats(out_root):
    (path,) = glob.glob(os.path.join(out_root, "**", "training_stats.pkl"), recursive=True)
    return PickleStatsLogger.read(path)


@pytest.mark.parametrize("extra", [[], ["--accumulation_steps", "2", "--linear_decay_steps", "4"]],
                         ids=["adam", "adam_accum2_decay"])
def test_cli_matches_jax_cli_from_the_same_checkpoint(tmp_path, extra):
    corpus = _corpus(tmp_path)
    argv = TINY + ["--optimiser", "adam", "--dataset", f"local:{corpus}", "--num_batches", "3",
                   "--epochs", "2", "--max_steps", "5", "--log_every", "1"] + extra
    # the start point: other params than either CLI's init (seed 5)
    jparams = jbuild_workload(jtrain.build_parser().parse_args(argv + ["--seed", "5"])).params
    jck, ck = str(tmp_path / "jck"), str(tmp_path / "ck.pt")
    jsave_checkpoint(jck, jparams)
    save_checkpoint(ck, gpt2_params_from_jax(jparams))
    jtrain.main(argv + ["--checkpoint", jck, "--out", str(tmp_path / "jruns")])
    records = []
    train.main(argv + ["--checkpoint", ck, "--out", str(tmp_path / "runs")],
               on_step=lambda s, r: records.append(r))
    jstats, stats = _stats(str(tmp_path / "jruns")), _stats(str(tmp_path / "runs"))
    assert [r["step"] for r in stats] == [r["step"] for r in jstats] == list(range(5))
    for key in ("loss", "ema_loss"):
        np.testing.assert_allclose([r[key] for r in stats], [r[key] for r in jstats], rtol=1e-5,
                                   err_msg=key)
    assert [r["loss"] for r in records] == [r["loss"] for r in stats]
    # the checkpoint was loaded: a random init starts elsewhere
    init = []
    train.main(argv + ["--max_steps", "1", "--out", str(tmp_path / "init")],
               on_step=lambda s, r: init.append(r))
    assert init[0]["loss"] != records[0]["loss"]


@pytest.mark.parametrize("epochs,expected", [([], 2), (["--epochs", "3"], 5)],
                         ids=["one_epoch", "three_epochs"])
def test_max_steps_counts_inside_epochs_as_jax(tmp_path, monkeypatch, capsys, epochs, expected):
    """--max_steps larger than the batch count stops at the end of the
    epochs (JAX ``train/loop.py``); it does not cycle over the batches."""
    monkeypatch.chdir(tmp_path)  # the run directories go under ./runs
    argv = ["--model", "gpt2-tiny", "--batch_size", "2", "--max_length", "16", "--num_batches",
            "2", "--max_steps", "5", "--optimiser", "lanczos-host", "--k", "3", "--cpu"] + epochs
    jtrain.main(argv)
    jsteps = [int(s) for s in re.findall(r"^step (\d+)  loss", capsys.readouterr().out, re.M)]
    records = []
    train.main(argv, on_step=lambda s, r: records.append(r))
    assert jsteps[-1] + 1 == len(records) == expected


def test_resume_continues_bit_for_bit_with_jax_step_count(tmp_path):
    corpus = _corpus(tmp_path)
    argv = TINY + ["--optimiser", "adam", "--dataset", f"local:{corpus}", "--num_batches", "3",
                   "--out", str(tmp_path / "runs")]
    p = {name: str(tmp_path / name) for name in ("whole", "S", "S2", "ck_whole", "ck_resumed")}
    whole, part = [], []
    train.main(argv + ["--epochs", "2", "--save_checkpoint", p["ck_whole"]],
               on_step=lambda s, r: whole.append(r["loss"]))
    train.main(argv + ["--epochs", "1", "--save_state", p["S"]],
               on_step=lambda s, r: part.append(r["loss"]))
    train.main(argv + ["--epochs", "1", "--resume_state", p["S"], "--save_state", p["S2"],
                       "--save_checkpoint", p["ck_resumed"]],
               on_step=lambda s, r: part.append(r["loss"]))
    assert len(whole) == 6 and part == whole
    a, b = load_checkpoint(p["ck_whole"]), load_checkpoint(p["ck_resumed"])
    assert a.keys() == b.keys() and all(torch.equal(a[n], b[n]) for n in a)
    state, state2 = load_checkpoint(p["S"]), load_checkpoint(p["S2"])
    assert set(state) == {"params", "opt_state", "step"} and set(state["opt_state"]) == {
        "step", "m", "v"}
    assert (state["step"], state2["step"], state2["opt_state"]["step"]) == (3, 6, 6)
    # JAX counts the same: N after the first process, 2N after the resumed one
    jargv = argv[:-2] + ["--out", str(tmp_path / "jruns"), "--epochs", "1"]
    jtrain.main(jargv + ["--save_state", p["S"] + "_jax"])
    jtrain.main(jargv + ["--resume_state", p["S"] + "_jax", "--save_state", p["S2"] + "_jax"])
    assert [int(jload_checkpoint(p[s] + "_jax")["step"]) for s in ("S", "S2")] == [3, 6]


def test_lanczos_host_state_keeps_params_momentum_step(tmp_path, capsys):
    argv = TINY + ["--optimiser", "lanczos-host", "--k", "3", "--refresh_every", "2",
                   "--max_steps", "2", "--out", str(tmp_path / "runs")]
    s1, s2 = str(tmp_path / "s1"), str(tmp_path / "s2")
    train.main(argv + ["--save_state", s1])
    train.main(argv + ["--resume_state", s1, "--save_state", s2])
    assert f"resumed train state <- {s1}" in capsys.readouterr().out
    first, second = load_checkpoint(s1), load_checkpoint(s2)
    assert set(first) == set(second) == {"params", "momentum", "step"}
    assert (first["step"], second["step"]) == (2, 4)
    assert first["params"].keys() == first["momentum"].keys()
    assert any(not torch.equal(first["params"][n], second["params"][n]) for n in first["params"])


def _same_block_precision_verdicts(ours, ref):
    """--block_precision's validators (one function per package): the same
    verdict on every name the card runs and on lower-case non-names (the
    port also refuses upper-case presets it has no tier for)."""
    for value in ("default", "high", "highest", *PRESETS):
        assert ours(value) == ref(value) == value
    for bad in ("mixed", "fast", "bf16"):
        for validate in (ours, ref):
            with pytest.raises(argparse.ArgumentTypeError):
                validate(bad)


def test_defaults_and_flags_are_the_jax_clis(tmp_path):
    ours = {a.option_strings[0]: a for a in train.build_parser()._actions if a.option_strings}
    ref = {a.option_strings[0]: a for a in jtrain.build_parser()._actions if a.option_strings}
    assert ours["--optimiser"].default == "sgd" and ours["--delta"].default is None
    for flag, action in ours.items():
        if flag == "-h" or "not ported yet" in (action.help or ""):
            continue
        for attr in ("default", "type", "choices", "nargs", "const"):
            if (flag, attr) == ("--block_precision", "type"):
                _same_block_precision_verdicts(action.type, ref[flag].type)
                continue
            assert getattr(action, attr) == getattr(ref[flag], attr), (flag, attr)
    # --delta resolves per optimiser, as the run directory shows
    for extra, optim, delta in (([], "sgd", 1e-4), (["--optimiser", "adam"], "adam", 1e-8),
                                (["--optimiser", "raw", "--delta", "0.5"], "raw", 0.5),
                                (["--optimiser", "lanczos-host", "--k", "3"], "lanczos-host",
                                 1e-4)):
        out = str(tmp_path / optim)
        train.main(TINY + ["--num_batches", "1", "--out", out] + extra)
        k = 3 if optim == "lanczos-host" else 10
        assert os.path.isfile(os.path.join(jrun_dir_name(
            out, optim, 1.0, lr=0.001, delta=delta, batchsize=4, k=k, accum=1,
            lanczosmomentum=0.0), "training_stats.pkl"))


def test_unknown_optimiser_exits():
    with pytest.raises(SystemExit, match="unknown --optimiser 'bogus'"):
        train.main(TINY + ["--optimiser", "bogus"])


def test_no_card_exits(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card error cannot occur")
    with pytest.raises(SystemExit, match="no CUDA device"):
        train.main([a for a in TINY if a != "--cpu"] + ["--out", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_jax_stats_file_reads_in_the_port(tmp_path):
    """The JAX CLI's training_stats.pkl reads with the port's logger."""
    jtrain.main(TINY + ["--optimiser", "raw", "--num_batches", "2", "--log_every", "1",
                        "--out", str(tmp_path)])
    (path,) = glob.glob(str(tmp_path / "**" / "training_stats.pkl"), recursive=True)
    rows = PickleStatsLogger.read(path)
    assert rows == JPickleStatsLogger.read(path) and [r["step"] for r in rows] == [0, 1]
    assert jax.numpy.isfinite(rows[-1]["loss"])


def test_modules_import_without_jax():
    """The train and spectrum CLIs, the loop and the checkpoints import with
    JAX and the JAX package blocked."""
    code = ("import sys; sys.modules['jax'] = None; sys.modules['hessian_llm_vision_tpu'] = None\n"
            "import hessian_llm_vision_tpu_torch.cli.train, hessian_llm_vision_tpu_torch.train.loop\n"
            "import hessian_llm_vision_tpu_torch.io.checkpoints, hessian_llm_vision_tpu_torch.cli.spectrum\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'hessian_llm_vision_tpu.'))\n"
            "               for m in sys.modules if sys.modules[m] is not None)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root, timeout=120)
