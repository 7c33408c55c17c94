"""Port checkpoints, run directories and pickle stats: a save/load round
trip is bit-exact, the template checks fire, the reference ``module.``
prefix is stripped, and run-directory names and stats files are the JAX
package's."""

import os

import numpy as np
import pytest
import torch

from hessian_llm_vision_tpu.io import runs as jruns
from hessian_llm_vision_tpu.obs.loggers import MultiLogger as JMultiLogger
from hessian_llm_vision_tpu.obs.loggers import PickleStatsLogger as JPickleStatsLogger
from hessian_llm_vision_tpu_torch.io import runs
from hessian_llm_vision_tpu_torch.io.checkpoints import (
    load_checkpoint,
    load_torch_state_dict,
    save_checkpoint,
)
from hessian_llm_vision_tpu_torch.obs.loggers import MultiLogger, PickleStatsLogger
from hessian_llm_vision_tpu_torch.optim.manual import manual_adam
from hessian_llm_vision_tpu_torch.train.loop import TrainState


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"h_0.attn.kernel": torch.randn(4, 6, generator=g),
              "wte": torch.randn(9, 4, generator=g), "ln_f.scale": torch.rand(4, generator=g)}
    opt = manual_adam(1e-3).init(params)
    opt["m"] = {n: torch.randn(p.shape, generator=g) for n, p in params.items()}
    opt["step"] = 7
    return TrainState(params=params, opt_state=opt, step=7)


def _flat(tree, prefix=""):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_round_trip_is_bit_exact(tmp_path):
    state = _state()
    path = str(tmp_path / "sub" / "state")
    save_checkpoint(path, state)
    back = load_checkpoint(path, template=_state(seed=1))
    assert isinstance(back, TrainState) and back.step == 7 and back.opt_state["step"] == 7
    assert list(back.params) == list(state.params)
    got, ref = dict(_flat(back)), dict(_flat(state))
    assert got.keys() == ref.keys()
    for key, v in ref.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(got[key], v) and got[key].dtype == v.dtype, key
        else:
            assert got[key] == v, key
    # without a template: the stored nested dict, named tuples as dicts
    raw = load_checkpoint(path)
    assert set(raw) == {"params", "opt_state", "step"} and raw["step"] == 7
    assert not any(f.name.startswith("state.tmp") for f in (tmp_path / "sub").iterdir())


@pytest.mark.parametrize("change,message", [
    (lambda s: s.params.pop("wte"), r"/params: missing keys \['wte'\], extra keys \[\]"),
    (lambda s: s.params.update(extra=torch.zeros(2)), r"missing keys \[\], extra keys \['extra'\]"),
    (lambda s: s.params.update(wte=torch.zeros(9, 5)), r"/params/wte: \(9, 5\) torch.float32 where "
                                                        r"the template has \(9, 4\)"),
    (lambda s: s.params.update(wte=torch.zeros(9, 4, dtype=torch.float64)), "torch.float64"),
], ids=["missing_key", "extra_key", "wrong_shape", "wrong_dtype"])
def test_template_errors(tmp_path, change, message):
    state = _state()
    change(state)
    path = str(tmp_path / "bad")
    save_checkpoint(path, state)
    with pytest.raises(ValueError, match=message):
        load_checkpoint(path, template=_state())


def test_template_step_and_unsupported_entries(tmp_path):
    path = str(tmp_path / "ck")
    save_checkpoint(path, {"params": {"w": torch.ones(2)}, "step": 3})
    with pytest.raises(ValueError, match="/step: expected a tensor, found int"):
        load_checkpoint(path, template={"params": {"w": torch.ones(2)}, "step": torch.ones(())})
    with pytest.raises(ValueError, match="/params/w: expected int, found Tensor"):
        load_checkpoint(path, template={"params": {"w": 0}, "step": 0})
    with pytest.raises(ValueError, match=r"/params/w: expected a dict with keys \['a'\], found Tensor"):
        load_checkpoint(path, template={"params": {"w": {"a": torch.ones(2)}}, "step": 0})
    with pytest.raises(TypeError, match="/x: str is not a tensor"):
        save_checkpoint(path, {"x": "text"})


def test_load_torch_state_dict_strips_module_prefix(tmp_path):
    path = str(tmp_path / "model_trained.pt")
    torch.save({"module.h.weight": torch.arange(6.0).reshape(2, 3), "bias": torch.ones(3)}, path)
    out = load_torch_state_dict(path)
    assert set(out) == {"h.weight", "bias"}
    np.testing.assert_array_equal(out["h.weight"], np.arange(6.0).reshape(2, 3))
    assert isinstance(out["bias"], np.ndarray)
    kept = load_torch_state_dict(path, strip_module_prefix=False)
    assert "module.h.weight" in kept
    torch.save(torch.nn.Linear(2, 3), str(tmp_path / "module.pt"))
    assert set(load_torch_state_dict(str(tmp_path / "module.pt"))) == {"weight", "bias"}


@pytest.mark.parametrize("hparams", [
    dict(lr=0.001, delta=1e-08, batchsize=8, k=10, accum=1, lanczosmomentum=0.0),
    dict(lr=0.05, delta=0.0001, batchsize=60, k=4, accum=2, lanczosmomentum=0.9),
])
def test_run_dir_name_is_the_jax_packages(tmp_path, hparams):
    for optim, subsample in (("adam", 1.0), ("lanczos-host", 0.5), ("sgd", 100)):
        name = runs.run_dir_name(str(tmp_path), optim, subsample, **hparams)
        assert name == jruns.run_dir_name(str(tmp_path), optim, subsample, **hparams)
        assert runs.parse_run_dir(name) == jruns.parse_run_dir(name) == hparams


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_pickle_stats_read_across_packages(tmp_path, writer):
    path = str(tmp_path / "runs" / "training_stats.pkl")
    logger_cls, multi = ((PickleStatsLogger, MultiLogger) if writer == "port"
                         else (JPickleStatsLogger, JMultiLogger))
    logger = multi([logger_cls(path, flush_every=3)])
    records = [{"loss": 5.5 - 0.1 * i, "ema_loss": 5.5, "step_time": 0.01} for i in range(7)]
    for i, rec in enumerate(records):
        logger.log(i, rec)
    assert os.path.getsize(path) > 0  # two chunks flushed before close
    logger.close()
    expected = [{"step": i, **rec} for i, rec in enumerate(records)]
    assert PickleStatsLogger.read(path) == JPickleStatsLogger.read(path) == expected
