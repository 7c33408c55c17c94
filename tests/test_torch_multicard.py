"""The port's mesh across cards, as far as the CPU can show it: the dry run
of ``parallel/dryrun.py`` on four gloo ranks (data 2 x model 2, gpt2-tiny)
with its JAX-style line, the spectrum CLI's rank plan for
``--probe_parallel`` over a host's cards (a pure function), the refusals of
a NCCL group with fewer cards than ranks, and the one place that picks the
collectives' path.  The four-card run itself is
``scripts/torch_multicard_smoke.py`` on the card machine.
"""

import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from hessian_llm_vision_tpu_torch.cli import spectrum
from hessian_llm_vision_tpu_torch.parallel import dist_init, spawn
from hessian_llm_vision_tpu_torch.parallel import mesh as mesh_module
from hessian_llm_vision_tpu_torch.parallel.dryrun import dryrun_multichip, multichip_line
from hessian_llm_vision_tpu_torch.parallel.probe_parallel import rank_plan
from hessian_llm_vision_tpu_torch.parallel.spawn import run_ranks
from test_torch_model_parallel import SPAWN_TIMEOUT, _shared

TINY = ["--model", "gpt2-tiny", "--cpu", "--dataset", "random", "--num_batches", "1",
        "--batch_size", "2", "--max_length", "16", "--lanczos_iters", "4", "--host_loop",
        "--hvp_precision", "high"]


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """``dryrun_multichip(4)``'s summary and line, and the modules its ranks
    imported."""
    def produce(workdir):
        ranks = []

        def recorded(*args, **kwargs):
            ranks.extend(run_ranks(*args, **kwargs))
            return ranks

        spawn.run_ranks = recorded
        try:
            summary = dryrun_multichip(4, timeout=SPAWN_TIMEOUT)
        finally:
            spawn.run_ranks = run_ranks
        return {"summary": summary, "line": multichip_line(summary),
                "modules": [r["modules"] for r in ranks]}

    return _shared(tmp_path_factory, "dryrun_grid", produce)


def test_dryrun_on_a_data_by_model_grid(grid):
    d = grid["summary"]
    assert d["ranks"] == 4 and d["probe_parallel"] == "4x4iters"
    assert d["loss_rel"] <= 1e-6 and max(d["grad_rel"], d["hvp_rel"]) <= 1e-5
    assert d["probe_parallel_T_diff"] <= 1e-4
    ma, pp = d["model_axis"], d["pipeline"]
    assert ma["mesh"] == {"data": 2, "model": 2} and pp["mesh"] == {"data": 2, "pp": 2}
    for key in ("host_loop_T_diff", "seq_parallel_T_diff", "ep_T_diff"):
        assert ma[key] <= 1e-4, key
    assert ma["step_eig_max_rel"] <= 1e-3 and pp["T_diff"] <= 1e-4


def test_dryrun_prints_the_jax_line(grid):
    line = grid["line"]
    assert line.startswith("dryrun_multichip ok: mesh={'data': 2, 'model': 2} loss=")
    for key in ("eig_max=", "hostloop_alpha0=", "hostloop_trainer_loss=",
                "seqparallel_alpha0=", "probe_parallel=4x4iters", "pipeline_alpha0=",
                "moe_ep_alpha0="):
        assert key in line, key
    assert len(grid["modules"]) == 4 and all("jax" not in m for m in grid["modules"])


@pytest.mark.parametrize("cards,probes,cpu,launched,want", [
    (4, 4, False, False, 4),  # launched plainly on four cards: a rank a card
    (4, 8, False, False, 4),
    (8, 8, False, False, 8),
    (1, 4, False, False, 0),  # one card: in turn, as before
    (0, 4, False, False, 0),
    (4, 4, True, False, 0),  # --cpu
    (4, 4, False, True, 0),  # torchrun's group: joined, as before
    (4, 3, False, True, 0),
])
def test_probe_parallel_rank_plan(cards, probes, cpu, launched, want):
    assert rank_plan(cards, probes, cpu=cpu, launched=launched) == want


def test_probe_parallel_rank_plan_keeps_its_value_error():
    with pytest.raises(ValueError, match="multiple of the mesh"):
        rank_plan(4, 6, cpu=False, launched=False)


def test_probe_parallel_on_the_cpu_without_a_group_runs_as_before(monkeypatch, capsys):
    """``--cpu`` on a host that reports four cards: no ranks start, the
    probes run in turn in this process."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(spectrum, "over_cards", lambda *a: pytest.fail("started ranks"))
    for var in ("MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    par, _ = spectrum.main(TINY + ["--probes", "2", "--probe_parallel"])
    seq, _ = spectrum.main(TINY + ["--probes", "2"])
    assert torch.equal(par.eigvals, seq.eigvals)
    assert "on rank 0 of 1" in capsys.readouterr().out


def test_a_nccl_group_with_fewer_cards_than_ranks_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 NCCL ranks on this host but 1 CUDA cards"):
        dist_init.initialize(num_processes=2, process_id=0, store=dist.HashStore(),
                             backend="nccl")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="4 NCCL ranks but 1 CUDA cards"):
        run_ranks("x:y", 4, "unused", backend="nccl")


@pytest.mark.parametrize("axis,i,want", [("model", 2, 5), ("data", 0, 1), ("mesh", 4, 4)])
def test_rank_on_maps_an_axis_index_to_the_global_rank(axis, i, want):
    """On the JAX grid ``reshape(num_data, num_model)``: rank 4 of a 2 x 3
    mesh sits at data index 1 and model index 1."""
    m = mesh_module.Mesh(2, 3, 4)
    assert (m.data_index, m.model_index) == (1, 1)
    assert m.rank_on(axis, i) == want


def test_the_collective_path_is_chosen_in_one_place():
    """NCCL, and gloo on CPU tensors, run the native collectives; gloo on
    CUDA tensors the padded ones.  The clock counts each kind."""
    try:
        dist_init.initialize(num_processes=1, process_id=0, backend="gloo",
                             store=dist.HashStore())
        group = dist.group.WORLD
        assert mesh_module.native(group, torch.zeros(1))
        assert not mesh_module.native(group, types.SimpleNamespace(is_cuda=True))
        m = mesh_module.make_mesh()
        assert m.collective_path(torch.zeros(1)) == "native"
        assert mesh_module.Mesh(1).collective_path(torch.zeros(1)) == "none"  # no group
        with mesh_module.collective_clock() as clock:
            m.sum_(torch.ones(3), "data")
            m.sum_(torch.ones(2), "mesh")
        assert clock["calls"] == 2 and clock["bytes"] == 20
        assert clock["by"]["all_reduce"]["calls"] == 2
        assert mesh_module._CLOCK is None
        np.testing.assert_array_equal(m.all_gather(torch.arange(3.0), "data"), [0, 1, 2])
    finally:
        dist.destroy_process_group()
