"""The control: the plain reference in the program's place, its products
in TF32 (the precision below the configurations' fp32 with TF32 off), must
come out not correct under each cell's own limits.

On a card this test runs it at full width and two layers; at the cells'
own sizes it runs as

    python3 benchmark/tests/test_bench_control.py <cell> <seconds> <seed>...

from the root of a checkout, one run a seed, each printing its result
line; ``PERF.md`` gives the readings."""

import json
import os
import sys
import time

import pytest

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))))

from benchmark.tests import tiny  # noqa: E402

CELLS = {"gpt2-124m.spectrum": ("gpt2-124m", {"n_layer": 2}, {"num_batches": 1, "lanczos_iters": 8}),
         "pythia-1.4b.spectrum": ("pythia-1.4b", {"num_hidden_layers": 2}, {"lanczos_iters": 8})}


def shallow_root(tmp, cell: str) -> str:
    """A copy of the benchmark whose ``cell`` has two layers at full width
    and keeps the cell's own limits."""
    root = tiny.make_root(tmp)
    config, layers, shape = CELLS[cell]
    bdir = os.path.join(root, "benchmark")
    cpath = os.path.join(bdir, "configs", config + ".json")
    tiny.dump({**tiny.load(cpath), **layers}, cpath)
    wpath = os.path.join(bdir, "workloads", cell + ".json")
    tiny.dump({**tiny.load(wpath), **shape}, wpath)
    return root


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_is_not_correct(card, cell, tmp_path, capsys):
    from benchmark.harness import cell as cell_mod

    root = shallow_root(tmp_path, cell)
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        rc = cell_mod.main(["--workload", cell, "--seed", str(seed), "--seconds", "1"],
                           t0=time.perf_counter(), root=root, device=card, control=True)
        res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == 0 and res["correct"] is False, res["checks"]


def main(argv) -> int:
    from benchmark.harness import cell as cell_mod

    cell, seconds, seeds = argv[0], argv[1], argv[2:]
    root = os.getcwd()
    for seed in seeds:
        rc = cell_mod.main(["--workload", cell, "--seed", seed, "--seconds", seconds],
                           t0=time.perf_counter(), root=root, control=True)
        print(json.dumps({"control_rc": rc, "seed": int(seed)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
