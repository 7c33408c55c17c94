"""A configuration, a cell, a driver, a model family with its reference and
a per-layer metric are taken from added files and entries alone; the
spectrum cells run end to end."""

import os

from benchmark.tests import tiny

READER = '''
"""iterations_done: the window's iterations (a test's metric)."""


def read(run):
    return float(run.window.iterations)
'''


FAMILY = '''
"""A bigram LM (a test's family): a token embedding and a dense head."""

import torch


class Bigram(torch.nn.Module):
    def __init__(self, vocab, width):
        super().__init__()
        self.wte = torch.nn.Parameter(torch.empty(vocab, width))
        self.head = torch.nn.Parameter(torch.empty(width, vocab))

    def forward(self, ids):
        return torch.tanh(self.wte[ids]) @ self.head


def build(cfg):
    model = Bigram(cfg["vocab_size"], cfg["n_embd"])

    def loss_fn(params, batch):
        ids = batch["input_ids"]
        z = torch.func.functional_call(model, params, (ids,))
        return torch.nn.functional.cross_entropy(z[:, :-1].reshape(-1, z.shape[-1]),
                                                 ids[:, 1:].reshape(-1))

    return model, loss_fn


def forward_flops(cfg, batch, seq):
    return 2.0 * batch * seq * cfg["n_embd"] * cfg["vocab_size"], 0.0
'''

BIGRAM_REFERENCE = '''
"""A plain bigram LM (a test's reference)."""

import torch
import torch.nn.functional as F


def shapes(cfg):
    return {"wte": (cfg["vocab_size"], cfg["n_embd"]), "head": (cfg["n_embd"], cfg["vocab_size"])}


def loss(w, ids, cfg):
    z = torch.tanh(w["wte"][ids]) @ w["head"]
    return F.cross_entropy(z[:, :-1].reshape(-1, z.shape[-1]), ids[:, 1:].reshape(-1))


def check(cfg):
    pass
'''


def test_cells_run_end_to_end(tmp_path):
    root = tiny.make_root(tmp_path)
    for cell in ("gpt2-tiny.spectrum", "neox-tiny.spectrum"):
        rc, res, err = tiny.run(root, cell, seed=2**31 + 12345)
        assert rc == 0, err[-3000:]
        assert res["correct"] and res["attempted"] >= 1 and res["failed"] == 0
        assert set(res["metrics"]) == {"tokens_per_s", "setup_s"}  # no card: no peak
        assert list(res)[-1] == "checks" and res["checks"]
        assert err.strip().splitlines()[-1].startswith("check ")


def test_added_files_alone_make_a_cell_and_a_metric(tmp_path):
    root = tiny.make_root(tmp_path)
    bdir = os.path.join(root, "benchmark")
    cfg = {**tiny.load(os.path.join(bdir, "configs", "gpt2-tiny.json")), "n_layer": 1}
    tiny.dump(cfg, os.path.join(bdir, "configs", "gpt2-one.json"))
    mix = {**tiny.load(os.path.join(bdir, "workloads", "gpt2-tiny.spectrum.json")),
           "num_batches": 2}
    tiny.dump(mix, os.path.join(bdir, "workloads", "gpt2-one.dataset.json"))
    with open(os.path.join(bdir, "metrics", "iterations_done.py"), "w") as f:
        f.write(READER)
    bench = tiny.load(os.path.join(root, "BENCHMARK.json"))
    bench["configs"].append({"name": "gpt2-one", "source": cfg["source"],
                             "file": "benchmark/configs/gpt2-one.json", "reduced": [],
                             "why": "added"})
    bench["workloads"].append({"name": "gpt2-one.dataset", "config": "gpt2-one",
                               "traffic": "dataset", "chips": 1, "why": "added"})
    bench["per_layer"].append({"name": "iterations_done", "unit": "iterations",
                               "better": "higher", "source": "host_clock", "layer": "tests",
                               "moves": "tokens_per_s", "workloads": ["gpt2-one.dataset"]})
    tiny.dump(bench, os.path.join(root, "BENCHMARK.json"))
    rc, res, err = tiny.run(root, "gpt2-one.dataset", trace=1)
    assert rc == 0, err[-3000:]
    assert res["correct"]
    assert res["metrics"]["iterations_done"]["value"] == res["attempted"] >= 1
    assert "lanczos_overhead_pct" not in res["metrics"]  # listed for other cells only


def test_a_cell_missing_its_driver_fails(tmp_path):
    root = tiny.make_root(tmp_path)
    path = os.path.join(root, "benchmark", "workloads", "gpt2-tiny.spectrum.json")
    tiny.dump({**tiny.load(path), "driver": "no_such_driver"}, path)
    rc, res, err = tiny.run(root, "gpt2-tiny.spectrum")
    assert rc != 0 and res is None and "no_such_driver" in err


def test_added_files_alone_make_a_model_family(tmp_path):
    root = tiny.make_root(tmp_path)
    bdir = os.path.join(root, "benchmark")
    for kind, text in (("families", FAMILY), ("reference", BIGRAM_REFERENCE)):
        with open(os.path.join(bdir, kind, "bigram.py"), "w") as f:
            f.write(text)
    cfg = {"source": "a test", "family": "bigram", "reference": "bigram", "vocab_size": 64,
           "n_embd": 8, "initializer_range": 0.5}
    tiny.dump(cfg, os.path.join(bdir, "configs", "bigram-tiny.json"))
    mix = tiny.load(os.path.join(bdir, "workloads", "gpt2-tiny.spectrum.json"))
    tiny.dump(mix, os.path.join(bdir, "workloads", "bigram-tiny.spectrum.json"))
    bench = tiny.load(os.path.join(root, "BENCHMARK.json"))
    bench["configs"].append({"name": "bigram-tiny", "source": "a test",
                             "file": "benchmark/configs/bigram-tiny.json", "reduced": [],
                             "why": "added"})
    bench["workloads"].append({"name": "bigram-tiny.spectrum", "config": "bigram-tiny",
                               "traffic": "spectrum", "chips": 1, "why": "added"})
    tiny.dump(bench, os.path.join(root, "BENCHMARK.json"))
    rc, res, err = tiny.run(root, "bigram-tiny.spectrum")
    assert rc == 0, err[-3000:]
    assert res["correct"] and res["attempted"] >= 1 and res["failed"] == 0
    assert res["checks"]["t_gap"]["value"] < 1e-5
