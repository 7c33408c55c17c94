"""``BENCHMARK.json`` against the benchmark's contract: its keys, the
characters of names and units, every file it names, the bounds and the
chip time of a check."""

import json
import os
import re

import pytest

from benchmark.tests.tiny import BENCH, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|^(hidden_size|intermediate_size|n_embd|n_inner|head_dim|"
                   r"num_experts_per_tok|ffn_dim)$")


@pytest.fixture(scope="module")
def bench():
    path = os.path.join(REPO, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    with open(path) as f:
        return json.load(f)


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(bench["command"]) <= 32 and all(line(w) for w in bench["command"])
    assert bench["paths"] == ["benchmark"]
    for word in bench["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        if os.sep in word:
            assert word.startswith("benchmark/") and os.path.exists(os.path.join(REPO, word))


def test_names_units_and_entry_keys(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line(c["source"]) and line(c["why"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            extra = {"bound"} if kind == "end_to_end" else {"layer", "moves"}
            assert set(m) - {"workloads"} == {"name", "unit", "better", "source"} | extra
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
            names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    for kind in ("configs", "workloads"):
        ns = [x["name"] for x in bench[kind]]
        assert len(ns) == len(set(ns))
    ms = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(ms) == len(set(ms))


def test_every_named_file_is_there(bench):
    for c in bench["configs"]:
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert not any(WIDTH.search(k) for k in c["reduced"])
        assert os.path.exists(os.path.join(BENCH, "reference", cfg["reference"] + ".py"))
    for w in bench["workloads"]:
        with open(os.path.join(BENCH, "workloads", w["name"] + ".json")) as f:
            mix = json.load(f)
        assert os.path.exists(os.path.join(BENCH, "drivers", mix["driver"] + ".py"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics", m["name"] + ".py"))


def test_metrics_bounds_and_cells(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells and line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for c in cells:
        reported = [m for m in bench["end_to_end"] if c in m.get("workloads", [c])]
        assert len(reported) >= 2
        assert any(c in m.get("workloads", [c]) for m in bench["per_layer"])
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(cells) // 4)


def test_check_fits_its_time_with_24_cells(bench):
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200
