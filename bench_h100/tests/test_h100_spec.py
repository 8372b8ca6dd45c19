"""BENCHMARK.json against the contract the harness is built to, and the
harness finding every configuration, traffic mix and metric by name."""

import json
import os
import re

import pytest

from bench_h100 import run, spec

BENCH = spec.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_h100"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word


def test_names_units_and_keys():
    seen = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))
        assert c["file"].startswith("bench_h100/")
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for x in BENCH[group]:
            assert NAME.match(x["name"]), x["name"]
            assert x["name"] not in seen
            seen.add(x["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files_and_metrics(cell):
    c = spec.Cell(BENCH, cell)
    assert c.config["name"] == c.entry["config"]
    assert c.config["cards"] == c.chips
    assert "setup_s" in c.e2e and len(c.e2e) >= 2 and c.per_layer
    moves = {m["name"]: m["moves"] for m in BENCH["per_layer"]}
    for name in c.per_layer:
        assert moves[name] in c.e2e
    for name in c.e2e + c.per_layer:
        assert callable(spec.reader(name))
    assert set(c.config["limits"]) >= {"step", "row"}


# readers kept for a cell that waits: the boundary stage's, for a channel
# configuration from a published case (PERF.md, Open questions)
WAITING = {"boundary_us_per_stage"}


def test_every_metric_has_a_reader_and_every_reader_a_metric():
    names = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    files = {f[:-3] for f in os.listdir(os.path.join(spec.HERE, "metrics"))
             if f.endswith(".py") and f not in ("__init__.py", "common.py")}
    assert names == files - WAITING
    assert not names & WAITING


def test_arguments():
    a = run.parse(["--workload", CELLS[0], "--seed", str(2 ** 31 + 7),
                   "--seconds", "10", "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == (CELLS[0],
                                                         2 ** 31 + 7, 10, 1)
    with pytest.raises(SystemExit):
        run.parse(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "2"])
    with pytest.raises(KeyError):
        spec.Cell(BENCH, "no_such_cell")


def test_no_card_no_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                     "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""
