"""Cells, configurations, traffic and per-layer metrics are found by name,
and a new one is a new file; BENCHMARK.json agrees with the files."""

import json
import os
import shutil
import sys

import pytest

from trackbench import harness, spec
from trackbench.tests.tiny import tiny_run

REPO = os.path.dirname(spec.ROOT)


def test_cells_configs_and_traffic_are_found_by_name():
    cell = spec.load_cell("classical.s8")
    assert cell.cell["config"] == "classical_ycbineoat" and cell.config["name"] == "classical_ycbineoat"
    assert cell.traffic["streams"] == 8
    assert spec.load_cell("lfnet.s8").config["tracker"]["frontend"]["kind"] == "lfnet"
    with pytest.raises(SystemExit):
        spec.load_cell("no.such.cell")


def test_a_cell_added_as_a_data_file_alone_is_picked_up_and_runs(tmp_path, monkeypatch):
    for kind in ("configs", "workloads", "traffic", "weights"):
        shutil.copytree(os.path.join(spec.ROOT, kind), tmp_path / kind)
    doc = json.load(open(tmp_path / "workloads" / "classical.s8.json"))
    traffic = json.load(open(tmp_path / "traffic" / "orbit_s8.json"))
    json.dump(dict(traffic, streams=4, directions=[1, -1, 1, -1]), open(tmp_path / "traffic" / "orbit_s4.json", "w"))
    json.dump(dict(doc, traffic="orbit_s4"), open(tmp_path / "workloads" / "classical.s4.json", "w"))
    monkeypatch.setattr(spec, "ROOT", str(tmp_path))
    assert spec.load_cell("classical.s4").traffic["streams"] == 4
    res = tiny_run("classical.s4")
    assert res["correct"] and res["attempted"] % 2 == 0  # TINY cuts it to 2 streams


def test_a_metric_added_as_a_file_alone_is_read(tmp_path, monkeypatch):
    import trackbench.metrics as pkg

    pkg_dir = tmp_path / "extra"
    pkg_dir.mkdir()
    (pkg_dir / "frames_traced.py").write_text(
        'NAME, UNIT, BETTER, SOURCE = "frames_traced", "frames", "higher", "device_trace"\n'
        'LAYER, MOVES, WORKLOADS = "device", "frames_per_s", ["classical.s8"]\n'
        'def read(ctx):\n    return ctx["trace"].frames\n')
    monkeypatch.setattr(pkg, "__path__", list(pkg.__path__) + [str(pkg_dir)])
    monkeypatch.setitem(sys.modules, "trackbench.metrics.frames_traced", None)
    sys.modules.pop("trackbench.metrics.frames_traced")
    names = [m.NAME for m in harness.metric_readers("classical.s8")]
    assert "frames_traced" in names and "frames_traced" not in [m.NAME for m in harness.metric_readers("lfnet.s8")]
    res = tiny_run(trace=True)
    assert res["metrics"]["frames_traced"]["value"] == 2
    sys.modules.pop("trackbench.metrics.frames_traced", None)


def test_benchmark_json_agrees_with_the_files():
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["trackbench"]
    configs = {c["name"]: c for c in bench["configs"]}
    for name, c in configs.items():
        doc = json.load(open(os.path.join(REPO, c["file"])))
        assert doc["name"] == name and doc["source"] == c["source"] and doc["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.cell["config"] == w["config"] and cell.cell["traffic"] == w["traffic"]
        assert w["config"] in configs and w["chips"] == cell.cell["chips"] == 1
    assert {m["name"] for m in bench["end_to_end"]} == {"frames_per_s", "frame_ms_p95", "peak_mem_gib", "setup_s"}
    readers = {m.NAME: m for m in harness.metric_readers("classical.s8") + harness.metric_readers("lfnet.s8")}
    assert {m["name"] for m in bench["per_layer"]} == set(readers)
    for m in bench["per_layer"]:
        r = readers[m["name"]]
        assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == \
            (r.UNIT, r.BETTER, r.SOURCE, r.LAYER, r.MOVES)
        assert m.get("workloads") == r.WORKLOADS


def test_the_frozen_weights_are_the_ones_the_configuration_records(tmp_path):
    config = spec.load_cell("lfnet.s8").config
    path = spec.weights_path(config)
    shipped = os.path.join(REPO, "checkpoints", "lfnet_params.npz")
    if os.path.isfile(shipped):  # the copy was taken from the repo's checkpoint
        assert open(shipped, "rb").read() == open(path, "rb").read()
    changed = tmp_path / "lfnet_params.npz"
    data = open(path, "rb").read()
    changed.write_bytes(data[:-1] + bytes([data[-1] ^ 1]))
    with pytest.raises(SystemExit):
        spec.weights_path(dict(config, lfnet_weights=str(changed)))
