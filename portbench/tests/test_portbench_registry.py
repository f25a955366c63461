"""BENCHMARK.json keeps to the benchmark's contract, every file it names is
found by name, and a configuration, a traffic mix, a cell's limits and a
per-layer metric are each added as new files, with no edit to a file that
is already there."""
import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import harness
from portbench.tests import cells

ROOT = Path(harness.ROOT)
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_lines():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    assert len({x["name"] for x in SPEC["end_to_end"] + SPEC["per_layer"]}) \
        == len(SPEC["end_to_end"]) + len(SPEC["per_layer"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in SPEC["configs"] + SPEC["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]


def test_configs_are_found_and_state_what_they_cut():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert all(k in cfg for k in c["reduced"])
        assert len(c["source"]) <= 200


def test_cells():
    configs = {c["name"] for c in SPEC["configs"]}
    assert len(CELLS) == len(set(CELLS))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {w["config"] for w in SPEC["workloads"]} == configs
    four = [w for w in SPEC["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(CELLS) // 4)


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in SPEC["end_to_end"]
                if m["name"] == "setup_s")["bound"] == 0.25


@pytest.mark.parametrize("cell", cells.CELLS)
def test_every_file_of_a_cell_is_found(cell):
    reg = cells.registry()
    c = reg.cell(cell)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names
        assert callable(reg.reader(m["name"]))
    assert c.limits and c.traffic["entry"]


def test_throwaway_entries_are_new_files(tmp_path, run_small):
    """A new configuration, traffic mix, cell and per-layer metric: the
    harness finds each by its name, and no file it already has changes."""
    bench = tmp_path / harness.HERE.name
    for sub in ("configs", "traffic", "limits", "layer_metrics"):
        shutil.copytree(harness.HERE / sub, bench / sub)
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((bench / "configs" / "rgb1080p_420_q75.json").read_text())
    (bench / "configs" / "tiny_444_q90.json").write_text(json.dumps(
        dict(cfg, height=40, width=56, subsampling="444", quality=90)))
    (bench / "traffic" / "tiny_batch3.json").write_text(json.dumps(
        {"entry": "encode_batch", "source": "host", "frames_per_call": 3,
         "sample_images": 2}))
    (bench / "limits" / "tiny_444_q90.tiny_batch3.json").write_text(
        json.dumps({"files_unlike_reference_coding": 0,
                    "coef_diff_frac": 1e-5, "coef_max_abs": 1}))
    (bench / "layer_metrics" / "calls_per_s.py").write_text(
        "def read(ctx):\n    return ctx.calls / ctx.window_s\n")
    spec["configs"].append({"name": "tiny_444_q90", "source": "a test",
                            "file": "portbench/configs/tiny_444_q90.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "tiny_444_q90.tiny_batch3",
                              "config": "tiny_444_q90",
                              "traffic": "tiny_batch3", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({"name": "calls_per_s.tiny", "unit": "1/s",
                              "better": "higher", "source": "host_clock",
                              "layer": "API", "moves": "encode_mpix_per_s",
                              "workloads": ["tiny_444_q90.tiny_batch3"]})
    for m in spec["end_to_end"]:
        if m["name"] == "encode_mpix_per_s":
            m["workloads"].append("tiny_444_q90.tiny_batch3")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    reg = harness.Registry(tmp_path)
    cell = reg.cell("tiny_444_q90.tiny_batch3")
    assert [m["name"] for m in cell.end_to_end] == ["setup_s",
                                                    "encode_mpix_per_s"]
    e2e = run_small(cell, registry=reg)
    assert e2e["correct"] and set(e2e["metrics"]) == {"setup_s",
                                                      "encode_mpix_per_s"}
    traced = run_small(cell, trace=True, registry=reg)
    assert traced["correct"] and traced["metrics"]["calls_per_s.tiny"][
        "value"] > 0
    assert all(p.read_bytes() == b for p, b in before.items())


def test_left_out_cells_are_apart_and_complete():
    """`left_out.json`'s cells, configurations and metrics are not in
    BENCHMARK.json, and with them added the whole still keeps the
    contract's shape: each cell reports setup_s and another end-to-end
    metric, and each configuration is used by a cell."""
    left = json.loads((harness.HERE / "left_out.json").read_text())
    for key in ("configs", "workloads", "per_layer"):
        assert not {x["name"] for x in left[key]} & \
            {x["name"] for x in SPEC[key]}
    merged = cells.spec()
    used = {w["config"] for w in merged["workloads"]}
    assert used == {c["name"] for c in merged["configs"]}
    for name in cells.CELLS:
        e2e = [m["name"] for m in merged["end_to_end"]
               if name in m.get("workloads", [name])]
        assert "setup_s" in e2e and len(e2e) >= 2
    assert set(cells.CELLS) == set(CELLS) | \
        {w["name"] for w in left["workloads"]}
