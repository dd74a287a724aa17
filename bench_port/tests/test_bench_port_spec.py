"""BENCHMARK.json against the contract's shape, and every cell, config and
metric found by name in its own file."""

import json
import re
import shutil

import pytest

from bench_port import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_port"]
    assert BENCH["command"] == ["python3", "bench_port/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k)
                                             for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        for cell in m.get("workloads", ()):
            assert cell in CELLS
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = harness.load_cell(cell)
    assert hasattr(harness.job_module(c), "Job")
    assert callable(harness.plugins.load(
        "scenes", c.config["scene"]["generator"]).arrays)
    assert callable(harness.plugins.load(
        "samplers", c.workload["sampling"]["kind"]).draw)
    assert c.config["name"] == c.workload["config"]
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_resolves(metric):
    assert callable(harness.metric_reader(metric))


def test_new_cell_and_metric_found_by_name(tmp_path):
    """A later cell or metric is new files plus new entries: the harness
    finds them by name without an edit."""
    base = tmp_path / "bench_port"
    shutil.copytree(harness.HERE / "workloads", base / "workloads")
    shutil.copytree(harness.HERE / "metrics", base / "metrics")
    shutil.copytree(harness.HERE / "configs", base / "configs")
    bench = json.loads(json.dumps(BENCH))
    w = json.loads((base / "workloads" / "hall720-bvh.frames.json")
                   .read_text())
    w["name"] = "hall720-bvh.frames-independent"
    w["sampling"] = {"kind": "independent"}
    (base / "workloads" / f"{w['name']}.json").write_text(json.dumps(w))
    (base / "metrics" / "units.frame.py").write_text(
        "def read(trace):\n    return float(trace.n)\n")
    bench["workloads"].append({"name": w["name"], "config": "hall720-bvh",
                               "traffic": "frames-independent", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "units.frame", "unit": "frames",
                               "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "frame_ms",
                               "workloads": [w["name"]]})
    for m in bench["end_to_end"]:
        if "frame_ms" in m["name"]:
            m["workloads"].append(w["name"])
    for c in bench["configs"]:
        c["file"] = str(base / "configs" / f"{c['name']}.json")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell(w["name"], root=tmp_path, base=base)
    assert cell.workload["sampling"] == {"kind": "independent"}
    assert [m["name"] for m in cell.per_layer] == ["units.frame"]
    read = harness.metric_reader("units.frame", base=base)
    assert read(type("T", (), {"n": 4})()) == 4.0


#: a new part of each kind, as a later PR would add it: the file's body
NEW_PARTS = {
    "scenes": ("tiny", "def arrays(spec):\n    return {'n': spec['n']}\n"),
    "samplers": ("flat", "def draw(spec, render, gen, device):\n"
                         "    return ('cam', spec['value'])\n"),
    "jobs": ("idle", "def build(config, arrays, dev):\n    return 'prog'\n"
                     "class Job:\n    def __init__(self, cell, prog, seed):\n"
                     "        self.prog = prog\n"),
}


@pytest.mark.parametrize("folder", sorted(NEW_PARTS))
def test_new_part_found_by_name(tmp_path, folder):
    """A later scene generator, sampler or job is a new file: the harness
    finds it by the name a configuration or workload gives."""
    from bench_port import sampling
    name, body = NEW_PARTS[folder]
    (tmp_path / folder).mkdir()
    (tmp_path / folder / f"{name}.py").write_text(body)
    cell = harness.Cell("x.y", {"job": name, "sampling": {"kind": name,
                                                         "value": 7}},
                        {"scene": {"generator": name, "n": 3}}, [], [],
                        tmp_path)
    if folder == "scenes":
        assert harness.scene_arrays(cell) == {"n": 3}
    elif folder == "samplers":
        assert sampling.frame_samples(cell.workload["sampling"], {}, None,
                                      None, tmp_path) == ("cam", 7)
    else:
        assert harness.build_program(cell, {}, None) == "prog"
        assert harness.job_module(cell).Job(cell, "prog", 1).prog == "prog"
