"""BENCHMARK.json against the benchmark's contract, and the files its
entries name, found by name."""

from __future__ import annotations

import json
import re
import shutil

from conftest import HERE, REPO, make_checkout

from portbench import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")


def _bench(root=REPO):
    return json.loads((root / "BENCHMARK.json").read_text())


def test_names_units_and_lines_use_the_allowed_characters():
    b = _bench()
    for entry in b["configs"] + b["workloads"] + b["end_to_end"] + b["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert LINE.match(w["why"]) and w["chips"] in (1, 4)
    for c in b["configs"]:
        assert LINE.match(c["source"]) and all(NAME.match(k) for k in c["reduced"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert LINE.match(m["layer"])
    for word in b["command"]:
        assert LINE.match(word)
    names = [e["name"] for e in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))


def test_every_cell_finds_its_files_and_readers():
    b = _bench()
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["per_layer"]:
        assert m["moves"] in e2e
    for w in b["workloads"]:
        cell = cells.load(w["name"])
        assert cell.config["name"] == w["config"] and cell.traffic
        assert {n for n, _ in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2
        assert cell.per_layer and cell.limits
        for name, _ in cell.end_to_end + cell.per_layer:
            assert callable(cells.reader(name))


def test_each_configuration_states_its_source_and_departures():
    for c in _bench()["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"]
        assert set(cfg["reduced"]) == set(c["reduced"])
        assert all(cfg["reduced"].values()) and all(cfg["assumed"].values())


def test_a_cell_added_from_new_files_alone_loads(tmp_path):
    """A new configuration, traffic mix, metric and cell: new files and new
    BENCHMARK.json entries, and no file of the benchmark edited."""
    root = make_checkout(tmp_path)
    before = {p: p.read_bytes() for p in (root / HERE.name).rglob("*") if p.is_file()}
    folder = root / HERE.name
    cfg = json.loads((folder / "configs" / "euroc_stereo_vio.json").read_text())
    cfg["name"] = "euroc_stereo_vio_dense"
    (folder / "configs" / "euroc_stereo_vio_dense.json").write_text(json.dumps(cfg))
    shutil.copy(folder / "limits" / "euroc_stereo_vio.json",
                folder / "limits" / "euroc_stereo_vio_dense.json")
    traffic = json.loads((folder / "traffic" / "replay.json").read_text())
    (folder / "traffic" / "dense.json").write_text(json.dumps({**traffic, "n_points": 800}))
    (folder / "metrics" / "frames_seen.py").write_text(
        "def read(rec):\n    return len(rec['latency_s'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "euroc_stereo_vio_dense", "source": "a test",
                             "file": f"{HERE.name}/configs/euroc_stereo_vio_dense.json",
                             "reduced": []})
    bench["workloads"].append({"name": "stereo_vio.dense", "config": "euroc_stereo_vio_dense",
                               "traffic": "dense", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "frames_seen", "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "a test",
                               "moves": "frames_per_s", "workloads": ["stereo_vio.dense"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cells.load("stereo_vio.dense", root)
    assert cell.traffic["n_points"] == 800 and cell.config["name"] == "euroc_stereo_vio_dense"
    assert ("frames_seen", "frames") in cell.per_layer
    assert cells.reader("frames_seen", root)({"latency_s": [0.1] * 7}) == 7
    assert ("frames_seen", "frames") not in cells.load("small_euroc_stereo_vio", root).per_layer
    for p, data in before.items():
        assert p.read_bytes() == data, p
