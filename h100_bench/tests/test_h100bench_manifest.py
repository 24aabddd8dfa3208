"""BENCHMARK.json against its contract, and discovery of a cell by its files."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from h100_bench.core import manifest as mf

from .conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_keys_and_names(bench):
    assert list(bench) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for p in bench["paths"]:
        assert (REPO / p).is_dir() and not p.startswith("/") and ".." not in p


def test_end_to_end_and_bounds(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert set(e2e) == {"train_samples_per_s", "render_rays_per_s", "setup_s"}
    assert "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_every_cell_is_complete(bench):
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(bench["workloads"]) // 4)
    for w in bench["workloads"]:
        spec = mf.cell_spec(bench, w["name"])
        e2e = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2 and spec["per_layer"]
        for m in spec["per_layer"]:
            assert m["moves"] in e2e
            assert callable(mf.load_reader(m["name"]))
        assert callable(mf.load_driver(spec["traffic"]["driver"]).Cell)
        assert len(w["why"]) <= 200
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert (REPO / c["file"]).is_file() and c["file"].startswith("h100_bench/")
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == c["reduced"]


def test_per_layer_layers_are_named_alike(bench):
    layers = {m["layer"] for m in bench["per_layer"]}
    assert layers <= {"train step", "render loss", "act loop", "policy", "field", "kernels",
                      "device"}
    for m in bench["per_layer"]:
        if "_roofline" in m["name"]:
            assert m["unit"] == "%"


def test_a_cell_added_as_files_is_found(tmp_path, bench):
    """A new cell, configuration, traffic mix, driver and metric added as
    files and manifest entries is found by name, and no file that was there
    changes."""
    root = tmp_path / "root"
    shutil.copytree(REPO / "h100_bench", root / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "h100_bench").rglob("*") if p.is_file()}
    b = json.loads(json.dumps(bench))
    (root / "h100_bench" / "configs" / "dummy.json").write_text(
        json.dumps({"reduced": [], "program": {}}))
    (root / "h100_bench" / "traffic" / "dummy.steady.json").write_text(
        json.dumps({"driver": "dummy_steady", "work": 3}))
    (root / "h100_bench" / "drivers" / "dummy_steady.py").write_text(
        "class Cell:\n"
        "    def __init__(self, spec, seed, device):\n"
        "        self.work = spec['traffic']['work']\n")
    (root / "h100_bench" / "metrics" / "dummy.count.py").write_text(
        "def read(ctx):\n    return 7.0\n")
    b["configs"].append({"name": "dummy", "source": "https://example.org/dummy",
                         "file": "h100_bench/configs/dummy.json", "reduced": [], "why": "test"})
    b["workloads"].append({"name": "dummy.steady", "config": "dummy", "traffic": "dummy.steady",
                           "chips": 1, "why": "test"})
    b["end_to_end"].append({"name": "dummy_per_s", "unit": "1/s", "better": "higher",
                            "bound": 0.05, "source": "host_clock", "workloads": ["dummy.steady"]})
    b["per_layer"].append({"name": "dummy.count", "unit": "1", "better": "higher",
                           "source": "program_counter", "layer": "device",
                           "moves": "dummy_per_s", "workloads": ["dummy.steady"]})
    spec = mf.cell_spec(b, "dummy.steady", root)
    assert {m["name"] for m in spec["end_to_end"]} == {"dummy_per_s", "setup_s"}
    assert [m["name"] for m in spec["per_layer"]] == ["dummy.count"]
    cell = mf.load_driver(spec["traffic"]["driver"], spec["bench"]).Cell(spec, 1, "cpu")
    assert cell.work == 3
    assert mf.load_reader("dummy.count", spec["bench"])(None) == 7.0
    for p, data in before.items():
        assert p.read_bytes() == data
    # the cells that were there are found as before
    assert mf.cell_spec(b, "nerfact.train", root)["traffic"]["driver"] == "nerfact_train"
