"""Find everything a cell needs by the names in BENCHMARK.json: its
configuration file, its traffic file (whose `driver` names the module in
drivers/), and the reader of each of its metrics (metrics/<name>.py). A
later cell, configuration or metric is added as files and entries; no file
here names one."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_manifest(path: Optional[Path] = None) -> dict:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(manifest: dict, workload: str, root: Optional[Path] = None) -> dict:
    """The cell `workload`: its manifest entry, configuration (the file's
    content), traffic (the file's content), and the names of the end-to-end
    and per-layer metrics it reports, each with its manifest entry."""
    root = root or ROOT
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in the manifest")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    bench = root / manifest["paths"][0]
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if workload in m.get("workloads", ())
             or ("workloads" not in m and m["moves"] in e2e_names)]
    return {"workload": w, "config_entry": cfg_entry, "bench": bench,
            "config": _load_json(root / cfg_entry["file"]),
            "traffic": _load_json(bench / "traffic" / f"{w['traffic']}.json"),
            "end_to_end": e2e, "per_layer": layer}


def _load_file(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(name: str, bench: Optional[Path] = None):
    """drivers/<name>.py, by the traffic file's `driver`."""
    return _load_file((bench or BENCH_DIR) / "drivers" / f"{name}.py",
                      f"h100_bench.drivers.{name}")


def load_reader(metric: str, bench: Optional[Path] = None) -> Callable:
    """The `read(ctx)` of metrics/<metric>.py."""
    return _load_file((bench or BENCH_DIR) / "metrics" / f"{metric}.py",
                      "h100_bench.metrics." + metric.replace(".", "_").replace("-", "_")).read
