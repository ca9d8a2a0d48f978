"""``BENCHMARK.json`` and the files it names: each cell's configuration,
traffic mix and metric readers, found by name."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no config {name!r}")


def traffic(name: str, bench_dir: Path = BENCH) -> dict:
    return json.loads((bench_dir / "traffic" / f"{name}.json").read_text())


def metrics_of(bench: dict, workload: str, traced: bool) -> List[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end ones
    untraced, its per-layer ones traced."""
    def listed(m):
        return "workloads" not in m or workload in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if listed(m)]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if listed(m) and m["moves"] in names]


def reader(name: str, bench_dir: Path = BENCH) -> Callable:
    """``read(run)`` of ``bench/metrics/<name>.py``."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def problems(bench: dict, root: Path = ROOT) -> List[str]:
    """What in ``bench`` breaks the benchmark's contract, as far as the
    files can show it (empty when nothing does)."""
    out = []
    keys = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
    if set(bench) != keys:
        out.append(f"top-level keys {sorted(bench)}")
    if not 1 <= bench.get("run_seconds", 0) <= 51:
        out.append("run_seconds")
    names = set()
    for c in bench["configs"]:
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            out.append(f"config keys {sorted(c)}")
        if not NAME.match(c["name"]) or c["name"] in names:
            out.append(f"config name {c['name']}")
        names.add(c["name"])
        f = root / c["file"]
        if not f.exists() or not any(
                Path(c["file"]).parts[0] == Path(p).parts[0]
                for p in bench["paths"]):
            out.append(f"config file {c['file']}")
        else:
            data = json.loads(f.read_text())
            if sorted(data.get("reduced", [])) != sorted(c["reduced"]):
                out.append(f"{c['name']}: reduced differs from its file")
    cells = set()
    for w in bench["workloads"]:
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            out.append(f"workload keys {sorted(w)}")
        if not NAME.match(w["name"]) or w["name"] in cells:
            out.append(f"workload name {w['name']}")
        cells.add(w["name"])
        if w["config"] not in names or w["chips"] not in (1, 4):
            out.append(f"workload {w['name']}")
        if not (1 <= len(w["why"]) <= 200) or "\n" in w["why"]:
            out.append(f"why of {w['name']}")
        if not (BENCH / "traffic" / f"{w['traffic']}.json").exists():
            out.append(f"traffic {w['traffic']}")
    metric_names = set()
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            allowed = ({"name", "unit", "better", "bound", "source"}
                       if kind == "end_to_end" else
                       {"name", "unit", "better", "source", "layer",
                        "moves"})
            if set(m) - {"workloads"} != allowed:
                out.append(f"metric keys {m['name']}: {sorted(m)}")
            if not NAME.match(m["name"]) or m["name"] in metric_names:
                out.append(f"metric name {m['name']}")
            metric_names.add(m["name"])
            if not UNIT.match(m["unit"]) or m["better"] not in (
                    "lower", "higher") or m["source"] not in SOURCES:
                out.append(f"metric {m['name']}")
            if kind == "end_to_end" and (
                    m["source"] not in ("host_clock", "device_trace")
                    or not 0.01 <= m["bound"] <= 0.25):
                out.append(f"end-to-end metric {m['name']}")
            if not (BENCH / "metrics" / f"{m['name']}.py").exists():
                out.append(f"no reader for {m['name']}")
            for wl in m.get("workloads", []):
                if wl not in cells:
                    out.append(f"{m['name']} lists {wl}")
    e2e = {m["name"] for m in bench["end_to_end"]}
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for m in bench["per_layer"]:
        if m["moves"] not in e2e:
            out.append(f"{m['name']} moves {m['moves']}")
    used = {w["config"] for w in bench["workloads"]}
    if used != names:
        out.append(f"configs without a cell: {sorted(names - used)}")
    return out
