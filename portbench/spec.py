"""Finds a cell's files by name.

``BENCHMARK.json`` (at the root of the checkout) lists the cells, the
configurations and the metrics. Every other part sits in a file of its
own under this folder, found by the name the entry gives:

- ``configs/<config>.json``: a deployment (camera, sequence, pipeline
  settings, motion, scene), with its source, what was assumed and cut;
- ``traffic/<traffic>.json``: how the window drives the program, with
  its ``entry``;
- ``entries/<entry>.py``: the ``Driver`` that drives an entry point of
  the program (``drive.py`` has what drivers share);
- ``cells/<cell>.json``: what belongs to one cell (a live rate, the
  judge's sample and its limits);
- ``metrics/<metric>.py``: the reader of one per-layer metric.

A later cell, configuration, traffic mix or metric is new files and new
entries; no file here needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    cell: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name) and m["moves"] in moved]
    return Cell(
        name=name,
        config=load_json(root / config_entry["file"]),
        traffic=load_json(root / HERE.name / "traffic" / f"{entry['traffic']}.json"),
        cell=load_json(root / HERE.name / "cells" / f"{name}.json"),
        chips=int(entry["chips"]),
        end_to_end=e2e,
        per_layer=per_layer,
    )


def _load(folder: str, name: str, root: Path):
    """The module of ``<folder>/<name>.py`` under ``root``, loaded once."""
    path = (root / HERE.name / folder / f"{name}.py").resolve()
    key = f"portbench_{folder}_{name.replace('.', '_')}@{path}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules[key] = module
    return sys.modules[key]


def reader(metric: str, root: Path = ROOT):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    return _load("metrics", metric, root).read


def driver(entry: str, root: Path = ROOT):
    """The ``Driver`` class of ``entries/<entry>.py``."""
    return _load("entries", entry, root).Driver


def names_ok(bench: dict) -> Dict[str, str]:
    """Every name and unit of ``bench`` that breaks the character rules."""
    bad = {}
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for item in bench[key]:
            if not NAME.match(item["name"]):
                bad[item["name"]] = "name"
            if "unit" in item and not UNIT.match(item["unit"]):
                bad[item["name"]] = "unit"
    for w in bench["workloads"]:
        for k in ("config", "traffic"):
            if not NAME.match(w[k]):
                bad[w[k]] = k
    for c in bench["configs"]:
        for k in c["reduced"]:
            if not NAME.match(k):
                bad[k] = "reduced"
    return bad
