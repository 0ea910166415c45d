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
- ``metrics/<metric>.py``: the reader of one per-layer metric;
- ``checks/<number>.py``: a judged number that is not one of the core
  ``reference/judge.py::NUMBERS``, named by a key of a cell's
  ``limits``: ``judge(ctx)`` gives the program's number, ``control(ctx)``
  the same comparison with the reference in bfloat16 in the program's
  place.

A later cell, configuration, traffic mix, metric or judged number is new
files and new entries. The one edit to an entry already there: a new
cell's name appended to the ``workloads`` list of each metric it reports
(such as ``tracked_fps``).
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
    """The cell ``name`` of ``BENCHMARK.json`` with its files; raises
    before any set-up if a limit names neither a core number of the judge
    nor a file ``checks/<number>.py``."""
    from portbench.reference.judge import NUMBERS

    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name) and m["moves"] in moved]
    cell = load_json(root / HERE.name / "cells" / f"{name}.json")
    unknown = [k for k in cell["limits"] if k not in NUMBERS and not (root / HERE.name / "checks" / f"{k}.py").is_file()]
    if unknown:
        raise KeyError(f"cell {name!r} limits {unknown}: neither a core number of reference/judge.py nor a file checks/<number>.py")
    return Cell(
        name=name,
        config=load_json(root / config_entry["file"]),
        traffic=load_json(root / HERE.name / "traffic" / f"{entry['traffic']}.json"),
        cell=cell,
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


def check(number: str, root: Path = ROOT):
    """The module of ``checks/<number>.py``, with ``judge(ctx)`` and
    ``control(ctx)``."""
    return _load("checks", number, root)


def names_ok(bench: dict, root: Path = ROOT) -> Dict[str, str]:
    """Every name and unit of ``bench``, and every judged number that a
    cell's file limits or a file under ``checks/`` holds, that breaks the
    character rules."""
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
    numbers = [p.stem for p in (root / HERE.name / "checks").glob("*.py")]
    for w in bench["workloads"]:
        numbers += list(load_json(root / HERE.name / "cells" / f"{w['name']}.json")["limits"])
    for k in numbers:
        if not NAME.match(k):
            bad[k] = "check"
    return bad
