"""A cell of ``BENCHMARK.json`` and the files it names, found by name.

- the configuration: the ``file`` its entry names
  (``perfbench/configs/<config>.json``);
- the traffic mix: ``perfbench/traffic/<traffic>.json``, a data file
  whose ``loop`` names the loop the window drives,
  ``perfbench/loops/<loop>.py`` (its set-up, its call and the units a
  call counts, what it keeps and how the kept outputs are judged);
- the limits of the comparison that decides ``correct``:
  ``perfbench/limits/<cell>.json``;
- each metric, end-to-end or per-layer: a reader
  ``perfbench/metrics/<metric>.py`` whose ``read(run)`` returns the
  number or None;
- the configuration's ``family`` names its plain reference
  (``perfbench/reference/<family>.py``) and its counts of work
  (``perfbench/counts/<family>.py``).

A new configuration, mix, cell or metric is new files and entries; no
file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass
class Cell:
    name: str
    base: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict] = field(default_factory=list)
    per_layer: list[dict] = field(default_factory=list)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: str) -> Cell:
    """The cell ``name`` of the ``BENCHMARK.json`` at ``root``."""
    spec = benchmark(root)
    by_name = {w["name"]: w for w in spec["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r}; have {sorted(by_name)}")
    w = by_name[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _load_json(os.path.join(root, configs[w["config"]]["file"]))
    base = os.path.join(root, spec["paths"][0])
    traffic = _load_json(os.path.join(base, "traffic", f"{w['traffic']}.json"))
    limits = _load_json(os.path.join(base, "limits", f"{name}.json"))
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    layer = [m for m in spec["per_layer"] if _reports(m, name)]
    return Cell(name, base, w, config, traffic, limits, e2e, layer)


def _from_file(kind: str, name: str, base: str):
    path = os.path.join(base, kind, f"{name}.py")
    mod_name = f"perfbench_{kind}_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, base: str = HERE):
    """The ``read`` function of ``<base>/metrics/<metric>.py``."""
    return _from_file("metrics", metric, base).read


def loop(name: str, base: str = HERE):
    """The loop module ``<base>/loops/<name>.py``."""
    return _from_file("loops", name, base)


def module(package: str, name: str):
    """``perfbench/<package>/<name>.py`` as a module (a configuration's
    reference or its counts)."""
    return importlib.import_module(f"{package}.{name}")
