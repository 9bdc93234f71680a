"""Find a cell and everything that belongs to it by the names in
``BENCHMARK.json``: its configuration file, its traffic file, its limits
and the readers of its per-layer metrics. Nothing here names a cell."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file, as run
    traffic: dict         # the traffic file
    limits: dict          # {number: limit} of the comparison
    end_to_end: List[dict]
    per_layer: List[dict]
    root: str = ROOT      # the checkout that holds BENCHMARK.json

    @property
    def family(self) -> str:
        return self.config["family"]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError("no workload %r in BENCHMARK.json (%s)"
                       % (name, ", ".join(sorted(work))))
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    here = os.path.join(root, "portbench")
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(os.path.join(root, conf["file"])),
        traffic=load_json(os.path.join(here, "traffic",
                                       w["traffic"] + ".json")),
        limits=load_json(os.path.join(here, "limits", name + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        root=root)


Reader = Callable[["object"], Optional[float]]


def load_reader(metric: str, root: str = ROOT) -> Reader:
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = os.path.join(root, "portbench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def readers(cell: Cell, root: str = ROOT) -> Dict[str, Reader]:
    return {m["name"]: load_reader(m["name"], root) for m in cell.per_layer}
