"""What a cell is made of, found by name: its entry in ``BENCHMARK.json``,
its configuration file (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), its family's reference and counts
(``reference/<family>.py``, ``counts/<family>.py``) and the per-layer
metric readers (``metrics/<metric>.py``).  Adding any of these is adding a
file; nothing here names one.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

PKG = Path(__file__).resolve().parents[1]          # portbench/


@dataclasses.dataclass
class Cell:
    name: str
    root: Path                  # the checkout: BENCHMARK.json's directory
    workload: dict              # its BENCHMARK.json entry
    bench: dict                 # the whole BENCHMARK.json
    config: dict                # configs/<config>.json
    traffic: dict               # traffic/<traffic>.json

    @property
    def pkg(self) -> Path:
        return self.root / "portbench"

    @property
    def family(self) -> str:
        return self.config["family"]

    @property
    def pub(self) -> dict:
        """The published configuration, as the file holds it."""
        return self.config["config"]

    def reference(self) -> ModuleType:
        return importlib.import_module(f"portbench.reference.{self.family}")

    def counts(self) -> ModuleType:
        return importlib.import_module(f"portbench.counts.{self.family}")

    def metrics(self, kind: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
        return [m for m in self.bench[kind]
                if self.name in m.get("workloads", [self.name])]

    def reader(self, metric: str):
        """``read(run)`` of ``metrics/<metric>.py``."""
        path = self.pkg / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"portbench_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, name: str) -> Cell:
    bench = _load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(entries)}")
    w = entries[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(name=name, root=root, workload=w, bench=bench,
                config=_load_json(root / conf["file"]),
                traffic=_load_json(root / "portbench" / "traffic"
                                   / f"{w['traffic']}.json"))


def model_config(cell: Cell, overrides: Optional[Dict] = None):
    """The served model's ``ModelConfig``: the program's registered config
    of ``port.arch``, with every field the published config fixes
    (``reference.<family>.port_fields``), then the file's ``port.fields``
    (how it is served), then ``overrides`` (tests only)."""
    from repro_torch.configs import get_config
    base = get_config(cell.config["port"]["arch"])
    fields = dict(cell.reference().port_fields(cell.pub))
    fields.update(cell.config["port"].get("fields", {}))
    fields.update(overrides or {})
    for k, v in list(fields.items()):
        if isinstance(v, dict):       # a nested config group
            fields[k] = dataclasses.replace(getattr(base, k), **v)
    return dataclasses.replace(base, **fields)
