"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<c>`` is an entry of ``workloads``; its traffic mix, window and
correctness limits sit in ``workloads/<c>.json``, its configuration in
the file the ``configs`` entry names (``configs/<config>.json``), and
each metric's reader in ``metrics/<metric>.py``, a module with
``read(run) -> float | None``, and each limit that the judge does not
compute itself in ``reference/checks/<limit>.py``.  Adding a cell, a
configuration, a metric or a check adds files and entries; no file here
changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class Manifest:
    """The benchmark's manifest, with ``bench_dir`` the folder that holds
    ``configs/``, ``workloads/`` and ``metrics/`` (this one by
    default)."""

    def __init__(self, path: Path, bench_dir: Path = HERE):
        self.path = Path(path)
        self.bench_dir = Path(bench_dir)
        self.data = json.loads(self.path.read_text())
        self.checkout = self.path.parent

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no cell {name!r} in {self.path}")

    def config_entry(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no configuration {name!r} in {self.path}")

    def config_file(self, cell: dict) -> dict:
        entry = self.config_entry(cell["config"])
        return json.loads((self.checkout / entry["file"]).read_text())

    def workload_file(self, cell: dict) -> dict:
        return json.loads((self.bench_dir / "workloads"
                           / f"{cell['name']}.json").read_text())

    def metrics_of(self, cell: dict, kind: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
        return [m for m in self.data[kind]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def reader(self, metric: dict):
        """The ``read`` function of ``metrics/<name>.py``."""
        return _load(self.bench_dir / "metrics" / f"{metric['name']}.py",
                     "bench_metric_" + metric["name"]).read

    def check(self, name: str):
        """The module of ``reference/checks/<name>.py``: ``tap(prog)``
        (optional: called once set-up has ended, before the window),
        ``observe(prog, run, stream) -> dict`` (after the window, before
        the program is freed) and ``compare(obs, stream, cfg, workload,
        control) -> float``.  A name without its file raises."""
        path = self.bench_dir / "reference" / "checks" / f"{name}.py"
        if not NAME.match(name) or not path.is_file():
            raise KeyError(f"limit {name!r}: no check of the judge's own "
                           f"and no reference/checks/{name}.py")
        return _load(path, "bench_check_" + name)


def _load(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(
        module_name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
