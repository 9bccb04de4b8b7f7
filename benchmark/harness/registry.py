"""Finds the parts of a run by name, one file each, under the benchmark's
folder:

    workloads/<cell>.json          the cell: configuration, traffic, chips,
                                   why, and the limits of its checks
    configs/<config>.json          the configuration: sizes, source, family
    models/<family>.py             the family's variables, FLOPs, makers
                                   and its reference binding
    traffic/<traffic>.json         the traffic mix: its client and the
                                   client's parameters
    traffic/<client>.py            the client (``Client`` class)
    layer_metrics/<metric>.py      a per-layer metric's reader (``read``)

and ``BENCHMARK.json`` one folder up, which says which metrics a cell
reports. Adding a cell, a configuration or a metric adds files and
entries; nothing here changes.
"""

import importlib.util
import json
import re
import sys
from pathlib import Path

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")

BENCH_DIR = Path(__file__).resolve().parent.parent


class Registry:
    """The parts under ``root`` (the benchmark's folder) and the
    ``BENCHMARK.json`` beside it (``spec``, or one read from ``root``'s
    parent)."""

    def __init__(self, root=BENCH_DIR, spec=None):
        self.root = Path(root)
        if spec is None:
            spec = json.loads((self.root.parent / "BENCHMARK.json")
                              .read_text())
        self.spec = spec

    @staticmethod
    def check_name(name):
        if not isinstance(name, str) or not NAME.match(name):
            raise ValueError(f"not a valid name: {name!r}")
        return name

    def _json(self, folder, name):
        path = self.root / folder / f"{self.check_name(name)}.json"
        if not path.is_file():
            raise FileNotFoundError(f"no {folder} named {name!r} ({path})")
        return json.loads(path.read_text())

    def _module(self, folder, name):
        path = self.root / folder / f"{self.check_name(name)}.py"
        if not path.is_file():
            raise FileNotFoundError(f"no {folder} module {name!r} ({path})")
        key = f"_bench_{folder}_{name}".replace(".", "_").replace("-", "_")
        if key in sys.modules:
            return sys.modules[key]
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module
        spec.loader.exec_module(module)
        return module

    def workload(self, name):
        cell = self._json("workloads", name)
        cell["name"] = name
        for key in ("config", "traffic"):
            self.check_name(cell[key])
        return cell

    def config(self, name):
        config = self._json("configs", name)
        config["name"] = name
        return config

    def family(self, config):
        return self._module("models", config["family"])

    def traffic(self, name):
        traffic = self._json("traffic", name)
        traffic["name"] = name
        return traffic

    def client(self, traffic):
        return self._module("traffic", traffic["client"]).Client

    def reader(self, metric):
        return self._module("layer_metrics", metric).read

    def cell_metrics(self, cell, kind):
        """The ``end_to_end`` or ``per_layer`` entries of BENCHMARK.json
        that ``cell`` reports: those that list it, and those that list no
        cells and move (or are) an end-to-end metric the cell reports."""
        e2e = [m for m in self.spec["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if kind == "end_to_end":
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in names)]
