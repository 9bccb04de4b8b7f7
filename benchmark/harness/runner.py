"""One run of one cell: set-up, the measured window, the traced stretch and
the per-layer metrics, then, with the program's state freed, the check
against the reference; returns the result line's object.
"""

import gc
import os
import time

import torch

from benchmark.harness import seeds as seeds_lib
from benchmark.harness.devtrace import Stretch
from benchmark.harness.peaks import peaks_for
from benchmark.harness.registry import Registry


def _process_start():
    """The wall-clock time this process started, from /proc where there is
    one; else the time this module was first imported."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


class Run:
    """What a client and a reader see of the run. ``overrides`` (nested
    dicts laid over the configuration and the traffic mix) and
    ``program_hook`` (called with the client once the program holds its
    weights) serve the CPU tests and ``controls.py``; ``run.py`` passes
    neither."""

    def __init__(self, registry, cell, seed, device, overrides=None,
                 program_hook=None):
        overrides = overrides or {}
        self.cell = registry.workload(cell)
        self.config = _merged(registry.config(self.cell["config"]),
                              overrides.get("config", {}))
        self.traffic = _merged(registry.traffic(self.cell["traffic"]),
                               overrides.get("traffic", {}))
        self.family = registry.family(self.config)
        self.seeds = seeds_lib.derive(seed)
        self.device = torch.device(device)
        self.program_hook = program_hook
        self.limits = dict(self.cell["checks"])


def _merged(base, changes):
    out = dict(base)
    for key, value in changes.items():
        out[key] = (_merged(out[key], value)
                    if isinstance(value, dict) and isinstance(out.get(key),
                                                              dict)
                    else value)
    return out


class Observation:
    """What a per-layer metric's reader reads: the run, the window's
    totals (``window``: units, seconds, ...), the traced stretch's
    ``trace`` (``devtrace.Summary``) and the card's ``peaks``."""

    def __init__(self, run, window, trace, peaks):
        self.run = run
        self.config = run.config
        self.family = run.family
        self.window = window
        self.trace = trace
        self.peaks = peaks


def device_name(device):
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def run_cell(cell, seed, seconds, trace, device="cuda", registry=None,
             overrides=None, program_hook=None):
    """The result object of one run (see run.py)."""
    registry = registry or Registry()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = Run(registry, cell, seed, device, overrides, program_hook)
    client = registry.client(run.traffic)(run)
    stretch = Stretch() if trace else None
    if stretch is not None:
        stretch.warm(run.device)
    client.setup()
    setup_s = time.time() - _process_start()
    try:
        window = client.window(seconds, stretch)
    finally:
        if stretch is not None:
            stretch.close()
    peak = (torch.cuda.max_memory_allocated(run.device)
            if run.device.type == "cuda" else 0)
    kind = device_name(run.device)
    metrics = {}
    if trace:
        stretch.finish()
        obs = Observation(run, window, stretch.summary, peaks_for(kind))
        for spec in registry.cell_metrics(run.cell["name"], "per_layer"):
            value = registry.reader(spec["name"])(obs)
            if value is not None:
                metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    else:
        values = dict(window["metrics"], setup_s=setup_s)
        for spec in registry.cell_metrics(run.cell["name"], "end_to_end"):
            metrics[spec["name"]] = {"value": values[spec["name"]],
                                     "unit": spec["unit"]}
    client.release()
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    readings = client.check()
    checks = {name: {"value": readings[name], "limit": limit}
              for name, limit in run.limits.items()}
    correct = (window["attempted"] > 0 and window["failed"] == 0
               and all(c["limit"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()))
    result = {
        "correct": correct,
        "attempted": window["attempted"],
        "failed": window["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if run.device.type == "cuda"
                   else run.device.type,
                   "kind": kind, "count": run.cell["chips"],
                   "memory_peak_bytes": int(peak)},
    }
    if trace:
        summary = stretch.summary
        result["device"].update(busy_s=summary.busy_s,
                                window_s=summary.window_s)
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = checks
    return result
