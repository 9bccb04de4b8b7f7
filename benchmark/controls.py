"""Readings of a cell's checks for many seeds in one process: of the
program as the cell runs it, of the control, and of planted faults. The
limits in ``workloads/<cell>.json`` are set from these readings; the
benchmark's own runs do not run this.

    python3 benchmark/controls.py --workload <cell> --program 1-12 \
        --control 101-103 [--fault half_batch=201-203] [--seconds 3]

* program: the cell's set-up, a window of ``--seconds`` and its check;
* control: for a served cell the program with its int8 path switched on
  (``quantize_for_serving`` calibrated on four frames of the pool), the
  nearest precision below the bf16 the configuration states; for a
  training cell the reference computed with TF32 on, in the program's
  place (no window);
* faults (planted in the program before its first step or frame):
  ``half_batch`` (a train step on the first half of its batch),
  ``frozen_variables`` (a train step that advances the optimizer's state
  but returns the variables it was given) and ``altered_answer`` (a 32x32
  block of each fused frame's labels moved to the next class where the
  fusion produces them).

Each reading is printed as one JSON line; the last line sums up the
largest program reading and the least control and fault reading of each
number, and every limit beside them.
"""

import argparse
import json
import os
import sys
from pathlib import Path

if __name__ == "__main__":
    _root = Path(__file__).resolve().parent.parent
    if sys.path and Path(sys.path[0]).resolve() == Path(__file__).parent:
        sys.path.pop(0)
    sys.path.insert(0, str(_root))
    os.environ["USE_FLAX"] = "0"

import numpy as np
import torch

from benchmark.harness import compare
from benchmark.harness.registry import Registry
from benchmark.harness.runner import Run


def _half_batch(client):
    step = client.net._train_step

    def half(variables, opt_state, batch):
        return step(variables, opt_state,
                    {k: v[:v.shape[0] // 2] for k, v in batch.items()})

    client.net._train_step = half


def _frozen_variables(client):
    step = client.net._train_step

    def frozen(variables, opt_state, batch):
        _, opt_state, loss = step(variables, opt_state, batch)
        return variables, opt_state, loss

    client.net._train_step = frozen


def _altered_answer(client):
    fuse = client.net._fusion
    classes = client.config["num_classes"]

    def altered(expert_outputs):
        out = fuse(expert_outputs)
        block = out["prediction"][..., :32, :32]
        block.copy_((block + 1) % classes)
        return out

    client.net._fusion = altered


FAULTS = {"half_batch": _half_batch, "frozen_variables": _frozen_variables,
          "altered_answer": _altered_answer}


def _quantized(client):
    """Switch the served program to its int8 path, calibrated on four
    frames of the pool, and warm a new server up on it."""
    pool = client.pool[:4]
    data = {m: np.stack([f[m] for f in pool]) for m in pool[0]}
    scales = client.net.quantize_for_serving(data, num_batches=4)
    convs = sum(1 for name in client.net.variables if name.endswith("/kernel"))
    print(f"int8 path: {len(scales)} activation scales over {convs} kernels",
          file=sys.stderr)
    client.server = client.make_server()
    for _ in client.server.predict_stream(iter(pool * 4)):
        pass


def readings(cell, seed, mode, seconds, device="cuda", registry=None,
             overrides=None):
    """``{number: reading}`` of one seed in ``mode``: 'program', 'control'
    or a fault's name."""
    registry = registry or Registry()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = Run(registry, cell, seed, device, overrides,
              program_hook=FAULTS.get(mode))
    client = registry.client(run.traffic)(run)
    client.setup()
    training = client.unit == "step"
    if mode == "control" and training:
        client.release()
        reference = client.reference()
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            lower = client.reference()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        return compare.training_readings(lower, reference)[0]
    if mode == "control":
        _quantized(client)
    if not training:
        client.window(seconds)
    client.release()
    if device != "cpu":
        torch.cuda.empty_cache()
    return client.check()


def _seeds(text):
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--program", default="")
    parser.add_argument("--control", default="")
    parser.add_argument("--fault", action="append", default=[],
                        help="name=seeds")
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 2
    runs = [("program", s) for s in _seeds(args.program)] if args.program \
        else []
    runs += [("control", s) for s in _seeds(args.control)] if args.control \
        else []
    for fault in args.fault:
        name, _, seeds = fault.partition("=")
        if name not in FAULTS:
            raise SystemExit(f"unknown fault {name!r}")
        runs += [(name, s) for s in _seeds(seeds)]
    registry = Registry()
    summary = {}
    for mode, seed in runs:
        values = readings(args.workload, seed, mode, args.seconds,
                          registry=registry)
        print(json.dumps({"mode": mode, "seed": seed, "readings": values}),
              flush=True)
        for name, value in values.items():
            entry = summary.setdefault(name, {})
            pick = max if mode == "program" else min
            entry[mode] = pick(entry.get(mode, value), value)
    limits = registry.workload(args.workload)["checks"]
    for name, limit in limits.items():
        summary.setdefault(name, {})["limit"] = limit
    print(json.dumps({"workload": args.workload,
                      "device": torch.cuda.get_device_name(0),
                      "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
