"""Runs one cell of the benchmark once, on the card of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (``benchmark/workloads/<cell>.json``) names its configuration and
traffic mix; ``BENCHMARK.json`` at the root says which metrics it reports:
its end-to-end metrics with ``--trace 0``, its per-layer metrics, read
from a torch.profiler trace of a steady stretch of the window, with
``--trace 1``. The weights, the confusion matrices and the frames are made
from ``--seed``. After the window the program's outputs are held against
the plain reference (``benchmark/reference``); each number compared is
printed beside its limit on the last lines of standard error and under
``checks`` in the result.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (with ``busy_s`` and
``window_s`` of the traced stretch and, with ``--trace 1``, a
``breakdown``), and ``checks``. The run exits non-zero, printing no
result, where there is no CUDA card or fewer than the cell asks for,
where the program (``modular_semantic_segmentation_torch``) is not
beside this folder, and where JAX or the JAX package was loaded.

Build and kernel caches stay inside the checkout, under
``benchmark/_cache/``.
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "benchmark" / "_cache"
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[_var] = str(CACHE / _sub)
os.environ["USE_FLAX"] = "0"
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).parent:
    sys.path.pop(0)
sys.path.insert(0, str(ROOT))

PROGRAM = "modular_semantic_segmentation_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "modular_semantic_segmentation_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def power_limit():
    """The card's power limit as nvidia-smi gives it, or 'not measured'."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not measured"
    return out or "not measured"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch
    from benchmark.harness.registry import Registry
    registry = Registry()
    cell = registry.workload(args.workload)
    if not torch.cuda.is_available():
        print("error: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"error: the cell asks for {cell['chips']} cards, this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if not (ROOT / PROGRAM / "__init__.py").is_file():
        print(f"error: the program ({PROGRAM}) is not in {ROOT}",
              file=sys.stderr)
        return 2
    from benchmark.harness.runner import run_cell
    # one host operator thread: with the default eight, the copy of a
    # camera frame into pinned memory took 1 ms at the median and 6.7 ms at
    # the 95th percentile (an H100 80GB HBM3 host)
    torch.set_num_threads(1)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", registry=registry)
    loaded = forbidden_modules()
    if loaded:
        print(f"error: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    device = result["device"]
    device["power_limit"] = power_limit()
    print(f"device: {device['kind']}, {torch.cuda.device_count()} visible, "
          f"{device['count']} used, power limit {device['power_limit']}, "
          f"peak memory {device['memory_peak_bytes']} bytes",
          file=sys.stderr)
    for name, metric in result["metrics"].items():
        print(f"metric {name}: {metric['value']!r} {metric['unit']} "
              f"({device['kind']}, power limit {device['power_limit']})",
              file=sys.stderr)
    print(f"correct: {result['correct']} ({result['attempted']} attempted, "
          f"{result['failed']} failed)", file=sys.stderr)
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
