"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``portbench/workloads/<cell>.json``) names its configuration, its traffic
and its mode; the mode (``portbench/modes/<mode>.py``) makes the inputs from the seed,
sets up the program (``tdal_torch``), measures it for ``--seconds`` and holds what the
timed path produced against the plain reference (``portbench/reference``). With
``--trace 0`` the result carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer ones (a profiled stretch of the window; the readers are
``portbench/metrics/<metric>.py``); BENCHMARK.json at the checkout's root says which.

The last line on standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` also ``breakdown``, and last
``checks``, each number compared with its limit; the same numbers close standard
error. Without a CUDA card (or with fewer cards than the cell asks for), or where a
JAX module is loaded once the window has closed, it prints no result and exits 2.
"""

import os
import time

T0 = time.perf_counter()
# one process with few threads: the host's thread pools are fixed before numpy or torch
# load, so that spinning pool threads take no cores from the loop and the data thread
HOST_THREADS = "2"
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = HOST_THREADS

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import common  # noqa: E402

CACHE = ROOT / "build" / "portbench-cache"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None,
                    help="plant a control or fault in the program (portbench/controls.py); "
                         "for the tests and the readings that set the limits")
    return ap.parse_args(argv)


def fixed_caches():
    """Every build and kernel cache inside the checkout, at fixed paths (the port's
    own kernel library builds into ``build/tdal_torch_kernels`` there by itself)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def execute(run, benchmark: dict, t_start: float) -> dict:
    """Set up, measure and check ``run`` with its mode; -> the result object."""
    import importlib

    import torch

    from portbench import controls

    mode = importlib.import_module(f"portbench.modes.{run.cell['mode']}")
    with controls.planted(run.control, run.cell["mode"]):
        mode.run(run, t_start)
    found = common.forbidden_modules()
    if found:
        raise ForbiddenModules(found)
    metrics = {}
    for m in common.cell_metrics(benchmark, run.cell["name"], run.trace):
        value = common.read_metric(m["name"], run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = run.device.type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu",
              "count": int(run.cell["chips"]),
              "memory_peak_bytes": int(run.readings.get("memory_peak_bytes", 0))}
    trace = run.readings.get("trace")
    if run.trace and trace is not None:
        device.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
    correct = run.failed == 0 and all(v <= lim for v, lim in run.checks.values()) and bool(
        run.checks)
    result = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": device}
    if run.trace and trace is not None:
        result["breakdown"] = common.breakdown(trace)
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return result


class ForbiddenModules(RuntimeError):
    pass


def main(argv=None) -> int:
    args = parse(argv)
    fixed_caches()
    cell = common.load_cell(args.workload)
    bench_path = ROOT / "BENCHMARK.json"
    benchmark = common.load_json(bench_path)
    import torch

    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: cell {args.workload} needs {chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    workdir = Path(tempfile.mkdtemp(prefix="portbench-"))
    run = common.Run(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                     device=torch.device("cuda", 0), workdir=workdir, control=args.control)
    if args.control:
        print(f"portbench: control {args.control} planted", file=sys.stderr)
    try:
        result = execute(run, benchmark, T0)
    except ForbiddenModules as e:
        print(f"portbench: JAX modules loaded in the measuring process: {e}", file=sys.stderr)
        return 2
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for k, (v, lim) in run.checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
