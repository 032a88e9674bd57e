"""What every mode of the benchmark shares: finding cells by name, weights from the
seed, the reduction of a profiler window, and the result line.

A cell is ``workloads/<name>.json`` (its configuration, traffic, mode, chips, checks);
a configuration ``configs/<name>.json``; a traffic mix ``traffic/<name>.json``; a
metric ``metrics/<name>.py`` with ``read(run) -> float | None``; a mode
``modes/<name>.py`` with ``run(run)``. BENCHMARK.json, at the checkout's root, says
which metrics a cell reports.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# top-level modules no process of the benchmark may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "tdal")


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def cells(base: Path = HERE) -> list:
    """The names of the cells that ``base/workloads`` holds."""
    return sorted(p.stem for p in (base / "workloads").glob("*.json"))


def load_cell(name: str, base: Path = HERE) -> dict:
    """A cell with its configuration and traffic resolved by name."""
    path = base / "workloads" / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"portbench: no cell {name!r} (known: {', '.join(cells(base))})")
    cell = load_json(path)
    cell["name"] = name
    cell["config_file"] = load_json(base / "configs" / f"{cell['config']}.json")
    cell["traffic_params"] = load_json(base / "traffic" / f"{cell['traffic']}.json")
    return cell


def cell_metrics(benchmark: dict, cell: str, trace: bool) -> list:
    """The metrics ``cell`` reports: its end-to-end ones, or with ``trace`` its
    per-layer ones."""
    group = benchmark["per_layer"] if trace else benchmark["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def read_metric(name: str, run, base: Path = HERE):
    """Run ``metrics/<name>.py``'s ``read(run)``: a number, or None where it found
    nothing to read."""
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{len(name)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def forbidden_modules() -> list:
    """The forbidden top-level names in ``sys.modules``, whole names compared."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


@dataclasses.dataclass
class Run:
    """One run of one cell: its inputs, and what its mode and readers leave for each
    other. ``readings`` holds the raw readings (host clocks, events, counts, the
    reduced trace) by key; ``checks`` the numbers compared, each (value, limit)."""
    cell: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    workdir: Path
    readings: dict = dataclasses.field(default_factory=dict)
    checks: dict = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    control: str | None = None  # a control or fault planted (``portbench/controls.py``)

    @property
    def config(self) -> dict:
        return self.cell["config_file"]["config"]

    @property
    def traffic(self) -> dict:
        return self.cell["traffic_params"]

    def log(self, msg: str):
        print(f"portbench: {msg}", file=sys.stderr, flush=True)

    def phase(self, t_start: float, what: str):
        """Log the seconds since the process started, at the end of a set-up phase."""
        import time

        self.log(f"t+{time.perf_counter() - t_start:.2f} s: {what}")


def set_tf32(on: bool):
    """PyTorch's TF32 switches for matmuls and cuDNN's convs, both at once."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


# ---------------------------------------------------------------------------
# Weights from the seed
# ---------------------------------------------------------------------------

HM_INIT_BIAS = -2.19  # CenterPoint's heatmap bias: sigmoid(-2.19) = 0.1


def make_weights(shapes: dict, fan_in, seed: int, device, hm_classes: int,
                 hm_bias: float = HM_INIT_BIAS) -> dict:
    """Every tensor of a detector from ``seed`` on ``device``, in one draw of a
    generator there: weights lecun-normal over ``fan_in(name, shape)``, BatchNorm
    scales 1, biases 0 but the heatmap's (``hm_bias``), running means 0,
    running variances 1; ``hm_classes`` are the last channels of a head's final bias."""
    import torch

    dtype = torch.float32
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    drawn = [k for k, s in shapes.items() if len(s) > 1]
    total = sum(math.prod(shapes[k]) for k in drawn)
    noise = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, at = {}, 0
    for k, s in shapes.items():
        if len(s) > 1:
            n = math.prod(s)
            out[k] = noise[at : at + n].reshape(s) * (1.0 / math.sqrt(fan_in(k, s)))
            at += n
        elif k.endswith("running_var") or k.endswith(".scale") or k.endswith(".weight"):
            out[k] = torch.ones(s, device=device, dtype=dtype)
        else:
            out[k] = torch.zeros(s, device=device, dtype=dtype)
            if k.endswith("final_conv_bias"):
                out[k][-hm_classes:] = hm_bias
    return out


# ---------------------------------------------------------------------------
# The profiler window
# ---------------------------------------------------------------------------


def union_seconds(spans) -> float:
    """Seconds covered by the union of (start, end) intervals in microseconds."""
    busy, reach = 0.0, -math.inf
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, reach))
        reach = max(reach, b)
    return busy / 1e6


def reduce_trace(prof, wall_s: float, path) -> dict:
    """A stopped ``torch.profiler`` stretch -> device busy seconds (the union of its
    device intervals: kernels, copies, sets), device seconds by name, and the idle gaps
    between device work named by the host op (the innermost torch op or CUDA runtime
    call) running when each began. Read from the stretch's Chrome trace, written to
    ``path``."""
    prof.export_chrome_trace(str(path))
    events = load_json(path)["traceEvents"]
    path.unlink()
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev.append((a, b, e.get("name", "")))
        elif cat in ("cpu_op", "cuda_runtime", "cuda_driver") and b > a:
            host.append((a, b, e.get("name", "")))
    by_name = {}
    for a, b, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e6
    spans = sorted((a, b) for a, b, _ in dev)
    gaps, reach = [], None
    for a, b in spans:
        if reach is not None and a > reach:
            gaps.append((reach, a))
        reach = b if reach is None else max(reach, b)
    host.sort()
    starts = [h[0] for h in host]
    idle = {}
    for g0, g1 in gaps:
        i = bisect.bisect_right(starts, g0)
        name = "no torch op on the host"
        for a, b, n in reversed(host[max(0, i - 200) : i]):  # the innermost one open at g0
            if b >= g0:
                name = n
                break
        idle[name] = idle.get(name, 0.0) + (g1 - g0) / 1e6
    return dict(busy_s=union_seconds(spans), window_s=wall_s, device_events=len(dev),
                by_name=by_name, idle=idle)


def set_cudnn_benchmark(on: bool):
    """cuDNN's benchmark mode, a cell's ``cudnn_benchmark``: with it on, cuDNN times its
    algorithms for each conv shape at the shape's first call in the process and keeps
    the fastest; off, it takes its heuristic's first choice. Either choice is cached
    for the process by the conv's shape, so it is set once, before any conv runs."""
    import torch

    torch.backends.cudnn.benchmark = on


@contextlib.contextmanager
def profiler_warmed(run):
    """With ``--trace 1``, run the body (a set-up step) under a profiler that is thrown
    away: the profiler's first start in a process sets up its tracing, which would
    otherwise fall in the window's traced stretch."""
    if not run.trace:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if run.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        yield


class Segment:
    """The profiled stretch of a traced window: its first ``steps`` steps or batches
    run under ``torch.profiler`` (the host's ops and CUDA activity), its trace reduced
    once the window has closed. ``after`` is (host time, work done) where the stretch
    ended; the rest of the window is untraced.

    Recording the host's ops slows the host, and where the device waits for the host
    its idle share then grows for the profiler's sake. So ``reduce`` also gives the
    device's busy seconds a unit over the untraced rest's seconds a unit
    (``busy_over_untraced``), and ``wall_ratio``, the stretch's seconds a unit over the
    rest's: how far the profiler slowed the host."""

    def __init__(self, run, steps: int):
        self.run, self.steps = run, steps
        self.prof = self.wall = self.after = None

    def start(self, t0: float):
        self.t0 = t0
        if self.run.trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.run.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()

    @property
    def open(self) -> bool:
        return self.prof is not None and self.wall is None

    def tick(self, n: int, done: int) -> bool:
        """After the ``n``-th step or batch, with ``done`` units of work so far; ->
        whether the stretch closed with it."""
        import time

        import torch

        if not (self.open and n == self.steps):
            return False
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)
        self.wall = time.perf_counter() - self.t0
        self.prof.stop()
        self.after = (time.perf_counter(), done)
        return True

    def reduce(self, path, rest_s: float, rest_units: int):
        if self.wall is None:
            return None
        t = reduce_trace(self.prof, self.wall, path)
        rest = rest_s / rest_units if rest_units else None
        t["wall_ratio"] = self.wall / self.steps / rest if rest else None
        t["busy_over_untraced"] = t["busy_s"] / self.steps / rest if rest else None
        self.run.log(f"traced stretch: {self.steps} units, device busy {t['busy_s']:.4f} of "
                     f"{self.wall:.4f} s; untraced rest {rest_units} units in {rest_s:.4f} s; "
                     f"seconds a unit traced over untraced {t['wall_ratio']}; busy a unit over "
                     f"the untraced seconds a unit {t['busy_over_untraced']}")
        return t


def breakdown(trace: dict) -> dict:
    top = sorted(trace["by_name"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(trace["idle"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:120], s] for n, s in top],
            "idle_gaps": [[n[:120], s] for n, s in gaps]}


def quantile(values, q: float) -> float:
    """The q-quantile (0 < q < 1) by linear interpolation between order statistics."""
    v = sorted(values)
    pos = q * (len(v) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
