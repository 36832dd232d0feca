"""One run of one cell, driven by data: the cell's entry in
``BENCHMARK.json`` names its configuration file and its traffic mix
(``portbench/traffic/<traffic>.json``), the mix names its kind, a generator
``portbench/generators/<kind>.py``, and each per-layer metric the cell
reports is read by ``portbench/metrics/<metric>.py``. Adding a
configuration, a mix, a kind or a metric adds files; nothing here changes.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import ModuleType

import torch

from portbench import program, tracing

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
# top-level module names the run may not hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "slr")


def load_module(path: Path) -> ModuleType:
    """A Python file of the benchmark, by path (metric names hold dots)."""
    name = "portbench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as fh:
        return json.load(fh)


def cell_of(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def reports(metric: dict, workload: str, bench: dict) -> bool:
    """Whether ``workload`` reports ``metric``: its ``workloads`` list;
    without one, an end-to-end metric is every cell's and a per-layer one
    every cell's that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    if "moves" not in metric:
        return True
    moves = [m for m in bench["end_to_end"] if m["name"] == metric.get("moves")]
    return bool(moves) and reports(moves[0], workload, bench)


def load_cell(workload: str, bench: dict | None = None):
    """(cell, configuration dict, mix dict, generator module) of a cell."""
    bench = bench or manifest()
    cell = cell_of(bench, workload)
    conf = [c for c in bench["configs"] if c["name"] == cell["config"]][0]
    with open(ROOT / conf["file"]) as fh:
        cfg = json.load(fh)
    with open(BENCH / "traffic" / f"{cell['traffic']}.json") as fh:
        mix = json.load(fh)
    gen = load_module(BENCH / "generators" / f"{mix['kind']}.py")
    return cell, cfg, mix, gen


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (default: the loaded
    modules), each compared whole."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def limits_check(readings: dict, limits: dict) -> list:
    """[name, reading, limit, ok] of every number compared; a ``_min``
    limit is a floor, every other a ceiling; a limit not yet set fails."""
    out = []
    for name, value in readings.items():
        lim = limits.get(name)
        ok = lim is not None and (value >= lim if name.endswith("_min") else value <= lim)
        out.append([name, value, lim, bool(ok)])
    return out


def _note(t_start: float, what: str):
    print(f"portbench: {time.perf_counter() - t_start:8.2f} s  {what}", file=sys.stderr,
          flush=True)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
             device="cuda", bench: dict | None = None, cfg_override=None,
             mix_override=None) -> dict:
    """Set up, measure and check one cell; returns the result line's object.
    ``cfg_override`` and ``mix_override`` (tests) update the configuration
    and the mix's parameters."""
    bench = bench or manifest()
    cell, cfg, mix, gen = load_cell(workload, bench)
    cfg.update(cfg_override or {})
    params = {**mix["params"], **(mix_override or {})}
    traffic = gen.Traffic(cfg, params, seed, device)
    on_card = torch.device(device).type == "cuda"
    try:
        traffic.setup()
        _note(t_start, f"set-up done, {program.build_seconds[0]:.2f} s of it in kernel builds")
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        window_start = time.perf_counter()
        e2e, attempted, failed = traffic.window(seconds, sync_spans=trace)
        e2e["setup_s"] = window_start - t_start
        spans = {k: list(v) for k, v in traffic.spans.items()}
        _note(t_start, f"window done: {attempted} attempted")
        result_trace = None
        if trace:
            result_trace = tracing.profile(traffic.traced_slice) if on_card else None
            if result_trace is not None:
                _note(t_start, f"traced slice read: {result_trace.wall_unprofiled_s:.4f} s "
                               f"unprofiled, {result_trace.wall_s:.4f} s traced on the device")
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        traffic.release()
        gc.collect()
        readings = traffic.readings()
        _note(t_start, "outputs compared")
    finally:
        traffic.close()
    checks = limits_check(readings, cfg["checks"]["limits"])
    correct = failed == 0 and attempted > 0 and all(c[3] for c in checks)

    if trace:
        metrics = {}
        for m in bench["per_layer"]:
            if not reports(m, workload, bench):
                continue
            reader = load_module(BENCH / "metrics" / f"{m['name']}.py")
            value = reader.read(ReaderInput(result_trace, spans, cfg, params))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"] if reports(m, workload, bench)}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name() if on_card else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device_info,
           # set-up's share in the program's kernel builds: a checkout's first
           # run compiles, every later one loads
           "build_s": program.build_seconds[0]}
    if trace and result_trace is not None:
        device_info["busy_s"] = tracing.busy_s(result_trace.device)
        device_info["window_s"] = result_trace.wall_s
        out["breakdown"] = tracing.breakdown(result_trace)
    out["checks"] = {c[0]: {"value": c[1], "limit": c[2]} for c in checks}
    return out


class ReaderInput:
    """What a per-layer metric's reader gets: the traced slice (None off
    the card), the window's spans (seconds, by stage), the configuration
    and the mix's parameters."""

    def __init__(self, trace, spans: dict, cfg: dict, params: dict):
        self.trace, self.spans, self.cfg, self.params = trace, spans, cfg, params

