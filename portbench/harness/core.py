"""The benchmark's frame: the manifest, a cell's files found by name, the
environment a run starts from, and the result line.

Everything a cell needs is found by the names in BENCHMARK.json:
configs/<config>.json (or the `file` the manifest names), traffic/<mix>.json,
generators/<generator>.py (named by the traffic file) and metrics/<metric>.py.
A later cell, mix or metric is added as new files and manifest entries only.
"""
from __future__ import annotations

import importlib.util
import json
import os
import statistics
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Any, Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

# Top-level module names that may not be loaded in a run's process: the JAX
# stack and the JAX package the port was made from. Compared whole, so the
# port (interpolated_diffusion_tpu_torch) is not one of them.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "interpolated_diffusion_tpu")

# Environment the program reads that would change what a cell measures: the
# TPU tuning registry and its overrides, and extra nvcc flags (each setting
# builds another kernel library). A cell pins its own policy instead.
CLEARED_ENV = ("ID_TPU_ATTN_TUNE", "ID_TPU_SMALL_ATTN", "ID_TPU_FUSED_ROWS",
               "ID_KERNELS_NVCC_FLAGS")


def prepare_environment(root: Path = ROOT) -> None:
    """Clear the tuning variables, keep libraries that would load JAX from
    doing so, and put every compile cache at a fixed path in the checkout.
    Call before torch is imported."""
    for name in CLEARED_ENV:
        os.environ.pop(name, None)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    cache = root / "build" / "portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: Optional[str] = None) -> ModuleType:
    """Import a file by its path (metric files carry dots in their names)."""
    name = name or "portbench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """One workload of the manifest with its configuration and traffic."""

    name: str
    workload: Dict[str, Any]
    config: Dict[str, Any]          # the configuration file's contents
    config_entry: Dict[str, Any]    # the manifest's entry for it
    traffic: Dict[str, Any]         # the traffic mix's parameters
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    bench_dir: Path = BENCH_DIR

    @property
    def chips(self) -> int:
        return int(self.workload.get("chips", 1))


def applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, manifest: Optional[Dict[str, Any]] = None,
              bench_dir: Path = BENCH_DIR, root: Path = ROOT) -> Cell:
    """The cell `name` with its files, found by the manifest's names."""
    manifest = manifest if manifest is not None else load_json(root / "BENCHMARK.json")
    wl = {w["name"]: w for w in manifest["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in the manifest; have {sorted(wl)}")
    workload = wl[name]
    entries = {c["name"]: c for c in manifest["configs"]}
    entry = entries[workload["config"]]
    config = load_json(root / entry["file"])
    traffic = load_json(bench_dir / "traffic" / f"{workload['traffic']}.json")
    e2e = [m for m in manifest["end_to_end"] if applies(m, name)]
    layers = [m for m in manifest["per_layer"] if applies(m, name)]
    return Cell(name, workload, config, entry, traffic, e2e, layers, bench_dir)


def generator_module(cell: Cell) -> ModuleType:
    return load_module(cell.bench_dir / "generators" / f"{cell.traffic['generator']}.py")


def metric_reader(cell: Cell, metric: str) -> Callable[[Any], Optional[float]]:
    return load_module(cell.bench_dir / "metrics" / f"{metric}.py").read


def sub_seed(seed: int, stream: int) -> int:
    """A seed of its own for each random stream of a run (weights, data,
    draws, requests, the sample checked), from the run's --seed."""
    return (int(seed) * 1_000_003 + int(stream)) % (1 << 63)


def quartile_spread(values: List[float]) -> float:
    """(Q3 - Q1) / median, quartiles as statistics.quantiles(n=4) gives them."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def percentile(values: List[float], p: float) -> float:
    """The p-th percentile (0-100) by linear interpolation between ranks."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * p / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


@dataclass
class Check:
    """One number compared, with its limit: ok while value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclass
class Outcome:
    """What a generator hands back after its run.

    e2e: end-to-end metric values by name; layer: what the per-layer readers
    read (counters, host spans, the parsed trace, shapes); checks: the numbers
    compared for `correct`; device: the run's device facts."""

    e2e: Dict[str, float]
    layer: Dict[str, Any]
    checks: List[Check]
    attempted: int
    failed: int
    device: Dict[str, Any]
    breakdown: Optional[Dict[str, Any]] = None

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks) and self.failed == 0


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device, reset: bool = False) -> int:
    """The allocator's peak on `device` since the last reset (0 off the card)."""
    import torch

    if torch.device(device).type != "cuda":
        return 0
    peak = int(torch.cuda.max_memory_allocated(device))
    if reset:
        torch.cuda.reset_peak_memory_stats(device)
    return peak


def device_name(device) -> str:
    import torch

    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def forbidden_loaded() -> List[str]:
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def result_line(cell: Cell, outcome: Outcome, trace: bool) -> Dict[str, Any]:
    """The result object: end-to-end metrics with --trace 0, the per-layer
    metrics whose readers find something with --trace 1; `checks` last."""
    metrics: Dict[str, Dict[str, Any]] = {}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] in outcome.e2e:
                metrics[m["name"]] = {"value": outcome.e2e[m["name"]], "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            value = metric_reader(cell, m["name"])(outcome.layer)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line: Dict[str, Any] = {"correct": outcome.correct, "attempted": outcome.attempted,
                            "failed": outcome.failed, "metrics": metrics,
                            "device": outcome.device}
    if trace and outcome.breakdown:
        line["breakdown"] = outcome.breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}
    return line
