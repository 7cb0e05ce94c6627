"""A closed loop of maze planning calls: one batch of requests per call.

Set-up builds the program's two denoisers (models/denoisers.KeypointDenoiser
and InterpLevelDenoiser, holding the benchmark's seeded weights in the type
they are served in), routes their blocks by the cell's policy and makes the
planner with sample/generate.make_pipeline, then warms it at the cell's batch
with two calls and checks the launch counts of the kernels the policy names.
The window keeps `in_flight` calls on the device: it issues call n+1, with
its outputs' copy to pinned host memory behind it, and only then waits for
call n's outputs, so the card runs call n+1's head while the host reads
call n. When --seconds are up it issues nothing more, waits for every call
it issued, and reads the clock after that wait. Every call has fresh
requests (sorted anchor frames with both ends, Bernoulli occupancy grids,
start and goal) and draws (the Stage-1 noise, the Stage-2 mask uniforms),
all made on the device from the seed and the call's number. A traced run
then issues `trace_calls` calls one at a time onto an idle device (the host
time a call takes to return), and profiles `trace_calls` more, issued as in
the window, with a span around every transformer block. After the window a
sample of the requests, drawn from the seed, is planned again by the plain
reference and compared with what the program returned.

Traffic parameters (traffic/<mix>.json): policy, batch, occupancy,
in_flight (1 when absent: each call's outputs read before the next is
issued), warmup_calls, check_rows, trace_calls; the configuration gives the
model and the planner's shape (T, K, levels, DDIM steps, ...).
"""
from __future__ import annotations

import gc
import sys
import time
from collections import deque
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.harness.core import (Cell, Check, Outcome, device_name, peak_bytes, percentile,
                                    sub_seed, sync)
from portbench.harness.trace import Spans, profiled_segment
from portbench.harness.weights import load_into, make_weights
from portbench.reference import maze_ref
from portbench.reference.numerics import Numerics, strict_f32

# Limits of the compared numbers (PERF.md gives the readings they were set
# from): over the sampled requests, the widest gap of any refined position
# and of any Stage-1 keypoint from the reference's, positions in [0, 1].
LIMITS = {"refined_gap_max": 0.07, "keypoint_gap_max": 0.055}
STREAM_WEIGHTS, STREAM_CALLS, STREAM_SAMPLE = 1, 1000, 2


def requests(cfg: Dict, tr: Dict, seed: int, call: int, device) -> Dict[str, torch.Tensor]:
    """One call's requests and draws: anchor frames [B, K] (0 and T-1 and
    K-2 distinct interior frames, sorted), occupancy [B, 1, G, G],
    start_goal [B, 4] uniform, Stage-1 noise [B, K, D], Stage-2 mask
    uniforms [B, T]."""
    B, T, K, G = tr["batch"], cfg["T"], cfg["K"], cfg["grid"]
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, STREAM_CALLS + call))
    interior = torch.rand((B, T - 2), generator=g, device=device).argsort(dim=1)[:, :K - 2] + 1
    idx = torch.cat([torch.zeros((B, 1), dtype=torch.long, device=device), interior,
                     torch.full((B, 1), T - 1, dtype=torch.long, device=device)], dim=1)
    return {"idx": torch.sort(idx, dim=1).values,
            "occ": (torch.rand((B, 1, G, G), generator=g, device=device)
                    < tr["occupancy"]).float(),
            "start_goal": torch.rand((B, 4), generator=g, device=device),
            "z_init": torch.randn((B, K, cfg["data_dim"]), generator=g, device=device),
            "mask_rand": torch.rand((B, T), generator=g, device=device)}


def build_program(cfg: Dict, policy: str, weights: Dict[str, torch.Tensor], device):
    from interpolated_diffusion_tpu_torch.models.denoisers import (InterpLevelDenoiser,
                                                                   KeypointDenoiser)
    from interpolated_diffusion_tpu_torch.ops.schedules import make_schedule
    from interpolated_diffusion_tpu_torch.sample.generate import PipelineConfig, make_pipeline

    w = dict(d_model=cfg["d_model"], n_layers=cfg["n_layers"], n_heads=cfg["n_heads"],
             d_ff=cfg["d_ff"], d_cond=cfg["d_cond"], data_dim=cfg["data_dim"],
             maze_channels=tuple(cfg["maze_channels"]))
    dtype = getattr(torch, cfg["weights_dtype"])
    # built on the device itself: a build on the meta device runs the layers'
    # initialisers through torch._refs, which imports torch._dynamo (seconds)
    with torch.device(device):
        kp = KeypointDenoiser(**w).to(dtype)
        it = InterpLevelDenoiser(mask_channels=cfg["mask_channels"],
                                 max_levels=cfg["max_levels"], **w).to(dtype)
    load_into(kp, weights, "kp.")
    load_into(it, weights, "it.")
    for m in (kp, it):
        m.eval()
        m.set_attn_policy(policy)
    pcfg = PipelineConfig(T=cfg["T"], K=cfg["K"], levels=cfg["levels"], K_min=cfg["K_min"],
                          ddim_steps=cfg["ddim_steps"], time_spacing=cfg["time_spacing"],
                          k_schedule=cfg["k_schedule"], stage2_mode=cfg["stage2_mode"],
                          clamp_policy=cfg["clamp_policy"], pos_clip=cfg["pos_clip"])
    sched = make_schedule(cfg["schedule"], cfg["n_train"], device=device)
    return kp, it, make_pipeline(kp, it, sched, pcfg, cfg["data_dim"])


def _launches():
    import importlib

    fb = importlib.import_module("interpolated_diffusion_tpu_torch.kernels.fused_block")
    sm = importlib.import_module("interpolated_diffusion_tpu_torch.kernels.small_mha")
    return {"fused_film_block": fb.fused_film_block.launches,
            "small_mha_packed": sm.small_mha_packed.launches}


def expected_launches(cfg: Dict, policy: str) -> Dict[str, int]:
    """Per call: under block every transformer block is one fused_film_block
    (Stage 1's DDIM evaluations and Stage 2's levels); under fused Stage 2's
    attention goes through small_mha_packed and Stage 1 (H*K <= 256) runs
    plain attention; under dense no kernel of either runs."""
    evals = len(maze_ref.ddim_times(cfg["n_train"], cfg["ddim_steps"])) - 1
    if policy == "block":
        return {"fused_film_block": (evals + cfg["levels"]) * cfg["n_layers"],
                "small_mha_packed": 0}
    packed = cfg["levels"] * cfg["n_layers"] if policy == "fused" else 0
    return {"fused_film_block": 0, "small_mha_packed": packed}


def call(pipe, req) -> Tuple:
    cond = {"occ": req["occ"], "start_goal": req["start_goal"]}
    return pipe(req["idx"], cond, z_init=req["z_init"], mask_rand=req["mask_rand"])


class Calls:
    """Planning calls issued with up to `in_flight` of them unread: issue()
    makes call n's requests, calls the planner and, on the card, queues the
    copy of its outputs into one of `in_flight` pinned host buffers and an
    event behind it; read() waits for the oldest call's outputs and returns
    them with the host seconds from its issue to then. Buffers are made at
    the first call (set-up) and reused: call n + in_flight is issued only
    after call n has been read."""

    def __init__(self, cfg: Dict, tr: Dict, seed: int, pipe, device):
        self.cfg, self.tr, self.seed, self.pipe, self.dev = cfg, tr, seed, pipe, device
        self.in_flight = max(1, int(tr.get("in_flight", 1)))
        self.pinned = device.type == "cuda"
        self.slots: List[List[torch.Tensor]] = []
        self.pending = deque()

    def issue(self, n: int) -> float:
        """Issues call n; returns the host seconds until the planner returned."""
        req = requests(self.cfg, self.tr, self.seed, n, self.dev)
        t_issue = time.perf_counter()
        out = call(self.pipe, req)
        t_back = time.perf_counter()
        done = None
        if self.pinned:
            if not self.slots:
                self.slots = [[torch.empty(o.shape, dtype=o.dtype, pin_memory=True) for o in out]
                              for _ in range(self.in_flight)]
            bufs = self.slots[n % self.in_flight]
            for b, o in zip(bufs, out):
                b.copy_(o, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            out = bufs
        self.pending.append((t_issue, done, out))
        return t_back - t_issue

    def full(self) -> bool:
        return len(self.pending) >= self.in_flight

    def read(self) -> Tuple[List[np.ndarray], float]:
        t_issue, done, out = self.pending.popleft()
        if done is not None:
            done.synchronize()
            host = [b.numpy().copy() for b in out]
        else:
            host = [o.cpu().numpy() for o in out]
        return host, time.perf_counter() - t_issue


def failures(req_host: Dict[str, np.ndarray], out: List[np.ndarray]) -> int:
    """Requests whose answer breaks what every plan guarantees: finite,
    positions in [0, 1], start and goal kept, keypoints kept in the path."""
    x_interp, x_ref, z = out
    sg = req_host["start_goal"]
    bad = ~np.isfinite(x_ref).all(axis=(1, 2)) | ~np.isfinite(z).all(axis=(1, 2))
    bad |= ((x_ref[..., :2] < 0) | (x_ref[..., :2] > 1)).any(axis=(1, 2))
    bad |= (x_ref[:, 0, :2] != sg[:, :2]).any(axis=1) | (x_ref[:, -1, :2] != sg[:, 2:]).any(axis=1)
    anchors = np.take_along_axis(x_interp, req_host["idx"][..., None], axis=1)
    bad |= (anchors != z).any(axis=(1, 2))
    return int(bad.sum())


def sample_rows(seed: int, n_calls: int, batch: int, n: int) -> Dict[int, np.ndarray]:
    """The requests checked: n drawn from the seed over every call of the
    window, grouped by call."""
    rng = np.random.default_rng(sub_seed(seed, STREAM_SAMPLE))
    flat = np.sort(rng.choice(n_calls * batch, size=min(n, n_calls * batch), replace=False))
    return {int(c): flat[flat // batch == c] % batch for c in np.unique(flat // batch)}


def reference_plans(cfg: Dict, tr: Dict, seed: int, picked: Dict[int, np.ndarray], device,
                    precision: str = "f32", chunk: int = 1024):
    """The reference's (x_refined, z_pred) of the picked requests, in the
    order of `picked` (call, then row)."""
    strict_f32()
    P = make_weights(maze_ref.param_spec(cfg), sub_seed(seed, STREAM_WEIGHTS), device)
    rows = {k: [] for k in ("idx", "occ", "start_goal", "z_init", "mask_rand")}
    for c, rs in picked.items():
        req = requests(cfg, tr, seed, c, device)
        sel = torch.as_tensor(rs, device=device)
        for k in rows:
            rows[k].append(req[k][sel])
    batch = {k: torch.cat(v) for k, v in rows.items()}
    num = Numerics(precision)
    outs = []
    for s in range(0, batch["idx"].shape[0], chunk):
        part = {k: v[s:s + chunk] for k, v in batch.items()}
        _, x_ref, z = maze_ref.plan(P, cfg, part["idx"], part["occ"], part["start_goal"],
                                    part["z_init"], part["mask_rand"], num)
        outs.append((x_ref, z))
    return torch.cat([o[0] for o in outs]).cpu().numpy(), torch.cat([o[1] for o in outs]).cpu().numpy()


def gaps(prog_x: np.ndarray, prog_z: np.ndarray, ref_x: np.ndarray, ref_z: np.ndarray) -> Dict:
    dx = np.abs(prog_x[..., :2] - ref_x[..., :2]).max(axis=(1, 2))
    dz = np.abs(prog_z[..., :2] - ref_z[..., :2]).max(axis=(1, 2))
    return {"refined_gap_max": float(dx.max()), "keypoint_gap_max": float(dz.max()),
            "refined_gap_p50": float(np.median(dx)), "refined_gap_p90": float(np.quantile(dx, 0.9)),
            "keypoint_gap_p50": float(np.median(dz))}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda") -> Outcome:
    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device)
    policy, B = tr["policy"], tr["batch"]
    t_setup = time.perf_counter()
    torch.empty(1, device=dev)   # the device's context
    sync(dev)
    t_context = time.perf_counter()
    weights = make_weights(maze_ref.param_spec(cfg), sub_seed(seed, STREAM_WEIGHTS), dev)
    kp, it, pipe = build_program(cfg, policy, weights, dev)
    del weights
    sync(dev)
    marks = [time.perf_counter()]
    launches = {}
    calls = Calls(cfg, tr, seed, pipe, dev)
    for i in range(int(tr["warmup_calls"])):   # issued and read as in the window
        before = _launches()
        calls.issue(-1 - i)
        launches = {k: v - before[k] for k, v in _launches().items()}
        if calls.full():
            calls.read()
            marks.append(time.perf_counter())
    while calls.pending:
        calls.read()
        marks.append(time.perf_counter())
    sync(dev)
    setup_s = time.perf_counter() - t_setup
    print(f"[setup] {setup_s:.2f} s: device context {t_context - t_setup:.2f}, weights and models "
          f"{marks[0] - t_context:.2f}, warm-up calls "
          + ", ".join(f"{b - a:.3f}" for a, b in zip(marks, marks[1:])), file=sys.stderr, flush=True)
    setup_peak = peak_bytes(dev, reset=True)

    host_out: List[List[np.ndarray]] = []
    latency, enqueue = [], []

    def read():
        host, seconds_to_host = calls.read()
        host_out.append(host)
        latency.append(seconds_to_host)

    t0 = time.perf_counter()
    n_issued = 0
    while time.perf_counter() - t0 < seconds:
        calls.issue(n_issued)
        n_issued += 1
        if calls.full():
            read()
    while calls.pending:
        read()
    window_s = time.perf_counter() - t0
    window_peak = peak_bytes(dev)
    n_calls = len(host_out)

    traced = None
    if trace:
        n_trace = int(tr["trace_calls"])
        for j in range(n_trace):   # one at a time onto an idle device
            sync(dev)
            enqueue.append(calls.issue(n_calls + j))
            calls.read()
        spans = Spans()
        for model in (kp, it):
            for layer in model.transformer.layers:
                spans.around(layer, "pb.block")
        with profiled_segment(dev) as seg:
            for j in range(n_trace):
                calls.issue(n_calls + n_trace + j)
                if calls.full():
                    calls.read()
            while calls.pending:
                calls.read()
        spans.remove()
        traced = seg["trace"]
        traced.units["calls"] = n_trace
    card = device_name(dev)
    del kp, it, pipe, calls
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    failed = 0
    for c in range(n_calls):
        req = {k: v.cpu().numpy() for k, v in requests(cfg, tr, seed, c, dev).items()
               if k in ("idx", "start_goal")}
        failed += failures(req, host_out[c])
    picked = sample_rows(seed, n_calls, B, int(tr["check_rows"]))
    prog_x = np.concatenate([host_out[c][1][rs] for c, rs in picked.items()])
    prog_z = np.concatenate([host_out[c][2][rs] for c, rs in picked.items()])
    t_ref = time.perf_counter()
    ref_x, ref_z = reference_plans(cfg, tr, seed, picked, dev)
    found = gaps(prog_x, prog_z, ref_x, ref_z)
    want = expected_launches(cfg, policy)
    print(f"[path] launches in the last warm-up call: {launches}, expected {want}",
          file=sys.stderr, flush=True)
    print(f"[reference] {prog_x.shape[0]} requests in {time.perf_counter() - t_ref:.1f} s; "
          f"gaps {found}", file=sys.stderr, flush=True)
    checks = [Check(k, found[k], v) for k, v in LIMITS.items()]
    if dev.type == "cuda":   # the plain twins that run off the card launch nothing
        checks += [Check(f"launches_{k}", abs(launches[k] - v), 0) for k, v in want.items()]

    device_info = {"platform": "gpu", "kind": card, "count": 1,
                   "memory_peak_bytes": int(max(setup_peak, window_peak))}
    if traced is not None:
        device_info["busy_s"] = traced.busy_s
        device_info["window_s"] = traced.window_s
    print(f"[window] {n_calls} calls of {B} in {window_s:.3f} s; call p50 "
          f"{1e3 * percentile(latency, 50):.2f} ms, p90 {1e3 * percentile(latency, 90):.2f} ms "
          f"over {len(latency)} calls", file=sys.stderr, flush=True)
    layer = {"kind": "plan", "cfg": cfg, "traffic": tr, "batch": B, "calls": n_calls,
             "window_s": window_s, "enqueue_s": enqueue, "latency_s": latency,
             "trace": traced}
    return Outcome(
        e2e={"plan_samples_per_s": n_calls * B / window_s,
             "plan_call_p90_ms": 1e3 * percentile(latency, 90), "setup_s": setup_s,
             "peak_mem_gib": window_peak / 2 ** 30},
        layer=layer, checks=checks, attempted=n_calls * B, failed=failed, device=device_info,
        breakdown=traced.breakdown() if traced is not None else None)
