"""The port's `idt.*` spans (utils/profiling.span, backward_span) at small
widths on the CPU: with no profiler recording they open no profiler range
and leave the autograd graph node for node as it is; under
a profiler their names, counts and nesting are those utils/profiling.py
documents; and the results are bitwise the same either way."""
import contextlib
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from interpolated_diffusion_tpu_torch.kernels import sla as sla_mod
from interpolated_diffusion_tpu_torch.models.denoisers import InterpLevelDenoiser, KeypointDenoiser
from interpolated_diffusion_tpu_torch.ops.ddpm import make_timesteps
from interpolated_diffusion_tpu_torch.ops.schedules import make_schedule
from interpolated_diffusion_tpu_torch.sample.generate import PipelineConfig, make_pipeline
from interpolated_diffusion_tpu_torch.train.state import flatten_dict
from interpolated_diffusion_tpu_torch.train.train_keypoints_wansynth import (build_argparser,
                                                                             make_trainer)
from interpolated_diffusion_tpu_torch.utils import profiling
from interpolated_diffusion_tpu_torch.utils.prefetch import DevicePrefetcher, pinned_put

WAN_LAYERS = 2
WAN_FLAGS = ("--device cpu --T 8 --K 3 --latent_c 4 --latent_h 16 --latent_w 16 --text_len 6 "
             f"--text_dim 32 --wan_dim 64 --wan_layers {WAN_LAYERS} --wan_heads 2 --wan_ffn 128 "
             "--lora_rank 2 --sla_block 64 --sla_topk 0.5 --bf16 0 --use_remat 1 --batch 2 "
             "--use_ema 0")
MAZE = dict(d_model=32, n_layers=2, n_heads=2, d_ff=64, d_cond=16, data_dim=2,
            maze_channels=(4, 8))
PLAN = PipelineConfig(T=16, K=4, levels=2, K_min=4, ddim_steps=5, stage2_mode="adj",
                      clamp_policy="endpoints", pos_clip=True)
N_TRAIN = 20


# ---------------------------------------------------------------------------
# the four sites, tiny
# ---------------------------------------------------------------------------

def wan_step():
    """A tiny Wan Phase-1 trainer (SLA, remat) and a closure taking one step
    on a fixed batch; returns (run, state): run() -> loss."""
    torch.manual_seed(0)
    args = build_argparser().parse_args(WAN_FLAGS.split())
    state, base, step, _, _ = make_trainer(args, torch.device("cpu"))
    g = torch.Generator().manual_seed(0)
    batch = {"latents": torch.randn(2, 8, 4, 16, 16, generator=g),
             "text_embed": 0.02 * torch.randn(2, 6, 32, generator=g)}
    rng = torch.Generator().manual_seed(1)
    holder = {"state": state}

    def run():
        holder["state"], metrics = step(holder["state"], base, batch, rng)
        return metrics["loss"]

    return run, holder


def planner():
    """A tiny two-stage maze planner and one call's requests and draws;
    returns run() -> (x_interp, x_refined, z_pred)."""
    g = torch.Generator().manual_seed(2)
    kp = KeypointDenoiser(**MAZE).eval()
    it = InterpLevelDenoiser(mask_channels=2, max_levels=8, **MAZE).eval()
    for m in (kp, it):
        m.set_attn_policy("block")
        with torch.no_grad():
            for w in m.parameters():
                w.copy_(0.1 * torch.randn(w.shape, generator=g))
    pipe = make_pipeline(kp, it, make_schedule("linear", N_TRAIN), PLAN, MAZE["data_dim"])
    B, T, K = 3, PLAN.T, PLAN.K
    inner = torch.stack([torch.randperm(T - 2, generator=g)[:K - 2] + 1 for _ in range(B)])
    idx = torch.sort(torch.cat([torch.zeros(B, 1, dtype=torch.long), inner,
                                torch.full((B, 1), T - 1)], dim=1), dim=1).values
    cond = {"occ": (torch.rand(B, 1, 9, 9, generator=g) < 0.2).float(),
            "start_goal": torch.rand(B, 4, generator=g)}
    z_init, mask_rand = torch.randn(B, K, 2, generator=g), torch.rand(B, T, generator=g)
    return lambda: pipe(idx, cond, z_init=z_init, mask_rand=mask_rand)


def sla_fwd_bwd():
    """One SparseLinearAttention forward and backward; returns (out, grads)."""
    torch.manual_seed(0)
    mod = sla_mod.SparseLinearAttention(16, topk=0.5, block_q=32, block_k=32)
    q, k, v = (torch.randn(1, 2, 96, 16, requires_grad=True) for _ in range(3))
    out = mod(q, k, v)
    grads = torch.autograd.grad(out.square().sum(), (q, k, v))
    return out, grads


def prefetch_reads(n=3):
    feed = DevicePrefetcher(iter([{"a": np.full(4, float(i))} for i in range(n)]),
                            pinned_put("cpu"))
    try:
        return [next(feed)["a"] for _ in range(n)]
    finally:
        feed.close()


def _trace(fn, tmp_path):
    """fn() under a CPU profiler: (its result, the host events whose names
    start idt. as (name, start, end) in us)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
             for e in events if e.get("ph") == "X" and e.get("name", "").startswith("idt.")]
    return out, spans


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(child, parents):
    return any(p[1] <= child[1] and child[2] <= p[2] for p in parents)


# ---------------------------------------------------------------------------
# profiler off
# ---------------------------------------------------------------------------

def test_span_is_one_shared_no_op_while_no_profiler_records():
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("idt.a") is profiling.span("idt.b")
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(profiling.span("idt.a"), torch._C._profiler._RecordFunctionFast)


@pytest.mark.parametrize("site", ["train_step", "pipeline", "sla", "prefetch"])
def test_no_profiler_opens_no_range(monkeypatch, site):
    def refuse(name):
        raise AssertionError(f"range {name!r} opened with no profiler recording")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    if site == "train_step":
        run, _ = wan_step()
        assert torch.isfinite(run())
    elif site == "pipeline":
        assert all(torch.isfinite(o).all() for o in planner()())
    elif site == "sla":
        out, grads = sla_fwd_bwd()
        assert torch.isfinite(out).all() and all(torch.isfinite(g).all() for g in grads)
    else:
        assert [float(a[0]) for a in prefetch_reads()] == [0.0, 1.0, 2.0]


def _graph_nodes(t: torch.Tensor) -> int:
    seen, todo = set(), [t.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo.extend(n for n, _ in node.next_functions)
    return len(seen)


def _sla_out():
    torch.manual_seed(0)
    mod = sla_mod.SparseLinearAttention(16, topk=0.5, block_q=32, block_k=32)
    q, k, v = (torch.randn(1, 2, 96, 16, requires_grad=True) for _ in range(3))
    return mod(q, k, v)


def test_sla_graph_node_for_node_without_a_profiler(monkeypatch):
    off = _graph_nodes(_sla_out())
    with profile(activities=[ProfilerActivity.CPU]):
        on = _graph_nodes(_sla_out())
    monkeypatch.setattr(sla_mod, "span", lambda name: contextlib.nullcontext())
    monkeypatch.setattr(sla_mod, "backward_span", lambda name, fn, *inputs: fn(*inputs))
    bypassed = _graph_nodes(_sla_out())
    assert off == bypassed and on == bypassed + 2   # the span's two identity nodes


# ---------------------------------------------------------------------------
# profiler on: names, counts, nesting
# ---------------------------------------------------------------------------

def test_train_step_spans(tmp_path):
    run, _ = wan_step()
    run()   # the first step outside the trace
    _, spans = _trace(run, tmp_path)
    steps = _named(spans, "idt.train.step")
    assert len(steps) == 1
    for child in ("idt.train.forward", "idt.train.backward", "idt.train.optimizer"):
        assert len(_named(spans, child)) == 1 and _inside(_named(spans, child)[0], steps)
    fwd, bwd, opt = (_named(spans, f"idt.train.{p}")[0]
                     for p in ("forward", "backward", "optimizer"))
    assert fwd[2] <= bwd[1] and bwd[2] <= opt[1]
    # under remat each layer's SLA forward runs twice (the recompute inside
    # the backward), its backward span once, inside the step's backward
    sla = _named(spans, "idt.wan.sla")
    assert len(sla) == 2 * WAN_LAYERS
    assert sum(_inside(s, [bwd]) for s in sla) == WAN_LAYERS
    assert len(_named(spans, "idt.wan.sla.bwd")) == WAN_LAYERS
    assert all(_inside(s, [bwd]) for s in _named(spans, "idt.wan.sla.bwd"))
    for part in ("block_map", "sparse", "linear"):
        parts = _named(spans, f"idt.wan.sla.{part}")
        assert len(parts) == 2 * WAN_LAYERS and all(_inside(p, sla) for p in parts)


def test_sla_spans_alone(tmp_path):
    _, spans = _trace(sla_fwd_bwd, tmp_path)
    assert [len(_named(spans, n)) for n in ("idt.wan.sla", "idt.wan.sla.block_map",
                                            "idt.wan.sla.sparse", "idt.wan.sla.linear",
                                            "idt.wan.sla.bwd")] == [1, 1, 1, 1, 1]
    fwd, bwd = _named(spans, "idt.wan.sla")[0], _named(spans, "idt.wan.sla.bwd")[0]
    assert fwd[2] <= bwd[1]


def test_planner_spans(tmp_path):
    run = planner()
    _, spans = _trace(run, tmp_path)
    calls = _named(spans, "idt.plan.call")
    assert len(calls) == 1
    for name, n in (("idt.plan.encode", 1), ("idt.plan.stage1", 1), ("idt.plan.lerp", 1),
                    ("idt.plan.level", PLAN.levels)):
        assert len(_named(spans, name)) == n and all(_inside(s, calls) for s in _named(spans, name))
    evaluations = len(make_timesteps(N_TRAIN, PLAN.ddim_steps, PLAN.time_spacing)) - 1
    blocks = _named(spans, "idt.block")
    assert len(blocks) == MAZE["n_layers"] * (evaluations + PLAN.levels)
    stage1, levels = _named(spans, "idt.plan.stage1"), _named(spans, "idt.plan.level")
    assert sum(_inside(b, stage1) for b in blocks) == MAZE["n_layers"] * evaluations
    assert sum(_inside(b, levels) for b in blocks) == MAZE["n_layers"] * PLAN.levels


def test_prefetch_wait_spans(tmp_path):
    out, spans = _trace(prefetch_reads, tmp_path)
    assert len(out) == 3 and len(_named(spans, "idt.data.wait")) == 3


# ---------------------------------------------------------------------------
# results unchanged
# ---------------------------------------------------------------------------

def test_train_step_bitwise_the_same_under_the_profiler(tmp_path):
    results = []
    for traced in (False, True):
        run, holder = wan_step()
        losses = [run()]
        losses.append(_trace(run, tmp_path)[0] if traced else run())
        params = flatten_dict(holder["state"].params)
        results.append(([float(x) for x in losses], {n: p.detach().clone()
                                                     for n, p in params.items()}))
    (loss_off, p_off), (loss_on, p_on) = results
    assert loss_off == loss_on
    assert p_off.keys() == p_on.keys() and all(torch.equal(p_off[n], p_on[n]) for n in p_off)


def test_planner_and_sla_bitwise_the_same_under_the_profiler(tmp_path):
    off = planner()()
    on, _ = _trace(planner(), tmp_path)
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    (o_off, g_off), ((o_on, g_on), _) = sla_fwd_bwd(), _trace(sla_fwd_bwd, tmp_path)
    assert torch.equal(o_off, o_on) and all(torch.equal(a, b) for a, b in zip(g_off, g_on))
