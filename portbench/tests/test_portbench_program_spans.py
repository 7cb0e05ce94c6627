"""The readers of the program's own `idt.*` spans (harness/program_spans.py
and the metrics built on it) on hand-built traces: which operations each
rule attributes to which span, per step or call, and nothing at all from a
trace without the program's spans (a program older than them)."""
import pytest

from portbench.harness import core
from portbench.harness import program_spans as ps
from portbench.harness.trace import Trace
from portbench.harness.work import least_s, maze_block, maze_call, wan_self_attention

MS = 1e-3
MAIN, AUTOGRAD, LOADER = 1, 2, 3
TRAIN_READERS = ("forward_ms.train", "backward_ms.train", "optimizer_ms.train",
                 "optimizer_host_ms.train", "sla_block_map_ms.train", "sla_linear_ms.train",
                 "sla_roofline.train", "prefetch_wait_ms.train")
PLAN_READERS = ("stage1_ms.plan", "stage2_ms.plan", "stage1_host_ms.plan", "film_roofline.plan")


def build(host, ops, units):
    """host: (name, start ms, end ms, tid); ops: (name, launch ms, tid, device ms)."""
    device, launches = [], {}
    for corr, (name, at, tid, dur) in enumerate(ops):
        device.append((name, (at + 0.5) * MS, (at + 0.5 + dur) * MS, corr))
        launches[corr] = (at * MS, tid)
    return Trace(0.0, 0.2, device, {}, launches,
                 [(n, s * MS, e * MS, tid) for n, s, e, tid in host], dict(units))


def wan_trace(prefix="idt."):
    """One step: forward on the main thread with one SLA call (its block
    map, sparse and linear parts, and a kernel after them inside the SLA
    span), the backward opened on the main thread while the autograd thread
    launches its kernels (the recomputed SLA forward and the SLA backward
    span among them), a copy from the loader's thread during the backward,
    and the optimizer."""
    p = prefix
    host = [(f"{p}data.wait", 0, 2, MAIN), (f"{p}train.step", 3, 100, MAIN),
            (f"{p}train.forward", 4, 30, MAIN), (f"{p}wan.sla", 5, 20, MAIN),
            (f"{p}wan.sla.block_map", 6, 8, MAIN), (f"{p}wan.sla.sparse", 9, 12, MAIN),
            (f"{p}wan.sla.linear", 13, 18, MAIN), (f"{p}train.backward", 31, 80, MAIN),
            (f"{p}wan.sla", 40, 50, AUTOGRAD), (f"{p}wan.sla.block_map", 41, 43, AUTOGRAD),
            (f"{p}wan.sla.sparse", 43.5, 44, AUTOGRAD), (f"{p}wan.sla.linear", 44, 46, AUTOGRAD),
            (f"{p}wan.sla.bwd", 55, 65, AUTOGRAD), (f"{p}train.optimizer", 81, 99, MAIN),
            ("aten::mm", 4.5, 4.6, MAIN)]
    ops = [("gemm_fwd", 4.5, MAIN, 1.0), ("topk_kernel", 7, MAIN, 0.5),
           ("sla_fwd_kernel", 10, MAIN, 0.25), ("linear_kernel", 14, MAIN, 0.125),
           ("add_kernel", 19, MAIN, 0.0625),
           ("gemm_bwd", 35, AUTOGRAD, 2.0), ("Memcpy HtoD (Pinned -> Device)", 36, LOADER, 0.75),
           ("topk_kernel", 42, AUTOGRAD, 0.5), ("linear_kernel", 45, AUTOGRAD, 0.125),
           ("sla_bwd_dq_kernel", 60, AUTOGRAD, 1.0), ("adamw_kernel", 85, MAIN, 0.5),
           ("between_steps", 101, MAIN, 0.25)]
    return build(host, ops, {"steps": 1})


def wan_run(trace):
    cell = core.find_cell("wan13b-p1-lora-sla")
    C, H, W = cell.traffic["latents"]
    L = cell.traffic["K"] * (H // 2) * (W // 2)
    return cell, {"kind": "train", "cfg": cell.config, "traffic": cell.traffic,
                  "batch": cell.traffic["batch"], "tokens": L, "trace": trace}


def read(cell, name, run):
    return core.metric_reader(cell, name)(run)


def test_train_readers_attribute_each_operation_once():
    cell, run = wan_run(wan_trace())
    got = {name: read(cell, name, run) for name in TRAIN_READERS}
    assert got["forward_ms.train"] == pytest.approx(1.9375)
    # the autograd thread's kernels, the recomputation's included; not the copy
    assert got["backward_ms.train"] == pytest.approx(2.0 + 0.5 + 0.125 + 1.0)
    assert got["optimizer_ms.train"] == pytest.approx(0.5)
    assert got["optimizer_host_ms.train"] == pytest.approx(18.0)
    assert got["sla_block_map_ms.train"] == pytest.approx(1.0)
    assert got["sla_linear_ms.train"] == pytest.approx(0.25)
    assert got["prefetch_wait_ms.train"] == pytest.approx(2.0)
    work = wan_self_attention(run["cfg"], run["batch"], run["tokens"])
    least = 2 * least_s(*work["fwd"]) + least_s(*work["bwd"])
    busy = (0.5 + 0.25 + 0.125 + 0.0625) + (0.5 + 0.125) + 1.0
    assert got["sla_roofline.train"] == pytest.approx(100.0 * least / (busy * MS))


def test_a_second_threads_kernel_counts_only_while_open_anywhere():
    trace = wan_trace()
    name = "gemm_bwd"
    assert name in [op[0] for op in ps.kernels_while_open(trace, "idt.train.backward")]
    for span in ("idt.train.backward", "idt.train.forward", "idt.train.optimizer",
                 "idt.train.step"):
        assert name not in [op[0] for op in ps.ops_in(trace, span)]
    # the step by the any-thread rule is its three phases and nothing else
    phases = sum(trace.device_s(f(trace, s)) for f, s in (
        (ps.ops_in, "idt.train.forward"), (ps.kernels_while_open, "idt.train.backward"),
        (ps.ops_in, "idt.train.optimizer")))
    assert trace.device_s(ps.kernels_while_open(trace, "idt.train.step")) == pytest.approx(phases)


def test_nested_spans_are_merged_before_attribution():
    trace = wan_trace()
    names = [op[0] for op in ps.ops_in(trace, "idt.wan.sla", "idt.wan.sla.linear")]
    assert "add_kernel" in names and names.count("linear_kernel") == 2


def plan_cfg():
    cell = core.find_cell("maze-plan-b4096-block")
    return cell, dict(cell.config, n_layers=1, n_train=10, ddim_steps=3)


def plan_trace(cfg, prefix="idt.", drop_block=False):
    """Two calls: encode, Stage 1 with one block per evaluation, lerp, one
    level span per level with one block each, and the benchmark's own
    request draws and copy outside them."""
    blocks = maze_call(cfg, 4)["blocks"]
    evals, levels = blocks[cfg["K"]], blocks[cfg["T"]]
    host, ops = [], []
    for c in range(2):
        t = 100 * c
        ops.append(("rand_kernel", t + 0.5, MAIN, 0.25))
        host += [(f"{prefix}plan.call", t + 1, t + 95, MAIN),
                 (f"{prefix}plan.encode", t + 2, t + 5, MAIN),
                 (f"{prefix}plan.stage1", t + 5, t + 50, MAIN),
                 (f"{prefix}plan.lerp", t + 50, t + 52, MAIN)]
        ops += [("conv_kernel", t + 3, MAIN, 0.5), ("lerp_kernel", t + 51, MAIN, 0.25)]
        for i in range(evals):
            host.append((f"{prefix}block", t + 6 + 4 * i, t + 9 + 4 * i, MAIN))
            ops.append(("fused_film_block", t + 7 + 4 * i, MAIN, 1.0))
        for i in range(levels):
            s = t + 53 + 12 * i
            host.append((f"{prefix}plan.level", s, s + 11, MAIN))
            host.append((f"{prefix}block", s + 1, s + 9, MAIN))
            ops += [("fused_film_block", s + 2, MAIN, 4.0), ("clamp_kernel", s + 10, MAIN, 0.125)]
        ops.append(("Memcpy DtoH (Device -> Pinned)", t + 96, MAIN, 0.5))
    if drop_block:
        host.remove(next(h for h in host if h[0] == f"{prefix}block"))
    return build(host, ops, {"calls": 2}), evals, levels


def test_plan_readers_per_call():
    cell, cfg = plan_cfg()
    trace, evals, levels = plan_trace(cfg)
    run = {"kind": "plan", "cfg": cfg, "batch": 4, "trace": trace}
    assert read(cell, "stage1_ms.plan", run) == pytest.approx(evals * 1.0)
    assert read(cell, "stage2_ms.plan", run) == pytest.approx(levels * (4.0 + 0.125))
    assert read(cell, "stage1_host_ms.plan", run) == pytest.approx(45.0)
    least = 2 * (evals * least_s(*maze_block(cfg, 4, cfg["K"]))
                 + levels * least_s(*maze_block(cfg, 4, cfg["T"])))
    busy = 2 * (evals * 1.0 + levels * 4.0) * MS
    assert read(cell, "film_roofline.plan", run) == pytest.approx(100.0 * least / busy)
    # the children cover the call; the request draws and the copy lie outside
    children = trace.device_s(ps.ops_in(trace, "idt.plan.encode", "idt.plan.stage1",
                                        "idt.plan.lerp", "idt.plan.level"))
    assert children == pytest.approx(trace.device_s(ps.ops_in(trace, "idt.plan.call")))
    trace_short, _, _ = plan_trace(cfg, drop_block=True)
    assert read(cell, "film_roofline.plan", dict(run, trace=trace_short)) is None


def test_no_program_spans_no_reading():
    cell, run = wan_run(wan_trace(prefix="pb."))
    assert all(read(cell, name, run) is None for name in TRAIN_READERS)
    pcell, cfg = plan_cfg()
    trace, _, _ = plan_trace(cfg, prefix="pb.")
    prun = {"kind": "plan", "cfg": cfg, "batch": 4, "trace": trace}
    assert all(read(pcell, name, prun) is None for name in PLAN_READERS)
    # and a reader of the other kind of run finds nothing either
    assert all(read(cell, name, dict(prun, trace=plan_trace(cfg)[0])) is None
               for name in TRAIN_READERS)
    assert all(read(pcell, name, wan_run(wan_trace())[1]) is None for name in PLAN_READERS)
