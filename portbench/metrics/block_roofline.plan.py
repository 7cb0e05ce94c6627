"""Both 12-layer FiLM transformer stacks' share of their roofline, in %:
the least time of the traced block calls' work (harness/work.maze_block at
each call's sequence length) over the device time of every operation
launched inside the benchmark's spans around the blocks, whatever kernels
implement them."""
from portbench.harness.work import least_s, maze_block, maze_call


def read(run):
    trace = run.get("trace")
    if run.get("kind") != "plan" or trace is None:
        return None
    busy = trace.device_s(trace.kernels_in("pb.block"))
    if busy <= 0:
        return None
    cfg, B = run["cfg"], run["batch"]
    per_call = maze_call(cfg, B)["blocks"]
    least = trace.units["calls"] * sum(n * least_s(*maze_block(cfg, B, L))
                                       for L, n in per_call.items())
    if trace.range_count("pb.block.fwd") != trace.units["calls"] * sum(per_call.values()):
        return None
    return 100.0 * least / busy
