"""Both 12-layer FiLM transformer stacks' share of their roofline, in %,
from the program's own spans: the least time of the traced block calls'
work (harness/work.maze_block at each call's sequence length) over the
device time of the operations launched inside the program's `idt.block`
spans, whatever kernels implement the blocks. None unless every block call
of the traced calls opened its span."""
from portbench.harness.program_spans import count, ops_in, traced
from portbench.harness.work import least_s, maze_block, maze_call


def read(run):
    trace = traced(run, "plan")
    if trace is None:
        return None
    cfg, B = run["cfg"], run["batch"]
    per_call = maze_call(cfg, B)["blocks"]
    if count(trace, "idt.block") != trace.units["calls"] * sum(per_call.values()):
        return None
    busy = trace.device_s(ops_in(trace, "idt.block"))
    if busy <= 0:
        return None
    least = trace.units["calls"] * sum(n * least_s(*maze_block(cfg, B, L))
                                       for L, n in per_call.items())
    return 100.0 * least / busy
