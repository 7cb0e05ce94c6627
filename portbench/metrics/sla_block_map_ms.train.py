"""Device milliseconds a traced training step spends building SLA's block
map (pooled scores, top-k LUT): operations launched inside the program's
`idt.wan.sla.block_map` spans on their thread, the forward's and the
recomputation's under remat."""
from portbench.harness.program_spans import count, ops_in, per_unit_ms, traced


def read(run):
    trace = traced(run, "train")
    if trace is None or not count(trace, "idt.wan.sla.block_map"):
        return None
    return per_unit_ms(trace, ops_in(trace, "idt.wan.sla.block_map"), "steps")
