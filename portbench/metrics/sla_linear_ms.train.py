"""Device milliseconds a traced training step spends in SLA's linear branch
and its projection `proj_l`: operations launched inside the program's
`idt.wan.sla.linear` spans on their thread, the forward's and the
recomputation's under remat."""
from portbench.harness.program_spans import count, ops_in, per_unit_ms, traced


def read(run):
    trace = traced(run, "train")
    if trace is None or not count(trace, "idt.wan.sla.linear"):
        return None
    return per_unit_ms(trace, ops_in(trace, "idt.wan.sla.linear"), "steps")
