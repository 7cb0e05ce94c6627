"""Device milliseconds a traced planning call spends in Stage 2: operations
launched inside the program's `idt.plan.level` spans (one per refinement
level), on their thread."""
from portbench.harness.program_spans import count, ops_in, per_unit_ms, traced


def read(run):
    trace = traced(run, "plan")
    if trace is None or not count(trace, "idt.plan.level"):
        return None
    return per_unit_ms(trace, ops_in(trace, "idt.plan.level"), "calls")
