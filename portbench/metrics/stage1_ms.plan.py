"""Device milliseconds a traced planning call spends in Stage 1 (the
keypoint solver loop): operations launched inside the program's
`idt.plan.stage1` span, on its thread."""
from portbench.harness.program_spans import count, ops_in, per_unit_ms, traced


def read(run):
    trace = traced(run, "plan")
    if trace is None or not count(trace, "idt.plan.stage1"):
        return None
    return per_unit_ms(trace, ops_in(trace, "idt.plan.stage1"), "calls")
