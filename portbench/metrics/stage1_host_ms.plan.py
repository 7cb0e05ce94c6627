"""Host milliseconds a traced planning call spends issuing Stage 1: the
program's `idt.plan.stage1` span, calls issued as in the window. Set beside
stage1_ms.plan: at or above it, Stage 1 is paced by the host."""
from portbench.harness.program_spans import count, host_s, traced


def read(run):
    trace = traced(run, "plan")
    if trace is None or not count(trace, "idt.plan.stage1"):
        return None
    return 1e3 * host_s(trace, "idt.plan.stage1") / trace.units["calls"]
