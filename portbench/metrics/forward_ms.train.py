"""Device milliseconds a traced training step spends in the loss's forward:
operations launched inside the program's `idt.train.forward` span, on its
thread."""
from portbench.harness.program_spans import count, ops_in, per_unit_ms, traced


def read(run):
    trace = traced(run, "train")
    if trace is None or not count(trace, "idt.train.forward"):
        return None
    return per_unit_ms(trace, ops_in(trace, "idt.train.forward"), "steps")
