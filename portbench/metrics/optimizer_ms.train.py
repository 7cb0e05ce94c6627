"""Device milliseconds a traced training step spends in the update:
operations launched inside the program's `idt.train.optimizer` span (global
norm, clip, per-leaf cast, AdamW, EMA), on its thread."""
from portbench.harness.program_spans import count, ops_in, per_unit_ms, traced


def read(run):
    trace = traced(run, "train")
    if trace is None or not count(trace, "idt.train.optimizer"):
        return None
    return per_unit_ms(trace, ops_in(trace, "idt.train.optimizer"), "steps")
