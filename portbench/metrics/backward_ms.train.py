"""Device milliseconds a traced training step spends in the backward:
kernels launched, from any thread, while the program's `idt.train.backward`
span is open (the autograd engine launches them from its own thread; the
activation recomputation under remat is part of it)."""
from portbench.harness.program_spans import count, kernels_while_open, per_unit_ms, traced


def read(run):
    trace = traced(run, "train")
    if trace is None or not count(trace, "idt.train.backward"):
        return None
    return per_unit_ms(trace, kernels_while_open(trace, "idt.train.backward"), "steps")
