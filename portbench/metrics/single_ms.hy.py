"""Device milliseconds a traced HunyuanVideo step spends in the 40
single-stream blocks: kernels launched, from any thread, while the
program's `idt.hy.single` span is open (the forward, its recomputation
under remat and the backward)."""
from portbench.harness.program_spans import count, kernels_while_open, per_unit_ms, traced


def read(run):
    trace = traced(run, "train")
    if trace is None or not count(trace, "idt.hy.single"):
        return None
    return per_unit_ms(trace, kernels_while_open(trace, "idt.hy.single"), "steps")
