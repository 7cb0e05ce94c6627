"""Host milliseconds a traced training step spends inside the program's
`idt.train.optimizer` span: the Python and launches of the clip, the
per-leaf cast over every trainable leaf, AdamW and the EMA."""
from portbench.harness.program_spans import count, host_s, traced


def read(run):
    trace = traced(run, "train")
    if trace is None or not count(trace, "idt.train.optimizer"):
        return None
    return 1e3 * host_s(trace, "idt.train.optimizer") / trace.units["steps"]
