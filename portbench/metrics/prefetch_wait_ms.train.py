"""Host milliseconds a traced training step waits for its batch: the
program's `idt.data.wait` spans, around the blocking read of
utils/prefetch.DevicePrefetcher's queue."""
from portbench.harness.program_spans import count, host_s, traced


def read(run):
    trace = traced(run, "train")
    if trace is None or not count(trace, "idt.data.wait"):
        return None
    return 1e3 * host_s(trace, "idt.data.wait") / trace.units["steps"]
