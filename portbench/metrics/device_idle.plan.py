"""Share of the profiled segment, planning calls issued and read as in the
window, in which no operation ran on the device, in %."""


def read(run):
    trace = run.get("trace")
    if run.get("kind") != "plan" or trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
