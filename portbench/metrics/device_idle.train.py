"""Share of the traced training steps in which no operation ran on the
device (the union of the device operations' intervals against the traced
window), in %."""


def read(run):
    trace = run.get("trace")
    if run.get("kind") != "train" or trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
