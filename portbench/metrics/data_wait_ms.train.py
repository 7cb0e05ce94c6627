"""Host milliseconds a training step waits in next() of the program's loader
(data/dataset.BatchLoader behind utils/prefetch.DevicePrefetcher), the mean
over the measured window's steps: the benchmark's own span around the call."""


def read(run):
    waits = run.get("data_wait_s") if run.get("kind") == "train" else None
    return 1e3 * sum(waits) / len(waits) if waits else None
