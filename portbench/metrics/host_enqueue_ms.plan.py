"""Mean host milliseconds from a planning call's start to the return of
sample/generate.make_pipeline's callable, before the outputs are copied to
the host: the Python, wrapper and launch work of a call (the benchmark's own
span around the call, over the calls a traced run issues one at a time onto
an idle device after the window)."""


def read(run):
    enq = run.get("enqueue_s") if run.get("kind") == "plan" else None
    return 1e3 * sum(enq) / len(enq) if enq else None
