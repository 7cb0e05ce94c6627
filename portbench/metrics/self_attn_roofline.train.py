"""The self-attention core's share of its roofline, in %: the least time of
its work in the traced steps (harness/work.wan_self_attention: the forward
once and again under activation recomputation, and the backward) over the
device time of every operation launched inside the benchmark's spans around
the SLA module's forward and backward, whatever kernels implement it."""
from portbench.harness.work import least_s, wan_self_attention


def read(run):
    trace = run.get("trace")
    if run.get("kind") != "train" or trace is None:
        return None
    ops = trace.kernels_in("pb.self_attn")
    busy = trace.device_s(ops)
    if busy <= 0:
        return None
    work = wan_self_attention(run["cfg"], run["batch"], run["tokens"])
    fwd_calls = trace.range_count("pb.self_attn.fwd")
    bwd_calls = trace.range_count("pb.self_attn.bwd")
    least = fwd_calls * least_s(*work["fwd"]) + bwd_calls * least_s(*work["bwd"])
    return 100.0 * least / busy
