"""The self-attention core's share of its roofline, in %, from the
program's own spans: the least time of its work in the traced steps
(harness/work.wan_self_attention, once per `idt.wan.sla` span, the
recomputation under remat included, and the backward once per
`idt.wan.sla.bwd` span) over the device time of the operations launched
inside those spans on their threads."""
from portbench.harness.program_spans import count, ops_in, traced
from portbench.harness.work import least_s, wan_self_attention


def read(run):
    trace = traced(run, "train")
    if trace is None:
        return None
    busy = trace.device_s(ops_in(trace, "idt.wan.sla", "idt.wan.sla.bwd"))
    if busy <= 0:
        return None
    work = wan_self_attention(run["cfg"], run["batch"], run["tokens"])
    least = (count(trace, "idt.wan.sla") * least_s(*work["fwd"])
             + count(trace, "idt.wan.sla.bwd") * least_s(*work["bwd"]))
    return 100.0 * least / busy
