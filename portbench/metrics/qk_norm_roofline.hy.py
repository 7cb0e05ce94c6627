"""The q/k RMSNorm + RoPE kernel pair's share of its roofline, in %: the
bytes of a step's launches (harness/work_hy.qk_norm_bytes: both directions,
the forward twice under remat) over 3.35 TB/s, per traced step, against
the device time of the pair's kernels in the traced steps."""
from portbench.harness.program_spans import traced
from portbench.harness.work import PEAK_HBM
from portbench.harness.work_hy import qk_norm_bytes

NAMES = ("qk_norm_rope_fwd_kernel", "qk_norm_rope_bwd_kernel")


def _ours(name: str) -> bool:
    return any(n in name for n in NAMES)


def read(run):
    trace = traced(run, "train")
    if trace is None or not run.get("traced_valid"):
        return None
    busy = trace.device_s([op for op in trace.device if _ours(op[0])])
    if busy <= 0:
        return None
    tr = run["traffic"]
    nbytes = qk_norm_bytes(run["cfg"], run["batch"], run["tokens"], tr["K"] + tr["text_len"])
    least = trace.units["steps"] * (nbytes["fwd"] + nbytes["bwd"]) / PEAK_HBM
    return 100.0 * least / busy
