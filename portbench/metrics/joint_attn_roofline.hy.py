"""The joint text-video attention's share of its roofline, in %: the least
time of the flash kernels' work in the traced steps (harness/work_hy.
joint_attention at each row's key length: the forward for every
`idt.hy.attn` span, twice a step under remat, and the backward once a step
per block) over the device time of the flash kernels (forward, dQ, dK/dV)
launched in those steps. In this cell every flash launch is a joint
attention: the refiner's attention is plain PyTorch."""
from portbench.harness.program_spans import count, traced
from portbench.harness.work import least_s
from portbench.harness.work_hy import joint_attention

NAMES = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel")


def read(run):
    trace = traced(run, "train")
    if trace is None or not run.get("traced_valid") or not count(trace, "idt.hy.attn"):
        return None
    busy = trace.device_s([op for op in trace.device if any(n in op[0] for n in NAMES)])
    if busy <= 0:
        return None
    cfg, tr = run["cfg"], run["traffic"]
    L = run["tokens"] + tr["K"] + tr["text_len"]
    blocks = cfg["num_layers"] + cfg["num_single_layers"]
    least = 0.0
    for valid in run["traced_valid"]:
        work = joint_attention(cfg, L, [run["tokens"] + tr["K"] + n for n in valid])
        least += blocks * (2 * least_s(*work["fwd"]) + least_s(*work["bwd"]))
    return 100.0 * least / busy
