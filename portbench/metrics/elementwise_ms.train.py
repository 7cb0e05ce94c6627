"""Device milliseconds a traced training step spends in kernels that are
neither matrix products (cuBLAS / CUTLASS, by the names below) nor the
port's hand-written attention kernels, nor launched inside the benchmark's
self-attention spans: norms, modulation, RoPE, casts, optimizer and the
rest of PyTorch's elementwise and reduction kernels."""

GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass", "cublas", "splitkreduce")
ATTENTION_NAMES = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel",
                   "sla_fwd_kernel", "sla_bwd_dq_kernel", "sla_bwd_dkdv_kernel")


def read(run):
    trace = run.get("trace")
    if run.get("kind") != "train" or trace is None:
        return None
    in_spans = {op[3] for op in trace.kernels_in("pb.self_attn")}
    total = 0.0
    for name, s, e, corr in trace.device:
        low = name.lower()
        if corr in in_spans or any(g in low for g in GEMM_NAMES):
            continue
        if any(a in name for a in ATTENTION_NAMES) or "memcpy" in low or "memset" in low:
            continue
        total += e - s
    return 1e3 * total / trace.units["steps"]
