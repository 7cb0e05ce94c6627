"""Model FLOPs of the HunyuanVideo training steps completed in the measured
window over the window's time and the chip's bf16 peak, in %
(harness/work_hy.step_flops at each step's own prompt lengths: forward and
backward, no recomputation, no weight gradients of the frozen base)."""
from portbench.harness.work import mfu_percent
from portbench.harness.work_hy import step_flops


def kv_lens(run, valid):
    """Joint key lengths of a step's rows: the video, the frame-condition
    tokens and the valid prompt tokens."""
    return [run["tokens"] + run["traffic"]["K"] + n for n in valid]


def read(run):
    if run.get("kind") != "train" or not run.get("steps") or "window_valid" not in run:
        return None
    tr = run["traffic"]
    L_t = tr["K"] + tr["text_len"]
    flops = sum(step_flops(run["cfg"], run["batch"], run["tokens"], L_t, kv_lens(run, v), tr["K"])
                for v in run["window_valid"])
    return mfu_percent(flops, run["window_s"])
