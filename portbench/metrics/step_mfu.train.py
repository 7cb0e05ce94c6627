"""Model FLOPs of the training steps completed in the measured window over
the window's time and the chip's bf16 peak, in % (harness/work.wan_step_flops:
forward and backward, no recomputation, no weight gradients of the frozen
base)."""
from portbench.harness.work import mfu_percent, wan_step_flops


def read(run):
    if run.get("kind") != "train" or not run.get("steps"):
        return None
    flops = wan_step_flops(run["cfg"], run["batch"], run["tokens"], run["traffic"]["text_len"],
                           run["traffic"]["K"])
    return mfu_percent(flops * run["steps"], run["window_s"])
