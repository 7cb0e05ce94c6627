"""FLOPs of the planning calls completed in the measured window over the
window's time and the chip's bf16 peak, in % (harness/work.maze_call: the
model evaluations that run, the encoders once per call)."""
from portbench.harness.work import maze_call, mfu_percent


def read(run):
    if run.get("kind") != "plan" or not run.get("calls"):
        return None
    flops = maze_call(run["cfg"], run["batch"])["flops"] * run["calls"]
    return mfu_percent(flops, run["window_s"])
