"""Cells of the manifest cut to sizes a CPU test can run: every width
small, the same code paths. The maze keeps the planner's own shape (12
layers, T 64, K 8, DDIM-20, 3 levels): the float8 control's gap grows with
depth and steps, and a 2-layer, 5-step planner would hide it."""
from portbench.harness import core


def tiny_wan():
    cell = core.find_cell("wan13b-p1-lora-sla")
    cell.config = dict(cell.config, dim=64, num_layers=2, num_heads=2, ffn_dim=128, in_dim=4,
                       out_dim=4, text_dim=32, lora_rank=2, sla_block=64, sla_topk=0.5,
                       frame_cond_hidden=16)
    cell.traffic = dict(cell.traffic, T=8, K=3, latents=[4, 16, 16], text_len=6)
    return cell


def tiny_maze(policy: str = "block"):
    cell = core.find_cell(f"maze-plan-b4096-{policy}")
    cell.config = dict(cell.config, d_model=64, n_heads=4, d_ff=128, d_cond=32,
                       maze_channels=[8, 16])
    cell.traffic = dict(cell.traffic, batch=32, check_rows=64, warmup_calls=1, trace_calls=2)
    return cell
