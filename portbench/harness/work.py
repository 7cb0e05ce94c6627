"""The yardstick's arithmetic: peaks of the chip, and the operations and
bytes of the work the cells do, counted from shapes.

Peaks are NVIDIA's published dense rates of one H100 SXM at its 700 W limit.
Every product is counted at the bfloat16 tensor-core peak, whatever precision
the program runs it in, so that a share of a peak can only be under 100%.
Bytes count each input read once and each output written once.
"""
from __future__ import annotations

from typing import Dict, Tuple

PEAK_BF16 = 989e12     # FLOP/s, dense
PEAK_HBM = 3.35e12     # bytes/s
BF16 = 2


def least_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: operations or bytes, whichever
    bounds."""
    return max(flops / PEAK_BF16, nbytes / PEAK_HBM)


def mfu_percent(flops: float, seconds: float) -> float:
    return 100.0 * flops / seconds / PEAK_BF16


# ---------------------------------------------------------------------------
# maze planner
# ---------------------------------------------------------------------------

def ddim_evaluations(n_train: int, steps: int) -> int:
    """Model evaluations of a linear-spacing DDIM run: one per pair of the
    deduplicated timesteps with both ends kept."""
    import numpy as np

    times = set(np.linspace(0, n_train - 1, steps).astype(np.int64).tolist()) | {0, n_train - 1}
    return len(times) - 1


def maze_block(cfg: Dict, B: int, L: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one FiLM transformer block at [B, L, d]: q/k/v and
    out projections, the FFN, attention (QK^T and PV over all heads) and the
    two FiLM projections of the condition vector."""
    d, dff, dc = cfg["d_model"], cfg["d_ff"], cfg["d_cond"]
    per_token = 2 * d * (4 * d + 2 * dff) + 4 * L * d
    flops = B * L * per_token + B * 2 * (2 * dc * 2 * d)
    weights = (4 * d * d + 2 * d * dff + 2 * dc * 2 * d) * BF16
    acts = 2 * B * L * d * BF16 + B * dc * BF16
    return float(flops), float(weights + acts)


def maze_encoder_flops(cfg: Dict, B: int) -> float:
    """The maze CNN (3x3 same convolutions) and its linear head, and the
    start/goal MLP, for B requests."""
    G, dc = cfg["grid"], cfg["d_cond"]
    flops, cin = 0, 1
    for c in cfg["maze_channels"]:
        flops += 2 * 9 * cin * c * G * G
        cin = c
    flops += 2 * cin * dc + 2 * 4 * dc + 2 * dc * dc
    return float(B * flops)


def maze_call(cfg: Dict, B: int) -> Dict[str, float]:
    """FLOPs of one planning call of B requests, and the block calls it
    makes by sequence length: {"flops", "blocks": {L: count}}."""
    d, K, T, n = cfg["d_model"], cfg["K"], cfg["T"], cfg["n_layers"]
    dd, dc = cfg["data_dim"], cfg["d_cond"]
    evals = ddim_evaluations(cfg["n_train"], cfg["ddim_steps"])
    levels = cfg["levels"]
    s1_block, _ = maze_block(cfg, B, K)
    s2_block, _ = maze_block(cfg, B, T)
    s1_io = B * K * 2 * d * (2 * dd + d // 2 + dd) + B * (2 * 2 * d * d + 2 * dc * d)
    s2_io = B * T * 2 * d * (cfg["mask_channels"] + dd + dd) + B * (2 * 2 * d * d + 2 * dc * d)
    flops = (evals * (n * s1_block + s1_io) + levels * (n * s2_block + s2_io)
             + 2 * maze_encoder_flops(cfg, B))
    return {"flops": float(flops), "blocks": {K: evals * n, T: levels * n}}


# ---------------------------------------------------------------------------
# Wan2.1 Phase-1 LoRA step
# ---------------------------------------------------------------------------

def sla_keys(cfg: Dict, L: int) -> int:
    n = -(-L // cfg["sla_block"])
    topk = max(1, min(n, int(cfg["sla_topk"] * n)))
    return min(L, topk * cfg["sla_block"])


def wan_self_attention(cfg: Dict, B: int, L: int) -> Dict[str, Tuple[float, float]]:
    """(FLOPs, bytes) of one layer's self-attention core (SLA) for B
    samples: "fwd" the sparse branch over the LUT's keys (QK^T, PV), the
    linear branch (phi(k)^T v, phi(q) kv, the denominator) and its
    projection; "bwd" twice those products (the gradients of both operands
    of each, no recomputation). Bytes: q, k, v in and o out, and for the
    backward q, k, v, o, dO in and dQ, dK, dV out, bfloat16."""
    d = cfg["dim"]
    dh = d // cfg["num_heads"]
    fwd = B * (4 * L * sla_keys(cfg, L) * d + 6 * L * d * dh)
    act = B * L * d * BF16
    return {"fwd": (float(fwd), float(4 * act)), "bwd": (float(2 * fwd), float(8 * act))}


def wan_step_flops(cfg: Dict, B: int, L: int, n_text: int, n_extra: int) -> float:
    """Model FLOPs of one Phase-1 LoRA step (forward and backward, no
    recomputation). Forward: every product of the patch embedding, the
    condition embedders, the 30 blocks (their LoRA paths included), the
    attention (SLA as counted above, dense cross-attention over the text and
    frame-condition tokens) and the head. Backward: the input gradient of
    every block product whose input needs one (all but the first block's
    q/k/v, whose input is the patch embedding), the cross-attention k/v
    products over the context (the frame-condition tokens train), twice the
    attention products, and the weight gradients of the LoRA leaves; the
    frozen base gets no weight gradient."""
    d, ffn, r, n = cfg["dim"], cfg["ffn_dim"], cfg["lora_rank"], cfg["num_layers"]
    Lc = n_text + n_extra
    td = cfg["text_dim"]
    patch = cfg["patch_size"][0] * cfg["patch_size"][1] * cfg["patch_size"][2]
    c_patch = cfg["in_dim"] * patch
    lora = lambda tokens, d_in, d_out: 2 * tokens * r * (d_in + d_out)
    base_tok = 2 * L * (4 * d * d + 2 * d * d + 2 * d * ffn)      # self qkvo, cross q/o, ffn
    base_ctx = 2 * Lc * 2 * d * d                                  # cross k, v
    lora_f = (lora(L, d, d) * 6 + lora(Lc, d, d) * 2 + lora(L, d, ffn) + lora(L, ffn, d))
    sa = wan_self_attention(cfg, 1, L)["fwd"][0]
    ca = 4 * L * Lc * d
    layer_fwd = base_tok + base_ctx + lora_f + sa + ca
    embed = (2 * L * c_patch * d + 2 * (cfg["freq_dim"] * d + d * d + d * 6 * d)
             + 2 * n_text * (td * d + d * d) + 2 * n_extra * (td * d + d * d)
             + 2 * n_extra * (cfg["frame_cond_dim"] * cfg["frame_cond_hidden"]
                              + cfg["frame_cond_hidden"] * td))
    head = 2 * L * d * cfg["out_dim"] * patch
    fwd = n * layer_fwd + embed + head
    first_qkv = 2 * L * 3 * d * d
    bwd = (n * (base_tok + base_ctx + 2 * (sa + ca) + 2 * lora_f) - first_qkv
           + 2 * n_extra * (td * d + d * d) + head)
    return float(B * (fwd + bwd))

