"""The yardstick's arithmetic for the HunyuanVideo cell: operations and bytes
of its Phase-1 LoRA step and of the two kernels it reads, counted from
shapes (harness/work.py's peaks and conventions: every product at the bf16
tensor-core peak, each input byte read once and each output byte written
once)."""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

from portbench.harness.work import BF16

F32 = 4


def dims(cfg: Dict) -> Tuple[int, int, int, int]:
    """(dim, heads, head dim, MLP width)."""
    H, dh = cfg["num_attention_heads"], cfg["attention_head_dim"]
    d = H * dh
    return d, H, dh, int(d * cfg["mlp_ratio"])


def joint_attention(cfg: Dict, L: int, kv_lens: Sequence[int]) -> Dict[str, Tuple[float, float]]:
    """(FLOPs, bytes) of one joint attention over [video; text] of L rows for
    the samples whose key lengths are kv_lens: every row of each sample's
    heads against its first kv_len keys. "fwd": Q K^T and P V; "bwd" twice
    those (the gradients of both operands of each, no recomputation). Bytes
    (bf16): q and o over L rows, k and v over the keys attended; the
    backward's q, o, dO in and dQ out over L rows, k, v in and dK, dV out over
    the keys, and its f32 lse and delta."""
    d, _, _, _ = dims(cfg)
    keys = float(sum(kv_lens))
    rows = float(L * len(kv_lens))
    fwd = 4.0 * L * keys * d
    fwd_bytes = (2 * rows + 2 * keys) * d * BF16
    bwd_bytes = (4 * rows + 4 * keys) * d * BF16 + 2 * rows * F32 * cfg["num_attention_heads"]
    return {"fwd": (fwd, fwd_bytes), "bwd": (2 * fwd, bwd_bytes)}


def qk_norm_bytes(cfg: Dict, B: int, L_v: int, L_t: int) -> Dict[str, float]:
    """Bytes of a step's q/k norm launches, each way (bf16 rows, f32 rstd
    a row and head, the f32 RoPE tables of the rotated rows once a launch):
    each dual-stream block norms q and k of the video rows (rotated) and of
    the text rows, each single-stream block q and k of the joint rows (the
    video rows rotated); the forward runs twice under remat."""
    d, H, dh, _ = dims(cfg)
    n2, n1 = cfg["num_layers"], cfg["num_single_layers"]

    def one(rows: int, rotated: int, bwd: bool) -> float:
        row = (3 if bwd else 2) * d * BF16 + H * F32   # x in, q out (dq in, dx out), rstd
        return B * (rows * row + rotated * dh * F32)   # cos / sin: Dh / 2 each

    fwd = 2 * (n2 * 2 * (one(L_v, L_v, False) + one(L_t, 0, False))
               + n1 * 2 * one(L_v + L_t, L_v, False))
    bwd = (n2 * 2 * (one(L_v, L_v, True) + one(L_t, 0, True))
           + n1 * 2 * one(L_v + L_t, L_v, True))
    return {"fwd": fwd, "bwd": bwd}


def step_flops(cfg: Dict, B: int, L_v: int, L_t: int, kv_lens: Sequence[int], K: int) -> float:
    """Model FLOPs of one Phase-1 LoRA step (forward and backward, no
    recomputation) for B samples of L_v video and L_t text rows whose joint
    key lengths are kv_lens. Forward: the patch embedding, the time /
    guidance / pooled embeddings, the token refiner over the text rows, every
    product of the 20 dual- and 40 single-stream blocks (their LoRA paths and
    modulation Linears included), the joint attention, the head and the
    frame-condition projector. Backward: the input gradient of every block
    product whose input needs one (all but the first dual block's video
    q / k / v, whose input is the patch embedding), of the refiner (its
    input holds the trainable frame-condition tokens) and of the head, twice
    the attention products, and the LoRA leaves' weight gradients; the frozen
    base gets none."""
    d, H, dh, ffn = dims(cfg)
    r = cfg["lora_rank"]
    n2, n1 = cfg["num_layers"], cfg["num_single_layers"]
    L = L_v + L_t
    td, pd = cfg["text_embed_dim"], cfg["pooled_projection_dim"]
    c_patch = cfg["in_channels"] * cfg["patch_size_t"] * cfg["patch_size"] ** 2
    lora = lambda tokens, d_in, d_out: 2 * tokens * r * (d_in + d_out)
    attn = sum(4.0 * L * kv * d for kv in kv_lens) / B   # a sample's joint attention
    # a dual block: q, k, v, out (4 d^2) and the FFN (2 d ffn) for both
    # streams, both modulation Linears (d x 6d) once a sample
    dual_base = 2 * L * (4 * d * d + 2 * d * ffn) + 2 * 2 * 6 * d * d
    dual_lora = 4 * lora(L, d, d) + lora(L, d, ffn) + lora(L, ffn, d)
    single_base = 2 * L * (3 * d * d + d * ffn + (d + ffn) * d) + 2 * 3 * d * d
    single_lora = 3 * lora(L, d, d) + lora(L, d, ffn) + lora(L, d + ffn, d)
    n_ref = cfg["num_refiner_layers"]
    refiner = (2 * L_t * td * d + 2 * (256 * d + d * d + td * d + d * d)
               + n_ref * (2 * L_t * (4 * d * d + 2 * d * ffn) + 4 * L_t * L_t * d
                          + 2 * 2 * d * d))
    embed = (2 * L_v * c_patch * d + 2 * (2 * (256 * d + d * d) + pd * d + d * d)
             + 2 * K * (cfg["frame_cond_dim"] * cfg["frame_cond_hidden"]
                        + cfg["frame_cond_hidden"] * td))
    head = 2 * 2 * d * d + 2 * L_v * d * cfg["out_channels"] * cfg["patch_size"] ** 2
    fwd = (n2 * (dual_base + dual_lora + attn) + n1 * (single_base + single_lora + attn)
           + refiner + embed + head)
    first_qkv = 2 * L_v * 3 * d * d
    bwd = (n2 * (dual_base + 2 * attn + 2 * dual_lora) + n1 * (single_base + 2 * attn
                                                               + 2 * single_lora)
           - first_qkv + refiner + head)
    return float(B * (fwd + bwd))
