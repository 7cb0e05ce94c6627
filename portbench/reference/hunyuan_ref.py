"""Plain PyTorch reference of the HunyuanVideo Phase-1 LoRA training step,
float32.

The model follows the published HunyuanVideo transformer (tencent/HunyuanVideo;
diffusers' HunyuanVideoTransformer3DModel, whose parameter names it uses):
(1, 2, 2) patch embedding; a token refiner over the text states (a time +
masked-mean-pooled conditioning vector gating 2 blocks of masked
self-attention and a SiLU MLP); temb = time + guidance + pooled-CLIP
embeddings; 20 dual-stream blocks (video and text with weights of their own,
adaLN-zero modulation, per-head RMS-normed q / k, RoPE on the video q / k,
one attention over [video; text] with the padded text keys masked, tanh-GELU
FFNs); 40 single-stream blocks over [video; text] (attention, RoPE on the
video rows only, and an MLP in parallel, one output projection); a head
modulated by temb (scale first). RoPE rotates interleaved pairs over t / h / w
head-dim splits of 16 / 56 / 56 at theta 256, t at the frames' absolute
indices. LoRA adds (alpha / r)(x A^T) B^T to the dual blocks' attention
projections and FFNs and to the single blocks' q / k / v, proj_mlp and
proj_out. The Phase-1 loss is portbench/reference/wan_ref's (anchor-slot eps
MSE, jittered uniform anchors, linear betas), with the K frame-condition
tokens ahead of the prompt in the refiner's input and text dropout zeroing
the prompt and the pooled vector; the update is a global-norm clip and AdamW
over the LoRA and frame-condition leaves.

It imports nothing of the program. The benchmark hands it the program's
weights (the frozen base in bfloat16); each product upcasts its operands
(`Numerics`), and each block runs under an activation checkpoint, so that a
block's float32 weights and intermediates live only while that block runs;
the attention runs a few heads at a time under checkpoints of their own.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.harness.weights import Leaf
from portbench.reference import wan_ref
from portbench.reference.numerics import Numerics
from portbench.reference.update import adamw_steps

W = Dict[str, torch.Tensor]
HEAD_CHUNK = 4     # heads of the joint attention at a time


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def _lin(name: str, d_in: int, d_out: int, dtype, scale: float = 1.0) -> List[Leaf]:
    s = scale * (3.0 * d_in) ** -0.5
    return [Leaf(f"{name}.weight", (d_out, d_in), s, 0.0, dtype),
            Leaf(f"{name}.bias", (d_out,), s, 0.0, dtype)]


def _lora(name: str, d_in: int, d_out: int, r: int) -> List[Leaf]:
    return [Leaf(f"{name}.lora_A", (r, d_in), 1.0 / r, 0.0, torch.float32),
            Leaf(f"{name}.lora_B", (d_out, r), 2e-3, 0.0, torch.float32)]


def param_spec(cfg: Dict) -> List[Leaf]:
    """Every leaf of the model ("hy." prefix; the frozen base in bfloat16,
    the LoRA leaves float32) and of the frame-condition projector ("fc.",
    float32). Weights and biases ~ N(0, 1/(3 fan_in)), the modulation
    Linears a tenth of that (their gates stay small through 60 blocks), norm
    scales near 1, LoRA A std 1/r and B small but non-zero."""
    bf = torch.bfloat16
    H, dh = cfg["num_attention_heads"], cfg["attention_head_dim"]
    d, r = H * dh, cfg["lora_rank"]
    ffn = int(d * cfg["mlp_ratio"])
    p, pt, ps = "hy.", cfg["patch_size_t"], cfg["patch_size"]
    c_in, td, pd = cfg["in_channels"], cfg["text_embed_dim"], cfg["pooled_projection_dim"]
    fan = c_in * pt * ps * ps
    spec = [Leaf(p + "x_embedder.proj.weight", (d, c_in, pt, ps, ps), (3.0 * fan) ** -0.5, 0.0,
                 bf),
            Leaf(p + "x_embedder.proj.bias", (d,), (3.0 * fan) ** -0.5, 0.0, bf)]
    ce = p + "context_embedder."
    spec += _lin(ce + "time_text_embed.timestep_embedder.linear_1", 256, d, bf)
    spec += _lin(ce + "time_text_embed.timestep_embedder.linear_2", d, d, bf)
    spec += _lin(ce + "time_text_embed.text_embedder.linear_1", td, d, bf)
    spec += _lin(ce + "time_text_embed.text_embedder.linear_2", d, d, bf)
    spec += _lin(ce + "proj_in", td, d, bf)
    for i in range(cfg["num_refiner_layers"]):
        b = f"{ce}token_refiner.refiner_blocks.{i}."
        for norm in ("norm1", "norm2"):
            spec += [Leaf(f"{b}{norm}.weight", (d,), 0.05, 1.0, bf),
                     Leaf(f"{b}{norm}.bias", (d,), 0.05, 0.0, bf)]
        for proj in ("to_q", "to_k", "to_v", "to_out.0"):
            spec += _lin(f"{b}attn.{proj}", d, d, bf)
        spec += _lin(b + "ff.net.0.proj", d, ffn, bf) + _lin(b + "ff.net.2", ffn, d, bf)
        spec += _lin(b + "norm_out.linear", d, 2 * d, bf, scale=0.1)
    for emb in ("timestep_embedder", "guidance_embedder"):
        spec += _lin(f"{p}time_text_embed.{emb}.linear_1", 256, d, bf)
        spec += _lin(f"{p}time_text_embed.{emb}.linear_2", d, d, bf)
    spec += _lin(p + "time_text_embed.text_embedder.linear_1", pd, d, bf)
    spec += _lin(p + "time_text_embed.text_embedder.linear_2", d, d, bf)
    for i in range(cfg["num_layers"]):
        b = f"{p}transformer_blocks.{i}."
        spec += _lin(b + "norm1.linear", d, 6 * d, bf, scale=0.1)
        spec += _lin(b + "norm1_context.linear", d, 6 * d, bf, scale=0.1)
        for proj in ("to_q", "to_k", "to_v", "to_out.0", "add_q_proj", "add_k_proj",
                     "add_v_proj", "to_add_out"):
            spec += _lin(f"{b}attn.{proj}", d, d, bf) + _lora(f"{b}attn.{proj}", d, d, r)
        for norm in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            spec.append(Leaf(f"{b}attn.{norm}.weight", (dh,), 0.05, 1.0, bf))
        for ff in ("ff", "ff_context"):
            for proj, d_in, d_out in (("net.0.proj", d, ffn), ("net.2", ffn, d)):
                spec += _lin(f"{b}{ff}.{proj}", d_in, d_out, bf)
                spec += _lora(f"{b}{ff}.{proj}", d_in, d_out, r)
    for i in range(cfg["num_single_layers"]):
        b = f"{p}single_transformer_blocks.{i}."
        for proj in ("to_q", "to_k", "to_v"):
            spec += _lin(f"{b}attn.{proj}", d, d, bf) + _lora(f"{b}attn.{proj}", d, d, r)
        for norm in ("norm_q", "norm_k"):
            spec.append(Leaf(f"{b}attn.{norm}.weight", (dh,), 0.05, 1.0, bf))
        spec += _lin(b + "norm.linear", d, 3 * d, bf, scale=0.1)
        spec += _lin(b + "proj_mlp", d, ffn, bf) + _lora(b + "proj_mlp", d, ffn, r)
        spec += _lin(b + "proj_out", d + ffn, d, bf) + _lora(b + "proj_out", d + ffn, d, r)
    spec += _lin(p + "norm_out.linear", d, 2 * d, bf, scale=0.1)
    spec += _lin(p + "proj_out", d, cfg["out_channels"] * pt * ps * ps, bf)
    spec += _lin("fc.fc_0", cfg["frame_cond_dim"], cfg["frame_cond_hidden"], torch.float32)
    spec += _lin("fc.out", cfg["frame_cond_hidden"], td, torch.float32, scale=0.1)
    return spec


# ---------------------------------------------------------------------------
# model pieces
# ---------------------------------------------------------------------------

def time_sinusoid(x: torch.Tensor, dim: int = 256) -> torch.Tensor:
    """[cos | sin] of x * 10000^(-i / (dim / 2)) (diffusers' flip_sin_to_cos)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=x.device) / half)
    a = x.float()[:, None] * freqs
    return torch.cat([torch.cos(a), torch.sin(a)], dim=-1)


def rope_tables(frame_idx: torch.Tensor, pph: int, ppw: int, axes, theta: float):
    """(cos, sin) [B, F*pph*ppw, sum(axes)/2]: per-axis angles pos / theta^(2i
    / axis_dim), t at the frames' absolute indices, h and w the patch grid."""
    B, Fr = frame_idx.shape
    dev = frame_idx.device
    grid = {"t": frame_idx.float()[:, :, None, None].expand(B, Fr, pph, ppw),
            "h": torch.arange(pph, device=dev).float()[None, None, :, None].expand(B, Fr, pph, ppw),
            "w": torch.arange(ppw, device=dev).float()[None, None, None, :].expand(B, Fr, pph, ppw)}
    parts = []
    for axis, dim in zip(("t", "h", "w"), axes):
        freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=dev) / dim))
        parts.append(grid[axis].reshape(B, -1)[..., None] * freqs)
    ang = torch.cat(parts, dim=-1)
    return torch.cos(ang), torch.sin(ang)


class HyRef:
    """One reference model over a weight dict; `num` sets the products'
    precision."""

    def __init__(self, P: W, cfg: Dict, num: Numerics):
        self.P, self.cfg, self.num = P, cfg, num
        self.alpha = cfg["lora_alpha"] / cfg["lora_rank"]
        self.H, self.dh = cfg["num_attention_heads"], cfg["attention_head_dim"]

    def lin(self, name: str, x: torch.Tensor) -> torch.Tensor:
        P = self.P
        y = self.num.linear(x, P[name + ".weight"], P[name + ".bias"])
        if name + ".lora_A" in P:
            z = self.num.linear(x, P[name + ".lora_A"])
            y = y + self.num.linear(z, P[name + ".lora_B"]) * self.alpha
        return y

    def mlp(self, prefix: str, x: torch.Tensor, act) -> torch.Tensor:
        return self.lin(prefix + "linear_2", act(self.lin(prefix + "linear_1", x)))

    def heads(self, t: torch.Tensor) -> torch.Tensor:
        B, L, _ = t.shape
        return t.reshape(B, L, self.H, self.dh).transpose(1, 2)

    def qk(self, prefix: str, x, q_name, k_name, qn, kn):
        """RMS-normed (per head, [Dh] weights) q and k [B, H, L, Dh]."""
        P = self.P
        q = wan_ref.rms_norm(self.heads(self.lin(prefix + q_name, x)), P[prefix + qn + ".weight"])
        k = wan_ref.rms_norm(self.heads(self.lin(prefix + k_name, x)), P[prefix + kn + ".weight"])
        return q, k

    def _attend(self, q, k, v, keep):
        logits = self.num.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
        p = torch.softmax(logits.masked_fill(~keep, float("-inf")), dim=-1)
        return self.num.matmul(p, v)

    def attention(self, q, k, v, keep):
        """softmax(q k^T / sqrt(Dh)) v over [B, H, L, Dh] with keep [B, 1, Lq
        or 1, Lk]: a few heads at a time, each group under a checkpoint."""
        outs = []
        for h0 in range(0, q.shape[1], HEAD_CHUNK):
            sl = slice(h0, h0 + HEAD_CHUNK)
            if torch.is_grad_enabled():
                outs.append(checkpoint(self._attend, q[:, sl], k[:, sl], v[:, sl], keep,
                                       use_reentrant=False))
            else:
                outs.append(self._attend(q[:, sl], k[:, sl], v[:, sl], keep))
        o = torch.cat(outs, dim=1)
        return o.transpose(1, 2).reshape(o.shape[0], o.shape[2], -1)

    def modulation(self, name: str, temb: torch.Tensor, n: int):
        return [m[:, None] for m in self.lin(name, F.silu(temb)).chunk(n, dim=-1)]

    def refiner(self, text, t, mask):
        P, ce = self.P, "hy.context_embedder."
        m = mask.float()[..., None]
        pooled = (text * m).sum(dim=1) / m.sum(dim=1)
        c = (self.mlp(ce + "time_text_embed.timestep_embedder.", time_sinusoid(t), F.silu)
             + self.mlp(ce + "time_text_embed.text_embedder.", pooled, F.silu))
        h = self.lin(ce + "proj_in", text)
        valid = mask.bool()
        keep = (valid[:, :, None] & valid[:, None, :])
        keep[:, :, 0] = True
        for i in range(self.cfg["num_refiner_layers"]):
            b = f"{ce}token_refiner.refiner_blocks.{i}."
            g_msa, g_mlp = self.modulation(b + "norm_out.linear", c, 2)
            x = wan_ref.layer_norm(h, P[b + "norm1.weight"], P[b + "norm1.bias"])
            q, k, v = (self.heads(self.lin(f"{b}attn.{n}", x)) for n in ("to_q", "to_k", "to_v"))
            h = h + self.lin(b + "attn.to_out.0", self.attention(q, k, v, keep[:, None])) * g_msa
            x = wan_ref.layer_norm(h, P[b + "norm2.weight"], P[b + "norm2.bias"])
            h = h + self.lin(b + "ff.net.2", F.silu(self.lin(b + "ff.net.0.proj", x))) * g_mlp
        return h

    def double(self, i, img, txt, temb, cos, sin, keep):
        b = f"hy.transformer_blocks.{i}."
        sh, sc, g, sh2, sc2, g2 = self.modulation(b + "norm1.linear", temb, 6)
        csh, csc, cg, csh2, csc2, cg2 = self.modulation(b + "norm1_context.linear", temb, 6)
        hi = wan_ref.layer_norm(img) * (1 + sc) + sh
        ht = wan_ref.layer_norm(txt) * (1 + csc) + csh
        qi, ki = self.qk(b + "attn.", hi, "to_q", "to_k", "norm_q", "norm_k")
        qt, kt = self.qk(b + "attn.", ht, "add_q_proj", "add_k_proj", "norm_added_q",
                         "norm_added_k")
        qi, ki = wan_ref.rotate(qi, cos, sin), wan_ref.rotate(ki, cos, sin)
        v = torch.cat([self.heads(self.lin(b + "attn.to_v", hi)),
                       self.heads(self.lin(b + "attn.add_v_proj", ht))], dim=2)
        o = self.attention(torch.cat([qi, qt], dim=2), torch.cat([ki, kt], dim=2), v, keep)
        Lv = img.shape[1]
        img = img + self.lin(b + "attn.to_out.0", o[:, :Lv]) * g
        txt = txt + self.lin(b + "attn.to_add_out", o[:, Lv:]) * cg
        ff = lambda pre, x: self.lin(pre + "net.2", wan_ref.gelu(self.lin(pre + "net.0.proj", x)))
        img = img + g2 * ff(b + "ff.", wan_ref.layer_norm(img) * (1 + sc2) + sh2)
        txt = txt + cg2 * ff(b + "ff_context.", wan_ref.layer_norm(txt) * (1 + csc2) + csh2)
        return img, txt

    def single(self, i, x, temb, cos, sin, keep, Lv: int):
        b = f"hy.single_transformer_blocks.{i}."
        sh, sc, g = self.modulation(b + "norm.linear", temb, 3)
        h = wan_ref.layer_norm(x) * (1 + sc) + sh
        q, k = self.qk(b + "attn.", h, "to_q", "to_k", "norm_q", "norm_k")
        rot = lambda t: torch.cat([wan_ref.rotate(t[:, :, :Lv], cos, sin), t[:, :, Lv:]], dim=2)
        o = self.attention(rot(q), rot(k), self.heads(self.lin(b + "attn.to_v", h)), keep)
        m = wan_ref.gelu(self.lin(b + "proj_mlp", h))
        return x + g * self.lin(b + "proj_out", torch.cat([o, m], dim=-1))

    def forward(self, latents, t, text, mask, pooled, guidance, frame_idx):
        """latents [B, C, F, H, W] -> prediction of the same shape."""
        cfg, P = self.cfg, self.P
        B, C, Fr, Hh, Ww = latents.shape
        ps = cfg["patch_size"]
        pph, ppw = Hh // ps, Ww // ps
        z = latents.reshape(B, C, Fr, 1, pph, ps, ppw, ps).permute(0, 2, 4, 6, 1, 3, 5, 7)
        z = z.reshape(B, Fr * pph * ppw, C * ps * ps)
        img = self.num.linear(z, P["hy.x_embedder.proj.weight"].flatten(1),
                              P["hy.x_embedder.proj.bias"])
        tt = "hy.time_text_embed."
        temb = (self.mlp(tt + "timestep_embedder.", time_sinusoid(t), F.silu)
                + self.mlp(tt + "guidance_embedder.", time_sinusoid(guidance), F.silu)
                + self.mlp(tt + "text_embedder.", pooled, F.silu))
        txt = self.refiner(text, t, mask)
        Lv = img.shape[1]
        L = Lv + txt.shape[1]
        keep = (torch.arange(L, device=img.device)[None, :]
                < (Lv + mask.sum(dim=1))[:, None])[:, None, None, :]
        cos, sin = rope_tables(frame_idx, pph, ppw, cfg["rope_axes_dim"], cfg["rope_theta"])
        grad = torch.is_grad_enabled()
        for i in range(cfg["num_layers"]):
            if grad:
                img, txt = checkpoint(self.double, i, img, txt, temb, cos, sin, keep,
                                      use_reentrant=False)
            else:
                img, txt = self.double(i, img, txt, temb, cos, sin, keep)
        x = torch.cat([img, txt], dim=1)
        for i in range(cfg["num_single_layers"]):
            if grad:
                x = checkpoint(self.single, i, x, temb, cos, sin, keep, Lv, use_reentrant=False)
            else:
                x = self.single(i, x, temb, cos, sin, keep, Lv)
        scale, shift = self.modulation("hy.norm_out.linear", temb, 2)
        out = self.lin("hy.proj_out", wan_ref.layer_norm(x[:, :Lv]) * (1 + scale) + shift)
        out = out.reshape(B, Fr, pph, ppw, C, 1, ps, ps).permute(0, 4, 1, 5, 2, 6, 3, 7)
        return out.reshape(B, C, Fr, Hh, Ww)


# ---------------------------------------------------------------------------
# the Phase-1 loss and the update
# ---------------------------------------------------------------------------

def phase1_loss(ref: HyRef, cfg: Dict, batch: Dict, draws: Dict) -> torch.Tensor:
    """wan_ref.phase1_loss's objective through the HunyuanVideo forward: the
    K frame-condition tokens lead the refiner's input (valid), text dropout
    zeroes the prompt and the pooled vector, guidance = cfg["guidance"] x
    1000."""
    p, K = cfg["patch_size"], cfg["K"]
    latents = batch["latents"].float()
    B, T = latents.shape[:2]
    tokens = wan_ref.patchify(latents, p)
    idx = wan_ref.anchor_indices(draws["idx_rand"], T, K, cfg["uniform_jitter"])
    z0 = torch.gather(tokens, 1, idx[..., None, None].expand(-1, -1, *tokens.shape[2:]))
    ab = torch.cumprod(1.0 - torch.linspace(1e-4, 2e-2, cfg["n_train"], dtype=torch.float32), 0)
    ab = ab.to(latents.device)[draws["t"].long()][:, None, None, None]
    eps = draws["eps"].float()
    z_t = torch.sqrt(ab) * z0 + torch.sqrt(1.0 - ab) * eps
    drop = draws["drop_rand"] < cfg["cond_drop_prob"]
    text = torch.where(drop[:, None, None], 0.0, batch["text_embed"].float())
    pooled = torch.where(drop[:, None], 0.0, batch["pooled"].float())
    feat = torch.gather(wan_ref.frame_features(idx, T), 1, idx[..., None].expand(-1, -1, 5))
    P, num = ref.P, ref.num
    extra = num.linear(wan_ref.gelu(num.linear(feat, P["fc.fc_0.weight"], P["fc.fc_0.bias"])),
                       P["fc.out.weight"], P["fc.out.bias"])
    mask = batch["text_mask"].bool()
    text = torch.cat([extra, text], dim=1)
    mask = torch.cat([torch.ones_like(mask[:, :K]), mask], dim=1)
    guidance = torch.full((B,), float(cfg["guidance"]) * 1000.0, device=latents.device)
    hp, wp = latents.shape[3] // p, latents.shape[4] // p
    pred = ref.forward(wan_ref.unpatchify(z_t, p, hp, wp).transpose(1, 2), draws["t"], text,
                       mask, pooled, guidance, idx)
    pred_tok = wan_ref.patchify(pred.transpose(1, 2), p)
    return torch.mean((pred_tok - eps) ** 2)


def train_steps(P: W, cfg: Dict, batches: Sequence[Dict], draws: Sequence[Dict], num: Numerics
                ) -> Dict[str, object]:
    """len(batches) clipped AdamW steps from P (reference/update.py).
    Returns the losses, the first step's clipped gradient per trainable
    leaf, and each leaf's change over the steps (norms, float)."""
    ref = HyRef(P, cfg, num)
    return adamw_steps(P, cfg, batches, draws, lambda b, d: phase1_loss(ref, cfg, b, d))
