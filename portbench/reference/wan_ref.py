"""Plain PyTorch reference of the Wan2.1-T2V-1.3B Phase-1 LoRA training step,
float32.

The model follows the Wan2.1 description (Wan-AI/Wan2.1-T2V-1.3B and the
diffusers WanTransformer3DModel it is published in): (1, 2, 2) patch
embedding; 30 blocks of adaLN modulation from a six-way time projection,
self-attention with RMS-normed q/k and 3D rotary embeddings (head-dim split
t / h / w), cross-attention to the text tokens (and the frame-condition
tokens), a tanh-GELU FFN; a head modulated by the time embedding. The
self-attention is Sparse-Linear Attention: a block-sparse softmax branch over
each query block's top-k key blocks (chosen here, from this reference's own
mean-pooled q and centred k) plus a linear-attention branch (softmax feature
maps) through a projection. LoRA adds (alpha / r)(x A^T) B^T to every
attention and FFN projection. The Phase-1 loss is the anchor-slot epsilon MSE
of the keyframe trainer (uniform jittered anchors, linear betas, text dropout,
absolute-time RoPE of the K anchors); the update is a global-norm clip and
AdamW over the LoRA and frame-condition leaves.

It imports nothing of the program. Weights come from the benchmark (the same
values the program is handed), every product runs through `Numerics`, and
each block runs under an activation checkpoint so that the step fits.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.numerics import Numerics
from portbench.harness.weights import Leaf

W = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def _lin(name: str, d_in: int, d_out: int, dtype, scale: float = 1.0) -> List[Leaf]:
    s = scale * (3.0 * d_in) ** -0.5
    return [Leaf(f"{name}.weight", (d_out, d_in), s, 0.0, dtype),
            Leaf(f"{name}.bias", (d_out,), s, 0.0, dtype)]


def param_spec(cfg: Dict) -> List[Leaf]:
    """Every leaf of the model ("wan." prefix; the frozen base in bfloat16,
    the LoRA leaves float32) and of the frame-condition projector ("fc.",
    float32). Weights and biases ~ N(0, 1/(3 fan_in)), norm scales near 1,
    modulation tables std 0.02, LoRA A std 1/r and B small but non-zero, so
    that every trainable leaf has a gradient from the first step."""
    bf, f32 = torch.bfloat16, torch.float32
    d, ffn, r = cfg["dim"], cfg["ffn_dim"], cfg["lora_rank"]
    dh = d // cfg["num_heads"]
    p = "wan."
    pt, ph, pw = cfg["patch_size"]
    c_in = cfg["in_dim"]
    spec = [Leaf(p + "scale_shift_table", (1, 2, d), 0.02, 0.0, bf),
            Leaf(p + "patch_embedding.weight", (d, c_in, pt, ph, pw),
                 (3.0 * c_in * pt * ph * pw) ** -0.5, 0.0, bf),
            Leaf(p + "patch_embedding.bias", (d,), (3.0 * c_in * pt * ph * pw) ** -0.5, 0.0, bf)]
    ce = p + "condition_embedder."
    spec += _lin(ce + "time_embedder.linear_1", cfg["freq_dim"], d, bf)
    spec += _lin(ce + "time_embedder.linear_2", d, d, bf)
    spec += _lin(ce + "time_proj", d, 6 * d, bf)
    spec += _lin(ce + "text_embedder.linear_1", cfg["text_dim"], d, bf)
    spec += _lin(ce + "text_embedder.linear_2", d, d, bf)
    spec += _lin(ce + "extra_embedder.linear_1", cfg["text_dim"], d, bf)
    spec += _lin(ce + "extra_embedder.linear_2", d, d, bf)
    for i in range(cfg["num_layers"]):
        b = f"{p}blocks.{i}."
        spec.append(Leaf(b + "scale_shift_table", (1, 6, d), 0.02, 0.0, bf))
        for attn in ("attn1", "attn2"):
            for proj in ("to_q", "to_k", "to_v", "to_out.0"):
                spec += _lin(f"{b}{attn}.{proj}", d, d, bf)
                spec += [Leaf(f"{b}{attn}.{proj}.lora_A", (r, d), 1.0 / r, 0.0, f32),
                         Leaf(f"{b}{attn}.{proj}.lora_B", (d, r), 2e-3, 0.0, f32)]
            spec += [Leaf(f"{b}{attn}.norm_q.weight", (d,), 0.05, 1.0, bf),
                     Leaf(f"{b}{attn}.norm_k.weight", (d,), 0.05, 1.0, bf)]
            if attn == "attn1":
                spec += _lin(f"{b}attn1.sla.proj_l", dh, dh, bf, scale=0.1)
            else:
                spec += [Leaf(b + "norm2.weight", (d,), 0.05, 1.0, bf),
                         Leaf(b + "norm2.bias", (d,), 0.05, 0.0, bf)]
        for proj, d_in, d_out in (("ffn.net.0.proj", d, ffn), ("ffn.net.2", ffn, d)):
            spec += _lin(b + proj, d_in, d_out, bf)
            spec += [Leaf(f"{b}{proj}.lora_A", (r, d_in), 1.0 / r, 0.0, f32),
                     Leaf(f"{b}{proj}.lora_B", (d_out, r), 2e-3, 0.0, f32)]
    spec += _lin(p + "proj_out", d, cfg["out_dim"] * pt * ph * pw, bf)
    spec += _lin("fc.fc_0", cfg["frame_cond_dim"], cfg["frame_cond_hidden"], f32)
    spec += _lin("fc.out", cfg["frame_cond_hidden"], cfg["text_dim"], f32, scale=0.1)
    return spec


def is_trainable(name: str) -> bool:
    return name.startswith("fc.") or name.endswith(".lora_A") or name.endswith(".lora_B")


# ---------------------------------------------------------------------------
# model pieces
# ---------------------------------------------------------------------------

def sinusoid(x: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=x.device) / half)
    a = x.float()[..., None] * freqs
    return torch.cat([torch.sin(a), torch.cos(a)], dim=-1)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def layer_norm(x: torch.Tensor, w=None, b=None, eps: float = 1e-6) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    y = (x - mu) * torch.rsqrt(var + eps)
    return y if w is None else y * w.float() + b.float()


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w.float()


def rope_tables(frame_idx: torch.Tensor, pph: int, ppw: int, head_dim: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [B, F*pph*ppw, head_dim/2] of the t / h / w split (h = w =
    2 (d // 6), t the rest), time at the frames' absolute indices."""
    hw = 2 * (head_dim // 6)
    parts = []
    B, Fr = frame_idx.shape
    for axis, dim in (("t", head_dim - 2 * hw), ("h", hw), ("w", hw)):
        freqs = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                                device=frame_idx.device) / dim))
        if axis == "t":
            pos = frame_idx.float()[:, :, None, None].expand(B, Fr, pph, ppw)
        elif axis == "h":
            pos = torch.arange(pph, device=frame_idx.device).float()[None, None, :, None].expand(B, Fr, pph, ppw)
        else:
            pos = torch.arange(ppw, device=frame_idx.device).float()[None, None, None, :].expand(B, Fr, pph, ppw)
        parts.append(pos.reshape(B, -1)[..., None] * freqs)
    ang = torch.cat(parts, dim=-1)
    return torch.cos(ang), torch.sin(ang)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Interleaved pairs; x [B, H, L, D], cos/sin [B, L, D/2]."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    c, s = cos[:, None], sin[:, None]
    return torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).reshape(x.shape)


class Ref:
    """One reference model over a weight dict; `num` sets the products'
    precision."""

    def __init__(self, P: W, cfg: Dict, num: Numerics):
        self.P, self.cfg, self.num = P, cfg, num
        self.alpha = cfg["lora_alpha"] / cfg["lora_rank"]

    def lin(self, name: str, x: torch.Tensor) -> torch.Tensor:
        P = self.P
        y = self.num.linear(x, P[name + ".weight"], P[name + ".bias"])
        if name + ".lora_A" in P:
            z = self.num.linear(x, P[name + ".lora_A"])
            y = y + self.num.linear(z, P[name + ".lora_B"]) * self.alpha
        return y

    # ---- self-attention: Sparse-Linear Attention ----
    def block_map(self, q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        """LUT [BH, M, topk]: each query block's highest-scoring key blocks
        (mean-pooled q against mean-pooled centred k), best first, lower
        index first among equals."""
        bs = self.cfg["sla_block"]
        L = q.shape[1]
        n = -(-L // bs)
        counts = torch.clamp(L - torch.arange(n, device=q.device) * bs, 1, bs).float()

        def pool(x):
            xp = F.pad(x, (0, 0, 0, n * bs - L)).reshape(x.shape[0], n, bs, x.shape[-1])
            return xp.sum(dim=2) / counts[:, None]

        kc = k - k.mean(dim=1, keepdim=True)
        score = pool(q) @ pool(kc).transpose(-1, -2)
        topk = max(1, min(n, int(self.cfg["sla_topk"] * n)))
        return torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :topk]

    def sparse_branch(self, q, k, v, lut) -> torch.Tensor:
        BH, L, D = q.shape
        bs = self.cfg["sla_block"]
        n, topk = lut.shape[1], lut.shape[2]
        pad = lambda x: F.pad(x, (0, 0, 0, n * bs - L)).reshape(BH, n, bs, D)
        qb, kb, vb = pad(q), pad(k), pad(v)
        rows = torch.arange(BH, device=q.device)[:, None, None]
        kg = kb[rows, lut].reshape(BH, n, topk * bs, D)
        vg = vb[rows, lut].reshape(BH, n, topk * bs, D)
        key_pos = (lut[..., None] * bs + torch.arange(bs, device=q.device)).reshape(BH, n, -1)
        logits = self.num.einsum("bmqd,bmkd->bmqk", qb, kg) * D ** -0.5
        logits = logits.masked_fill(~(key_pos < L)[:, :, None, :], float("-inf"))
        o = self.num.einsum("bmqk,bmkd->bmqd", torch.softmax(logits, dim=-1), vg)
        return o.reshape(BH, n * bs, D)[:, :L]

    def linear_branch(self, q, k, v, prefix) -> torch.Tensor:
        fq, fk = torch.softmax(q, dim=-1), torch.softmax(k, dim=-1)
        kv = self.num.matmul(fk.transpose(-1, -2), v)
        num = self.num.matmul(fq, kv)
        den = fq @ fk.sum(dim=1)[..., None] + 1e-5
        return self.lin(prefix + "sla.proj_l", num / den)

    def self_attention(self, prefix, h, rope):
        B, L, d = h.shape
        H = self.cfg["num_heads"]
        Dh = d // H
        P = self.P
        heads = lambda t: t.reshape(B, L, H, Dh).transpose(1, 2)
        q = heads(rms_norm(self.lin(prefix + "to_q", h), P[prefix + "norm_q.weight"]))
        k = heads(rms_norm(self.lin(prefix + "to_k", h), P[prefix + "norm_k.weight"]))
        v = heads(self.lin(prefix + "to_v", h))
        q, k = rotate(q, *rope), rotate(k, *rope)
        qf, kf, vf = (t.reshape(B * H, L, Dh) for t in (q, k, v))
        with torch.no_grad():
            lut = self.block_map(qf, kf)
        o = self.sparse_branch(qf, kf, vf, lut) + self.linear_branch(qf, kf, vf, prefix)
        o = o.reshape(B, H, L, Dh).transpose(1, 2).reshape(B, L, d)
        return self.lin(prefix + "to_out.0", o)

    def cross_attention(self, prefix, x, ctx):
        B, L, d = x.shape
        H = self.cfg["num_heads"]
        Dh = d // H
        P = self.P
        heads = lambda t: t.reshape(B, t.shape[1], H, Dh).transpose(1, 2)
        q = heads(rms_norm(self.lin(prefix + "to_q", x), P[prefix + "norm_q.weight"]))
        k = heads(rms_norm(self.lin(prefix + "to_k", ctx), P[prefix + "norm_k.weight"]))
        v = heads(self.lin(prefix + "to_v", ctx))
        p = torch.softmax(self.num.matmul(q, k.transpose(-1, -2)) * Dh ** -0.5, dim=-1)
        o = self.num.matmul(p, v).transpose(1, 2).reshape(B, L, d)
        return self.lin(prefix + "to_out.0", o)

    def block(self, i, x, ctx, t_mod, cos, sin):
        P = self.P
        b = f"wan.blocks.{i}."
        mod = P[b + "scale_shift_table"].float() + t_mod
        sh1, sc1, g1, sh2, sc2, g2 = (mod[:, j][:, None] for j in range(6))
        h = layer_norm(x) * (1 + sc1) + sh1
        x = x + g1 * self.self_attention(b + "attn1.", h, (cos, sin))
        x = x + self.cross_attention(b + "attn2.",
                                     layer_norm(x, P[b + "norm2.weight"], P[b + "norm2.bias"]), ctx)
        h = layer_norm(x) * (1 + sc2) + sh2
        return x + g2 * self.lin(b + "ffn.net.2", gelu(self.lin(b + "ffn.net.0.proj", h)))

    def forward(self, latents, t, text, frame_idx, extra, remat: bool = True):
        """latents [B, C, F, H, W] -> prediction of the same shape."""
        cfg, P = self.cfg, self.P
        B, C, Fr, Hh, Ww = latents.shape
        _, ph, pw = cfg["patch_size"]
        pph, ppw = Hh // ph, Ww // pw
        d = cfg["dim"]
        z = latents.reshape(B, C, Fr, 1, pph, ph, ppw, pw).permute(0, 2, 4, 6, 1, 3, 5, 7)
        z = z.reshape(B, Fr * pph * ppw, C * ph * pw)
        x = self.num.linear(z, P["wan.patch_embedding.weight"].flatten(1),
                            P["wan.patch_embedding.bias"])
        ce = "wan.condition_embedder."
        t_emb = self.lin(ce + "time_embedder.linear_2",
                         F.silu(self.lin(ce + "time_embedder.linear_1", sinusoid(t, cfg["freq_dim"]))))
        t_mod = self.lin(ce + "time_proj", F.silu(t_emb)).reshape(B, 6, d)
        ctx = self.lin(ce + "text_embedder.linear_2", gelu(self.lin(ce + "text_embedder.linear_1", text)))
        ex = self.lin(ce + "extra_embedder.linear_2", gelu(self.lin(ce + "extra_embedder.linear_1", extra)))
        ctx = torch.cat([ctx, ex], dim=1)
        cos, sin = rope_tables(frame_idx, pph, ppw, d // cfg["num_heads"])
        for i in range(cfg["num_layers"]):
            if remat and torch.is_grad_enabled():
                x = checkpoint(self.block, i, x, ctx, t_mod, cos, sin, use_reentrant=False)
            else:
                x = self.block(i, x, ctx, t_mod, cos, sin)
        mod = P["wan.scale_shift_table"].float() + t_emb[:, None]
        x = self.lin("wan.proj_out", layer_norm(x) * (1 + mod[:, 1][:, None]) + mod[:, 0][:, None])
        x = x.reshape(B, Fr, pph, ppw, C, 1, ph, pw).permute(0, 4, 1, 5, 2, 6, 3, 7)
        return x.reshape(B, C, Fr, Hh, Ww)


# ---------------------------------------------------------------------------
# the Phase-1 loss and the update
# ---------------------------------------------------------------------------

def patchify(lat: torch.Tensor, p: int) -> torch.Tensor:
    """[B, T, C, H, W] -> [B, T, (H/p)(W/p), C p p]."""
    B, T, C, H, Wd = lat.shape
    z = lat.reshape(B, T, C, H // p, p, Wd // p, p).permute(0, 1, 3, 5, 2, 4, 6)
    return z.reshape(B, T, (H // p) * (Wd // p), C * p * p)


def unpatchify(tok: torch.Tensor, p: int, hp: int, wp: int) -> torch.Tensor:
    B, T, N, D = tok.shape
    C = D // (p * p)
    z = tok.reshape(B, T, hp, wp, C, p, p).permute(0, 1, 4, 2, 5, 3, 6)
    return z.reshape(B, T, C, hp * p, wp * p)


def anchor_indices(rand: torch.Tensor, T: int, K: int, jitter: float) -> torch.Tensor:
    """K uniformly spaced anchors, each moved by up to jitter/2 of a spacing
    (the ends stay), rounded half to even, then made strictly increasing."""
    base = torch.linspace(0.0, T - 1, K, device=rand.device)
    noise = (rand.float() - 0.5) * 2.0 * ((T - 1) / (K - 1) * jitter * 0.5)
    noise[:, 0] = 0.0
    noise[:, -1] = 0.0
    cols = list(torch.clamp(torch.round(base[None] + noise).long(), 0, T - 1).unbind(1))
    for k in range(1, K):
        cols[k] = torch.maximum(cols[k], cols[k - 1] + 1)
    cols[K - 1] = torch.clamp(cols[K - 1], max=T - 1)
    for k in range(K - 2, -1, -1):
        cols[k] = torch.minimum(cols[k], cols[k + 1] - 1)
    return torch.clamp(torch.stack(cols, dim=1), 0, T - 1)


def frame_features(idx: torch.Tensor, T: int) -> torch.Tensor:
    """[B, T, 5]: time, keyframe flag, position in its gap, gap length and
    distance to the nearer keyframe, both normalised."""
    B = idx.shape[0]
    mask = torch.zeros((B, T), dtype=torch.bool, device=idx.device).scatter(1, idx, True)
    t = torch.arange(T, dtype=torch.float32, device=idx.device)[None].expand(B, T)
    first = idx[:, :1].float()
    last = idx[:, -1:].float()
    left = torch.cummax(torch.where(mask, t, torch.full_like(t, -1e9)), dim=1).values
    right = torch.cummin(torch.where(mask, t, torch.full_like(t, 1e9)).flip(1), dim=1).values.flip(1)
    left = torch.where(left < 0, first, left)
    right = torch.where(right > T - 1, last, right)
    gap = torch.clamp(right - left, min=1.0)
    alpha = torch.clamp((t - left) / gap, 0.0, 1.0)
    dist = torch.minimum(torch.clamp(t - left, min=0.0), torch.clamp(right - t, min=0.0))
    return torch.stack([t / (T - 1), mask.float(), alpha, gap / (T - 1),
                        torch.clamp(2.0 * dist / gap, 0.0, 1.0)], dim=-1)


def phase1_loss(ref: Ref, cfg: Dict, latents: torch.Tensor, text: torch.Tensor, draws: Dict
                ) -> torch.Tensor:
    p, K = cfg["patch_size"][1], cfg["K"]
    B, T = latents.shape[:2]
    tokens = patchify(latents.float(), p)
    idx = anchor_indices(draws["idx_rand"], T, K, cfg["uniform_jitter"])
    z0 = torch.gather(tokens, 1, idx[..., None, None].expand(-1, -1, *tokens.shape[2:]))
    ab = torch.cumprod(1.0 - torch.linspace(1e-4, 2e-2, cfg["n_train"], dtype=torch.float32), 0)
    ab = ab.to(latents.device)[draws["t"].long()][:, None, None, None]
    eps = draws["eps"].float()
    z_t = torch.sqrt(ab) * z0 + torch.sqrt(1.0 - ab) * eps
    drop = draws["drop_rand"] < cfg["cond_drop_prob"]
    text = torch.where(drop[:, None, None], torch.zeros_like(text), text).float()
    feat = torch.gather(frame_features(idx, T), 1, idx[..., None].expand(-1, -1, 5))
    P, num = ref.P, ref.num
    extra = num.linear(gelu(num.linear(feat, P["fc.fc_0.weight"], P["fc.fc_0.bias"])),
                       P["fc.out.weight"], P["fc.out.bias"])
    hp, wp = latents.shape[3] // p, latents.shape[4] // p
    pred = ref.forward(unpatchify(z_t, p, hp, wp).transpose(1, 2), draws["t"], text, idx, extra)
    pred_tok = patchify(pred.transpose(1, 2), p)
    return torch.mean((pred_tok - eps) ** 2)


def train_steps(P: W, cfg: Dict, batches: Sequence[Dict], draws: Sequence[Dict], num: Numerics
                ) -> Dict[str, object]:
    """len(batches) clipped AdamW steps from P. Returns the losses, the first
    step's clipped gradient per trainable leaf, and each leaf's change over
    the steps (norms, float)."""
    names = [n for n in P if is_trainable(n)]
    for n in names:
        P[n] = P[n].detach().float().clone().requires_grad_(True)
    start = {n: P[n].detach().clone() for n in names}
    m = {n: torch.zeros_like(P[n]) for n in names}
    v = {n: torch.zeros_like(P[n]) for n in names}
    lr, wd, clip = cfg["lr"], cfg["weight_decay"], cfg["grad_clip"]
    b1, b2, eps = 0.9, 0.999, 1e-8
    ref = Ref(P, cfg, num)
    losses, grad0 = [], {}
    for step, (batch, dr) in enumerate(zip(batches, draws), start=1):
        loss = phase1_loss(ref, cfg, batch["latents"], batch["text_embed"], dr)
        grads = torch.autograd.grad(loss, [P[n] for n in names])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
            scale = clip / torch.clamp(norm, min=clip)
            for n, g in zip(names, grads):
                g = g * scale
                if step == 1:
                    grad0[n] = float(g.norm())
                P[n].mul_(1.0 - lr * wd)
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[n] / (1 - b2 ** step)).sqrt() + eps
                P[n].addcdiv_(m[n], denom, value=-lr / (1 - b1 ** step))
    change = {n: float((P[n].detach() - start[n]).norm()) for n in names}
    return {"losses": losses, "grad": grad0, "change": change}
