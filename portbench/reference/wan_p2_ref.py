"""Plain PyTorch reference of the Wan Phase-2 (level-interpolation) LoRA
training step, float32.

The model, its weights and the update are portbench/reference/wan_ref's
(WanDiT with Sparse-Linear self-attention, LoRA, the frame-condition
projector; global-norm clip and AdamW over the LoRA and projector leaves).
This file adds the Phase-2 objective of the repository's video refiner
(adjacent-level mode), from the random draws the program made, handed in:

- nested anchor sets: the interior frames ranked by a uniform draw, level s
  holding both ends and the first K_s - 2 of that order, K_s doubling from
  K_min at the coarsest level (capped at T);
- each level's corrupted interpolation of the token grid: the anchors, a
  share of them (`student_replace_prob`) moved by Gaussian noise of
  `student_noise_std` (confidence 0.5, the rest 0.95, other frames 0), a
  piecewise-linear fill between them with the anchors exact, then Gaussian
  noise of `corrupt_sigma`, scaled by `anchor_noise_frac` at the anchors;
- a sampled level s per row: the model sees level s (time s x
  `level_t_scale`, frame-condition tokens of the level's anchor features, its
  confidence and level s - 1's anchors, RoPE at frames 0 .. T - 1) and
  predicts level s - 1 minus level s; the loss is the squared error summed
  over features, weighted by w_missing + (w_anchor - w_missing) x level
  s - 1's confidence, over the weights' sum times the features.

It imports nothing of the program. At L 32760 the sparse branch runs a few
heads at a time, each group under an activation checkpoint of its own (the
same arithmetic as wan_ref's), so that a block's backward fits.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from portbench.reference import wan_ref
from portbench.reference.numerics import Numerics
from portbench.reference.update import adamw_steps

HEAD_CHUNK = 4


def k_schedule(T: int, K_min: int, levels: int) -> List[int]:
    """Anchors per level s = 0 (finest) .. levels (coarsest): doubling."""
    K = [0] * (levels + 1)
    K[levels] = min(K_min, T)
    for s in range(levels, 0, -1):
        K[s - 1] = min(T, max(K[s] + 1, 2 * K[s]))
    return K


def draws(gen: torch.Generator, B: int, T: int, D: int, K_min: int, levels: int) -> Dict:
    """The step's random draws in the program's order (adjacent mode): per
    level 0 .. levels the replacement uniforms [B, K_s], the anchor noise
    [B, K_s, D] and the corruption noise [B, T, D]; then the interior order's
    uniforms [B, T - 2], the sampled level [B] in 1 .. levels; then the text
    dropout uniforms [B]."""
    dev = gen.device
    per_level = {}
    for s, K in enumerate(k_schedule(T, K_min, levels)):
        per_level[s] = {"rep": torch.rand((B, K), generator=gen, device=dev),
                        "noise_a": torch.randn((B, K, D), generator=gen, device=dev),
                        "noise": torch.randn((B, T, D), generator=gen, device=dev)}
    corr = {"mask_rand": torch.rand((B, T - 2), generator=gen, device=dev),
            "s_idx": torch.randint(1, levels + 1, (B,), generator=gen, device=dev),
            "levels": per_level}
    return {"corr": corr, "drop_rand": torch.rand((B,), generator=gen, device=dev)}


def lerp_fill(idx: torch.Tensor, vals: torch.Tensor, T: int) -> torch.Tensor:
    """[B, T, D]: linear between consecutive anchors idx [B, K] (sorted), the
    anchors' own values exact."""
    B, K = idx.shape
    t = torch.arange(T, device=idx.device)
    seg = torch.clamp(torch.searchsorted(idx.contiguous(), t.expand(B, T).contiguous(),
                                         right=True) - 1, 0, K - 2)
    left, right = torch.gather(idx, 1, seg), torch.gather(idx, 1, seg + 1)
    take = lambda j: torch.gather(vals, 1, j[..., None].expand(-1, -1, vals.shape[-1]))
    w = ((t[None] - left).float() / torch.clamp(right - left, min=1).float())[..., None]
    y = take(seg) + w * (take(seg + 1) - take(seg))
    return y.scatter(1, idx[..., None].expand(-1, -1, vals.shape[-1]), vals)


def level_batch(z0: torch.Tensor, corr: Dict, cfg: Dict):
    """Every level's corrupted grid and confidence, the anchor sets and masks."""
    B, T, D = z0.shape
    order = torch.cat([torch.tensor([0, T - 1], device=z0.device).expand(B, 2),
                       torch.argsort(corr["mask_rand"], dim=1, stable=True) + 1], dim=1)
    zs, confs, idxs, masks = [], [], [], []
    for s, K in enumerate(k_schedule(T, cfg["K_min"], cfg["levels"])):
        idx = torch.sort(order[:, :max(K, 2)], dim=1).values
        mask = torch.zeros((B, T), dtype=torch.bool, device=z0.device).scatter(1, idx, True)
        d = corr["levels"][s]
        vals = torch.gather(z0, 1, idx[..., None].expand(-1, -1, D))
        rep = d["rep"] < cfg["student_replace_prob"]
        vals = torch.where(rep[..., None], vals + d["noise_a"] * cfg["student_noise_std"], vals)
        z = lerp_fill(idx, vals, T)
        scale = torch.where(mask, cfg["anchor_noise_frac"], 1.0)
        z = z + d["noise"] * cfg["corrupt_sigma"] * scale[..., None]
        conf = torch.zeros((B, T), device=z0.device).scatter(
            1, idx, torch.where(rep, 0.5, 0.95))
        zs.append(z), confs.append(conf), idxs.append(idx), masks.append(mask)
    return zs, confs, idxs, masks


class P2Ref(wan_ref.Ref):
    """wan_ref's model, its sparse branch a few heads at a time."""

    def sparse_branch(self, q, k, v, lut) -> torch.Tensor:
        outs = []
        for h0 in range(0, q.shape[0], HEAD_CHUNK):
            sl = slice(h0, h0 + HEAD_CHUNK)
            fn = super().sparse_branch
            if torch.is_grad_enabled():
                outs.append(checkpoint(fn, q[sl], k[sl], v[sl], lut[sl], use_reentrant=False))
            else:
                outs.append(fn(q[sl], k[sl], v[sl], lut[sl]))
        return torch.cat(outs, dim=0)


def phase2_loss(ref: P2Ref, cfg: Dict, batch: Dict, dr: Dict) -> torch.Tensor:
    p = cfg["patch_size"][1]
    latents = batch["latents"].float()
    B, T = latents.shape[:2]
    tokens = wan_ref.patchify(latents, p)                      # [B, T, N, Dt]
    N, Dt = tokens.shape[2:]
    zs, confs, idxs, masks = level_batch(tokens.reshape(B, T, N * Dt), dr["corr"], cfg)
    s = dr["corr"]["s_idx"].long()
    rows = torch.arange(B, device=latents.device)
    pick = lambda xs, lv: torch.stack(xs)[lv, rows]
    z_s, z_prev = pick(zs, s), pick(zs, s - 1)
    target, weight = z_prev - z_s, pick(confs, s - 1)
    mask_prev = pick(masks, s - 1)
    feat = torch.cat([torch.cat([wan_ref.frame_features(idxs[int(s[b])][b:b + 1], T)
                                 for b in range(B)]),
                      pick(confs, s)[..., None], mask_prev[..., None].float()], dim=-1)
    text = batch["text_embed"].float()
    drop = dr["drop_rand"] < cfg["cond_drop_prob"]
    text = torch.where(drop[:, None, None], 0.0, text)
    P, num = ref.P, ref.num
    extra = num.linear(wan_ref.gelu(num.linear(feat, P["fc.fc_0.weight"], P["fc.fc_0.bias"])),
                       P["fc.out.weight"], P["fc.out.bias"])
    hp, wp = latents.shape[3] // p, latents.shape[4] // p
    frames = torch.arange(T, device=latents.device)[None].expand(B, T)
    lat_in = wan_ref.unpatchify(z_s.reshape(B, T, N, Dt), p, hp, wp).transpose(1, 2)
    pred = ref.forward(lat_in, s * cfg["level_t_scale"], text, frames, extra)
    delta = wan_ref.patchify(pred.transpose(1, 2), p)
    diff = ((delta - target.reshape(B, T, N, Dt)) ** 2).sum(dim=-1)
    w = (cfg["w_missing"] + (cfg["w_anchor"] - cfg["w_missing"]) * weight[..., None]).expand_as(diff)
    return (diff * w).sum() / (w.sum() * Dt + 1e-8)


def train_steps(P: Dict[str, torch.Tensor], cfg: Dict, batches: Sequence[Dict],
                step_draws: Sequence[Dict], num: Numerics) -> Dict[str, object]:
    """Clipped AdamW steps over the Phase-2 loss (reference/update.py)."""
    ref = P2Ref(P, cfg, num)
    return adamw_steps(P, cfg, batches, step_draws, lambda b, d: phase2_loss(ref, cfg, b, d))
