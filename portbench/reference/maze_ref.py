"""Plain PyTorch reference of the two-stage maze planner, float32.

Written from the reference repository's description (EquilibriaW/
Interpolated_Diffusion, train_keypoints.py and sample_keypoints.py): a maze
CNN and start/goal MLP give a condition vector; Stage 1 denoises K keypoint
tokens with DDIM under a pre-norm FiLM transformer; the keypoints are joined
by segment-lerp to T frames; Stage 2 refines the whole sequence level by
level (nested keyframe masks, adjacent-level mask channels), with the
endpoints clamped to the plan's and positions clipped to [0, 1]. It imports
nothing of the program, runs every product through `Numerics` (float32 with
TF32 off, or the float8 control) and takes its weights from the benchmark.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.numerics import Numerics
from portbench.harness.weights import Leaf

W = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def _linear(name: str, d_in: int, d_out: int, dtype, std=None) -> List[Leaf]:
    s = std if std is not None else (3.0 * d_in) ** -0.5
    return [Leaf(f"{name}.weight", (d_out, d_in), s, 0.0, dtype),
            Leaf(f"{name}.bias", (d_out,), s, 0.0, dtype)]


def _denoiser_spec(cfg: Dict, prefix: str, stage2: bool) -> List[Leaf]:
    dt = getattr(torch, cfg["weights_dtype"])
    d, dff, dc = cfg["d_model"], cfg["d_ff"], cfg["d_cond"]
    spec: List[Leaf] = []
    if stage2:
        spec += _linear(f"{prefix}in_proj", cfg["data_dim"] + cfg["mask_channels"], d, dt)
        spec.append(Leaf(f"{prefix}level_emb.weight", (cfg["max_levels"] + 1, d), 1.0, 0.0, dt))
        spec += _linear(f"{prefix}level_proj.0", d, d, dt)
        spec += _linear(f"{prefix}level_proj.2", d, d, dt)
    else:
        in_dim = 2 * cfg["data_dim"] + d // 2
        spec += _linear(f"{prefix}in_proj", in_dim, d, dt)
        spec += _linear(f"{prefix}t_embed.0", d, d, dt)
        spec += _linear(f"{prefix}t_embed.2", d, d, dt)
    cin = 1
    for i, c in enumerate(cfg["maze_channels"]):
        s = (3.0 * cin * 9) ** -0.5
        spec += [Leaf(f"{prefix}cond_enc.maze.convs.{2 * i}.weight", (c, cin, 3, 3), s, 0.0, dt),
                 Leaf(f"{prefix}cond_enc.maze.convs.{2 * i}.bias", (c,), s, 0.0, dt)]
        cin = c
    spec += _linear(f"{prefix}cond_enc.maze.fc", cin, dc, dt)
    spec += _linear(f"{prefix}cond_enc.sg.mlp.0", 4, dc, dt)
    spec += _linear(f"{prefix}cond_enc.sg.mlp.2", dc, dc, dt)
    spec += _linear(f"{prefix}cond_proj", dc, d, dt)
    for i in range(cfg["n_layers"]):
        p = f"{prefix}transformer.layers.{i}."
        spec += [Leaf(p + "norm1.weight", (d,), 0.05, 1.0, dt), Leaf(p + "norm1.bias", (d,), 0.05, 0.0, dt),
                 Leaf(p + "norm2.weight", (d,), 0.05, 1.0, dt), Leaf(p + "norm2.bias", (d,), 0.05, 0.0, dt)]
        s = (3.0 * d) ** -0.5
        spec += [Leaf(p + "attn.in_proj_weight", (3 * d, d), s, 0.0, dt),
                 Leaf(p + "attn.in_proj_bias", (3 * d,), s, 0.0, dt)]
        spec += _linear(p + "attn.out_proj", d, d, dt)
        spec += _linear(p + "ff.0", d, dff, dt)
        spec += _linear(p + "ff.2", dff, d, dt)
        spec += _linear(p + "film1", dc, 2 * d, dt)
        spec += _linear(p + "film2", dc, 2 * d, dt)
    # Stage 2's head is small but not zero (a zero head makes Stage 2 the identity)
    spec += _linear(f"{prefix}out", d, cfg["data_dim"], dt,
                    std=0.01 / math.sqrt(3.0) if stage2 else None)
    return spec


def param_spec(cfg: Dict) -> List[Leaf]:
    """Every leaf of both stages: Stage 1 under "kp.", Stage 2 under "it."."""
    return _denoiser_spec(cfg, "kp.", False) + _denoiser_spec(cfg, "it.", True)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def sinusoid(x: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=x.device) / half)
    a = x.float()[..., None] * freqs
    return torch.cat([torch.sin(a), torch.cos(a)], dim=-1)


def layer_norm(x: torch.Tensor, w, b, eps: float = 1e-6) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    return (x - mu) * torch.rsqrt(var + eps) * w.float() + b.float()


def _lin(num: Numerics, P: W, name: str, x: torch.Tensor) -> torch.Tensor:
    return num.linear(x, P[name + ".weight"], P[name + ".bias"])


def cond_vector(num: Numerics, P: W, p: str, occ: torch.Tensor, sg: torch.Tensor,
                n_convs: int) -> torch.Tensor:
    x = occ.float()
    for i in range(n_convs):
        x = F.silu(num.conv2d(x, P[f"{p}cond_enc.maze.convs.{2 * i}.weight"],
                              P[f"{p}cond_enc.maze.convs.{2 * i}.bias"]))
    emb = _lin(num, P, f"{p}cond_enc.maze.fc", x.mean(dim=(2, 3)))
    h = F.silu(_lin(num, P, f"{p}cond_enc.sg.mlp.0", sg.float()))
    return emb + _lin(num, P, f"{p}cond_enc.sg.mlp.2", h)


def film_block(num: Numerics, P: W, p: str, x: torch.Tensor, cond: torch.Tensor,
               n_heads: int) -> torch.Tensor:
    B, L, D = x.shape
    dh = D // n_heads
    g1, b1 = _lin(num, P, p + "film1", cond).chunk(2, dim=-1)
    h = layer_norm(x, P[p + "norm1.weight"], P[p + "norm1.bias"]) * (1 + g1[:, None]) + b1[:, None]
    qkv = num.linear(h, P[p + "attn.in_proj_weight"], P[p + "attn.in_proj_bias"])
    q, k, v = (t.reshape(B, L, n_heads, dh).transpose(1, 2) for t in qkv.split(D, dim=-1))
    p_attn = torch.softmax(num.matmul(q, k.transpose(-1, -2)) * dh ** -0.5, dim=-1)
    attn = num.matmul(p_attn, v).transpose(1, 2).reshape(B, L, D)
    x = x + _lin(num, P, p + "attn.out_proj", attn)
    g2, b2 = _lin(num, P, p + "film2", cond).chunk(2, dim=-1)
    h = layer_norm(x, P[p + "norm2.weight"], P[p + "norm2.bias"]) * (1 + g2[:, None]) + b2[:, None]
    return x + _lin(num, P, p + "ff.2", F.silu(_lin(num, P, p + "ff.0", h)))


def _stack(num, P, p, h, cond, cfg):
    for i in range(cfg["n_layers"]):
        h = film_block(num, P, f"{p}transformer.layers.{i}.", h, cond, cfg["n_heads"])
    return h


def keypoint_eps(num, P, cfg, z, t, idx, known_mask, cond):
    """Stage 1: eps [B, K, D] for keypoints z at timestep t [B]."""
    p, d = "kp.", cfg["d_model"]
    pos = sinusoid(idx.float() / float(cfg["T"] - 1), d // 2)
    x = torch.cat([z, pos, known_mask.float()], dim=-1)
    h = _lin(num, P, p + "in_proj", x)
    te = _lin(num, P, p + "t_embed.2", F.silu(_lin(num, P, p + "t_embed.0", sinusoid(t, d))))
    h = h + te[:, None] + _lin(num, P, p + "cond_proj", cond)[:, None]
    return _lin(num, P, p + "out", _stack(num, P, p, h, cond, cfg))


def level_delta(num, P, cfg, x, s, mask_in, cond):
    """Stage 2: the refinement delta [B, T, D] at level s [B]."""
    p, d = "it.", cfg["d_model"]
    T = x.shape[1]
    h = _lin(num, P, p + "in_proj", torch.cat([x, mask_in], dim=-1))
    h = h + sinusoid(torch.linspace(0.0, 1.0, T, device=x.device), d)[None]
    lv = P[p + "level_emb.weight"].float()[s.long()]
    h = h + _lin(num, P, p + "level_proj.2", F.silu(_lin(num, P, p + "level_proj.0", lv)))[:, None]
    h = h + _lin(num, P, p + "cond_proj", cond)[:, None]
    return _lin(num, P, p + "out", _stack(num, P, p, h, cond, cfg))


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

def alpha_bar(n_train: int, device) -> torch.Tensor:
    betas = torch.linspace(1e-4, 2e-2, n_train, dtype=torch.float32)
    return torch.cumprod(1.0 - betas, dim=0).to(device)


def ddim_times(n_train: int, steps: int) -> List[int]:
    """Linear spacing, deduplicated, both ends kept, high to low."""
    times = np.unique(np.linspace(0, n_train - 1, steps).astype(np.int64))
    if times[0] != 0:
        times = np.concatenate([[0], times])
    if times[-1] != n_train - 1:
        times = np.concatenate([times, [n_train - 1]])
    return [int(t) for t in times[::-1]]


def k_schedule(T: int, K_min: int, levels: int) -> List[int]:
    ks = [0] * (levels + 1)
    ks[levels] = min(K_min, T)
    for s in range(levels, 0, -1):
        ks[s - 1] = min(T, max(ks[s] + 1, 2 * ks[s]))
    return ks


def segment_lerp(idx: torch.Tensor, vals: torch.Tensor, T: int) -> torch.Tensor:
    """[B, K] sorted anchors, [B, K, D] values -> [B, T, D], anchors exact."""
    B, K, D = vals.shape
    out = torch.empty((B, T, D), dtype=vals.dtype, device=vals.device)
    ti = torch.arange(T, device=idx.device)
    for j in range(K - 1):
        a, b = idx[:, j:j + 1], idx[:, j + 1:j + 2]                      # [B, 1]
        inside = (ti[None] >= a) & (ti[None] < b)
        w = ((ti[None] - a).float() / torch.clamp(b - a, min=1).float())[..., None]
        seg = vals[:, j:j + 1] + w * (vals[:, j + 1:j + 2] - vals[:, j:j + 1])
        out = torch.where(inside[..., None], seg, out)
    last = idx[:, -1:]
    out = torch.where((ti[None] >= last)[..., None], vals[:, -1:].expand(B, T, D), out)
    first = idx[:, :1]
    out = torch.where((ti[None] < first)[..., None], vals[:, :1].expand(B, T, D), out)
    return out.scatter(1, idx[..., None].expand(B, K, D), vals)


def nested_masks(idx: torch.Tensor, rand: torch.Tensor, T: int, ks: Sequence[int]) -> torch.Tensor:
    """[B, levels+1, T]: level s keeps the K_s highest of (anchors first, then
    rand descending, ties by position)."""
    B = idx.shape[0]
    base = torch.zeros((B, T), dtype=torch.bool, device=idx.device).scatter(1, idx, True)
    pri = torch.where(base, torch.full_like(rand, 2.0), rand.float())
    order = torch.sort(-pri, dim=1, stable=True).indices
    masks = []
    for K_s in ks:
        m = torch.zeros((B, T), dtype=torch.bool, device=idx.device)
        masks.append(m.scatter(1, order[:, :max(int(K_s), 2)], True))
    return torch.stack(masks, dim=1)


@torch.no_grad()
def plan(P: W, cfg: Dict, idx: torch.Tensor, occ: torch.Tensor, start_goal: torch.Tensor,
         z_init: torch.Tensor, mask_rand: torch.Tensor, num: Numerics
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(x_interp [B, T, D], x_refined [B, T, D], z_pred [B, K, D]) of a batch
    of requests under the given initial noise and Stage-2 mask draws."""
    T, K, Dd = cfg["T"], cfg["K"], cfg["data_dim"]
    idx = idx.long()
    ab = alpha_bar(cfg["n_train"], idx.device)
    n_convs = len(cfg["maze_channels"])
    c1 = cond_vector(num, P, "kp.", occ, start_goal, n_convs)
    c2 = cond_vector(num, P, "it.", occ, start_goal, n_convs)

    sg = start_goal.float()
    at_start, at_goal = (idx == 0)[..., None], (idx == T - 1)[..., None]
    known = torch.zeros((*idx.shape, Dd), dtype=torch.bool, device=idx.device)
    known[..., :2] = (at_start | at_goal).expand(-1, -1, 2)
    values = torch.zeros((*idx.shape, Dd), device=idx.device)
    values[..., :2] = torch.where(at_goal, sg[:, None, 2:],
                                  torch.where(at_start, sg[:, None, :2], values[..., :2]))

    def post(z):
        z = torch.where(known, values, z)
        return torch.cat([torch.clamp(z[..., :2], 0.0, 1.0), z[..., 2:]], dim=-1)

    z = post(z_init.float())
    times = ddim_times(cfg["n_train"], cfg["ddim_steps"])
    for t_now, t_prev in zip(times[:-1], times[1:]):
        tb = torch.full((idx.shape[0],), t_now, device=idx.device, dtype=torch.long)
        eps = keypoint_eps(num, P, cfg, z, tb, idx, known, c1)
        x0 = (z - torch.sqrt(1.0 - ab[t_now]) * eps) / torch.sqrt(ab[t_now])
        z = post(torch.sqrt(ab[t_prev]) * x0 + torch.sqrt(1.0 - ab[t_prev]) * eps)
    z_pred = z

    x_interp = segment_lerp(idx, z_pred, T)
    levels = cfg["levels"]
    masks = nested_masks(idx, mask_rand, T, k_schedule(T, K, levels))
    ends = torch.zeros((idx.shape[0], T, 1), dtype=torch.bool, device=idx.device)
    ends[:, 0] = ends[:, -1] = True
    x = x_interp
    for s in range(levels, 0, -1):
        mask_in = torch.stack([masks[:, s].float(), masks[:, s - 1].float()], dim=-1)
        sv = torch.full((idx.shape[0],), s, device=idx.device, dtype=torch.long)
        x = x + level_delta(num, P, cfg, x, sv, mask_in, c2)
        pos = torch.where(ends, x_interp[..., :2], x[..., :2])
        x = torch.cat([torch.clamp(pos, 0.0, 1.0), x[..., 2:]], dim=-1)
    return x_interp, x, z_pred
