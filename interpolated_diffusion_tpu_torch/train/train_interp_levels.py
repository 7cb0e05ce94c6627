"""Stage-2 interp-level denoiser trainer, maze family (port of
train/train_interp_levels.py).

    python -m interpolated_diffusion_tpu_torch.train.train_interp_levels [flags]

Nested mask policies (random_nested / uniform / dp-from-base, and a
per-sample mix of them), level sampling (uniform / high-biased), `adj`
(target = x_{s-1} - x_s) and `x0` (target = x0 - x_s) modes, anchor-confidence
channels with per-level anneal, interp corruption (distance-scaled noise,
anchor noise, index jitter), conf-weighted MSE, a curvature term, and Stage-1
bootstrap scheduled sampling (`--bootstrap_ckpt`: GT anchors of the coarsest
level are replaced by student anchors, sampled by `--bootstrap_solver` and
optionally the best of `--bootstrap_best_of` candidates, with a warm-up
scheduled probability; a bootstrap checkpoint trained with kp_feat gets its
index features, their cost channels from `--dphi_ckpt`). The `selector` /
`selector_level` mask policies (and `selector` in `--mask_policy_mix`) rank
the nested masks by a frozen keypoint selector's logits (`--selector_ckpt`;
selector_level: one logit row per level). `--causal 1` trains the causal
(autoregressive) denoiser, `causal` in its meta, for sample/generate_causal.py
(train/train_interp_levels_causal.py forces it). The model holds f32 master
parameters and computes in bf16 (`--bf16 1`). Runs on the GPU unless
`--device cpu`.

`--n_data_shards N` under `torchrun --nproc_per_node N`: data parallel, one
process per GPU (train/common.py, train/state.py).
"""
from __future__ import annotations

import argparse
import math
from typing import Dict, Optional

import numpy as np
import torch

from ..kernels.tuning import add_attn_policy_arg
from ..models.denoisers import InterpLevelDenoiser
from ..models.loading import load_keypoint_model
from ..ops.anchor_search import pick_anchors
from ..ops.ddpm import make_timesteps, run_solver
from ..ops.keyframes import (build_nested_masks_batch, build_nested_masks_from_base,
                             build_nested_masks_from_level_logits,
                             build_nested_masks_from_logits, compute_k_schedule)
from ..ops.normalize import logit_pos, sigmoid_pos
from ..ops.schedules import make_schedule
from ..ops.selection import build_kp_feat_full
from ..parallel.mesh import dp_sum
from .batches import (Rng, build_interp_adjacent_batch, build_interp_level_batch,
                      build_known_mask_values, draw, gather_keypoints, parse_policy_mix)
from .common import (add_data_args, add_train_args, build_seeded, data_mesh, make_dataset,
                     make_loader, model_params, resolve_device, resume_state, run_training,
                     sample_idx_policy, write_run_config)
from .state import TrainState, init_train_state, make_optimizer, make_train_multi_step


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("train_interp_levels (Stage-2)")
    p.add_argument("--T", type=int, default=64)
    p.add_argument("--K_min", type=int, default=8)
    p.add_argument("--levels", type=int, default=3)
    p.add_argument("--k_schedule", type=str, default="doubling",
                   choices=["doubling", "linear", "geom"])
    p.add_argument("--mode", type=str, default="adj", choices=["adj", "x0"])
    p.add_argument("--causal", type=int, default=0,
                   help="causal (autoregressive) denoiser, for the causal sampler")
    p.add_argument("--mask_policy", type=str, default="random_nested",
                   choices=["random_nested", "uniform", "dp", "selector", "selector_level"])
    p.add_argument("--selector_ckpt", type=str, default=None)
    p.add_argument("--mask_policy_mix", type=str, default="",
                   help='weighted policy mix like "uniform:0.5,random:0.3,dp:0.2", sampled '
                        "per sample; overrides --mask_policy")
    p.add_argument("--level_sampling", type=str, default="high", choices=["uniform", "high"])
    p.add_argument("--level_high_prob", type=float, default=0.5)
    p.add_argument("--d_model", type=int, default=384)
    p.add_argument("--n_layers", type=int, default=12)
    p.add_argument("--n_heads", type=int, default=12)
    p.add_argument("--d_ff", type=int, default=1536)
    p.add_argument("--d_cond", type=int, default=128)
    p.add_argument("--maze_channels", type=str, default="32,64,128,128")
    p.add_argument("--clamp_endpoints", type=int, default=1)
    p.add_argument("--cond_start_goal", type=int, default=1)
    p.add_argument("--recompute_vel", type=int, default=1)
    # anchor confidence channel
    p.add_argument("--anchor_conf", type=int, default=0)
    p.add_argument("--anchor_conf_teacher", type=float, default=0.95)
    p.add_argument("--anchor_conf_student", type=float, default=0.5)
    p.add_argument("--anchor_conf_endpoints", type=float, default=1.0)
    p.add_argument("--anchor_conf_missing", type=float, default=0.0)
    p.add_argument("--anchor_conf_anneal", type=int, default=0)
    p.add_argument("--anchor_conf_anneal_mode", type=str, default="linear",
                   choices=["none", "linear", "cosine"])
    # loss weights
    p.add_argument("--w_anchor", type=float, default=1.0)
    p.add_argument("--w_missing", type=float, default=1.0)
    # corruption
    p.add_argument("--corrupt_mode", type=str, default="none", choices=["none", "dist", "gauss"])
    p.add_argument("--corrupt_sigma_max", type=float, default=0.0)
    p.add_argument("--corrupt_sigma_min", type=float, default=0.0)
    p.add_argument("--corrupt_sigma_pow", type=float, default=1.0)
    p.add_argument("--corrupt_anchor_frac", type=float, default=0.0)
    p.add_argument("--smooth_weight", type=float, default=0.0,
                   help=">0: add a curvature-weighted error term "
                        "w * mean(second difference of (delta_hat - target), squared)")
    p.add_argument("--corrupt_index_jitter_max", type=int, default=0)
    p.add_argument("--corrupt_index_jitter_prob", type=float, default=0.0)
    p.add_argument("--corrupt_index_jitter_pow", type=float, default=1.0)
    p.add_argument("--pos_clip", type=int, default=0)
    p.add_argument("--pos_clip_min", type=float, default=0.0)
    p.add_argument("--pos_clip_max", type=float, default=1.0)
    p.add_argument("--corrupt_vel", type=int, default=0,
                   help="1: recompute velocity channels from the iid-noised positions; "
                        "0 (default): from the pre-noise segment-smooth positions")
    p.add_argument("--clean_target", type=int, default=1,
                   help="1 (default): the adj-mode target level x_{s-1} is the clean "
                        "interpolation; 0: an independent corruption draw on the target too")
    # Stage-1 bootstrap scheduled sampling
    p.add_argument("--bootstrap_ckpt", type=str, default=None)
    p.add_argument("--dphi_ckpt", type=str, default=None,
                   help="segment-cost ckpt for the bootstrap Stage-1 model's kp_feat cost "
                        "channels (when it was trained with kp_feat_dphi)")
    p.add_argument("--bootstrap_replace_prob", type=float, default=0.5)
    p.add_argument("--bootstrap_warmup_steps", type=int, default=2000)
    p.add_argument("--bootstrap_ddim_steps", type=int, default=5)
    p.add_argument("--bootstrap_solver", type=str, default="ddim",
                   choices=["ddim", "pfdiff", "dpm"])
    p.add_argument("--bootstrap_best_of", type=int, default=1,
                   help="> 1: sample N candidate anchor sets, keep the dp mix or the least "
                        "colliding (the sampler's stage1_best_of)")
    p.add_argument("--bootstrap_best_of_mode", type=str, default="dp",
                   choices=["dp", "collision"])
    p.add_argument("--bootstrap_x0_clip", type=float, default=4.0,
                   help=">0: clamp the bootstrap DDIM's per-step x0 estimate to +-this across "
                        "all dims; ignored in logit space")
    add_attn_policy_arg(p)
    add_data_args(p)
    add_train_args(p)
    return p


def _mask_mix_entries(args):
    """Parsed (policy, weight) list from --mask_policy_mix, or None."""
    if not getattr(args, "mask_policy_mix", ""):
        return None
    entries = parse_policy_mix(args.mask_policy_mix)
    bad = [n for n, _ in entries if n not in {"random", "uniform", "dp", "selector"}]
    if bad:
        raise ValueError(f"mask_policy_mix has unknown policies {bad}")
    return entries


def _mask_mix_buckets(args):
    """Bucket order of the per-sample mix: dp and uniform share the "base"
    bucket (both feed idx_base; the host picks which per sample)."""
    entries = _mask_mix_entries(args)
    if not entries:
        return None
    buckets = []
    for name, _ in entries:
        b = "base" if name in ("dp", "uniform") else name
        if b not in buckets:
            buckets.append(b)
    return buckets


def mask_channels_for(args) -> int:
    base = 2 if args.mode == "adj" else 1
    return base + (1 if args.anchor_conf else 0)


def make_meta(args, data_dim: int) -> Dict:
    return {
        "stage": "interp_levels", "T": args.T, "K_min": args.K_min, "levels": args.levels,
        "k_schedule": args.k_schedule, "mode": args.mode, "causal": args.causal,
        "d_model": args.d_model, "n_layers": args.n_layers, "n_heads": args.n_heads,
        "d_ff": args.d_ff, "d_cond": args.d_cond, "maze_channels": args.maze_channels,
        "mask_channels": mask_channels_for(args), "anchor_conf": args.anchor_conf,
        "anchor_conf_anneal": args.anchor_conf_anneal,
        "anchor_conf_anneal_mode": args.anchor_conf_anneal_mode,
        "clamp_endpoints": args.clamp_endpoints, "cond_start_goal": args.cond_start_goal,
        "with_velocity": args.with_velocity, "use_sdf": args.use_sdf,
        "recompute_vel": args.recompute_vel, "data_dim": data_dim,
        "maze_h": args.maze_h, "maze_w": args.maze_w,
        "corrupt_mode": args.corrupt_mode, "corrupt_vel": args.corrupt_vel,
        "clean_target": args.clean_target, "mask_policy": args.mask_policy,
        "mask_policy_mix": args.mask_policy_mix,
        "bootstrap_best_of": getattr(args, "bootstrap_best_of", 1),
        "bootstrap_best_of_mode": getattr(args, "bootstrap_best_of_mode", "dp"),
    }


def build_model(args, data_dim: int, device: torch.device) -> InterpLevelDenoiser:
    """The denoiser with f32 masters from --seed, bf16 compute under --bf16."""
    return build_seeded(
        InterpLevelDenoiser, args, device, d_model=args.d_model, n_layers=args.n_layers,
        n_heads=args.n_heads, d_ff=args.d_ff, d_cond=args.d_cond, use_sdf=bool(args.use_sdf),
        use_start_goal=bool(args.cond_start_goal), data_dim=data_dim,
        max_levels=max(8, args.levels), mask_channels=mask_channels_for(args),
        maze_channels=tuple(int(c) for c in args.maze_channels.split(",")),
        attn_policy=getattr(args, "attn_policy", "fused"), causal=bool(args.causal))


def build_anchor_conf(mask_s: torch.Tensor, student_mask: Optional[torch.Tensor],
                      conf_teacher: float, conf_student: float, conf_endpoints: float,
                      conf_missing: float, clamp_endpoints: bool) -> torch.Tensor:
    """Per-frame anchor confidence [B, T]: teacher anchors, student anchors,
    endpoints, missing frames."""
    conf = torch.where(mask_s, conf_teacher, conf_missing).float()
    if student_mask is not None:
        conf = torch.where(student_mask & mask_s, torch.full_like(conf, conf_student), conf)
    if clamp_endpoints:
        conf = conf.clone()
        conf[:, 0] = conf_endpoints
        conf[:, -1] = conf_endpoints
    return conf


def anneal_conf(conf: torch.Tensor, s_idx: torch.Tensor, levels: int, mode: str) -> torch.Tensor:
    """conf += (1 - conf) * lambda(s), lambda linear or cosine in s / levels."""
    if mode == "none" or levels <= 0:
        return conf
    frac = s_idx.float() / float(levels)
    if mode == "linear":
        lam = 1.0 - frac
    elif mode == "cosine":
        lam = 0.5 * (1.0 + torch.cos(math.pi * frac))
    else:
        lam = torch.zeros_like(frac)
    return conf + (1.0 - conf) * lam[:, None]


def sample_level_indices(rng: Rng, B: int, levels: int, mode: str, high_prob: float,
                         device=None) -> torch.Tensor:
    """s ~ uniform{1..levels}, or biased toward s = levels w.p. high_prob.
    Draws: "s_uni" randint [B] in [1, levels], "s_high" uniform [B]."""
    s_uni = draw(rng, "s_uni", "randint", (B,), 1, levels + 1).to(device).long()
    if mode == "uniform" or levels <= 1:
        return s_uni
    high = draw(rng, "s_high", "uniform", (B,)).to(device) < float(np.clip(high_prob, 0.0, 1.0))
    return torch.where(high, torch.full_like(s_uni, levels), s_uni)


def make_bootstrap_sampler(args, data_dim: int, device: torch.device):
    """Load the Stage-1 checkpoint (EMA weights, rebuilt from its meta) and
    return (sample, K): sample(rng, idx, cond) -> z_pred [B, K, D] in data
    space, a few-step `--bootstrap_solver` run with quadratic time spacing,
    known-endpoint re-clamping and per-step position clipping (as the serving
    sampler's Stage 1). Draw: "boot_z" normal [B, K, D]; under
    `--bootstrap_best_of` N > 1, [N, B, K, D]: the N candidates run as one
    batch of N * B rows, and the chain-DP mix (`--bootstrap_best_of_mode dp`)
    or the least colliding candidate is kept, as the sampler's best-of does."""
    kp_model, meta = load_keypoint_model(args.bootstrap_ckpt, bool(args.bf16), device=device)
    kp_feat_dim = int(meta.get("kp_feat_dim", 0)) if meta.get("use_kp_feat") else 0
    dphi_fn = None
    if getattr(args, "dphi_ckpt", None):
        from ..models.loading import make_dphi_seg_cost_fn

        dphi_fn, _ = make_dphi_seg_cost_fn(args.dphi_ckpt, int(meta["T"]), meta.get("use_sdf"),
                                           bool(args.bf16), device=device)
    elif meta.get("kp_feat_dphi"):
        raise ValueError("bootstrap Stage-1 ckpt was trained with D_phi kp_feat cost channels: "
                         "pass --dphi_ckpt (channels 3/4 would be off-distribution zeros)")
    kp_model.set_attn_policy(getattr(args, "attn_policy", "fused"))
    kp_schedule = make_schedule(meta["schedule"], int(meta["N_train"]), device=device)
    logit_space = bool(meta.get("logit_space", 0))
    logit_eps = float(meta.get("logit_eps", 1e-5))
    T = int(meta["T"])
    times = make_timesteps(int(meta["N_train"]), args.bootstrap_ddim_steps, "quadratic")
    x0c = getattr(args, "bootstrap_x0_clip", 0.0)
    N = int(getattr(args, "bootstrap_best_of", 1) or 1)

    def solve(z: torch.Tensor, idx: torch.Tensor, cond: Dict) -> torch.Tensor:
        if kp_feat_dim > 0:
            # the model was trained with index features: zeros here would be
            # off-distribution
            seg_cost = dphi_fn(cond, idx) if dphi_fn is not None else None
            cond = dict(cond, kp_feat=build_kp_feat_full(idx, T, kp_feat_dim, seg_cost))
        known_mask, known_values = build_known_mask_values(idx, cond, data_dim, T,
                                                           bool(meta["clamp_endpoints"]))
        if logit_space:
            known_values = logit_pos(known_values, eps=logit_eps)

        def post(z):
            if args.pos_clip and not logit_space:
                z = torch.cat([torch.clamp(z[..., :2], args.pos_clip_min, args.pos_clip_max),
                               z[..., 2:]], dim=-1)
            return torch.where(known_mask, known_values, z)

        eps_fn = lambda z, t_b: kp_model(z, t_b, idx, known_mask, cond, T)
        # the serving sampler clamps and clips the initial noise before the
        # first model evaluation: the scheduled-sampling anchors come from the
        # served distribution
        z = run_solver(args.bootstrap_solver, eps_fn, post(z), times, kp_schedule, post=post,
                       x0_clip=x0c if (x0c and not logit_space) else None)
        return sigmoid_pos(z) if logit_space else z

    @torch.no_grad()
    def sample(rng: Rng, idx: torch.Tensor, cond: Dict) -> torch.Tensor:
        B, K_ = idx.shape
        if N <= 1:
            z = draw(rng, "boot_z", "normal", (B, K_, data_dim)).to(idx.device).float()
            return solve(z, idx, cond)
        z = draw(rng, "boot_z", "normal", (N, B, K_, data_dim)).to(idx.device).float()
        rep = lambda t: t.repeat(N, *([1] * (t.ndim - 1)))
        z_cands = solve(z.reshape(N * B, K_, data_dim), rep(idx),
                        {k: rep(v) for k, v in cond.items()})
        occ = cond["occ"][:, 0] if cond["occ"].ndim == 4 else cond["occ"]
        return pick_anchors(z_cands.view(N, B, K_, data_dim), idx, occ, T,
                            getattr(args, "bootstrap_best_of_mode", "dp"))

    return sample, int(meta["K"])


def make_selector_logits_fn(args, device: torch.device):
    """Frozen selector logits for the selector / selector_level mask
    policies: logits_fn(cond) -> [B, T], or [B, levels+1, T] under
    selector_level with a level-conditioned selector."""
    from ..models.loading import load_selector_model

    sel_model, sel_meta = load_selector_model(args.selector_ckpt, bool(args.bf16), device=device)
    k_list = compute_k_schedule(args.T, args.K_min, args.levels, args.k_schedule)

    @torch.no_grad()
    def logits_fn(cond: Dict) -> torch.Tensor:
        B, dev = cond["occ"].shape[0], cond["occ"].device
        level = lambda lv: dict(cond, level=torch.full((B, 1), float(lv), device=dev))
        if args.mask_policy == "selector_level" and sel_meta.get("use_level"):
            return torch.stack([sel_model(level(
                s / max(1, args.levels) if sel_meta.get("level_mode") == "s_norm"
                else k_list[s] / max(1, args.T - 1))) for s in range(args.levels + 1)], dim=1)
        if sel_meta.get("use_level"):
            return sel_model(level(args.K_min / max(1, args.T - 1)))
        return sel_model(cond)

    return logits_fn


def make_loss_fn(model: InterpLevelDenoiser, args, bootstrap_sample=None,
                 selector_logits_fn=None):
    """loss_fn(params, batch, rng) -> (loss, {}); batch: x, occ, start_goal,
    [sdf], [idx_base], [mask_policy_code], [bootstrap_p] scalar. `params` are
    the model's own tensors. selector_logits_fn (make_selector_logits_fn)
    ranks the masks under the selector policies.

    Draws of `rng` (train/batches.Rng), in order: the masks' "mask_rand"
    uniform [B, T-2] (random_nested) or "base_rand" uniform [B, T] (from
    idx_base; a mix draws both), sample_level_indices' draws, the bootstrap's
    "boot_z" and "boot_rep" uniform [B], then "levels" (the batch functions'
    per-level corruption draws).
    """
    levels = args.levels
    corr = dict(
        corrupt_mode=args.corrupt_mode, corrupt_sigma_max=args.corrupt_sigma_max,
        corrupt_sigma_min=args.corrupt_sigma_min, corrupt_sigma_pow=args.corrupt_sigma_pow,
        corrupt_anchor_frac=args.corrupt_anchor_frac,
        corrupt_index_jitter_max=args.corrupt_index_jitter_max,
        corrupt_index_jitter_prob=args.corrupt_index_jitter_prob,
        corrupt_index_jitter_pow=args.corrupt_index_jitter_pow,
        clamp_endpoints=bool(args.clamp_endpoints), pos_clip=bool(args.pos_clip),
        pos_clip_min=args.pos_clip_min, pos_clip_max=args.pos_clip_max,
        corrupt_vel=bool(args.corrupt_vel))
    mix_buckets = _mask_mix_buckets(args)
    conf_args = (args.anchor_conf_teacher, args.anchor_conf_student, args.anchor_conf_endpoints,
                 args.anchor_conf_missing, bool(args.clamp_endpoints))

    def loss_fn(params, batch: Dict[str, torch.Tensor], rng: Rng):
        x0 = batch["x"].float()
        cond = {"occ": batch["occ"], "start_goal": batch["start_goal"]}
        if "sdf" in batch:
            cond["sdf"] = batch["sdf"]
        B, T, D = x0.shape
        dev = x0.device
        random_masks = lambda: build_nested_masks_batch(
            B, T, args.K_min, levels, k_schedule=args.k_schedule,
            rand=draw(rng, "mask_rand", "uniform", (B, T - 2)).to(dev))
        base_masks = lambda: build_nested_masks_from_base(
            batch["idx_base"].long(), T, levels, k_schedule=args.k_schedule,
            rand=draw(rng, "base_rand", "uniform", (B, T)).to(dev))

        def selector_masks():
            logits = selector_logits_fn(cond)
            build = (build_nested_masks_from_level_logits if logits.ndim == 3
                     else build_nested_masks_from_logits)
            return build(logits, args.K_min, levels, k_schedule=args.k_schedule)

        if mix_buckets:
            # per-sample policy mix: build each bucket's masks and select by
            # batch["mask_policy_code"] (assigned on the host, same bucket order)
            code = batch["mask_policy_code"]
            built = [random_masks() if name == "random" else
                     base_masks() if name == "base" else selector_masks()
                     for name in mix_buckets]
            masks_levels, idx_levels = built[0][0], list(built[0][1])
            for j in range(1, len(built)):
                sel = code == j
                masks_levels = torch.where(sel[:, None, None], built[j][0], masks_levels)
                idx_levels = [torch.where(sel[:, None], bj, io)
                              for io, bj in zip(idx_levels, built[j][1])]
        elif selector_logits_fn is not None:
            masks_levels, idx_levels = selector_masks()
        elif "idx_base" in batch:
            masks_levels, idx_levels = base_masks()
        else:
            masks_levels, idx_levels = random_masks()
        s_idx = sample_level_indices(rng, B, levels, args.level_sampling, args.level_high_prob,
                                     device=dev)

        # Stage-1 bootstrap: replace GT anchors at the coarsest level with
        # student DDIM samples w.p. batch["bootstrap_p"] per sample; interior
        # anchors of finer levels keep GT
        x0_used, student_mask = None, None
        if bootstrap_sample is not None:
            idx_coarse = idx_levels[levels]
            z_pred = bootstrap_sample(rng, idx_coarse, cond)
            replace = (draw(rng, "boot_rep", "uniform", (B,)).to(dev)
                       < batch["bootstrap_p"])[:, None, None]
            vals = torch.where(replace, z_pred, gather_keypoints(x0, idx_coarse))
            x0_used = x0.scatter(1, idx_coarse[..., None].expand(-1, -1, D), vals)
            student_mask = torch.zeros((B, T), dtype=torch.bool, device=dev).scatter(
                1, idx_coarse, replace[:, :, 0].expand_as(idx_coarse))

        shared = dict(recompute_velocity=bool(args.recompute_vel), x0_override=x0_used,
                      masks_levels=masks_levels, idx_levels=idx_levels, s_idx=s_idx, **corr)
        conf_of = lambda mask: build_anchor_conf(mask, student_mask, *conf_args)
        if args.mode == "adj":
            x_s, x_prev, mask_s, mask_prev, s_idx, _, _ = build_interp_adjacent_batch(
                rng, x0, args.K_min, levels, clean_target=bool(args.clean_target), **shared)
            target = x_prev - x_s
            conf_s, conf_prev = conf_of(mask_s), conf_of(mask_prev)
            if args.anchor_conf_anneal:
                conf_s = anneal_conf(conf_s, s_idx, levels, args.anchor_conf_anneal_mode)
                conf_prev = anneal_conf(conf_prev, torch.clamp(s_idx - 1, min=0), levels,
                                        args.anchor_conf_anneal_mode)
            chans = [mask_s.float(), mask_prev.float()]
            mask_in = torch.stack(chans + ([conf_s] if args.anchor_conf else []), dim=-1)
            weight = conf_prev if args.anchor_conf else mask_prev.float()
        else:  # x0 mode
            x_s, mask_s, s_idx, _, _ = build_interp_level_batch(
                rng, x0, args.K_min, levels, **shared)
            target = x0 - x_s
            conf_s = conf_of(mask_s)
            if args.anchor_conf_anneal:
                conf_s = anneal_conf(conf_s, s_idx, levels, args.anchor_conf_anneal_mode)
            if args.anchor_conf:
                mask_in, weight = torch.stack([mask_s.float(), conf_s], dim=-1), conf_s
            else:
                mask_in, weight = mask_s, mask_s.float()

        delta_hat = model(x_s, s_idx, mask_in, cond)
        diff = ((delta_hat - target) ** 2).sum(dim=-1)
        if args.anchor_conf:
            w = args.w_missing + (args.w_anchor - args.w_missing) * weight
        else:
            w = torch.where(weight > 0.5, args.w_anchor, args.w_missing)
        loss = dp_sum((diff * w).sum()) / (dp_sum(w.sum()) * D + 1e-8)
        if args.smooth_weight > 0:
            # curvature of the residual, not of the prediction: the target's
            # own anchor kinks stay free
            r = delta_hat - target
            d2 = r[:, 2:] - 2.0 * r[:, 1:-1] + r[:, :-2]
            w2 = w[:, 1:-1]
            loss = loss + args.smooth_weight * dp_sum(((d2 ** 2).sum(dim=-1) * w2).sum()) / (
                dp_sum(w2.sum()) * D + 1e-8)
        return loss, {}

    return loss_fn


def make_trainer(args, device: torch.device, data_dim: int, model=None,
                 optimizer: str = "adamw"):
    """(state, train_step, model): the model (built from --seed unless
    given), the optimizer state over its own parameters (`optimizer`:
    train/state.make_optimizer's adamw or muon), and
    train_step(state, batch or superbatch, rng) -> (state, metrics)."""
    if model is None:
        model = build_model(args, data_dim, device)
    bootstrap_sample = None
    if args.bootstrap_ckpt:
        bootstrap_sample, _ = make_bootstrap_sampler(args, data_dim, device)
    mix = _mask_mix_entries(args) or []
    selector_logits_fn = None
    if ((args.mask_policy in ("selector", "selector_level") and not mix)
            or any(n == "selector" for n, _ in mix)):
        if not args.selector_ckpt:
            raise ValueError("selector mask policy needs --selector_ckpt")
        selector_logits_fn = make_selector_logits_fn(args, device)
    loss_fn = make_loss_fn(model, args, bootstrap_sample, selector_logits_fn)
    tx = make_optimizer(args.lr, args.weight_decay, args.grad_clip, optimizer=optimizer)
    state = init_train_state(model_params(model), tx, use_ema=bool(args.use_ema))
    train_step = make_train_multi_step(loss_fn, args.ema_decay, args.grad_accum,
                                       max(1, args.steps_per_call),
                                       mesh=data_mesh(args))
    return state, train_step, model


def host_batch(args, batch: Dict[str, np.ndarray], step: int,
               host_rng: np.random.RandomState) -> Dict[str, np.ndarray]:
    """What one step takes from a loader batch: the host-side mask policy
    (idx_base, per-sample policy codes) and the bootstrap probability of
    this step."""
    out = {"x": batch["x"], "occ": batch["occ"], "start_goal": batch["start_goal"]}
    if "sdf" in batch and args.use_sdf:
        out["sdf"] = batch["sdf"]
    mix_entries, mix_buckets = _mask_mix_entries(args), _mask_mix_buckets(args)
    uniform_base = lambda: sample_idx_policy(host_rng, "uniform:1.0", args.batch, args.T,
                                             args.K_min).astype(np.int32)
    if mix_entries:
        names = [n for n, _ in mix_entries]
        w = np.asarray([v for _, v in mix_entries], np.float64)
        picks = host_rng.choice(len(names), size=args.batch, p=w / w.sum())
        code = np.zeros(args.batch, np.int32)
        idx_base = uniform_base()
        for pi, name in enumerate(names):
            rows = picks == pi
            code[rows] = mix_buckets.index("base" if name in ("dp", "uniform") else name)
            if name == "dp":
                if "kp_idx" not in batch:
                    raise ValueError("mask_policy_mix includes dp but the dataset has no kp_idx")
                idx_base[rows] = np.asarray(batch["kp_idx"])[rows, :args.K_min].astype(np.int32)
        out["mask_policy_code"], out["idx_base"] = code, idx_base
    elif args.mask_policy == "dp" and "kp_idx" in batch:
        out["idx_base"] = batch["kp_idx"][:, :args.K_min].astype(np.int32)
    elif args.mask_policy == "uniform":
        out["idx_base"] = uniform_base()
    if args.bootstrap_ckpt:
        out["bootstrap_p"] = np.float32(args.bootstrap_replace_prob * min(
            1.0, (step + 1) / max(1, args.bootstrap_warmup_steps)))
    return out


def main(argv=None) -> TrainState:
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    data_mesh(args)
    ds, data_dim = make_dataset(args)
    loader = iter(make_loader(ds, args))
    first = next(loader)

    state, train_step, model = make_trainer(args, device, data_dim)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model params: {n_params / 1e6:.2f}M | device: {device} | "
          f"attn_policy: {args.attn_policy}", flush=True)
    start_step = 0
    if args.resume:
        state, start_step = resume_state(state, args.resume, device)

    host_rng = np.random.RandomState(args.seed + 1)
    meta = make_meta(args, data_dim)
    write_run_config(args, {"args": vars(args), "meta": meta, "n_params": n_params})
    return run_training(args, device, loader, first, state, train_step,
                        lambda b, step: host_batch(args, b, step, host_rng), meta, start_step)


if __name__ == "__main__":
    main()
