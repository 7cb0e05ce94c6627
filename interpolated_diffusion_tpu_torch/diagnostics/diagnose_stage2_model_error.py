"""Per-level Stage-2 model error (port of
diagnostics/diagnose_stage2_model_error.py).

    python -m interpolated_diffusion_tpu_torch.diagnostics.diagnose_stage2_model_error \\
        --interp_ckpt RUN_OR_CKPT [--dataset prepared --prepared_path X.npz] [flags]

Evaluates a Stage-2 checkpoint's prediction error at every corruption level
s = 1 .. levels on held-out data (delta to the clean level s-1 in `adj`
mode, x0 - x_s in `x0` mode), beside the "do nothing" baseline (the target's
own mean square): which levels the model learned to refine. Batches are
drawn on the host with numpy's RandomState(--seed), as the JAX CLI draws
them; the nested masks' uniforms are the `draws` argument of `main` (one
{"mask_rand": [B, T-2]} a batch, levels outer, batches inner: a test hands in
the JAX CLI's), else drawn from a torch.Generator seeded by --seed on the
device. The model's blocks run under --attn_policy (rows 1 and 2 of the
kernel table under block / fused at bf16). Prints the JSON report
{level_s: {model_mse, zero_baseline_mse, improvement}} (and writes it to
--out_json).
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..kernels.tuning import add_attn_policy_arg
from ..models.loading import load_interp_model
from ..train.batches import build_interp_adjacent_batch, build_interp_level_batch
from ..train.common import add_data_args, make_dataset, resolve_device
from ..train.train_interp_levels import build_anchor_conf


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("diagnose_stage2_model_error")
    p.add_argument("--interp_ckpt", type=str, required=True)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--num_batches", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", type=int, default=0)
    p.add_argument("--out_json", type=str, default=None)
    add_attn_policy_arg(p)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; no fallback when there is no GPU) or cpu")
    add_data_args(p)
    return p


@torch.no_grad()
def level_error(model, meta: Dict, x0: torch.Tensor, cond: Dict[str, torch.Tensor], s: int,
                rng) -> "tuple[torch.Tensor, torch.Tensor]":
    """(model MSE, zero-baseline MSE) of one batch at level s; `rng` a
    torch.Generator or the draws {"mask_rand": [B, T-2]}."""
    B = x0.shape[0]
    K_min, levels = int(meta["K_min"]), int(meta["levels"])
    anchor_conf = bool(meta.get("anchor_conf", 0))
    s_idx = torch.full((B,), s, dtype=torch.long, device=x0.device)
    if isinstance(rng, dict):
        rng = {"levels": {}, **rng}
    if meta.get("mode", "adj") == "adj":
        x_s, x_prev, mask_s, mask_prev, _, _, _ = build_interp_adjacent_batch(
            rng, x0, K_min, levels, s_idx=s_idx)
        target = x_prev - x_s
        chans = [mask_s.float(), mask_prev.float()]
        if anchor_conf:
            chans.append(build_anchor_conf(mask_s, None, 0.95, 0.5, 1.0, 0.0, True))
        mask_in = torch.stack(chans, dim=-1)
    else:
        x_s, mask_s, _, _, _ = build_interp_level_batch(rng, x0, K_min, levels, s_idx=s_idx)
        target = x0 - x_s
        if anchor_conf:
            conf = build_anchor_conf(mask_s, None, 0.95, 0.5, 1.0, 0.0, True)
            mask_in = torch.stack([mask_s.float(), conf], dim=-1)
        else:
            mask_in = mask_s
    delta = model(x_s, s_idx, mask_in, cond).float()
    return ((delta - target) ** 2).mean(), (target ** 2).mean()


def main(argv=None, draws: Optional[Iterable[Dict[str, torch.Tensor]]] = None):
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    model, meta = load_interp_model(args.interp_ckpt, bool(args.bf16), device=device)
    model.set_attn_policy(args.attn_policy)
    levels = int(meta["levels"])
    args.T = int(meta["T"])
    ds, _ = make_dataset(args)
    rng = np.random.RandomState(args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    draws = iter(draws) if draws is not None else None
    report = {}
    for s in range(1, levels + 1):
        ms, zs = [], []
        for _ in range(args.num_batches):
            batch = ds.get_batch(rng.randint(0, len(ds), size=args.batch))
            cond = {"occ": torch.as_tensor(batch["occ"]).to(device),
                    "start_goal": torch.as_tensor(batch["start_goal"]).to(device)}
            if "sdf" in batch and meta.get("use_sdf"):
                cond["sdf"] = torch.as_tensor(batch["sdf"]).to(device)
            d = gen if draws is None else {k: torch.as_tensor(v).to(device)
                                           for k, v in next(draws).items()}
            m, z = level_error(model, meta, torch.as_tensor(batch["x"]).to(device).float(), cond,
                               s, d)
            ms.append(float(m))
            zs.append(float(z))
        report[f"level_{s}"] = {
            "model_mse": float(np.mean(ms)),
            "zero_baseline_mse": float(np.mean(zs)),
            "improvement": float(1.0 - np.mean(ms) / max(np.mean(zs), 1e-12)),
        }
    out = json.dumps(report, indent=2)
    print(out)
    if args.out_json:
        with open(args.out_json, "w") as f:
            f.write(out)
    return report


if __name__ == "__main__":
    main()
