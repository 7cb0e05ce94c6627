"""Per-case Sinkhorn-warp outlier triage on wan-synth latents (port of
diagnostics/diagnose_sinkhorn_outliers.py).

    python -m interpolated_diffusion_tpu_torch.diagnostics.diagnose_sinkhorn_outliers \\
        --ckpt SINKHORN_RUN_OR_CKPT [--data synthetic|tar --data_root DIR]
        [--straightener_ckpt RUN_OR_CKPT] [--out_dir DIR] [--device cpu]

Draws random (t0, t1, t) triplets (host numpy, RandomState(--seed + 1234),
the triplets of diagnose_latent_straightness, as the JAX CLI draws them),
interpolates the interior frame with a trained SinkhornWarpInterpolator and
ranks the cases by how much worse (or better) the warp is than plain LERP,
beside the per-case correspondence telemetry that explains outliers:
token-flow magnitude, Sinkhorn / dustbin confidence, forward-backward
consistency error and the global SE(2) estimate (theta, dx, dy). Both
warps are measured per case: with the flows shrunk by their confidence (the
interpolator's default) and raw. With --straightener_ckpt also the
straight-LERP baseline. Writes cases.jsonl (worst first), summary.json and,
with --save_tensors, the worst --topk cases' tensors (worst_cases.npz);
prints the summary and the worst / best cases.
"""
from __future__ import annotations

import argparse
import json
import math
import os

import numpy as np
import torch

from ..models.loading import load_sinkhorn_interp
from ..ops.image import resize_bilinear, warp
from ..train.common import resolve_device
from ..train.wansynth_common import add_wansynth_data_args, make_wansynth_loader
from .diagnose_latent_straightness import sample_triplets

CASE_FIELDS = (
    "sinkhorn_mse", "sinkhorn_rawflow_mse", "lerp_mse", "straight_lerp_mse",
    "flow01_tok_mag_mean", "flow01_tok_mag_max",
    "conf01_tok_mean", "conf10_tok_mean",
    "fb_err01_tok_mean", "fb_err10_tok_mean",
    "theta_deg", "dx_tok", "dy_tok",
)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("diagnose_sinkhorn_outliers")
    p.add_argument("--ckpt", type=str, required=True, help="sinkhorn_interp checkpoint")
    add_wansynth_data_args(p)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--num_batches", type=int, default=20)
    p.add_argument("--min_gap", type=int, default=2)
    p.add_argument("--topk", type=int, default=12)
    p.add_argument("--straightener_ckpt", type=str, default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out_dir", type=str, default="runs/sinkhorn_outliers")
    p.add_argument("--save_tensors", type=int, default=1,
                   help="save the worst-K (z0, z1, zt, z_hat) tensors as npz")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; no fallback when there is no GPU) or cpu")
    return p


@torch.no_grad()
def measure(model, z0, z1, zt, alpha, patch_size: float, straightener=None):
    """[B, C, H, W] endpoints / target and alpha [B] -> (per-case stats, z_hat)."""
    B, _, H, W = z0.shape
    a4 = alpha[:, None, None, None].float()
    f0, hp, wp = model.token_features(z0, True)
    f1, _, _ = model.token_features(z1, True)
    flow01_tok, conf01_tok = model._flow_and_conf(f0, f1, hp, wp)
    flow10_tok, conf10_tok = model._flow_and_conf(f1, f0, hp, wp)
    theta, dx, dy = model._global_se2(f0, f1)

    # forward-backward consistency error in token units (the raw signal
    # behind the module's fb_sigma confidence gate)
    f01c = flow01_tok.permute(0, 3, 1, 2).float()
    f10c = flow10_tok.permute(0, 3, 1, 2).float()
    fb01 = torch.linalg.vector_norm(f01c + warp(f10c, f01c), dim=1)
    fb10 = torch.linalg.vector_norm(f10c + warp(f01c, f10c), dim=1)
    if model.fb_sigma > 0.0:
        g = lambda e: torch.clamp(torch.exp(-0.5 * (e / model.fb_sigma) ** 2), 0.0, 1.0)
        conf01_tok = conf01_tok * g(fb01)
        conf10_tok = conf10_tok * g(fb10)

    flow01 = resize_bilinear(f01c, (H, W)) * patch_size
    flow10 = resize_bilinear(f10c, (H, W)) * patch_size
    c01 = torch.clamp(resize_bilinear(conf01_tok[:, None], (H, W)), 0.0, 1.0)
    c10 = torch.clamp(resize_bilinear(conf10_tok[:, None], (H, W)), 0.0, 1.0)

    def blend(conf_scale: bool):
        s01 = c01 if conf_scale else 1.0
        s10 = c10 if conf_scale else 1.0
        fa = flow01 * s01 * a4
        fb = flow10 * s10 * (1.0 - a4)
        z0w, z1w = warp(z0, -fa), warp(z1, -fb)
        c0w, c1w = warp(c01, -fa), warp(c10, -fb)
        w0, w1 = (1.0 - a4) * c0w, a4 * c1w
        denom = w0 + w1
        z_mix = (w0 * z0w + w1 * z1w) / torch.clamp(denom, min=1e-6)
        z_lerp = (1.0 - a4) * z0 + a4 * z1
        return torch.where(denom > 1e-6, z_mix, z_lerp)

    mse = lambda a, b: ((a.float() - b.float()) ** 2).mean(dim=(1, 2, 3))
    z_hat = blend(conf_scale=True)
    mag = torch.linalg.vector_norm(flow01_tok, dim=-1)
    out = {
        "sinkhorn_mse": mse(z_hat, zt),
        "sinkhorn_rawflow_mse": mse(blend(conf_scale=False), zt),
        "lerp_mse": mse((1.0 - a4) * z0 + a4 * z1, zt),
        "flow01_tok_mag_mean": mag.mean(dim=(1, 2)),
        "flow01_tok_mag_max": mag.amax(dim=(1, 2)),
        "conf01_tok_mean": conf01_tok.mean(dim=(1, 2)),
        "conf10_tok_mean": conf10_tok.mean(dim=(1, 2)),
        "fb_err01_tok_mean": fb01.mean(dim=(1, 2)),
        "fb_err10_tok_mean": fb10.mean(dim=(1, 2)),
        "theta_deg": theta * (180.0 / math.pi),
        "dx_tok": dx, "dy_tok": dy,
    }
    if straightener is not None:
        s_lerp = (1.0 - a4) * straightener.encode(z0) + a4 * straightener.encode(z1)
        out["straight_lerp_mse"] = mse(straightener.decode(s_lerp), zt)
    else:
        out["straight_lerp_mse"] = torch.full((B,), math.nan, device=z0.device)
    return out, z_hat


def main(argv=None):
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    model, meta = load_sinkhorn_interp(args.ckpt, device=device)
    straightener = None
    if args.straightener_ckpt:
        from ..models.straightener import load_latent_straightener

        straightener, _ = load_latent_straightener(args.straightener_ckpt, device=device)
    ps = float(meta["patch_size"])

    loader = make_wansynth_loader(args, args.seed)
    rng = np.random.RandomState(args.seed + 1234)
    T = args.T

    cases = []
    tensors = []  # (z0, z1, zt, z_hat) per case, host numpy
    for bi in range(args.num_batches):
        batch = next(loader)
        lat = np.asarray(batch["latents"], np.float32)
        keys = batch.get("__keys__", [""] * lat.shape[0])
        B = lat.shape[0]
        t0, t1, t, alpha = sample_triplets(B, T, args.min_gap, rng)
        take = lambda ti: torch.as_tensor(lat[np.arange(B), ti]).to(device)
        stats, z_hat = measure(model, take(t0), take(t1), take(t),
                               torch.as_tensor(alpha).to(device), ps, straightener)
        host = {k: v.cpu().numpy() for k, v in stats.items()}
        z_hat = z_hat.cpu().numpy()
        for i in range(B):
            rec = {"key": str(keys[i]), "batch": bi, "index": i,
                   "t0": int(t0[i]), "t1": int(t1[i]), "t": int(t[i]),
                   "gap": int(t1[i] - t0[i]), "alpha": float(alpha[i])}
            for f in CASE_FIELDS:
                rec[f] = float(host[f][i])
            rec["delta_vs_lerp"] = rec["sinkhorn_mse"] - rec["lerp_mse"]
            rec["delta_vs_straight"] = rec["sinkhorn_mse"] - rec["straight_lerp_mse"]
            cases.append(rec)
            if args.save_tensors:
                tensors.append((lat[i, t0[i]], lat[i, t1[i]], lat[i, t[i]], z_hat[i]))

    cases_sorted = sorted(cases, key=lambda c: c["delta_vs_lerp"], reverse=True)
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "cases.jsonl"), "w") as f:
        for c in cases_sorted:
            f.write(json.dumps(c) + "\n")

    arr = lambda f: np.asarray([c[f] for c in cases])
    summary = {
        "n_cases": len(cases),
        "sinkhorn_mse_mean": float(arr("sinkhorn_mse").mean()),
        "rawflow_mse_mean": float(arr("sinkhorn_rawflow_mse").mean()),
        "lerp_mse_mean": float(arr("lerp_mse").mean()),
        "frac_worse_than_lerp": float((arr("delta_vs_lerp") > 0).mean()),
        "worst_delta_vs_lerp": float(arr("delta_vs_lerp").max()),
        # is the confidence-shrunk warp rescuing the raw-flow outliers?
        "rawflow_worst_delta": float((arr("sinkhorn_rawflow_mse") - arr("lerp_mse")).max()),
    }
    with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)

    if args.save_tensors:
        order = sorted(range(len(cases)), key=lambda i: cases[i]["delta_vs_lerp"], reverse=True)
        worst = order[: args.topk]
        np.savez(os.path.join(args.out_dir, "worst_cases.npz"),
                 z0=np.stack([tensors[i][0] for i in worst]),
                 z1=np.stack([tensors[i][1] for i in worst]),
                 zt=np.stack([tensors[i][2] for i in worst]),
                 z_hat=np.stack([tensors[i][3] for i in worst]),
                 meta=json.dumps([cases[i] for i in worst]))

    print(json.dumps(summary, indent=2))
    name = lambda c: c["key"] or "b{batch}i{index}".format(**c)
    print(f"\nworst {args.topk} vs LERP:")
    for c in cases_sorted[: args.topk]:
        print(f"  key={name(c)} "
              f"gap={c['gap']} Δlerp={c['delta_vs_lerp']:+.5f} "
              f"flowmax={c['flow01_tok_mag_max']:.2f} "
              f"conf={c['conf01_tok_mean']:.3f} "
              f"fb={c['fb_err01_tok_mean']:.2f} θ={c['theta_deg']:+.1f}°")
    print(f"\nbest {args.topk} vs LERP:")
    for c in cases_sorted[-args.topk:][::-1]:
        print(f"  key={name(c)} gap={c['gap']} Δlerp={c['delta_vs_lerp']:+.5f}")
    return summary


if __name__ == "__main__":
    main()
