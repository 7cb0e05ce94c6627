"""Latent straightness diagnostics on wan-synth latents (port of
diagnostics/diagnose_latent_straightness.py).

    python -m interpolated_diffusion_tpu_torch.diagnostics.diagnose_latent_straightness \\
        [--data synthetic|tar --data_root DIR] [--straightener_ckpt RUN_OR_CKPT] [--device cpu]

Per batch: the temporal curvature |z_{t+1} - 2 z_t + z_{t-1}| (and its ratio
to the span), and barycentric linearity on random triplets (t0 < t < t1):
the LERP error against the copy-endpoint baseline, bucketed by gap; with a
trained straightener the same in its space (s-space LERP error, the z
decoded from the s-space LERP, s-space curvature). The measurements run on
the device, one batch at a time; the triplets are drawn on the host with
numpy's RandomState(--seed), as the JAX CLI draws them, so both packages
measure the same triplets. Prints the JAX CLI's lines and returns the
per-triplet arrays.
"""
from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from ..train.common import resolve_device
from ..train.wansynth_common import add_wansynth_data_args, make_wansynth_loader


def sample_triplets(B: int, T: int, min_gap: int, rng: np.random.RandomState):
    """(t0, t1, t, alpha) with t0 + min_gap <= t1, t strictly interior."""
    if T <= 2:
        raise ValueError("T must be >= 3 to sample triplets")
    min_gap = max(2, int(min_gap))
    t0 = np.empty(B, np.int64)
    t1 = np.empty(B, np.int64)
    todo = np.ones(B, bool)
    while todo.any():
        n = int(todo.sum())
        a = rng.randint(0, T - 1, size=n)
        b = rng.randint(0, T - 1, size=n)
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        ok = (hi - lo) >= min_gap
        sel = np.flatnonzero(todo)[ok]
        t0[sel], t1[sel] = lo[ok], hi[ok]
        todo[sel] = False
    gap = t1 - t0
    t = t0 + 1 + np.floor(rng.rand(B) * (gap - 1)).astype(np.int64)
    alpha = (t - t0).astype(np.float32) / np.maximum(gap, 1)
    return t0, t1, t, alpha


def _err(a: torch.Tensor, b: torch.Tensor, loss_type: str) -> torch.Tensor:
    d = (a - b).float()
    axes = tuple(range(1, d.ndim))
    if loss_type == "l2":
        return torch.sqrt((d ** 2).mean(dim=axes))
    return d.abs().mean(dim=axes)


def bucket_stats(gaps: np.ndarray, errs: np.ndarray, buckets):
    out = []
    for lo, hi in buckets:
        m = (gaps >= lo) & (gaps <= hi)
        out.append((lo, hi, float(errs[m].mean()) if m.any() else math.nan, int(m.sum())))
    return out


@torch.no_grad()
def measure(latents: torch.Tensor, t0, t1, t, alpha, loss_type: str = "l1", straightener=None):
    """Per-sample measurements of one [B, T, C, H, W] batch at triplets
    (t0, t1, t, alpha) ([B] tensors on its device): {curv, curv_ratio, lerp,
    copy} and, with a straightener, {s_lerp, z_from_s, s_curv, s_curv_ratio}."""
    lat = latents.float()
    z_prev, z_mid, z_next = lat[:, :-2], lat[:, 1:-1], lat[:, 2:]
    d2 = _err(z_next + z_prev, 2.0 * z_mid, loss_type)
    span = _err(z_next, z_prev, loss_type)
    out = {"curv": d2, "curv_ratio": d2 / (span + 1e-8)}

    b = torch.arange(lat.shape[0], device=lat.device)
    z0, z1, zt = lat[b, t0], lat[b, t1], lat[b, t]
    a4 = alpha[:, None, None, None]
    z_lerp = (1.0 - a4) * z0 + a4 * z1
    out["lerp"] = _err(z_lerp, zt, loss_type)
    out["copy"] = torch.minimum(_err(z0, zt, loss_type), _err(z1, zt, loss_type))

    if straightener is not None:
        enc = straightener.encode
        s0, s1, st = enc(z0), enc(z1), enc(zt)
        s_lerp = (1.0 - a4) * s0 + a4 * s1
        z_from_s = straightener.decode(s_lerp)
        out["s_lerp"] = _err(s_lerp, st, loss_type)
        out["z_from_s"] = _err(z_from_s, zt, loss_type)
        B, C, H, W = z0.shape
        T = lat.shape[1]
        flatten = lambda z5: z5.reshape((-1,) + tuple(z5.shape[2:]))
        sp = enc(flatten(lat[:, :-2])).reshape(B, T - 2, C, H, W)
        sm = enc(flatten(lat[:, 1:-1])).reshape(B, T - 2, C, H, W)
        sn = enc(flatten(lat[:, 2:])).reshape(B, T - 2, C, H, W)
        s_d2 = _err(sn + sp, 2.0 * sm, loss_type)
        s_span = _err(sn, sp, loss_type)
        out["s_curv"] = s_d2
        out["s_curv_ratio"] = s_d2 / (s_span + 1e-8)
    return out


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("diagnose_latent_straightness")
    add_wansynth_data_args(p)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--num_batches", type=int, default=20)
    p.add_argument("--min_gap", type=int, default=2)
    p.add_argument("--loss_type", type=str, default="l1", choices=["l1", "l2"])
    p.add_argument("--straightener_ckpt", type=str, default="")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; no fallback when there is no GPU) or cpu")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    loader = make_wansynth_loader(args, args.seed)
    rng = np.random.RandomState(args.seed)
    T = args.T

    straightener = None
    if args.straightener_ckpt:
        from ..models.straightener import load_latent_straightener

        straightener, _ = load_latent_straightener(args.straightener_ckpt, device=device)

    acc = {}
    gaps_all = []
    for _ in range(args.num_batches):
        batch = next(loader)
        lat = torch.as_tensor(np.asarray(batch["latents"])).to(device)
        B = lat.shape[0]
        t0, t1, t, alpha = sample_triplets(B, T, args.min_gap, rng)
        on = lambda a: torch.as_tensor(a).to(device)
        res = measure(lat, on(t0), on(t1), on(t), on(alpha), args.loss_type, straightener)
        for k, v in res.items():
            acc.setdefault(k, []).append(v.cpu().numpy())
        gaps_all.append(t1 - t0)

    agg = {k: np.concatenate(v) for k, v in acc.items()}
    gaps = np.concatenate(gaps_all)
    label = "L2" if args.loss_type == "l2" else "L1"
    print("\n=== Latent Straightness Diagnostics (raw latents) ===")
    print(f"samples (triplets): {agg['lerp'].size}")
    print(f"LERP {label} (mean): {agg['lerp'].mean():.6f}")
    print(f"Copy-endpoint {label} (mean): {agg['copy'].mean():.6f}")
    print(f"LERP improvement vs copy: {agg['copy'].mean() - agg['lerp'].mean():.3f}")
    print(f"Temporal curvature {label} (mean): {agg['curv'].mean():.6f}")
    print(f"Temporal curvature ratio (mean): {agg['curv_ratio'].mean():.6f}")
    if "s_lerp" in agg:
        print("\n--- Straightened space ---")
        print(f"S-space LERP {label} (mean): {agg['s_lerp'].mean():.6f}")
        print(f"Z from S-LERP {label} (mean): {agg['z_from_s'].mean():.6f}")
        print(f"S-space curvature {label} (mean): {agg['s_curv'].mean():.6f}")
        print(f"S-space curvature ratio (mean): {agg['s_curv_ratio'].mean():.6f}")
    buckets = [(2, 3), (4, 6), (7, 10), (11, 20)]
    print(f"\nLERP {label} by gap bucket:")
    for lo, hi, val, n in bucket_stats(gaps, agg["lerp"], buckets):
        print(f"  gap {lo:02d}-{hi:02d}: {val:.6f} (n={n})")
    print(f"Copy {label} by gap bucket:")
    for lo, hi, val, n in bucket_stats(gaps, agg["copy"], buckets):
        print(f"  gap {lo:02d}-{hi:02d}: {val:.6f} (n={n})")
    return agg


if __name__ == "__main__":
    main()
