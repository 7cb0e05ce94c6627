"""Interpolator quality against the lerp baseline (port of
diagnostics/eval_interpolators.py).

    python -m interpolated_diffusion_tpu_torch.diagnostics.eval_interpolators [flags]

`--interpolator lerp | flow | sinkhorn` on synthetic clips or tar shards:
K fixed anchors per clip (endpoints forced), and on the hidden frames the
latent L1 against the lerp's, PSNR and SSIM (global per-frame statistics),
and the count of clips whose L1 exceeds the lerp's by more than
`--outlier_delta`. The report is printed as JSON (and written to
`--out_json`) with the port's `samples_per_sec` beside JAX's keys. The
interpolator runs in f32 on `--device` (cuda unless asked). `--rgb 1`
decodes prediction, lerp and ground truth of 4-channel SD latents through
models/sd_vae.SDVAE (the weights of `--vae_sd`, else seeded ones: a smoke
run) and adds pixel-space PSNR / SSIM on the hidden frames (`rgb_psnr`,
`rgb_psnr_lerp`, `rgb_ssim`, `rgb_ssim_lerp`).

`--interpolator tiny` is refused, as in the JAX CLI: that CLI binds a model
only for flow and sinkhorn, so its `tiny` ends in an UnboundLocalError
before any batch; here it raises NotImplementedError saying so. (The model
itself is models/interpolators.TinyTemporalInterpolator, trained by
train/train_video_interpolator.py.)
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..data.wan_synth import SyntheticWanDataset, WanSynthTarDataset
from ..ops.keyframes import sample_fixed_k_indices_batch
from ..train.train_sinkhorn_interp_wansynth import lerp_baseline


def psnr(pred: np.ndarray, target: np.ndarray, data_range: Optional[float] = None) -> float:
    mse = float(((pred - target) ** 2).mean())
    if data_range is None:
        data_range = float(target.max() - target.min()) or 1.0
    return float(10.0 * np.log10(data_range ** 2 / max(mse, 1e-12)))


def ssim(pred: np.ndarray, target: np.ndarray) -> float:
    """Global-statistics SSIM (per-frame means, variances, covariance), averaged."""
    p = pred.reshape(pred.shape[0], -1).astype(np.float64)
    t = target.reshape(target.shape[0], -1).astype(np.float64)
    mu_p, mu_t = p.mean(1), t.mean(1)
    var_p, var_t = p.var(1), t.var(1)
    cov = ((p - mu_p[:, None]) * (t - mu_t[:, None])).mean(1)
    L = max(float(t.max() - t.min()), 1e-6)
    c1, c2 = (0.01 * L) ** 2, (0.03 * L) ** 2
    s = ((2 * mu_p * mu_t + c1) * (2 * cov + c2)) / (
        (mu_p ** 2 + mu_t ** 2 + c1) * (var_p + var_t + c2))
    return float(s.mean())


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("eval_interpolators")
    p.add_argument("--interpolator", type=str, default="lerp",
                   choices=["lerp", "flow", "sinkhorn", "tiny"])
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--data", type=str, default="synthetic", choices=["synthetic", "tar"])
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--T", type=int, default=21)
    p.add_argument("--K", type=int, default=5)
    p.add_argument("--latent_c", type=int, default=16)
    p.add_argument("--latent_h", type=int, default=16)
    p.add_argument("--latent_w", type=int, default=16)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--num_batches", type=int, default=8)
    p.add_argument("--outlier_delta", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", type=int, default=0,
                   help="recorded only: the interpolators run in f32, as in the JAX CLI")
    p.add_argument("--out_json", type=str, default=None)
    p.add_argument("--rgb", type=int, default=0,
                   help="also decode 4-channel SD latents through the SD VAE and report "
                        "pixel-space PSNR / SSIM (16-channel Wan latents have no decoder in "
                        "the repo: latent metrics only for those)")
    p.add_argument("--vae_sd", type=str, default=None,
                   help="diffusers SD-VAE checkpoint (dir or .safetensors) for --rgb; "
                        "seeded random weights if omitted (smoke only)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; no fallback when there is no GPU) or cpu")
    return p


def load_interp_fn(args, device: torch.device):
    """The interpolator's (latents, idx) -> latents, or None for lerp;
    --latent_c follows the checkpoint's meta."""
    if args.interpolator == "lerp":
        return None
    if args.interpolator == "tiny":
        raise NotImplementedError("--interpolator tiny: the JAX CLI builds no model for tiny "
                                  "(it binds one only for flow and sinkhorn, and its tiny run "
                                  "ends in UnboundLocalError), so there is no behaviour to "
                                  "port; train_video_interpolator trains the model")
    if not args.ckpt:
        raise ValueError(f"--ckpt required for {args.interpolator}")
    from ..models.loading import load_flow_interpolator, load_sinkhorn_interp

    load = load_flow_interpolator if args.interpolator == "flow" else load_sinkhorn_interp
    model, meta = load(args.ckpt, device=device)
    if "in_channels" in meta and int(meta["in_channels"]) != args.latent_c:
        print(f"latent_c {args.latent_c} -> {meta['in_channels']} (ckpt meta)")
        args.latent_c = int(meta["in_channels"])

    @torch.no_grad()
    def interp_fn(lat, idx):
        return model(lat, idx)[0]

    return interp_fn


def make_decode_fn(args, device: torch.device):
    """SD latents [B, T, 4, h, w] -> RGB [B, T, 3, 8h, 8w] in [0, 1]: the SD
    VAE decoder, f32, with the weights of --vae_sd or seeded ones."""
    if args.latent_c != 4:
        raise SystemExit(f"--rgb needs 4-channel SD latents (got C={args.latent_c}); "
                         "16-channel Wan latents have no in-repo decoder")
    from ..models.init import build_model
    from ..models.sd_vae import SDVAE, load_sd_vae_safetensors

    vae = build_model(SDVAE, generator=torch.Generator(device=device).manual_seed(0),
                      device=device)
    if args.vae_sd:
        vae.load_state_dict(load_sd_vae_safetensors(args.vae_sd))
    vae.eval().requires_grad_(False)

    @torch.no_grad()
    def decode_fn(latents):
        return vae.decode(latents)

    return decode_fn


def main(argv=None, draws: Optional[Iterable[Dict[str, np.ndarray]]] = None) -> Dict:
    """The report. `draws` (one {"idx_rand": [B, T - 2]} per batch) replaces
    the anchor draws of the CLI's generator, so that a test can hand in JAX's."""
    from ..train.common import resolve_device

    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    interp_fn = load_interp_fn(args, device)
    if args.data == "tar":
        ds_iter = WanSynthTarDataset(args.data_root, T=args.T).batches(args.batch)
        get_batch = lambda: next(ds_iter)
    else:
        ds = SyntheticWanDataset(n_samples=args.batch * args.num_batches, T=args.T,
                                 C=args.latent_c, H=args.latent_h, W=args.latent_w,
                                 text_len=4, text_dim=8, seed=args.seed + 7)
        rng = np.random.RandomState(args.seed)
        get_batch = lambda: ds.get_batch(rng.randint(0, len(ds), args.batch))
    decode_fn = make_decode_fn(args, device) if args.rgb else None
    gen = torch.Generator(device=device).manual_seed(args.seed)
    draws = iter(draws) if draws is not None else None

    rgb_psnrs, rgb_psnrs_lerp, rgb_ssims, rgb_ssims_lerp = [], [], [], []
    deltas, l1s, l1s_lerp, psnrs, ssims = [], [], [], [], []
    n_seen, busy = 0, 0.0
    for _ in range(args.num_batches):
        lat = torch.as_tensor(get_batch()["latents"]).to(device).float()
        B = lat.shape[0]
        rand = (torch.tensor(np.asarray(next(draws)["idx_rand"])).to(device)
                if draws is not None else None)
        idx, mask = sample_fixed_k_indices_batch(B, args.T, args.K, rand=rand, generator=gen)
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        lerp = lerp_baseline(lat, idx)
        pred = interp_fn(lat, idx) if interp_fn is not None else lerp
        pred_np = pred.cpu().numpy()      # waits for the device
        busy += time.perf_counter() - t0
        n_seen += B
        lerp_np, lat_np, hidden = lerp.cpu().numpy(), lat.cpu().numpy(), (~mask).cpu().numpy()
        for b in range(B):
            hb = hidden[b]
            p_np, l_np, t_np = pred_np[b][hb], lerp_np[b][hb], lat_np[b][hb]
            l1 = float(np.abs(p_np - t_np).mean())
            l1_l = float(np.abs(l_np - t_np).mean())
            l1s.append(l1)
            l1s_lerp.append(l1_l)
            deltas.append(l1 - l1_l)
            psnrs.append(psnr(p_np, t_np))
            ssims.append(ssim(p_np, t_np))
        if decode_fn is not None:
            rgb_pred, rgb_lerp, rgb_gt = (decode_fn(z).cpu().numpy() for z in (pred, lerp, lat))
            for b in range(B):
                hb = hidden[b]
                rgb_psnrs.append(psnr(rgb_pred[b][hb], rgb_gt[b][hb], 1.0))
                rgb_psnrs_lerp.append(psnr(rgb_lerp[b][hb], rgb_gt[b][hb], 1.0))
                rgb_ssims.append(ssim(rgb_pred[b][hb], rgb_gt[b][hb]))
                rgb_ssims_lerp.append(ssim(rgb_lerp[b][hb], rgb_gt[b][hb]))
    deltas = np.asarray(deltas)
    report = {
        "interpolator": args.interpolator,
        "latent_l1": float(np.mean(l1s)),
        "lerp_l1": float(np.mean(l1s_lerp)),
        "l1_vs_lerp_pct": float(100.0 * (np.mean(l1s_lerp) - np.mean(l1s))
                                / max(np.mean(l1s_lerp), 1e-12)),
        "psnr": float(np.mean(psnrs)),
        "ssim": float(np.mean(ssims)),
        "outliers_worse_than_lerp": int((deltas > args.outlier_delta).sum()),
        "n_samples": int(deltas.size),
        "samples_per_sec": n_seen / max(busy, 1e-9),
    }
    if rgb_psnrs:
        report.update({"rgb_psnr": float(np.mean(rgb_psnrs)),
                       "rgb_psnr_lerp": float(np.mean(rgb_psnrs_lerp)),
                       "rgb_ssim": float(np.mean(rgb_ssims)),
                       "rgb_ssim_lerp": float(np.mean(rgb_ssims_lerp))})
    out = json.dumps(report, indent=2)
    print(out, flush=True)
    if args.out_json:
        with open(args.out_json, "w") as f:
            f.write(out)
    return report


if __name__ == "__main__":
    main()
