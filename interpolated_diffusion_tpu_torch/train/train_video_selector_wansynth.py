"""Video keyframe selector trainer on wansynth latents (port of
train/train_video_selector_wansynth.py).

    python -m interpolated_diffusion_tpu_torch.train.train_video_selector_wansynth [flags]

Labels are the DP-optimal K keyframes of each clip under its exact oracle
latent-MSE cost matrix (ops/oracle_segment_cost.py, ops/selection.py);
the selector is trained with a positive-weighted BCE on its per-frame
logits, optionally conditioned on the level K / (T - 1), and every
--eval_every steps reports the top-K overlap with the DP labels. AdamW
behind a global-norm clip, no EMA. Runs on the GPU unless `--device cpu`;
`--n_data_shards N` runs data parallel under torchrun.
"""
from __future__ import annotations

import argparse
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..models.video_selector import VideoKeyframeSelector
from ..ops.oracle_segment_cost import (OracleSegPrecompute, build_oracle_seg_precompute,
                                       compute_oracle_cost_seg_mse)
from ..ops.selection import build_cost_matrix_from_segments, dp_select_indices_batch
from .common import build_seeded
from .interp_common import add_interp_train_args, make_state, setup, train_loop
from .state import TrainState


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("train_video_selector_wansynth")
    p.add_argument("--K", type=int, default=5)
    p.add_argument("--d_model", type=int, default=256)
    p.add_argument("--d_cond", type=int, default=256)
    p.add_argument("--n_sel_layers", type=int, default=4)
    p.add_argument("--n_heads", type=int, default=8)
    p.add_argument("--d_ff", type=int, default=1024)
    p.add_argument("--use_level", type=int, default=0)
    add_interp_train_args(p, batch=8, steps=5000, lr=2e-4, weight_decay=1e-2, bf16=0,
                          out_dir="runs/video_selector", save_every=2000)
    p.add_argument("--eval_every", type=int, default=500)
    return p


def dp_labels(latents: torch.Tensor, pre: OracleSegPrecompute, K: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(targets [B, T] with 1 at the DP keyframes, their indices [B, K])
    under the unnormalised oracle cost matrix of each clip."""
    B, T = latents.shape[:2]
    cost = compute_oracle_cost_seg_mse(latents.reshape(B, T, -1), pre, normalize=False)
    idx = dp_select_indices_batch(build_cost_matrix_from_segments(cost, pre, T), K)
    return torch.zeros((B, T), device=latents.device).scatter(1, idx, 1.0), idx


def build_model(args, device: torch.device) -> VideoKeyframeSelector:
    return build_seeded(VideoKeyframeSelector, args, device, T=args.T, text_dim=args.text_dim,
                        d_model=args.d_model, d_cond=args.d_cond, n_layers=args.n_sel_layers,
                        n_heads=args.n_heads, d_ff=args.d_ff, use_level=bool(args.use_level))


def _cond(args, text: torch.Tensor) -> Dict[str, torch.Tensor]:
    cond = {"text_embed": text}
    if args.use_level:
        cond["level"] = torch.full((text.shape[0], 1), args.K / max(1, args.T - 1),
                                   device=text.device)
    return cond


def make_loss_fn(model: VideoKeyframeSelector, args):
    """loss_fn(params, batch, rng) -> (loss, {}): BCE of the logits against
    batch["target"], positives weighted (T - K) / K. No draws."""
    pos_w = (args.T - args.K) / max(1.0, args.K)

    def loss_fn(params, batch: Dict[str, torch.Tensor], rng):
        target = batch["target"]
        logits = model(_cond(args, batch["text_embed"]))
        bce = F.relu(logits) - logits * target + torch.log1p(torch.exp(-torch.abs(logits)))
        return (bce * (1.0 + (pos_w - 1.0) * target)).mean(), {}

    return loss_fn


@torch.no_grad()
def overlap(model: VideoKeyframeSelector, args, text: torch.Tensor, idx_dp: torch.Tensor
            ) -> torch.Tensor:
    """Per clip, the share of the top-K logits that are DP keyframes."""
    top = torch.topk(model(_cond(args, text)), args.K, dim=-1).indices
    zeros = torch.zeros((text.shape[0], args.T), device=text.device)
    return (zeros.scatter(1, top, 1.0) * zeros.scatter(1, idx_dp, 1.0)).sum(1) / args.K


def run_meta(args) -> Dict:
    return {"stage": "video_selector", "T": args.T, "K": args.K, "d_model": args.d_model,
            "d_cond": args.d_cond, "n_layers": args.n_sel_layers, "n_heads": args.n_heads,
            "d_ff": args.d_ff, "use_level": args.use_level, "text_dim": args.text_dim}


def main(argv=None) -> TrainState:
    args = build_argparser().parse_args(argv)
    device, loader, batch0 = setup(args)
    pre = OracleSegPrecompute(*(t.to(device) for t in build_oracle_seg_precompute(args.T)))
    model = build_model(args, device)
    state, train_step = make_state(model, args, make_loss_fn(model, args))

    def prepare(batch):
        target, idx = dp_labels(batch["latents"].float(), pre, args.K)
        return {"text_embed": batch["text_embed"], "target": target, "idx_dp": idx}

    def evaluate(step, state, batch):
        if args.eval_every and (step + 1) % args.eval_every == 0:
            ov = overlap(model, args, batch["text_embed"], batch["idx_dp"])
            print(f"[eval] top-K/DP overlap {float(ov.mean()):.3f}", flush=True)

    return train_loop(args, device, loader, batch0, state, train_step,
                      ("latents", "text_embed"), run_meta(args), prepare=prepare,
                      after_step=evaluate)


if __name__ == "__main__":
    main()
