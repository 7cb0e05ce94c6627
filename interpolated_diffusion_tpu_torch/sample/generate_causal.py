"""Autoregressive chunked generation with the causal Stage 2 (port of
sample/generate_causal.py: make_causal_pipeline and its CLI).

    python -m interpolated_diffusion_tpu_torch.sample.generate_causal --kp_ckpt <run> --interp_ckpt <run>

Fixed-size windows: chunk c covers frames cur..end (cur advances by `chunk`,
end = min(T - 1, cur + chunk - 1); the last chunk may be shorter). Per chunk:
the right boundary is the goal on the last chunk and
left + min(1, L / remaining) (goal - left) on the others; a local Stage 1
samples K_local = min(K_min, L + 1) keypoints over the L + 1 frames
cur - 1..end with both endpoints clamped (linear DDIM spacing, as the
reference's causal sampler; any solver, FORA caching, best-of-N in set or dp
mode); the segment-lerp is spliced into the running buffer; one causal
Stage-2 delta at s = levels runs over the whole T buffer (causal attention
keeps the frames after `end` out of every row up to it); the clamp policy
holds rows cur - 1 and end (endpoints), every anchor (all_anchors) or
nothing; only rows cur..end are written back.

The JAX package unrolls the loop into one XLA program; here it runs eagerly
under torch.inference_mode(). Random draws are explicit (`make_causal_draws`),
per chunk in this order: the anchor draw `idx_rand` uniform [B, L - 1] (when
the chunk has interior anchors) and the Stage-1 noise `z` normal
[B, K_local, D] ([N, B, K_local, D] under best-of-N). They come from a
`torch.Generator` unless the caller passes them; a parity test passes JAX's:
key, k_idx, k_s1 = split(key, 3) per chunk, uniform(k_idx, (B, L - 1)),
normal(k_s1, ...) or normal(split(k_s1, N)[n], ...).

`--seq_shard N` (launched with `torchrun --nproc_per_node N`) shards the
only O(T^2) term, Stage 2's full-buffer delta, over T: each rank runs the
causal denoiser on its T / N frames with their global positions (pos_frac)
and causal ring attention (parallel/ring.py), and the chunks are gathered
back. Stage 1 runs the same on every rank (same draws); rank 0 writes the
outputs.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..eval.metrics import compute_metrics_batch
from ..models.loading import load_interp_model, load_keypoint_model, make_dphi_seg_cost_fn
from ..ops.anchor_search import pick_anchors
from ..ops.clamp import apply_clamp
from ..ops.ddpm import SOLVERS, make_timesteps, run_solver
from ..ops.keyframes import (interpolate_from_indices, recompute_velocity_channels,
                             sample_fixed_k_indices_batch)
from ..ops.normalize import logit_pos, sigmoid_pos
from ..ops.schedules import DiffusionSchedule, make_schedule
from ..ops.selection import build_kp_feat_full
from ..parallel.collectives import all_gather, axis_index, axis_size
from ..parallel.multihost import is_main_process
from ..parallel.ring import make_seq_mesh
from ..train.batches import build_known_mask_values
from ..train.common import add_data_args, make_dataset, resolve_device
from .generate import _repeat, check_summary_sanity, hoist_cond_vec

Draws = List[Dict[str, torch.Tensor]]


def chunk_plan(T: int, chunk: int) -> List[Tuple[int, int]]:
    """(cur, end) of every chunk: frames cur..end are generated, frame cur - 1
    is the chunk's left boundary."""
    plan, cur = [], 1
    while cur < T:
        end = min(T - 1, cur + chunk - 1)
        plan.append((cur, end))
        cur = end + 1
    return plan


def make_causal_draws(T: int, K_min: int, chunk: int, B: int, data_dim: int,
                      generator: torch.Generator, best_of: int = 1, device=None) -> Draws:
    """Every random draw of one pipeline call, chunk by chunk (see the module
    docstring for the order)."""
    device = device if device is not None else generator.device
    draws = []
    for cur, end in chunk_plan(T, chunk):
        local_T = end - cur + 2
        K_local = min(K_min, local_T)
        d = {}
        if local_T > 2 and K_local > 2:
            d["idx_rand"] = torch.rand((B, local_T - 2), generator=generator, device=device)
        shape = (best_of, B, K_local, data_dim) if best_of > 1 else (B, K_local, data_dim)
        d["z"] = torch.randn(shape, generator=generator, device=device)
        draws.append(d)
    return draws


def make_causal_pipeline(kp_model, interp_model, kp_schedule: DiffusionSchedule, *, T: int,
                         K_min: int, levels: int, chunk: int, ddim_steps: int, data_dim: int,
                         logit_space: bool = False, logit_eps: float = 1e-5,
                         clamp_endpoints: bool = True, clamp_policy: str = "endpoints",
                         clamp_dims: str = "pos", recompute_vel: bool = False,
                         mask_channels: int = 1, collect_chunks: bool = False,
                         kp_feat_dim: int = 0, dphi_fn=None, stage1_cache_interval: int = 1,
                         stage1_solver: str = "ddim", stage1_best_of: int = 1,
                         stage1_best_of_mode: str = "set", seq_group=None):
    """Returns pipeline(cond, *, generator=None, draws=None) -> x_gen [B, T, D]
    (and, with collect_chunks, the buffer after each chunk [n_chunks, B, T, D]).

    cond has "occ" [B, 1, G, G] and "start_goal" [B, 4] (and "sdf" when the
    models read it); everything runs on its device. `draws` is
    make_causal_draws' list (drawn from `generator` when not given). With
    kp_feat_dim > 0 each chunk's Stage 1 gets the index features of its local
    indices over its L + 1 frames, their cost channels from dphi_fn(cond,
    idx), which normalises by the full T (models/loading.make_dphi_seg_cost_fn).

    seq_group (a process group, parallel/ring.make_seq_mesh): the Stage-2
    delta runs sequence-sharded over its ranks as causal ring attention; the
    interp model is switched to attn_impl "ring" for it.
    """
    stage2 = lambda x, s, m, cv: interp_model(x, s, m, cv)
    if seq_group is not None:
        n, me = axis_size(seq_group), axis_index(seq_group)
        if T % n:
            raise ValueError(f"T={T} not divisible by seq_shard={n}")
        interp_model.set_attn_impl("ring", seq_group)
        c = T // n
        mine = slice(me * c, (me + 1) * c)

        def stage2(x, s, m, cv):
            pos = torch.linspace(0.0, 1.0, T, device=x.device)[mine]
            delta = interp_model(x[:, mine], s, m[:, mine], cv, pos_frac=pos)
            return all_gather(delta, seq_group, dim=1)

    if clamp_policy not in ("endpoints", "all_anchors", "none"):
        raise ValueError(f"unknown clamp_policy {clamp_policy!r}")
    if stage1_solver not in SOLVERS:
        raise ValueError(f"unknown solver {stage1_solver!r}; pick from {SOLVERS}")
    # linear spacing is the reference's causal sampler (the other samplers
    # default to quadratic)
    times = make_timesteps(kp_schedule.n_timesteps, ddim_steps, "linear")
    plan = chunk_plan(T, chunk)

    def stage1(sched, z, idx, known_mask, known_values, cond, local_T):
        if kp_feat_dim > 0:
            seg_cost = dphi_fn(cond, idx) if dphi_fn is not None else None
            cond = dict(cond, kp_feat=build_kp_feat_full(idx, local_T, kp_feat_dim, seg_cost))
        post = lambda z: torch.where(known_mask, known_values, z)
        eps_fn = lambda z, t_b, **cache_kw: kp_model(z, t_b, idx, known_mask, cond, local_T,
                                                     **cache_kw)
        delta0 = torch.zeros((z.shape[0], z.shape[1], kp_model.d_model), dtype=kp_model.dtype,
                             device=z.device)
        z = run_solver(stage1_solver, eps_fn, post(z), times, sched, post=post,
                       cache_interval=stage1_cache_interval, delta0=delta0)
        return sigmoid_pos(z) if logit_space else z

    def mask_channels_of(mask: torch.Tensor) -> torch.Tensor:
        """The splice mask as the checkpoint's mask channels (an adj model
        reads [mask_s, mask_prev] (+ conf): in AR mode each is the splice
        mask; as in JAX, at most three)."""
        if mask_channels == 1:
            return mask
        return torch.stack([mask.float()] * min(3, mask_channels), dim=-1)

    @torch.inference_mode()
    def pipeline(cond: Dict[str, torch.Tensor], *, generator: Optional[torch.Generator] = None,
                 draws: Optional[Draws] = None):
        sg = cond["start_goal"].float()
        B, device = sg.shape[0], sg.device
        if draws is None:
            if generator is None:
                raise ValueError("pipeline needs a generator unless its draws are given")
            draws = make_causal_draws(T, K_min, chunk, B, data_dim, generator, stage1_best_of,
                                      device)
        if len(draws) != len(plan):
            raise ValueError(f"{len(draws)} chunks of draws for {len(plan)} chunks")
        sched = kp_schedule if kp_schedule.betas.device == device else kp_schedule.to(device)
        start, goal = sg[:, :2], sg[:, 2:]
        rows = torch.arange(T, device=device)
        x_gen = torch.zeros((B, T, data_dim), device=device)
        x_gen[:, 0, :2] = start
        mask_gen = torch.zeros((B, T), dtype=torch.bool, device=device)
        mask_gen[:, 0] = True
        chunk_states = []
        for (cur, end), d in zip(plan, draws):
            L = end - cur + 1
            local_T = L + 1
            left = x_gen[:, cur - 1, :2]
            if end == T - 1:
                right = goal
            else:
                frac = min(1.0, float(L) / max(1, T - cur))
                right = left + frac * (goal - left)
            K_local = min(K_min, local_T)
            idx, mask_local = sample_fixed_k_indices_batch(B, local_T, K_local, True,
                                                           rand=d.get("idx_rand"))
            idx, mask_local = idx.to(device), mask_local.to(device)
            # the chunk's own start and goal: its endpoints are the known keypoints
            cond_chunk = dict(cond, start_goal=torch.cat([left, right], dim=1))
            known_mask, known_values = build_known_mask_values(idx, cond_chunk, data_dim,
                                                               local_T, clamp_endpoints)
            if logit_space:
                known_values = logit_pos(known_values, eps=logit_eps)
            # the maze encoders read the chunk's start/goal: they run once a chunk
            kp_cond = hoist_cond_vec(kp_model, cond_chunk)
            if stage1_best_of > 1:
                N = stage1_best_of
                z_cands = stage1(sched, d["z"].reshape(N * B, K_local, data_dim).float(),
                                 _repeat(idx, N), _repeat(known_mask, N),
                                 _repeat(known_values, N),
                                 {k: _repeat(v, N) for k, v in kp_cond.items()}, local_T)
                occ = cond["occ"][:, 0] if cond["occ"].ndim == 4 else cond["occ"]
                z_hat = pick_anchors(z_cands.view(N, B, K_local, data_dim), idx, occ, local_T,
                                     stage1_best_of_mode)
            else:
                z_hat = stage1(sched, d["z"].float(), idx, known_mask, known_values, kp_cond,
                               local_T)
            x_s = interpolate_from_indices(idx, z_hat, local_T, recompute_velocity=recompute_vel)

            # splice the chunk into the running buffer (frames cur - 1 .. end)
            x_full = x_gen.clone()
            x_full[:, cur - 1:end + 1] = x_s
            chunk_mask = torch.zeros((B, T), dtype=torch.bool, device=device)
            chunk_mask[:, cur - 1:end + 1] = mask_local
            mask_full = torch.where(rows[None] < cur - 1, mask_gen, chunk_mask)

            # one causal Stage-2 delta at s = levels over the whole buffer
            s_level = torch.full((B,), levels, dtype=torch.long, device=device)
            x_hat = x_full + stage2(x_full, s_level, mask_channels_of(mask_full),
                                    hoist_cond_vec(interp_model, cond_chunk))
            if clamp_policy == "all_anchors":
                x_hat = apply_clamp(x_hat, x_full, mask_full, clamp_dims)
            elif clamp_policy == "endpoints":
                ends = torch.zeros((B, T), dtype=torch.bool, device=device)
                ends[:, cur - 1] = ends[:, end] = True
                x_hat = apply_clamp(x_hat, x_full, ends, clamp_dims)

            # write back only the new frames cur..end
            x_gen = x_gen.clone()
            dims = slice(None) if data_dim > 2 and recompute_vel else slice(0, 2)
            x_gen[:, cur:end + 1, dims] = x_hat[:, cur:end + 1, dims]
            mask_gen = mask_full
            if collect_chunks:
                chunk_states.append(x_gen)
        if recompute_vel and data_dim == 4:
            x_gen = recompute_velocity_channels(x_gen, T)
        if collect_chunks:
            return x_gen, torch.stack(chunk_states, dim=0)
        return x_gen

    return pipeline


def _export_chunks(args, batch, chunks: torch.Tensor, x_gen: torch.Tensor) -> None:
    """Per-chunk frames + a GIF of sample 0, and samples.npz (x_gen is the
    pipeline's output, after the velocity recompute that the last chunk's
    buffer predates)."""
    from ..eval.visualize import plot_occupancy_trajectories

    occ, sg, gt = batch["occ"], batch["start_goal"], batch["x"]
    chunks_np = chunks.float().cpu().numpy()
    frames_dir = os.path.join(args.out_dir, "chunks")
    os.makedirs(frames_dir, exist_ok=True)
    paths = [plot_occupancy_trajectories(
        occ[0], [gt[0], chunks_np[ci][0]], labels=["gt", "prefix"], start_goal=sg[0],
        out_path=os.path.join(frames_dir, f"chunk_{ci:03d}.png"), title=f"chunk {ci}")
        for ci in range(chunks_np.shape[0])]
    try:
        from PIL import Image

        imgs = [Image.open(p) for p in paths]
        imgs[0].save(os.path.join(args.out_dir, "chunks.gif"), save_all=True,
                     append_images=imgs[1:], duration=400, loop=0)
    except Exception as e:  # the PNG frames remain the durable output
        print(f"gif export skipped ({e})")
    np.savez_compressed(os.path.join(args.out_dir, "samples.npz"),
                        x_gen=x_gen.float().cpu().numpy(), gt=gt, occ=occ, start_goal=sg,
                        chunks=chunks_np)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("sample_generate_causal (AR chunked, GPU)")
    p.add_argument("--kp_ckpt", type=str, required=True)
    p.add_argument("--interp_ckpt", type=str, required=True)
    p.add_argument("--use_ema", type=int, default=1)
    p.add_argument("--chunk", type=int, default=16)
    p.add_argument("--K_min", type=int, default=4)
    p.add_argument("--dphi_ckpt", type=str, default=None,
                   help="segment-cost ckpt for the kp_feat cost channels")
    p.add_argument("--stage1_cache_interval", type=int, default=1,
                   help="FORA-style block-stack caching in each chunk's DDIM scan (1 = exact)")
    p.add_argument("--stage1_solver", type=str, default="ddim", choices=list(SOLVERS))
    p.add_argument("--stage1_best_of", type=int, default=1,
                   help="per-chunk best-of-N anchor search (collision-scored)")
    p.add_argument("--stage1_best_of_mode", type=str, default="set", choices=["set", "dp"])
    p.add_argument("--seq_shard", type=int, default=0,
                   help="N > 1: the Stage-2 forward sequence-sharded over N processes "
                        "(torchrun --nproc_per_node N), causal ring attention")
    p.add_argument("--ddim_steps", type=int, default=10)
    p.add_argument("--num_batches", type=int, default=2)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--clamp_policy", type=str, default="endpoints",
                   choices=["endpoints", "all_anchors", "none"])
    p.add_argument("--clamp_dims", type=str, default="pos", choices=["pos", "all"])
    p.add_argument("--sample_seed", type=int, default=1234)
    p.add_argument("--bf16", type=int, default=1)
    p.add_argument("--sanity", type=int, default=0,
                   help="exit 2 when the summary trips check_summary_sanity")
    p.add_argument("--out_dir", type=str, default="runs/samples_causal")
    p.add_argument("--save_chunks", type=int, default=0,
                   help="export per-chunk frames (PNG + GIF) for sample 0 of batch 0 + "
                        "samples.npz (needs matplotlib)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; no fallback when there is no GPU) or cpu")
    p.add_argument("--attn_policy", type=str, default="fused", choices=["fused", "block", "dense"],
                   help="small-L attention route of every block (models/transformer.py)")
    add_data_args(p)
    return p


def _write_outputs(args, rows: List[Dict], summary: Dict) -> None:
    """metrics.csv, summary.json, run_config.json and the evidence archive."""
    from ..utils.run_config import archive_evidence, write_run_config

    with open(os.path.join(args.out_dir, "metrics.csv"), "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)
    with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    write_run_config(args.out_dir, args)
    archive_evidence(args.out_dir)


def main(argv=None):
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    seq_group = make_seq_mesh(args.seq_shard) if args.seq_shard > 1 else None
    main_rank = is_main_process()
    kp_model, kp_meta = load_keypoint_model(args.kp_ckpt, bool(args.bf16), bool(args.use_ema),
                                            device=device)
    interp_model, il_meta = load_interp_model(args.interp_ckpt, bool(args.bf16),
                                              bool(args.use_ema), device=device)
    for m in (kp_model, interp_model):
        m.set_attn_policy(args.attn_policy)
    if not il_meta.get("causal", 0):
        print("warning: interp checkpoint is not causal; results follow the bidirectional model")
    T, data_dim = int(kp_meta["T"]), int(kp_meta["data_dim"])
    dphi_fn = None
    if args.dphi_ckpt:
        dphi_fn, _ = make_dphi_seg_cost_fn(args.dphi_ckpt, T, kp_meta.get("use_sdf"),
                                           bool(args.bf16), device=device)
    elif kp_meta.get("kp_feat_dphi"):
        raise ValueError("Stage-1 ckpt was trained with D_phi kp_feat cost channels (meta "
                         "kp_feat_dphi=1): pass --dphi_ckpt, or sampling runs off-distribution "
                         "(channels 3/4 zero)")
    pipeline = make_causal_pipeline(
        kp_model, interp_model,
        make_schedule(kp_meta["schedule"], int(kp_meta["N_train"]), device=device),
        T=T, K_min=args.K_min, levels=int(il_meta["levels"]), chunk=args.chunk,
        ddim_steps=args.ddim_steps, data_dim=data_dim,
        logit_space=bool(kp_meta.get("logit_space", 0)),
        logit_eps=float(kp_meta.get("logit_eps", 1e-5)),
        clamp_endpoints=bool(kp_meta.get("clamp_endpoints", 1)),
        clamp_policy=args.clamp_policy, clamp_dims=args.clamp_dims,
        recompute_vel=bool(il_meta.get("recompute_vel", 0)) and data_dim == 4,
        mask_channels=int(il_meta.get("mask_channels", 1)),
        collect_chunks=bool(args.save_chunks),
        kp_feat_dim=int(kp_meta.get("kp_feat_dim", 0)) if kp_meta.get("use_kp_feat") else 0,
        dphi_fn=dphi_fn, stage1_cache_interval=args.stage1_cache_interval,
        stage1_solver=args.stage1_solver, stage1_best_of=args.stage1_best_of,
        stage1_best_of_mode=args.stage1_best_of_mode, seq_group=seq_group)

    args.T = T  # for make_dataset
    ds, _ = make_dataset(args)
    host_rng = np.random.RandomState(args.sample_seed)
    gen = torch.Generator(device=device).manual_seed(args.sample_seed)
    to_dev = lambda a: torch.as_tensor(a).to(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    os.makedirs(args.out_dir, exist_ok=True)
    rows = []
    t_total, n_total = 0.0, 0
    for bi in range(args.num_batches):
        batch = ds.get_batch(host_rng.randint(0, len(ds), size=args.batch))
        cond = {"occ": to_dev(batch["occ"]), "start_goal": to_dev(batch["start_goal"])}
        if "sdf" in batch and (kp_meta.get("use_sdf") or il_meta.get("use_sdf")):
            cond["sdf"] = to_dev(batch["sdf"])
        draws = make_causal_draws(T, args.K_min, args.chunk, args.batch, data_dim, gen,
                                  args.stage1_best_of, device)
        sync()
        t0 = time.perf_counter()
        out = pipeline(cond, draws=draws)
        x_gen, chunks = out if args.save_chunks else (out, None)
        sync()
        dt = time.perf_counter() - t0
        if bi > 0:  # the first batch holds the warm-up
            t_total += dt
            n_total += args.batch
        m = compute_metrics_batch(cond["occ"], x_gen, cond["start_goal"][:, 2:],
                                  to_dev(batch["x"]))
        m = {k: v.cpu().numpy() for k, v in m.items()}
        for b in range(args.batch):
            rows.append({"batch": bi, "sample": b, **{k: float(v[b]) for k, v in m.items()}})
        if main_rank:
            print(f"batch {bi}: {dt:.3f}s coll={m['collision_rate'].mean():.4f} "
                  f"goal={m['goal_dist'].mean():.4f}", flush=True)
        if bi == 0 and args.save_chunks and main_rank:
            _export_chunks(args, batch, chunks, x_gen)

    summary = {k: float(np.mean([r[k] for r in rows]))
               for k in rows[0] if k not in ("batch", "sample")}
    if n_total:
        summary["samples_per_sec"] = n_total / t_total
    sanity = check_summary_sanity(summary)
    summary["sanity"] = sanity
    if main_rank:
        _write_outputs(args, rows, summary)
        print("summary:", json.dumps(summary, indent=2), flush=True)
    if sanity["failures"] and args.sanity:
        print("SANITY FAILED:", "; ".join(sanity["failures"]), file=sys.stderr)
        sys.exit(2)
    return summary


if __name__ == "__main__":
    main()
