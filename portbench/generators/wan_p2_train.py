"""A closed loop of Wan Phase-2 (level-interpolation) LoRA training steps over
whole clips.

Set-up builds the program's Phase-2 trainer once
(train/train_interp_levels_wansynth.make_trainer over a WanDiT and
frame-condition projector that hold the benchmark's seeded weights, adjacent
mode: the projector reads 7 features a frame), feeds it through the program's
own loader (data/dataset.BatchLoader over the benchmark's synthetic Wan rows,
utils/prefetch.DevicePrefetcher with pinned copies) on the trainer's synthetic
route (no precomputed Phase-1 anchors: the student anchors are noisy teacher
values) and drives the first `check_steps` steps from the seed: they warm
every shape and are the steps the reference follows. The same trainer then
runs the measured window; a traced run profiles `trace_steps` more. After
the window the program is freed and the plain reference
(reference/wan_p2_ref.py) repeats the checked steps on the same batches,
weights and draws.

Traffic parameters (traffic/<mix>.json): batch, T, latents [C, H, W],
text_len, sla_topk, sla_block, mode, levels, K_min, corrupt_mode,
corrupt_sigma, anchor_noise_frac, student_replace_prob, student_noise_std,
interp_mode, level_t_scale, frame_cond_dim, cond_drop_prob, w_anchor,
w_missing, lr, weight_decay, grad_clip, prefetch_depth, check_steps,
trace_steps; the configuration gives the model and LoRA settings.
`train_tokens_per_s` counts the clip's tokens (T x the patch grid).
"""
from __future__ import annotations

import gc
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.generators import hy_train
from portbench.generators.wan_train import SyntheticWan, _launch_counts, build_program
from portbench.harness.core import Cell, Check, Outcome, device_name, peak_bytes, sub_seed, sync
from portbench.harness.trace import Spans, profiled_segment
from portbench.harness.weights import make_weights
from portbench.reference import wan_p2_ref, wan_ref
from portbench.reference.numerics import Numerics, strict_f32

# The limits of the three compared numbers, set as the Phase-1 cell's are
# (PERF.md gives the readings): above the sound runs' largest reading, below
# the float8 control's and the planted faults' smallest (the control's loss
# gap lies under three times the sound runs' and sets none).
LIMITS = {"loss_gap": 1e-3, "grad_gap_median": 2.0e-3, "change_gap_median": 6.0e-4}


def model_config(cfg: Dict, tr: Dict) -> Dict:
    """The configuration as this cell runs it: the traffic's SLA top-k and
    block, and the adjacent mode's 7 frame features."""
    return dict(cfg, sla_topk=tr["sla_topk"], sla_block=tr["sla_block"],
                frame_cond_dim=tr["frame_cond_dim"])


def trainer_args(cfg: Dict, tr: Dict, seed: int):
    from interpolated_diffusion_tpu_torch.train.train_interp_levels_wansynth import (
        build_argparser)

    C, H, W = tr["latents"]
    flags = {"--batch": tr["batch"], "--T": tr["T"], "--latent_c": C, "--latent_h": H,
             "--latent_w": W, "--text_len": tr["text_len"], "--text_dim": cfg["text_dim"],
             "--wan_dim": cfg["dim"], "--wan_layers": cfg["num_layers"],
             "--wan_heads": cfg["num_heads"], "--wan_ffn": cfg["ffn_dim"],
             "--attn_mode": cfg["attn_mode"], "--sla_topk": cfg["sla_topk"],
             "--sla_block": cfg["sla_block"], "--lora_rank": cfg["lora_rank"],
             "--lora_alpha": cfg["lora_alpha"], "--lora_targets": cfg["lora_targets"],
             "--lora_form": cfg["lora_form"], "--use_remat": int(cfg["use_remat"]),
             "--patch_size": cfg["patch_size"][1], "--mode": tr["mode"],
             "--levels": tr["levels"], "--K_min": tr["K_min"],
             "--corrupt_mode": tr["corrupt_mode"], "--corrupt_sigma": tr["corrupt_sigma"],
             "--anchor_noise_frac": tr["anchor_noise_frac"],
             "--student_replace_prob": tr["student_replace_prob"],
             "--student_noise_std": tr["student_noise_std"], "--interp_mode": tr["interp_mode"],
             "--level_t_scale": tr["level_t_scale"], "--cond_drop_prob": tr["cond_drop_prob"],
             "--w_anchor": tr["w_anchor"], "--w_missing": tr["w_missing"], "--lr": tr["lr"],
             "--weight_decay": tr["weight_decay"], "--grad_clip": tr["grad_clip"],
             "--prefetch_depth": tr["prefetch_depth"], "--bf16": 1, "--use_ema": 0,
             "--seed": seed % (1 << 31), "--device": "cuda"}
    return build_argparser().parse_args([str(x) for kv in flags.items() for x in kv])


def compare(prog: Dict, ref: Dict) -> List[Check]:
    return hy_train.compare(prog, ref, LIMITS)


def reference_run(cfg: Dict, tr: Dict, weights_seed: int, batches, gen_states, device,
                  precision: str = "f32") -> Dict:
    """The plain reference over the checked steps, from the same seeded
    weights, host batches and draw states."""
    strict_f32()
    P = {n: w.float() for n, w in make_weights(wan_ref.param_spec(cfg), weights_seed,
                                               device).items()}
    rcfg = dict(cfg, **{k: tr[k] for k in (
        "levels", "K_min", "corrupt_sigma", "anchor_noise_frac", "student_replace_prob",
        "student_noise_std", "level_t_scale", "cond_drop_prob", "w_anchor", "w_missing", "lr",
        "weight_decay", "grad_clip")})
    C, H, W = tr["latents"]
    p = cfg["patch_size"][1]
    D = (H // p) * (W // p) * C * p * p
    dev_batches, step_draws = [], []
    for b, state in zip(batches, gen_states):
        dev_batches.append({k: torch.from_numpy(v).to(device) for k, v in b.items()})
        g = torch.Generator(device=device)
        g.set_state(state)
        step_draws.append(wan_p2_ref.draws(g, tr["batch"], tr["T"], D, tr["K_min"],
                                           tr["levels"]))
    return wan_p2_ref.train_steps(P, rcfg, dev_batches, step_draws, Numerics(precision))


def run(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda") -> Outcome:
    from interpolated_diffusion_tpu_torch.data.dataset import BatchLoader
    from interpolated_diffusion_tpu_torch.train.train_interp_levels_wansynth import make_trainer
    from interpolated_diffusion_tpu_torch.utils.prefetch import DevicePrefetcher, pinned_put

    tr = cell.traffic
    cfg = model_config(cell.config, tr)
    if tr["mode"] != "adj" or tr["corrupt_mode"] != "gauss" or tr["interp_mode"] != "linear":
        raise ValueError("the reference holds the adjacent mode with gauss corruption and a "
                         "linear fill")
    dev = torch.device(device)
    t_setup = time.perf_counter()
    torch.empty(1, device=dev)   # the device's context
    sync(dev)
    t_context = time.perf_counter()
    args = trainer_args(cfg, tr, seed)
    w_seed = sub_seed(seed, 1)
    weights = make_weights(wan_ref.param_spec(cfg), w_seed, dev)
    wan, fc = build_program(cfg, weights, dev)
    del weights
    state, base, train_step, wan, fc = make_trainer(args, dev, model=wan, fc=fc)
    sync(dev)
    marks = [time.perf_counter()]

    C, H, W = tr["latents"]
    data = SyntheticWan(sub_seed(seed, 2), tr["T"], C, H, W, tr["text_len"], cfg["text_dim"])
    n_check = int(tr["check_steps"])
    recorded: List[Dict[str, np.ndarray]] = []

    def host_batches():
        for b in BatchLoader(data, batch_size=tr["batch"], seed=sub_seed(seed, 3) % (1 << 32)):
            if len(recorded) < n_check:
                recorded.append({k: v.copy() for k, v in b.items()})
            yield b

    feed = DevicePrefetcher(host_batches(), pinned_put(dev, keys=("latents", "text_embed")),
                            depth=tr["prefetch_depth"])
    rng = torch.Generator(device=dev).manual_seed(sub_seed(seed, 4))
    named = {**{"wan." + n: p for n, p in state.params["lora"].items()},
             **{"fc." + n: p for n, p in state.params["frame_cond"].items()}}
    start = {n: p.detach().clone() for n, p in named.items()}
    losses, gen_states, grad0, launches = [], [], {}, {}
    for i in range(n_check):
        gen_states.append(rng.get_state())
        before = _launch_counts()
        state, metrics = train_step(state, base, next(feed), rng)
        losses.append(metrics["loss"])
        if i == 0:
            adam = state.opt_state.adamw
            grad0 = {n: float(adam.state[p]["exp_avg"].norm() / 0.1) if p in adam.state else 0.0
                     for n, p in named.items()}
            marks.append(time.perf_counter())
        if i == n_check - 1:
            after = _launch_counts()
            launches = {k: after[k] - before[k] for k in after}
    change = {n: float((p.detach() - start[n]).norm()) for n, p in named.items()}
    program = {"losses": [float(x) for x in losses], "grad": grad0, "change": change}
    del start
    sync(dev)
    setup_s = time.perf_counter() - t_setup
    setup_peak = peak_bytes(dev, reset=True)
    print(f"[setup] {setup_s:.2f} s: device context {t_context - t_setup:.2f}, weights and trainer "
          f"{marks[0] - t_context:.2f}, first step {marks[1] - marks[0]:.2f}, {n_check - 1} more "
          f"{t_setup + setup_s - marks[1]:.2f}", file=sys.stderr, flush=True)

    B = tr["batch"]
    L = tr["T"] * (H // cfg["patch_size"][1]) * (W // cfg["patch_size"][2])
    waits, window_losses = [], []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        tw = time.perf_counter()
        batch = next(feed)
        waits.append(time.perf_counter() - tw)
        state, metrics = train_step(state, base, batch, rng)
        window_losses.append(metrics["loss"])
    sync(dev)
    window_s = time.perf_counter() - t0
    steps = len(window_losses)
    window_peak = peak_bytes(dev)

    traced = None
    if trace:   # the benchmark's own spans around SLA, as the Phase-1 cell's
        spans = Spans()
        for block in wan.blocks:
            spans.around(block.attn1.sla, "pb.self_attn", backward=True)
        with profiled_segment(dev) as seg:
            for _ in range(int(tr["trace_steps"])):
                state, _ = train_step(state, base, next(feed), rng)
        spans.remove()
        traced = seg["trace"]
        traced.units["steps"] = int(tr["trace_steps"])
    feed.close()
    failed = sum(1 for x in window_losses if not bool(torch.isfinite(x)))
    card = device_name(dev)
    del state, base, train_step, wan, fc, named, feed, metrics, window_losses
    if steps:
        del batch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    want = {"sla_fwd": 2 * cfg["num_layers"], "sla_bwd_dq": cfg["num_layers"],
            "sla_bwd_dkdv": cfg["num_layers"]}
    print(f"[path] launches in checked step {n_check}: {launches}, expected {want}",
          file=sys.stderr, flush=True)
    t_ref = time.perf_counter()
    ref = reference_run(cfg, tr, w_seed, recorded, gen_states, dev)
    print(f"[reference] {n_check} steps in {time.perf_counter() - t_ref:.1f} s; program losses "
          f"{program['losses']}, reference {ref['losses']}", file=sys.stderr, flush=True)
    checks = compare(program, ref)
    if dev.type == "cuda":   # the plain twins that run off the card launch nothing
        checks += [Check(f"launches_{k}", abs(launches[k] - v), 0) for k, v in want.items()]

    device_info = {"platform": "gpu", "kind": card, "count": 1,
                   "memory_peak_bytes": int(max(setup_peak, window_peak))}
    layer = {"kind": "train", "cfg": cfg, "traffic": tr, "batch": B, "tokens": L,
             "steps": steps, "window_s": window_s, "data_wait_s": waits, "trace": traced}
    if traced is not None:
        device_info["busy_s"] = traced.busy_s
        device_info["window_s"] = traced.window_s
    return Outcome(
        e2e={"train_tokens_per_s": steps * B * L / window_s, "setup_s": setup_s,
             "peak_mem_gib": window_peak / 2 ** 30},
        layer=layer, checks=checks, attempted=steps, failed=failed, device=device_info,
        breakdown=traced.breakdown() if traced is not None else None)
