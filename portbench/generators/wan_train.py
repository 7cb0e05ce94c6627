"""A closed loop of Wan Phase-1 LoRA training steps.

Set-up builds the program's trainer once (train/train_keypoints_wansynth.
make_trainer over a WanDiT and frame-condition projector that hold the
benchmark's seeded weights), feeds it through the program's own loader
(data/dataset.BatchLoader over the benchmark's copy of the synthetic Wan
dataset, utils/prefetch.DevicePrefetcher with pinned copies) and drives the
first `check_steps` steps from the seed: they warm every shape and are the
steps the reference follows. The same trainer then runs the measured window:
as many steps as fit in --seconds, each one next() of the prefetcher and one
call of the step. A traced run then profiles `trace_steps` more under the
benchmark's spans. After the window the program is freed and the plain
reference repeats the checked steps on the same batches, weights and draws.

Traffic parameters (traffic/<mix>.json): batch, T, K, latents [C, H, W],
text_len, phase1_input_mode, uniform_jitter, cond_drop_prob, lr,
weight_decay, grad_clip, prefetch_depth, check_steps, trace_steps; the
configuration gives the model, LoRA and SLA settings.
"""
from __future__ import annotations

import gc
import statistics
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.harness.core import Cell, Check, Outcome, device_name, peak_bytes, sub_seed, sync
from portbench.harness.trace import Spans, profiled_segment
from portbench.harness.weights import make_weights
from portbench.reference import wan_ref
from portbench.reference.numerics import Numerics, strict_f32

# The limits of the three compared numbers (PERF.md gives the readings they
# were set from): the relative gap of each checked step's loss, and the
# median trainable leaf's gap of gradient norm (first step) and of change
# norm (over the checked steps), each leaf's gap taken against the larger of
# the reference's norm of that leaf and of the median leaf. The worst leaf's
# gaps are printed, not compared: they are the noise of the small
# cross-attention LoRA A leaves (PERF.md).
LIMITS = {"loss_gap": 1e-3, "grad_gap_median": 2.0e-3, "change_gap_median": 8.5e-4}
# Leaves whose reference gradient is under this share of the median leaf's
# are nought to rounding and are left out of the gradient and change gaps.
NEGLIGIBLE = 1e-3


class SyntheticWan:
    """The benchmark's copy of the port's synthetic Wan dataset: each row
    has K smooth random keyframe latents lerped to T frames and a text
    embedding, made from (seed, row) alone, so that rows are reproducible and
    all differ."""

    def __init__(self, seed: int, T: int, C: int, H: int, W: int, text_len: int, text_dim: int,
                 n_keyframes: int = 5, n_rows: int = 2 ** 31 - 1):
        self.seed, self.T, self.C, self.H, self.W = seed, T, C, H, W
        self.text_len, self.text_dim, self.n_kf, self.n = text_len, text_dim, n_keyframes, n_rows

    def __len__(self):
        return self.n

    def get(self, row: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng([self.seed & 0xFFFFFFFF, self.seed >> 32, int(row)])
        kf = rng.standard_normal((self.n_kf, self.C, self.H, self.W), dtype=np.float32)
        ts = np.linspace(0, self.n_kf - 1, self.T)
        lo = np.clip(np.floor(ts).astype(int), 0, self.n_kf - 2)
        w = (ts - lo)[:, None, None, None].astype(np.float32)
        lat = kf[lo] * (1 - w) + kf[lo + 1] * w
        text = rng.standard_normal((self.text_len, self.text_dim), dtype=np.float32) * 0.02
        return {"latents": lat, "text_embed": text}

    def get_batch(self, rows) -> Dict[str, np.ndarray]:
        items = [self.get(int(r)) for r in np.asarray(rows)]
        return {k: np.stack([it[k] for it in items]) for k in items[0]}


def draws(gen: torch.Generator, B: int, K: int, N: int, D: int, n_train: int) -> Dict:
    """The step's random draws in the trainer's order: anchor jitter
    uniforms [B, K], timesteps [B], eps [B, K, N, D], text-dropout uniforms."""
    dev = gen.device
    return {"idx_rand": torch.rand((B, K), generator=gen, device=dev),
            "t": torch.randint(0, n_train, (B,), generator=gen, device=dev),
            "eps": torch.randn((B, K, N, D), generator=gen, device=dev),
            "drop_rand": torch.rand((B,), generator=gen, device=dev)}


def trainer_args(cfg: Dict, tr: Dict, seed: int):
    from interpolated_diffusion_tpu_torch.train.train_keypoints_wansynth import build_argparser

    C, H, W = tr["latents"]
    flags = {"--batch": tr["batch"], "--T": tr["T"], "--K": tr["K"], "--latent_c": C,
             "--latent_h": H, "--latent_w": W, "--text_len": tr["text_len"],
             "--text_dim": cfg["text_dim"], "--wan_dim": cfg["dim"],
             "--wan_layers": cfg["num_layers"], "--wan_heads": cfg["num_heads"],
             "--wan_ffn": cfg["ffn_dim"], "--attn_mode": cfg["attn_mode"],
             "--sla_topk": cfg["sla_topk"], "--sla_block": cfg["sla_block"],
             "--lora_rank": cfg["lora_rank"], "--lora_alpha": cfg["lora_alpha"],
             "--lora_targets": cfg["lora_targets"], "--lora_form": cfg["lora_form"],
             "--use_remat": int(cfg["use_remat"]), "--frame_cond": 1,
             "--frame_cond_dim": cfg["frame_cond_dim"], "--patch_size": cfg["patch_size"][1],
             "--N_train": cfg["n_train"], "--schedule": "linear",
             "--phase1_input_mode": tr["phase1_input_mode"],
             "--uniform_jitter": tr["uniform_jitter"], "--cond_drop_prob": tr["cond_drop_prob"],
             "--lr": tr["lr"], "--weight_decay": tr["weight_decay"],
             "--grad_clip": tr["grad_clip"], "--prefetch_depth": tr["prefetch_depth"],
             "--bf16": 1, "--use_ema": 0, "--seed": seed % (1 << 31), "--device": "cuda"}
    return build_argparser().parse_args([str(x) for kv in flags.items() for x in kv])


def build_program(cfg: Dict, weights: Dict[str, torch.Tensor], device):
    """The program's WanDiT and projector as build_wan makes them, holding
    the benchmark's weights (trainable leaves float32, the base bfloat16)."""
    from interpolated_diffusion_tpu_torch.models.wan_dit import FrameCondProjector, WanDiT

    # built on the device itself: a build on the meta device runs the layers'
    # initialisers through torch._refs, which imports torch._dynamo (seconds)
    with torch.device(device):
        wan = WanDiT(dim=cfg["dim"], n_layers=cfg["num_layers"], n_heads=cfg["num_heads"],
                     ffn_dim=cfg["ffn_dim"], in_channels=cfg["in_dim"],
                     out_channels=cfg["out_dim"], text_dim=cfg["text_dim"],
                     patch_size=tuple(cfg["patch_size"]), freq_dim=cfg["freq_dim"],
                     attn_mode=cfg["attn_mode"], sla_topk=cfg["sla_topk"],
                     sla_block=cfg["sla_block"], lora_rank=cfg["lora_rank"],
                     lora_alpha=cfg["lora_alpha"], lora_targets=cfg["lora_targets"],
                     extra_context=True, use_remat=bool(cfg["use_remat"]),
                     lora_form=cfg["lora_form"])
        fc = FrameCondProjector(cfg["frame_cond_dim"], cfg["text_dim"],
                                cfg["frame_cond_hidden"])
    with torch.no_grad():
        for prefix, module in (("wan.", wan), ("fc.", fc)):
            params = dict(module.named_parameters())
            if set(prefix + n for n in params) != {n for n in weights if n.startswith(prefix)}:
                raise ValueError(f"the program's {prefix} leaves differ from the configuration's")
            for n, p in params.items():
                w = weights[prefix + n]
                if tuple(p.shape) != tuple(w.shape):
                    raise ValueError(f"{n}: program {tuple(p.shape)} vs {tuple(w.shape)}")
                p.data = w.detach().clone()
    return wan.eval(), fc.eval()


def _launch_counts():
    from interpolated_diffusion_tpu_torch.kernels import block_sparse_attention as bsa

    return {"sla_fwd": bsa.block_sparse_attention.launches,
            "sla_bwd_dq": bsa.sla_bwd_dq.launches, "sla_bwd_dkdv": bsa.sla_bwd_dkdv.launches}


def _gaps(prog: Dict[str, float], ref: Dict[str, float], names: List[str]) -> Dict[str, float]:
    """Per leaf: |program norm - reference norm| over the larger of the
    reference's norm of that leaf and of the median leaf."""
    med = statistics.median(ref[n] for n in names)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med) for n in names}


def compare(prog: Dict, ref: Dict) -> List[Check]:
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    med = statistics.median(ref["grad"].values())
    names = [n for n in ref["grad"] if ref["grad"][n] >= NEGLIGIBLE * med]
    checks = [Check("loss_gap", loss_gap, LIMITS["loss_gap"])]
    for key in ("grad", "change"):
        gaps = _gaps(prog[key], ref[key], names)
        worst = sorted(gaps, key=gaps.get)[-3:]
        median = statistics.median(gaps.values())
        print(f"[compare] {key}: {len(names)} of {len(ref['grad'])} leaves, median gap "
              f"{median:.3e}, worst "
              + ", ".join(f"{n} {gaps[n]:.3e} (ref {ref[key][n]:.3e}, prog {prog[key][n]:.3e})"
                          for n in worst), file=sys.stderr, flush=True)
        checks.append(Check(f"{key}_gap_median", median, LIMITS[f"{key}_gap_median"]))
    return checks


def reference_run(cfg: Dict, tr: Dict, weights_seed: int, batches, gen_states, device,
                  precision: str = "f32") -> Dict:
    """The plain reference over the checked steps, from the same seeded
    weights, host batches and draw states."""
    strict_f32()
    P = {n: w.float() for n, w in make_weights(wan_ref.param_spec(cfg), weights_seed,
                                               device).items()}
    rcfg = dict(cfg, K=tr["K"], uniform_jitter=tr["uniform_jitter"],
                cond_drop_prob=tr["cond_drop_prob"], lr=tr["lr"],
                weight_decay=tr["weight_decay"], grad_clip=tr["grad_clip"])
    C, H, W = tr["latents"]
    p = cfg["patch_size"][1]
    N, D = (H // p) * (W // p), C * p * p
    dev_batches, step_draws = [], []
    for b, state in zip(batches, gen_states):
        dev_batches.append({k: torch.from_numpy(v).to(device) for k, v in b.items()})
        g = torch.Generator(device=device)
        g.set_state(state)
        step_draws.append(draws(g, tr["batch"], tr["K"], N, D, cfg["n_train"]))
    return wan_ref.train_steps(P, rcfg, dev_batches, step_draws, Numerics(precision))


def run(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda") -> Outcome:
    from interpolated_diffusion_tpu_torch.data.dataset import BatchLoader
    from interpolated_diffusion_tpu_torch.train.train_keypoints_wansynth import make_trainer
    from interpolated_diffusion_tpu_torch.utils.prefetch import DevicePrefetcher, pinned_put

    cfg, tr = cell.config, cell.traffic
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
    state, base, train_step, wan, fc = make_trainer(args, dev, wan=wan, fc=fc)
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
          f"{marks[0] - t_context:.2f}, first step "
          f"{marks[1] - marks[0]:.2f}, {n_check - 1} more {t_setup + setup_s - marks[1]:.2f}",
          file=sys.stderr, flush=True)

    B = tr["batch"]
    L = tr["K"] * (H // cfg["patch_size"][1]) * (W // cfg["patch_size"][2])
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
    if trace:
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
    del state, base, train_step, wan, fc, named, feed, metrics, batch, window_losses
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
    layer = {"kind": "train", "cfg": cfg, "traffic": cell.traffic, "batch": B, "tokens": L,
             "steps": steps, "window_s": window_s, "data_wait_s": waits, "trace": traced}
    if traced is not None:
        device_info["busy_s"] = traced.busy_s
        device_info["window_s"] = traced.window_s
    return Outcome(
        e2e={"train_tokens_per_s": steps * B * L / window_s, "setup_s": setup_s,
             "peak_mem_gib": window_peak / 2 ** 30},
        layer=layer, checks=checks, attempted=steps, failed=failed, device=device_info,
        breakdown=traced.breakdown() if traced is not None else None)
