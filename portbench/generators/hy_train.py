"""A closed loop of HunyuanVideo Phase-1 LoRA training steps.

The Wan cell's loop (generators/wan_train.py) over the program's other
backbone: set-up builds the program's trainer once
(train/train_keypoints_wansynth.make_trainer under --dit hunyuan_video, over a
HunyuanVideoTransformer3DModel and frame-condition projector that hold the
benchmark's seeded weights), feeds it through the program's own loader
(data/dataset.BatchLoader over synthetic rows with a prompt mask and a pooled
text vector, utils/prefetch.DevicePrefetcher with pinned copies) and drives
the first `check_steps` steps from the seed: they warm every shape and are
the steps the reference follows. The same trainer then runs the measured
window; a traced run profiles `trace_steps` more. After the window the
program is freed and the plain reference (reference/hunyuan_ref.py) repeats
the checked steps on the same batches, weights and draws.

Traffic parameters (traffic/<mix>.json): batch, T, K, latents [C, H, W],
text_len, text_valid [lo, hi] (valid prompt tokens of a row, uniform),
pooled_dim, guidance, phase1_input_mode, uniform_jitter, cond_drop_prob, lr,
weight_decay, grad_clip, prefetch_depth, check_steps, trace_steps; the
configuration gives the model and LoRA settings. `train_tokens_per_s`
counts video tokens.
"""
from __future__ import annotations

import gc
import statistics
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.generators.wan_train import NEGLIGIBLE, SyntheticWan, _gaps, draws
from portbench.harness.core import Cell, Check, Outcome, device_name, peak_bytes, sub_seed, sync
from portbench.harness.trace import profiled_segment
from portbench.harness.weights import make_weights
from portbench.reference import hunyuan_ref
from portbench.reference.numerics import Numerics, strict_f32

# The limits of the three compared numbers, set as the Wan cell's are (PERF.md
# gives the readings): above the sound runs' largest reading, below the
# float8 control's and the planted faults' smallest. The float8 control
# fails on the change gap; its loss and gradient gaps overlap the sound
# runs', so those two limits lie below the faults' readings instead.
LIMITS = {"loss_gap": 1.4e-3, "grad_gap_median": 3.0e-3, "change_gap_median": 5.0e-4}


class SyntheticHy(SyntheticWan):
    """SyntheticWan's rows with a prompt mask (the first n tokens valid, n
    uniform in text_valid) and a pooled text vector [pooled_dim], drawn after
    the rest from the row's own generator."""

    def __init__(self, seed: int, T: int, C: int, H: int, W: int, text_len: int, text_dim: int,
                 text_valid, pooled_dim: int, n_keyframes: int = 5):
        super().__init__(seed, T, C, H, W, text_len, text_dim, n_keyframes)
        self.text_valid, self.pooled_dim = tuple(text_valid), pooled_dim

    def get(self, row: int) -> Dict[str, np.ndarray]:
        out = super().get(row)
        rng = np.random.default_rng([self.seed & 0xFFFFFFFF, self.seed >> 32, int(row), 1])
        n = int(rng.integers(self.text_valid[0], self.text_valid[1] + 1))
        out["text_mask"] = (np.arange(self.text_len) < n).astype(np.int32)
        out["pooled"] = rng.standard_normal(self.pooled_dim, dtype=np.float32)
        return out


def compare(prog: Dict, ref: Dict, limits: Dict = LIMITS) -> List[Check]:
    """wan_train.compare's numbers under `limits`: each checked step's
    relative loss gap, and the median trainable leaf's gap of first gradient
    norm and of change norm (leaves whose reference gradient is under
    NEGLIGIBLE of the median leaf's left out); the worst leaves are
    printed."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    med = statistics.median(ref["grad"].values())
    names = [n for n in ref["grad"] if ref["grad"][n] >= NEGLIGIBLE * med]
    checks = [Check("loss_gap", loss_gap, limits["loss_gap"])]
    for key in ("grad", "change"):
        gaps = _gaps(prog[key], ref[key], names)
        worst = sorted(gaps, key=gaps.get)[-3:]
        median = statistics.median(gaps.values())
        print(f"[compare] {key}: {len(names)} of {len(ref['grad'])} leaves, median gap "
              f"{median:.3e}, worst "
              + ", ".join(f"{n} {gaps[n]:.3e} (ref {ref[key][n]:.3e}, prog {prog[key][n]:.3e})"
                          for n in worst), file=sys.stderr, flush=True)
        checks.append(Check(f"{key}_gap_median", median, limits[f"{key}_gap_median"]))
    return checks


def trainer_args(cfg: Dict, tr: Dict, seed: int):
    from interpolated_diffusion_tpu_torch.models.hunyuan_video import EMBEDDED_GUIDANCE
    from interpolated_diffusion_tpu_torch.train.train_keypoints_wansynth import build_argparser

    if tr["guidance"] != EMBEDDED_GUIDANCE:
        raise ValueError(f"the trainer embeds guidance {EMBEDDED_GUIDANCE}, the traffic "
                         f"{tr['guidance']}")
    C, H, W = tr["latents"]
    lo, hi = tr["text_valid"]
    flags = {"--dit": "hunyuan_video", "--batch": tr["batch"], "--T": tr["T"], "--K": tr["K"],
             "--latent_c": C, "--latent_h": H, "--latent_w": W, "--text_len": tr["text_len"],
             "--text_dim": cfg["text_embed_dim"], "--text_valid_min": lo,
             "--text_valid_max": hi, "--pooled_dim": cfg["pooled_projection_dim"],
             "--hy_heads": cfg["num_attention_heads"], "--hy_double": cfg["num_layers"],
             "--hy_single": cfg["num_single_layers"], "--patch_size": cfg["patch_size"],
             "--lora_rank": cfg["lora_rank"], "--lora_alpha": cfg["lora_alpha"],
             "--lora_targets": cfg["lora_targets"], "--lora_form": cfg["lora_form"],
             "--use_remat": int(cfg["use_remat"]), "--frame_cond": 1,
             "--frame_cond_dim": cfg["frame_cond_dim"], "--N_train": cfg["n_train"],
             "--schedule": "linear", "--phase1_input_mode": tr["phase1_input_mode"],
             "--uniform_jitter": tr["uniform_jitter"], "--cond_drop_prob": tr["cond_drop_prob"],
             "--lr": tr["lr"], "--weight_decay": tr["weight_decay"],
             "--grad_clip": tr["grad_clip"], "--prefetch_depth": tr["prefetch_depth"],
             "--bf16": 1, "--use_ema": 0, "--seed": seed % (1 << 31), "--device": "cuda"}
    return build_argparser().parse_args([str(x) for kv in flags.items() for x in kv])


def _adopt(module: torch.nn.Module, weights: Dict[str, torch.Tensor], prefix: str) -> None:
    """Make the benchmark's tensors the parameters of a module built on the
    meta device (no copy: 25.6 GB of base weights are held once)."""
    names = {prefix + n for n, _ in module.named_parameters()}
    mine = {n for n in weights if n.startswith(prefix)}
    if names != mine:
        raise ValueError(f"the program's {prefix} leaves differ from the configuration's: "
                         f"{sorted(names ^ mine)[:6]}")
    for mod_name, mod in module.named_modules():
        for name, p in list(mod._parameters.items()):
            if p is None:
                continue
            w = weights[prefix + (f"{mod_name}.{name}" if mod_name else name)]
            if tuple(p.shape) != tuple(w.shape):
                raise ValueError(f"{mod_name}.{name}: program {tuple(p.shape)} vs "
                                 f"{tuple(w.shape)}")
            mod._parameters[name] = torch.nn.Parameter(w.detach(), requires_grad=False)
    if any(t.is_meta for t in list(module.parameters()) + list(module.buffers())):
        raise ValueError(f"{prefix}: a tensor was left on the meta device")


def build_program(cfg: Dict, args, weights: Dict[str, torch.Tensor]):
    """The program's HunyuanVideo model and projector as the trainer builds
    them, holding the benchmark's weights (the base bfloat16, the trainable
    leaves float32)."""
    from interpolated_diffusion_tpu_torch.models.hunyuan_video import (
        HunyuanVideoTransformer3DModel)
    from interpolated_diffusion_tpu_torch.models.wan_dit import FrameCondProjector
    from interpolated_diffusion_tpu_torch.train.wansynth_common import hunyuan_kwargs

    with torch.device("meta"):
        model = HunyuanVideoTransformer3DModel(**hunyuan_kwargs(args))
        fc = FrameCondProjector(cfg["frame_cond_dim"], cfg["text_embed_dim"],
                                cfg["frame_cond_hidden"])
    _adopt(model, weights, "hy.")
    _adopt(fc, weights, "fc.")
    return model.eval(), fc.eval()


def _launch_counts():
    from interpolated_diffusion_tpu_torch.kernels import block_sparse_attention as bsa
    from interpolated_diffusion_tpu_torch.kernels import qk_norm_rope as qknr

    return {"flash_fwd": bsa.flash_attention.launches, "flash_bwd_dq": bsa.flash_bwd_dq.launches,
            "flash_bwd_dkdv": bsa.flash_bwd_dkdv.launches,
            "qk_norm_fwd": qknr.qk_norm_rope.launches,
            "qk_norm_bwd": qknr.qk_norm_rope.launches_bwd}


def expected_launches(cfg: Dict) -> Dict[str, int]:
    """A step's launches: one joint attention a block, forward twice under
    remat; four q/k norms a dual-stream block, two a single-stream one."""
    n2, n1 = cfg["num_layers"], cfg["num_single_layers"]
    return {"flash_fwd": 2 * (n2 + n1), "flash_bwd_dq": n2 + n1, "flash_bwd_dkdv": n2 + n1,
            "qk_norm_fwd": 2 * (4 * n2 + 2 * n1), "qk_norm_bwd": 4 * n2 + 2 * n1}


def reference_run(cfg: Dict, tr: Dict, weights_seed: int, batches, gen_states, device,
                  precision: str = "f32") -> Dict:
    """The plain reference over the checked steps, from the same seeded
    weights (the base left in bfloat16: each product upcasts), host batches
    and draw states."""
    strict_f32()
    P = make_weights(hunyuan_ref.param_spec(cfg), weights_seed, device)
    rcfg = dict(cfg, K=tr["K"], uniform_jitter=tr["uniform_jitter"],
                cond_drop_prob=tr["cond_drop_prob"], lr=tr["lr"], guidance=tr["guidance"],
                weight_decay=tr["weight_decay"], grad_clip=tr["grad_clip"])
    C, H, W = tr["latents"]
    p = cfg["patch_size"]
    N, D = (H // p) * (W // p), C * p * p
    dev_batches, step_draws = [], []
    for b, state in zip(batches, gen_states):
        dev_batches.append({k: torch.from_numpy(v).to(device) for k, v in b.items()})
        g = torch.Generator(device=device)
        g.set_state(state)
        step_draws.append(draws(g, tr["batch"], tr["K"], N, D, cfg["n_train"]))
    return hunyuan_ref.train_steps(P, rcfg, dev_batches, step_draws, Numerics(precision))


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
    weights = make_weights(hunyuan_ref.param_spec(cfg), w_seed, dev)
    model, fc = build_program(cfg, args, weights)
    del weights
    state, base, train_step, model, fc = make_trainer(args, dev, wan=model, fc=fc)
    sync(dev)
    marks = [time.perf_counter()]

    C, H, W = tr["latents"]
    data = SyntheticHy(sub_seed(seed, 2), tr["T"], C, H, W, tr["text_len"],
                       cfg["text_embed_dim"], tr["text_valid"], cfg["pooled_projection_dim"])
    n_check = int(tr["check_steps"])
    recorded: List[Dict[str, np.ndarray]] = []
    valid: List[int] = []   # valid prompt tokens of each row, in the order the steps take them

    def host_batches():
        for b in BatchLoader(data, batch_size=tr["batch"], seed=sub_seed(seed, 3) % (1 << 32)):
            if len(recorded) < n_check:
                recorded.append({k: v.copy() for k, v in b.items()})
            valid.append([int(n) for n in b["text_mask"].sum(axis=1)])
            yield b

    keys = ("latents", "text_embed", "text_mask", "pooled")
    feed = DevicePrefetcher(host_batches(), pinned_put(dev, keys=keys), depth=tr["prefetch_depth"])
    rng = torch.Generator(device=dev).manual_seed(sub_seed(seed, 4))
    named = {**{"hy." + n: p for n, p in state.params["lora"].items()},
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

    B, p = tr["batch"], cfg["patch_size"]
    L = tr["K"] * (H // p) * (W // p)
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

    traced, traced_valid = None, []
    if trace:
        taken = n_check + steps
        with profiled_segment(dev) as seg:
            for _ in range(int(tr["trace_steps"])):
                state, _ = train_step(state, base, next(feed), rng)
        traced = seg["trace"]
        traced.units["steps"] = int(tr["trace_steps"])
        traced_valid = valid[taken:taken + int(tr["trace_steps"])]
    feed.close()
    failed = sum(1 for x in window_losses if not bool(torch.isfinite(x)))
    card = device_name(dev)
    del state, base, train_step, model, fc, named, feed, metrics, window_losses
    if steps:
        del batch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    want = expected_launches(cfg)
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
    # the valid prompt tokens of each row of the window's and the traced steps
    layer = {"kind": "train", "cfg": cfg, "traffic": tr, "batch": B, "tokens": L,
             "steps": steps, "window_s": window_s, "data_wait_s": waits, "trace": traced,
             "window_valid": valid[n_check:n_check + steps], "traced_valid": traced_valid}
    if traced is not None:
        device_info["busy_s"] = traced.busy_s
        device_info["window_s"] = traced.window_s
    return Outcome(
        e2e={"train_tokens_per_s": steps * B * L / window_s, "setup_s": setup_s,
             "peak_mem_gib": window_peak / 2 ** 30},
        layer=layer, checks=checks, attempted=steps, failed=failed, device=device_info,
        breakdown=traced.breakdown() if traced is not None else None)
