#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's two sampling paths once on one GPU.

    python3 chip_smoke.py [--profile]

Phases, each on its own lines; any failure exits non-zero:
  1. device       the card's name and power limit (nvidia-smi); CUDA required
  2. build        nvcc builds csrc/*.cu (one process per source) into
                  build/kernels/<hash>/
  3. kernels      the maze kernels against their plain PyTorch twins, bf16, at
                  the shapes the maze path gives them
  4. main         make_pipeline at the bench configuration (384d x 12 layers x
                  12 heads, T=64, K=8, DDIM-20, 3 levels, seeded random
                  weights): requests of B in {1, 64, 1024} under attn_policy
                  "block" and B=64 under "fused"; invariants, launch counts,
                  and agreement of the kernel path with the plain-twin path
  5. timings      maze kernels vs twins (CUDA events) and pipeline samples/s
  6. wan kernels  the SLA, int8 SLA and flash kernels against their twins at
                  the Wan anchor path's shapes, at the 33k-token geometry of
                  scripts/bench_wan33k.py (blocks 128 and 256) and at a
                  sentinel case
  7. wan main     Phase-1 anchor sampling (sample/wan_anchors) through
                  Wan2.1-1.3B at full width and depth (1536d x 30 layers x 12
                  heads, ffn 8960, LoRA rank 8, frame conditioning, B=4,
                  K=5 anchors of 16x60x104 latents, L=7800, 3 DDIM
                  evaluations, seeded random weights) under attn_mode sla,
                  sage_sla and flash; shapes, finiteness, launch counts and
                  agreement of the kernel path with the plain-twin path
  8. wan timings  Wan kernels vs twins (CUDA events) and sampler samples/s
                  per mode (kernels, twins, twins, kernels)
--profile adds a torch.profiler table of one sla-mode sampler call. The
line before the last is a JSON summary
of the kernels; the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Tolerances of a kernel against its plain twin on the same bf16 inputs, as
# max|kernel - twin| / max|twin|. Both compute the same f32 sums in another
# order, so a value just at a bf16 rounding boundary can round one way in one
# and the other way in the other: one bf16 ulp is 2^-8 = 3.9e-3 of the value.
ATTN_TOL = 1e-2    # output rounded once from f32 sums: within ~2 ulps of the max
BLOCK_TOL = 2e-2   # h, qkv, p, o, f each round to bf16 inside the block and a
                   # flipped ulp there moves y through the next product
# Pipeline, kernel path vs plain-twin path, max |delta| of positions in [0, 1]:
# 19 Stage-1 steps and 3 Stage-2 levels feed each model output back in, so
# per-block rounding differences compound; random weights make no attempt to
# be contractive.
PIPE_TOL = 5e-2

BENCH = dict(T=64, K=8, levels=3, K_min=8, ddim_steps=20, n_train=100,
             d_model=384, n_layers=12, n_heads=12, d_ff=1536, d_cond=128,
             maze_channels=(32, 64, 128, 128), grid=21, data_dim=2)
KERNEL_SOURCES = {
    "fused_film_block": ("interpolated_diffusion_tpu_torch/csrc/fused_block.cu",
                         "interpolated_diffusion_tpu/kernels/fused_block.py:68"),
    "small_mha_packed": ("interpolated_diffusion_tpu_torch/csrc/small_mha.cu",
                         "interpolated_diffusion_tpu/kernels/small_mha.py:125"),
    "block_sparse_attention": ("interpolated_diffusion_tpu_torch/csrc/block_attention.cu",
                               "interpolated_diffusion_tpu/kernels/block_sparse_attention.py:46"),
    "int8_block_sparse_attention": ("interpolated_diffusion_tpu_torch/csrc/block_attention.cu",
                                    "interpolated_diffusion_tpu/kernels/int8_attention.py:48"),
    "flash_attention": ("interpolated_diffusion_tpu_torch/csrc/block_attention.cu",
                        "interpolated_diffusion_tpu/kernels/block_sparse_attention.py:174"),
}

# Wan2.1-T2V-1.3B Phase-1 anchor sampling: the defaults of
# data/precompute_phase1_anchors.py (batch 4, ddim_steps 4, sla_block 128) and
# train/wansynth_common.py (model, LoRA, frame conditioning, latents).
WAN = dict(wan_dim=1536, wan_layers=30, wan_heads=12, wan_ffn=8960, latent_c=16,
           text_dim=4096, attn_mode="sla", sla_topk=0.1, sla_block=128, lora_rank=8,
           lora_alpha=16.0, lora_form="runtime", lora_targets="attn,ffn", ffn_mode="dense",
           frame_cond=1, frame_cond_dim=5)
WAN_ANCHORS = dict(T=21, K=5, latent_c=16, latent_h=60, latent_w=104, patch_size=2,
                   n_train=1000, schedule="linear", ddim_steps=4)
WAN_B, WAN_TEXT_LEN = 4, 512
WAN_33K = (12, 32760)    # (BH, L) of scripts/bench_wan33k.py, Dh 128
WAN_MODES = ("sla", "sage_sla", "flash")
WAN_KERNELS = ("block_sparse_attention", "int8_block_sparse_attention", "flash_attention")
# launches per sampler call: 3 evaluations x 30 layers, self- and cross-attention
WAN_EXPECT = {"sla": (90, 0, 90), "sage_sla": (0, 90, 90), "flash": (0, 0, 180)}
INT8_VS_BF16_TOL = 0.08  # int8 SLA against the bf16 SLA twin (docs/kernels_tpu.json)
# Sampler, kernel path vs plain-twin path, max|d| / max|twin| of the anchors:
# the kernels round P to bf16 per 64-key tile, the twins per LUT block (or
# not at all); the difference (~1e-3 of an attention output) passes through
# 30 bf16 layers and 3 DDIM steps, the first of which scales eps by
# 1/sqrt(alpha_bar(999)) ~ 156 along with the anchors themselves.
WAN_TOL = 5e-2


class SmokeFailure(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase_device():
    import torch

    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} count={torch.cuda.device_count()}", flush=True)
    return card


def phase_build():
    from interpolated_diffusion_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    took = time.perf_counter() - t0
    print(f"[build] {os.path.relpath(path, ROOT)} in {took:.1f} s "
          f"(nvcc {_build.build_seconds:.1f} s)", flush=True)
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"[build] {line.strip()}", flush=True)


def _block_inputs(B, L, D, H, F, film, gen, device):
    import torch

    def u(*shape, bound):
        return (torch.rand(shape, generator=gen, device=device) * 2 - 1) * bound

    bf = torch.bfloat16
    x = torch.randn((B, L, D), generator=gen, device=device).to(bf)
    gb = lambda: 0.1 * torch.randn((B, 2 * D), generator=gen, device=device)
    zeros = torch.zeros((B, 2 * D), device=device)
    ln = lambda mean: mean + 0.1 * torch.randn(D, generator=gen, device=device)
    args = (gb() if film else zeros, gb() if film else zeros, ln(1.0), ln(0.0), ln(1.0),
            ln(0.0), u(3 * D, D, bound=D ** -0.5), u(3 * D, bound=D ** -0.5),
            u(D, D, bound=D ** -0.5), u(D, bound=D ** -0.5),
            u(F, D, bound=D ** -0.5), u(F, bound=D ** -0.5),
            u(D, F, bound=F ** -0.5), u(D, bound=F ** -0.5))
    return x, tuple(a.to(bf) for a in args)


def _errors(out, ref):
    d = (out.float() - ref.float()).abs().max().item()
    return d, d / max(ref.float().abs().max().item(), 1e-30)


def _time_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernels(dev):
    """Each kernel against its plain twin at the main path's shapes."""
    import torch
    from interpolated_diffusion_tpu_torch.kernels.fused_block import _torch_block, fused_film_block
    from interpolated_diffusion_tpu_torch.kernels.small_mha import _torch_attention, small_mha_packed

    gen = torch.Generator(device=dev).manual_seed(0)
    D, H, F = BENCH["d_model"], BENCH["n_heads"], BENCH["d_ff"]
    results = {"fused_film_block": [], "small_mha_packed": []}
    with torch.inference_mode():
        for B, L, film in ((1024, 8, True), (1024, 64, True), (1, 8, True), (37, 64, True),
                           (37, 8, False)):
            x, args = _block_inputs(B, L, D, H, F, film, gen, dev)
            out = fused_film_block(x, *args, n_heads=H, group_b=max(1, 512 // L),
                                   use_film=film)
            ref = _torch_block(x, *args, n_heads=H, use_film=film)
            torch.cuda.synchronize()
            require(out.shape == ref.shape and out.dtype == torch.bfloat16,
                    f"fused_film_block shape/dtype {out.shape} {out.dtype}")
            require(bool(torch.isfinite(out).all()), "fused_film_block: non-finite output")
            err, rel = _errors(out, ref)
            print(f"[kernels] fused_film_block B={B} L={L} D={D} H={H} F={F} film={film}: "
                  f"max|d|={err:.3e} max|d|/max|plain|={rel:.3e} (tol {BLOCK_TOL})",
                  flush=True)
            require(rel <= BLOCK_TOL, f"fused_film_block B={B} L={L} disagrees: {rel:.3e}")
            results["fused_film_block"].append(((B, L, film), err, x, args))
        for B, L in ((1024, 64), (1024, 8)):
            qkv = torch.randn((B, L, 3 * D), generator=gen, device=dev).to(torch.bfloat16)
            q, k, v = qkv.split(D, dim=-1)   # strided views, as the model passes them
            out = small_mha_packed(q, k, v, H, max(1, 512 // L))
            ref = _torch_attention(q, k, v, H)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(out).all()), "small_mha_packed: non-finite output")
            err, rel = _errors(out, ref)
            print(f"[kernels] small_mha_packed [{B},{L},{D}] H={H}: max|d|={err:.3e} "
                  f"max|d|/max|plain|={rel:.3e} (tol {ATTN_TOL})", flush=True)
            require(rel <= ATTN_TOL, f"small_mha_packed B={B} L={L} disagrees: {rel:.3e}")
            results["small_mha_packed"].append(((B, L), err, q, k, v))
    return results


@contextlib.contextmanager
def plain_twins():
    """Route the model's kernel calls to the plain twins (on CUDA tensors)."""
    from interpolated_diffusion_tpu_torch.kernels import fused_block, small_mha
    from interpolated_diffusion_tpu_torch.models import transformer

    saved = transformer.fused_film_block, transformer.small_mha_packed
    transformer.fused_film_block = (
        lambda x, *a, n_heads, group_b=8, use_film=True:
        fused_block._torch_block(x, *a, n_heads=n_heads, use_film=use_film))
    transformer.small_mha_packed = (
        lambda q, k, v, n_heads, group_b=8: small_mha._torch_attention(q, k, v, n_heads))
    try:
        yield
    finally:
        transformer.fused_film_block, transformer.small_mha_packed = saved


def _requests(B, gen_cpu, device):
    import torch

    T, K, G = BENCH["T"], BENCH["K"], BENCH["grid"]
    interior = torch.stack([torch.randperm(T - 2, generator=gen_cpu)[:K - 2] + 1
                            for _ in range(B)])
    idx = torch.cat([torch.zeros((B, 1), dtype=torch.long), interior,
                     torch.full((B, 1), T - 1, dtype=torch.long)], dim=1)
    idx = torch.sort(idx, dim=1).values
    cond = {"occ": (torch.rand((B, 1, G, G), generator=gen_cpu) < 0.2).float(),
            "start_goal": torch.rand((B, 4), generator=gen_cpu)}
    return idx.to(device), {k: v.to(device) for k, v in cond.items()}


def _build_models(device):
    import torch
    from interpolated_diffusion_tpu_torch.models.denoisers import InterpLevelDenoiser, KeypointDenoiser
    from interpolated_diffusion_tpu_torch.models.init import build_model

    w = {k: BENCH[k] for k in ("d_model", "n_layers", "n_heads", "d_ff", "d_cond",
                               "maze_channels", "data_dim")}
    kp = build_model(KeypointDenoiser, generator=torch.Generator().manual_seed(1),
                     device=device, dtype=torch.bfloat16, **w)
    it = build_model(InterpLevelDenoiser, generator=torch.Generator().manual_seed(2),
                     device=device, dtype=torch.bfloat16, mask_channels=2, **w)
    # the zero-init Stage-2 head would make Stage 2 the identity
    with torch.no_grad():
        g = torch.Generator().manual_seed(3)
        it.out.weight.copy_((torch.rand(it.out.weight.shape, generator=g) * 2 - 1) * 1e-2)
        it.out.bias.copy_((torch.rand(it.out.bias.shape, generator=g) * 2 - 1) * 1e-2)
    return kp.eval(), it.eval()


def _check_outputs(B, idx, cond, out):
    import torch

    T, K, Dd = BENCH["T"], BENCH["K"], BENCH["data_dim"]
    x_interp, x_ref, z_pred = out
    require(tuple(x_interp.shape) == (B, T, Dd) and tuple(x_ref.shape) == (B, T, Dd)
            and tuple(z_pred.shape) == (B, K, Dd), f"B={B}: bad output shapes")
    require(all(t.device.type == "cuda" for t in out), f"B={B}: outputs not on cuda")
    require(all(bool(torch.isfinite(t).all()) for t in out), f"B={B}: non-finite output")
    anchors = torch.gather(x_interp, 1, idx[..., None].expand(B, K, Dd))
    require(torch.equal(anchors, z_pred), f"B={B}: anchors not preserved in x_interp")
    sg = cond["start_goal"]
    require(torch.equal(x_ref[:, 0, :2], sg[:, :2]) and torch.equal(x_ref[:, -1, :2], sg[:, 2:]),
            f"B={B}: endpoints differ from start/goal")
    for name, t in (("x_interp", x_interp), ("x_refined", x_ref)):
        require(bool(((t[..., :2] >= 0) & (t[..., :2] <= 1)).all()),
                f"B={B}: {name} positions outside [0, 1]")


def phase_main(dev):
    import torch
    from interpolated_diffusion_tpu_torch.kernels.fused_block import fused_film_block
    from interpolated_diffusion_tpu_torch.kernels.small_mha import small_mha_packed
    from interpolated_diffusion_tpu_torch.ops.schedules import make_schedule
    from interpolated_diffusion_tpu_torch.sample.generate import PipelineConfig, make_pipeline

    kp, it = _build_models(dev)
    cfg = PipelineConfig(T=BENCH["T"], K=BENCH["K"], levels=BENCH["levels"],
                         K_min=BENCH["K_min"], ddim_steps=BENCH["ddim_steps"],
                         stage2_mode="adj", clamp_policy="endpoints", pos_clip=True)
    pipe = make_pipeline(kp, it, make_schedule("linear", BENCH["n_train"], device=dev), cfg,
                         BENCH["data_dim"])
    n_evals = len(range(BENCH["ddim_steps"] - 1))
    per_block_call = (n_evals + BENCH["levels"]) * BENCH["n_layers"]     # 264
    per_fused_call = BENCH["levels"] * BENCH["n_layers"]                 # 36: Stage 2 only
    gen_cpu = torch.Generator().manual_seed(4)
    plan = [("block", 1), ("block", 64), ("block", 1024), ("fused", 64)]
    reqs = {(p, B): _requests(B, gen_cpu, dev) for p, B in plan}

    fused_film_block.launches = small_mha_packed.launches = 0
    outs = {}
    for policy, B in plan:
        kp.set_attn_policy(policy)
        it.set_attn_policy(policy)
        before = (fused_film_block.launches, small_mha_packed.launches)
        idx, cond = reqs[(policy, B)]
        t0 = time.perf_counter()
        out = pipe(idx, cond, generator=torch.Generator(device=dev).manual_seed(B))
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        d_blk = fused_film_block.launches - before[0]
        d_mha = small_mha_packed.launches - before[1]
        _check_outputs(B, idx, cond, out)
        want = (per_block_call, 0) if policy == "block" else (0, per_fused_call)
        require((d_blk, d_mha) == want,
                f"{policy} B={B}: launches fused_film_block={d_blk} small_mha_packed={d_mha}, "
                f"expected {want}")
        print(f"[main] policy={policy} B={B}: {took:.3f} s (first call includes warm-up), "
              f"launches fused_film_block +{d_blk} small_mha_packed +{d_mha}; "
              f"shapes {tuple(out[0].shape)} {tuple(out[1].shape)} {tuple(out[2].shape)}; "
              f"anchors, endpoints, [0,1] ok", flush=True)
        outs[(policy, B)] = out
    launches = {"fused_film_block": fused_film_block.launches,
                "small_mha_packed": small_mha_packed.launches}
    print(f"[main] launches in the main-path run: {launches}", flush=True)

    # kernel path vs plain-twin path, same inputs and draws
    for policy, B in (("block", 64), ("fused", 64)):
        kp.set_attn_policy(policy)
        it.set_attn_policy(policy)
        idx, cond = reqs[(policy, B)]
        with plain_twins():
            ref = pipe(idx, cond, generator=torch.Generator(device=dev).manual_seed(B))
        for name, a, b in zip(("x_interp", "x_refined", "z_pred"), outs[(policy, B)], ref):
            err = (a - b).abs().max().item()
            print(f"[main] policy={policy} B={B} kernels vs plain twins: {name} "
                  f"max|d|={err:.3e} (tol {PIPE_TOL})", flush=True)
            require(err <= PIPE_TOL, f"{policy} B={B}: {name} kernel path disagrees ({err:.3e})")
    return kp, it, pipe, launches


def phase_timings(dev, card, kernel_cases, pipe, kp, it):
    import torch
    from interpolated_diffusion_tpu_torch.kernels.fused_block import _torch_block, fused_film_block
    from interpolated_diffusion_tpu_torch.kernels.small_mha import _torch_attention, small_mha_packed

    D, H = BENCH["d_model"], BENCH["n_heads"]
    tag = f"[{card}]"
    times = {}
    with torch.inference_mode():
        saved = fused_film_block.launches, small_mha_packed.launches
        for (B, L, film), _, x, args in kernel_cases["fused_film_block"]:
            k_ms = _time_ms(lambda: fused_film_block(x, *args, n_heads=H, use_film=film))
            p_ms = _time_ms(lambda: _torch_block(x, *args, n_heads=H, use_film=film))
            print(f"[timing] {tag} fused_film_block [{B},{L},{D}] film={film}: "
                  f"kernel {k_ms:.4f} ms, plain twin {p_ms:.4f} ms", flush=True)
            times[("fused_film_block", B, L)] = (k_ms, p_ms)
        for (B, L), _, q, k, v in kernel_cases["small_mha_packed"]:
            k_ms = _time_ms(lambda: small_mha_packed(q, k, v, H))
            p_ms = _time_ms(lambda: _torch_attention(q, k, v, H))
            print(f"[timing] {tag} small_mha_packed [{B},{L},{D}]: kernel {k_ms:.4f} ms, "
                  f"plain twin {p_ms:.4f} ms", flush=True)
            times[("small_mha_packed", B, L)] = (k_ms, p_ms)
        fused_film_block.launches, small_mha_packed.launches = saved

    # pipeline samples/s at B=1024, kernel path vs plain-twin path, timed in
    # the order kernels, twins, twins, kernels so that clock drift cancels
    B, iters = 1024, 5
    idx, cond = _requests(B, torch.Generator().manual_seed(5), dev)

    def run(path):
        ctx = plain_twins() if path == "plain twins" else contextlib.nullcontext()
        with ctx:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(iters):
                pipe(idx, cond, generator=torch.Generator(device=dev).manual_seed(i))
            torch.cuda.synchronize()
            return B * iters / (time.perf_counter() - t0)

    for policy in ("block", "fused"):
        kp.set_attn_policy(policy)
        it.set_attn_policy(policy)
        for small in (1, 64):   # per-request latency of small batches, kernel path
            sidx, scond = _requests(small, torch.Generator().manual_seed(6), dev)
            pipe(sidx, scond, generator=torch.Generator(device=dev).manual_seed(0))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(iters):
                pipe(sidx, scond, generator=torch.Generator(device=dev).manual_seed(i))
                torch.cuda.synchronize()
            print(f"[timing] {tag} pipeline B={small} policy={policy} kernels: "
                  f"{(time.perf_counter() - t0) / iters * 1e3:.1f} ms per request", flush=True)
        for path in ("kernels", "plain twins"):   # warm-up
            with plain_twins() if path == "plain twins" else contextlib.nullcontext():
                pipe(idx, cond, generator=torch.Generator(device=dev).manual_seed(0))
        runs = {"kernels": [], "plain twins": []}
        for path in ("kernels", "plain twins", "plain twins", "kernels"):
            runs[path].append(run(path))
        for path, vals in runs.items():
            print(f"[timing] {tag} pipeline B={B} policy={policy} {path}: "
                  f"{sum(vals) / len(vals):.1f} samples/s (runs of {iters} calls: "
                  f"{', '.join(f'{v:.1f}' for v in vals)})", flush=True)
    return times


def _wan_qkv(BH, L, D, gen, dev, Lk=None):
    import torch

    q = torch.randn((BH, L, D), generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((BH, Lk or L, D), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    return q, k, v


def _check_pair(name, label, got, want, tol, errs):
    """o and lse of a kernel against a twin; records the largest |d| of o."""
    import torch

    (o, lse), (ro, rlse) = got, want
    require(bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all()),
            f"{name} {label}: non-finite output")
    err, rel = _errors(o, ro)
    _, rel_lse = _errors(lse, rlse)
    print(f"[wan kernels] {name} {label}: o max|d|={err:.3e} max|d|/max|twin|={rel:.3e}, "
          f"lse max|d|/max|twin|={rel_lse:.3e} (tol {tol})", flush=True)
    require(rel <= tol and rel_lse <= tol, f"{name} {label} disagrees: {rel:.3e} {rel_lse:.3e}")
    errs.setdefault(name, []).append(err)


def phase_wan_kernels(dev):
    """The three Wan attention kernels against their twins, on bf16 inputs."""
    import torch
    from interpolated_diffusion_tpu_torch.kernels import block_sparse_attention as bsa
    from interpolated_diffusion_tpu_torch.kernels import int8_attention as i8
    from interpolated_diffusion_tpu_torch.kernels.block_sparse_reference import (
        block_sparse_attention_reference as sla_twin)
    from interpolated_diffusion_tpu_torch.kernels.sla import get_block_map

    gen = torch.Generator(device=dev).manual_seed(10)
    errs, cases = {}, {}
    H, D = WAN["wan_heads"], WAN["wan_dim"] // WAN["wan_heads"]
    L = WAN_ANCHORS["K"] * (WAN_ANCHORS["latent_h"] // 2) * (WAN_ANCHORS["latent_w"] // 2)
    BH, Lk_cross = WAN_B * H, WAN_TEXT_LEN + WAN_ANCHORS["K"]

    def sla_and_int8(q, k, v, block, label, keep=False):
        _, lut, topk = get_block_map(q, k, WAN["sla_topk"], block, block)
        ref = sla_twin(q, k, v, lut, block, block)
        _check_pair("block_sparse_attention", f"{label} block={block} topk={topk}",
                    bsa.block_sparse_attention_fwd(q, k, v, lut, block, block), ref,
                    ATTN_TOL, errs)
        qi, ki, qs, ks = i8.quantize_qk(q, k)
        got = i8.int8_attention_fwd(qi, ki, v, qs, ks, lut, block, block, D ** -0.5)
        _check_pair("int8_block_sparse_attention", f"{label} block={block} vs int8 twin", got,
                    i8._torch_int8_attention(qi, ki, v, qs, ks, lut, block, block, D ** -0.5),
                    ATTN_TOL, errs)
        _, rel = _errors(got[0], ref[0])
        print(f"[wan kernels] int8_block_sparse_attention {label} block={block} vs bf16 SLA "
              f"twin: max|d|/max|twin|={rel:.3e} (tol {INT8_VS_BF16_TOL})", flush=True)
        require(rel <= INT8_VS_BF16_TOL, f"int8 vs bf16 SLA {label} disagrees: {rel:.3e}")
        if keep:
            cases["sla"] = (q, k, v, lut, block)
            cases["int8"] = (qi, ki, v, qs, ks, lut, block)

    with torch.inference_mode():
        # the anchor path's shapes: BH = 4 x 12, L = 7800, Dh = 128
        q, k, v = _wan_qkv(BH, L, D, gen, dev)
        sla_and_int8(q, k, v, WAN["sla_block"], f"path [{BH},{L},{D}]", keep=True)
        kc, vc = (torch.randn((BH, Lk_cross, D), generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        for label, kk, vv, bn in (("cross", kc, vc, 640), ("self", k, v, 1024)):
            _check_pair("flash_attention", f"path {label} q [{BH},{L},{D}] k [{BH},{kk.shape[1]},{D}]",
                        bsa.flash_attention_fwd(q, kk, vv), bsa._torch_flash(q, kk, vv, D ** -0.5, bn),
                        ATTN_TOL, errs)
            cases[f"flash_{label}"] = (q, kk, vv, bn)
        # a sentinel case: ring SLA's primitive on the path's shapes
        block = WAN["sla_block"]
        _, lut, _ = get_block_map(q[:8], k[:8], WAN["sla_topk"], block, block)
        sentinel = -(-L // block)
        lut[:, 1::3, -1] = sentinel
        lut[:, 2::7, :] = sentinel
        lut = lut.contiguous()
        got = bsa.block_sparse_attention_lse(q[:8].contiguous(), k[:8].contiguous(),
                                             v[:8].contiguous(), lut, block, block)
        _check_pair("block_sparse_attention", f"lse with sentinels [8,{L},{D}]", got,
                    sla_twin(q[:8], k[:8], v[:8], lut, block, block, kv_len=L, kv_pad_blocks=1),
                    ATTN_TOL, errs)
        rows = torch.arange(L, device=dev) // block % 7 == 2
        require(bool((got[0][:, rows] == 0).all()), "sentinel rows: o is not 0")
        del q, k, v, kc, vc
        # scripts/bench_wan33k.py geometry: BH 12, L 32760, Dh 128, topk 0.1
        bh33, l33 = WAN_33K
        q, k, v = _wan_qkv(bh33, l33, D, gen, dev)
        for block in (128, 256):
            sla_and_int8(q, k, v, block, f"33k [{bh33},{l33},{D}]")
        o, lse = bsa.flash_attention_fwd(q, k, v)   # the twin's logits would be 51 GB:
        rows = slice(0, 2048)                       # compare the first 2048 rows
        _check_pair("flash_attention", f"33k rows 0:2048 of [{bh33},{l33},{D}]",
                    (o[:, rows], lse[:, rows]),
                    bsa._torch_flash(q[:, rows].contiguous(), k, v, D ** -0.5, 1024),
                    ATTN_TOL, errs)
        del q, k, v, o, lse
    torch.cuda.synchronize()
    return errs, cases


def _wan_counts():
    from interpolated_diffusion_tpu_torch.kernels import block_sparse_attention as bsa
    from interpolated_diffusion_tpu_torch.kernels import int8_attention as i8

    return (bsa.block_sparse_attention.launches, i8.int8_block_sparse_attention.launches,
            bsa.flash_attention.launches)


@contextlib.contextmanager
def count_twin_calls():
    """Count calls of the Wan kernels' plain twins (none on the kernel path)."""
    from interpolated_diffusion_tpu_torch.kernels import block_sparse_attention as bsa
    from interpolated_diffusion_tpu_torch.kernels import int8_attention as i8

    calls = [0]
    saved = [(bsa, "block_sparse_attention_reference"), (bsa, "_torch_flash"),
             (i8, "_torch_int8_attention")]
    originals = [getattr(m, n) for m, n in saved]

    def counting(fn):
        def wrapped(*a, **kw):
            calls[0] += 1
            return fn(*a, **kw)
        return wrapped

    for (m, n), fn in zip(saved, originals):
        setattr(m, n, counting(fn))
    try:
        yield calls
    finally:
        for (m, n), fn in zip(saved, originals):
            setattr(m, n, fn)


@contextlib.contextmanager
def wan_plain_twins():
    """Route WanDiT's attention kernels to their plain twins (on CUDA tensors)."""
    import torch
    from interpolated_diffusion_tpu_torch.kernels import block_sparse_attention as bsa
    from interpolated_diffusion_tpu_torch.kernels import int8_attention as i8
    from interpolated_diffusion_tpu_torch.kernels import sla
    from interpolated_diffusion_tpu_torch.kernels.block_sparse_reference import (
        block_sparse_attention_reference)
    from interpolated_diffusion_tpu_torch.models import wan_dit

    def int8_twin(q, k, v, lut, bm, bn):
        qi, ki, qs, ks = i8.quantize_qk(q, k)
        return i8._torch_int8_attention(qi, ki, v.to(torch.bfloat16), qs, ks, lut, bm, bn,
                                        q.shape[-1] ** -0.5)[0]

    saved = sla.block_sparse_attention, sla.int8_block_sparse_attention, wan_dit.flash_attention
    sla.block_sparse_attention = (
        lambda q, k, v, lut, bm, bn: block_sparse_attention_reference(q, k, v, lut, bm, bn)[0])
    sla.int8_block_sparse_attention = int8_twin
    wan_dit.flash_attention = (
        lambda q, k, v, bm, bn: bsa._torch_flash(q, k, v, q.shape[-1] ** -0.5, bn)[0])
    try:
        yield
    finally:
        sla.block_sparse_attention, sla.int8_block_sparse_attention, wan_dit.flash_attention = saved


def phase_wan_main(dev):
    import types

    import torch
    from interpolated_diffusion_tpu_torch.kernels import block_sparse_attention as bsa
    from interpolated_diffusion_tpu_torch.kernels import int8_attention as i8
    from interpolated_diffusion_tpu_torch.ops.schedules import make_schedule
    from interpolated_diffusion_tpu_torch.sample.wan_anchors import AnchorConfig, make_anchor_sampler
    from interpolated_diffusion_tpu_torch.train.wansynth_common import build_wan

    t0 = time.perf_counter()
    # zero_init_scale: LoRA B, the SLA projection and the frame-cond output
    # layer are non-zero, so that every branch of the path acts
    model, fc = build_wan(types.SimpleNamespace(**WAN), bf16=True, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(11),
                          zero_init_scale=1e-2)
    n_params = sum(p.numel() for p in model.parameters()) + sum(p.numel() for p in fc.parameters())
    print(f"[wan main] WanDiT + FrameCondProjector: {n_params / 1e9:.3f} B parameters (bf16), "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    cfg = AnchorConfig(**WAN_ANCHORS)
    sampler = make_anchor_sampler(cfg, model, fc, make_schedule(cfg.schedule, cfg.n_train,
                                                                device=dev))
    gen = torch.Generator(device=dev).manual_seed(12)
    hp, wp = cfg.spatial
    z_init = torch.randn((WAN_B, cfg.K, hp * wp, cfg.latent_c * cfg.patch_size ** 2),
                         generator=gen, device=dev)
    idx = torch.stack([torch.sort(torch.randperm(cfg.T, device=dev, generator=gen)[:cfg.K]).values
                       for _ in range(WAN_B)])
    text = torch.randn((WAN_B, WAN_TEXT_LEN, WAN["text_dim"]), generator=gen, device=dev)
    inputs = (z_init, idx, text)
    want_shape = (WAN_B, cfg.K, cfg.latent_c, cfg.latent_h, cfg.latent_w)

    bsa.block_sparse_attention.launches = 0
    i8.int8_block_sparse_attention.launches = 0
    bsa.flash_attention.launches = 0
    outs = {}
    for mode in WAN_MODES:
        model.set_attn_mode(mode)
        before = _wan_counts()
        with count_twin_calls() as twin_calls:
            t0 = time.perf_counter()
            out = sampler(*inputs)
            torch.cuda.synchronize()
            took = time.perf_counter() - t0
        delta = tuple(a - b for a, b in zip(_wan_counts(), before))
        require(tuple(out.shape) == want_shape and out.dtype == torch.float32,
                f"wan {mode}: output {tuple(out.shape)} {out.dtype}, expected {want_shape}")
        require(bool(torch.isfinite(out).all()), f"wan {mode}: non-finite anchors")
        require(delta == WAN_EXPECT[mode] and twin_calls[0] == 0,
                f"wan {mode}: launches {dict(zip(WAN_KERNELS, delta))}, twin calls "
                f"{twin_calls[0]}, expected {dict(zip(WAN_KERNELS, WAN_EXPECT[mode]))} and 0")
        print(f"[wan main] attn_mode={mode}: {took:.3f} s (first call of the mode), launches "
              f"{dict(zip(WAN_KERNELS, delta))}, twin calls 0; anchors {tuple(out.shape)} "
              f"finite, max|anchor|={out.abs().max().item():.3e}", flush=True)
        outs[mode] = out
    launches = dict(zip(WAN_KERNELS, _wan_counts()))
    print(f"[wan main] launches in the main-path run: {launches}", flush=True)

    for mode in WAN_MODES:   # kernel path vs plain-twin path, same weights and inputs
        model.set_attn_mode(mode)
        with wan_plain_twins():
            ref = sampler(*inputs)
        err, rel = _errors(outs[mode], ref)
        print(f"[wan main] attn_mode={mode} kernels vs plain twins: max|d|={err:.3e} "
              f"max|d|/max|twin|={rel:.3e} (tol {WAN_TOL})", flush=True)
        require(rel <= WAN_TOL, f"wan {mode}: kernel path disagrees with twin path ({rel:.3e})")
    _, rel = _errors(outs["sage_sla"], outs["sla"])
    print(f"[wan main] sage_sla vs sla anchors (int8 vs bf16 QK^T): max|d|/max|sla|={rel:.3e}",
          flush=True)
    return model, sampler, inputs, launches


def phase_wan_timings(card, cases, model, sampler, inputs, profile):
    import torch
    from interpolated_diffusion_tpu_torch.kernels import block_sparse_attention as bsa
    from interpolated_diffusion_tpu_torch.kernels import int8_attention as i8
    from interpolated_diffusion_tpu_torch.kernels.block_sparse_reference import (
        block_sparse_attention_reference)

    tag = f"[{card}]"
    times = {}
    saved = _wan_counts()
    with torch.inference_mode():
        q, k, v, lut, block = cases["sla"]
        qi, ki, vi, qs, ks, lut8, _ = cases["int8"]
        scale = q.shape[-1] ** -0.5
        plan = [
            ("block_sparse_attention", f"[{q.shape[0]},{q.shape[1]},{q.shape[2]}] block {block}",
             lambda: bsa.block_sparse_attention_fwd(q, k, v, lut, block, block),
             lambda: block_sparse_attention_reference(q, k, v, lut, block, block)),
            ("int8_block_sparse_attention", "same shape, pre-quantized q/k",
             lambda: i8.int8_attention_fwd(qi, ki, vi, qs, ks, lut8, block, block, scale),
             lambda: i8._torch_int8_attention(qi, ki, vi, qs, ks, lut8, block, block, scale))]
        for label in ("cross", "self"):
            fq, fk, fv, bn = cases[f"flash_{label}"]
            plan.append((f"flash_attention/{label}",
                         f"q [{fq.shape[0]},{fq.shape[1]},{fq.shape[2]}] k {fk.shape[1]} rows",
                         lambda fq=fq, fk=fk, fv=fv: bsa.flash_attention_fwd(fq, fk, fv),
                         lambda fq=fq, fk=fk, fv=fv, bn=bn: bsa._torch_flash(fq, fk, fv, scale, bn)))
        for name, shape, kernel, twin in plan:
            k_ms = _time_ms(kernel, iters=10, warmup=2)
            p_ms = _time_ms(twin, iters=3, warmup=1)
            print(f"[timing] {tag} {name} {shape}: kernel {k_ms:.4f} ms, plain twin "
                  f"{p_ms:.4f} ms", flush=True)
            times[name] = (k_ms, p_ms)
    bsa.block_sparse_attention.launches, i8.int8_block_sparse_attention.launches, \
        bsa.flash_attention.launches = saved

    # sampler samples/s per mode, one call per run, kernels / twins in turns
    for mode in WAN_MODES:
        model.set_attn_mode(mode)
        runs = {"kernels": [], "plain twins": []}
        for path in ("kernels", "plain twins", "plain twins", "kernels"):
            with wan_plain_twins() if path == "plain twins" else contextlib.nullcontext():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sampler(*inputs)
                torch.cuda.synchronize()
                runs[path].append(WAN_B / (time.perf_counter() - t0))
        for path, vals in runs.items():
            print(f"[timing] {tag} wan sampler attn_mode={mode} B={WAN_B} {path}: "
                  f"{sum(vals) / len(vals):.4f} samples/s (calls: "
                  f"{', '.join(f'{x:.4f}' for x in vals)})", flush=True)
    if profile:
        from torch.profiler import ProfilerActivity, profile as torch_profile

        model.set_attn_mode("sla")
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sampler(*inputs)
            torch.cuda.synchronize()
        table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=25)
        print(f"[profile] {tag} one sla-mode sampler call (B={WAN_B}):\n{table}", flush=True)
    return times


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", flush=True)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this script needs a GPU", flush=True)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import interpolated_diffusion_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"FAIL: the port package is not next to this script ({e})", flush=True)
        return 1
    try:
        card = phase_device()
        phase_build()
        dev = torch.device("cuda")
        # the plain twins are the f32 references: no TF32 in their products
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cases = phase_kernels(dev)
        kp, it, pipe, launches = phase_main(dev)
        times = phase_timings(dev, card, cases, pipe, kp, it)
        del kp, it, pipe
        torch.cuda.empty_cache()
        wan_errs, wan_cases = phase_wan_kernels(dev)
        model, sampler, inputs, wan_launches = phase_wan_main(dev)
        wan_times = phase_wan_timings(card, wan_cases, model, sampler, inputs,
                                      "--profile" in sys.argv[1:])
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        return 1

    summary = []
    for name, shape_key in (("fused_film_block", (1024, 64)), ("small_mha_packed", (1024, 64))):
        src, replaces = KERNEL_SOURCES[name]
        err = max(c[1] for c in cases[name])
        k_ms, p_ms = times[(name, *shape_key)]
        summary.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": err,
                        "ms": k_ms, "plain_ms": p_ms})
    for name in WAN_KERNELS:   # times at the anchor path's shapes (flash: cross-attention)
        src, replaces = KERNEL_SOURCES[name]
        k_ms, p_ms = wan_times[name if name != "flash_attention" else "flash_attention/cross"]
        summary.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": wan_launches[name], "max_abs_err": max(wan_errs[name]),
                        "ms": k_ms, "plain_ms": p_ms})
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
