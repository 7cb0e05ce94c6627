#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's maze sampling pipeline once on one GPU.

    python3 chip_smoke.py

Phases, each on its own lines; any failure exits non-zero:
  1. device   the card's name and power limit (nvidia-smi); CUDA required
  2. build    nvcc builds csrc/*.cu into build/kernels/<hash>/
  3. kernels  each hand-written kernel against its plain PyTorch twin, bf16,
              at the shapes the main path gives it
  4. main     make_pipeline at the bench configuration (384d x 12 layers x 12
              heads, T=64, K=8, DDIM-20, 3 levels, seeded random weights):
              requests of B in {1, 64, 1024} under attn_policy "block" and
              B=64 under "fused"; invariants, launch counts, and agreement of
              the kernel path with the plain-twin path
  5. timings  kernels vs twins (CUDA events) and pipeline samples/s
The line before the last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}.
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
}


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
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
