"""Rank workers for the port's multi-process CPU tests (gloo).

`spawn(jobs, world, tmp_path)` starts `world` fresh interpreters that import
torch and the port only (never JAX or a test module: a child is ready in a
second or two), joins them through a `file://` store under tmp_path (no
fixed TCP port, so parallel test workers cannot collide), runs the named
jobs of this module in order on every rank, and returns each rank's list of
results. A rank that fails, or a run past `timeout` (a deadlocked
collective), fails the calling test: every child is killed and its output
is shown.

A job is `(name, payload)`: the function `job_<name>(rank, world, payload)`
below, returning anything picklable.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import traceback
from typing import Any, List, Sequence, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spawn(jobs: Sequence[Tuple[str, Any]], world: int, tmp_path, timeout: float = 120.0
          ) -> List[List[Any]]:
    tmp = str(tmp_path)
    job_file = os.path.join(tmp, f"jobs_w{world}.pkl")
    with open(job_file, "wb") as f:
        pickle.dump(list(jobs), f)
    init = os.path.join(tmp, f"store_w{world}_{os.getpid()}")
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    procs = []
    for r in range(world):
        out = os.path.join(tmp, f"out_w{world}_r{r}.pkl")
        log = open(os.path.join(tmp, f"log_w{world}_r{r}.txt"), "w")
        cmd = [sys.executable, os.path.abspath(__file__), str(r), str(world), init, job_file, out]
        procs.append((subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env,
                                       cwd=REPO), out, log))
    failed = None
    try:
        for r, (p, _, _) in enumerate(procs):
            if p.wait(timeout=timeout) != 0 and failed is None:
                failed = f"rank {r} exited with {p.returncode}"
    except subprocess.TimeoutExpired:
        failed = f"ranks still running after {timeout} s (a deadlocked collective?)"
    finally:
        for p, _, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if failed:
        logs = "\n".join(f"--- rank {r}\n" + open(os.path.join(tmp, f"log_w{world}_r{r}.txt")).read()[-4000:]
                         for r in range(world))
        raise AssertionError(f"{failed}\n{logs}")
    results = []
    for _, out, _ in procs:
        with open(out, "rb") as f:
            results.append(pickle.load(f))
    return results


def _main() -> None:
    rank, world, init, job_file, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                        sys.argv[4], sys.argv[5])
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", world_size=world, rank=rank)
    try:
        with open(job_file, "rb") as f:
            jobs = pickle.load(f)
        results = [globals()[f"job_{name}"](rank, world, payload) for name, payload in jobs]
        with open(out, "wb") as f:
            pickle.dump(results, f)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
    dist.barrier()
    dist.destroy_process_group()


# --- jobs -------------------------------------------------------------------------

def job_collectives(rank, world, payload):
    """ppermute (and its backward), psum, all_gather, all_to_all."""
    import torch

    from interpolated_diffusion_tpu_torch.parallel import collectives as c

    x = torch.full((2, 3), float(rank), requires_grad=True)
    y = c.ppermute(x, None, c.ring_perm(world))          # i -> i - 1: rank gets rank + 1's
    (y * (rank + 1)).sum().backward()                    # grad of x: rank - 1's weight
    s = c.psum(torch.tensor([float(rank)]))
    g = c.all_gather(torch.tensor([[float(rank)]]), None, 0)
    a = c.all_to_all(torch.arange(world, dtype=torch.float32) + 10 * rank)
    return {"y": y.detach().numpy(), "xgrad": x.grad.numpy(), "psum": s.numpy(),
            "gather": g.numpy(), "a2a": a.numpy()}



def job_expert_parallel(rank, world, payload):
    """SwitchFFN with its experts split over the world: this rank's output
    rows, the aux loss, and the gradients of sum(y^2) + 0.01 aux / world
    (router: this rank's share; experts: this rank's slice)."""
    import torch

    from interpolated_diffusion_tpu_torch.models.moe import SwitchFFN
    from interpolated_diffusion_tpu_torch.parallel.ep import shard_experts

    dim, ffn, E, cf = payload["shape"]
    m = SwitchFFN(dim, ffn, E, cf)
    m.load_state_dict({k: torch.tensor(v) for k, v in payload["sd"].items()})
    shard_experts(m, None)
    x = torch.tensor(payload["x"])
    n = x.shape[0] // world
    y, aux = m(x[rank * n:(rank + 1) * n])
    ((y ** 2).sum() + 0.01 * aux / world).backward()
    return {"y": y.detach().numpy(), "aux": float(aux),
            "grads": {k: p.grad.numpy() for k, p in m.named_parameters()}}


def job_dp_stage2(rank, world, payload):
    """One data-parallel Stage-2 train step (the maze trainer's own step) on
    this rank's rows: with the injected global draws, and with a generator.
    Returns loss, grad_norm, the all-reduced gradients and the new params."""
    import torch

    from interpolated_diffusion_tpu_torch.parallel.mesh import shard_batch
    from interpolated_diffusion_tpu_torch.train import train_interp_levels as ps2
    from interpolated_diffusion_tpu_torch.train.common import data_mesh

    out = {}
    for name, rng in (("injected", payload["draws"]),
                      ("generator", torch.Generator().manual_seed(payload["seed"]))):
        args = ps2.build_argparser().parse_args(payload["argv"])
        args.steps_per_call = 1
        model = ps2.build_model(args, payload["D"], torch.device("cpu"))
        model.load_state_dict({k: torch.tensor(v) for k, v in payload["sd"].items()})
        state, step, _ = ps2.make_trainer(args, torch.device("cpu"), payload["D"], model)
        seen = []
        update = state.opt_state.update
        state.opt_state.update = lambda g, *a: (seen.append([x.clone() for x in g]),
                                                update(g, *a))[1]
        batch = shard_batch({k: torch.tensor(v) for k, v in payload["batch"].items()},
                            data_mesh(args))
        state, m = step(state, batch, rng)
        out[name] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                     "grads": {k: g.numpy() for k, g in zip(state.params, seen[0])},
                     "params": {k: p.detach().numpy() for k, p in state.params.items()}}
    return out


def job_train_cli(rank, world, payload):
    """A trainer CLI (module name, argv) on this rank; rank 0 writes."""
    import importlib

    importlib.import_module(payload["module"]).main(payload["argv"])
    return None


def job_sharded_checkpoint(rank, world, payload):
    """Every rank saves the same trees asynchronously; the directory's files."""
    import os

    import torch

    from interpolated_diffusion_tpu_torch.utils.checkpoint_sharded import (
        save_checkpoint_sharded, wait_for_async_saves)

    g = torch.Generator().manual_seed(0)
    params = {"lora": {f"w{i}": torch.randn(3, 2, generator=g) for i in range(5)},
              "frame_cond": {"b": torch.randn(4, generator=g)}}
    ema = {"lora": {f"w{i}": torch.randn(3, 2, generator=g) for i in range(5)},
           "frame_cond": {"b": torch.randn(4, generator=g)}}
    opt = {"count": 3, "adamw": {"state": {0: {"exp_avg": torch.randn(2, generator=g)}},
                                 "param_groups": [{"lr": 1e-3, "params": [0]}]}}
    save_checkpoint_sharded(payload["path"], params, opt, 7, ema, {"stage": "x"},
                            async_save=True)
    wait_for_async_saves()
    return {"params": params, "ema": ema, "opt": opt,
            "files": sorted(os.listdir(payload["path"]))}


def _chunk(x, rank, world, dim):
    import torch

    return torch.tensor(x).chunk(world, dim=dim)[rank].contiguous()


def job_ring(rank, world, payload):
    """ring_self_attention on this rank's chunk of q, k, v [B, H, L, D]
    (causal and not): the output chunk and the gradients of sum(o * w)."""
    from interpolated_diffusion_tpu_torch.parallel.ring import ring_self_attention

    out = {}
    for causal in (False, True):
        q, k, v = (_chunk(payload[n], rank, world, 2).requires_grad_(True)
                   for n in ("q", "k", "v"))
        o = ring_self_attention(q, k, v, None, causal)
        (o * _chunk(payload["w"], rank, world, 2)).sum().backward()
        out[causal] = {"o": o.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
                       "dv": v.grad.numpy()}
    return out


def job_ring_sla(rank, world, payload):
    """Ring-SLA pieces on this rank's chunk of q, k, v [BH, L, D]: the global
    LUT of its query blocks, the block-sparse hops under the given global
    LUT, the linear branch, and the host entry's global output."""
    import torch

    from interpolated_diffusion_tpu_torch.parallel import ring_sla as rs

    bm, topk = payload["block"], payload["topk"]
    q, k, v = (_chunk(payload[n], rank, world, 1) for n in ("q", "k", "v"))
    lut = _chunk(payload["lut"], rank, world, 1).to(torch.int32)
    return {"lut": rs.ring_sla_block_map(q, k, None, topk, bm, bm).numpy(),
            "o_sparse": rs.ring_block_sparse_attention(q, k, v, lut, None, bm, bm).numpy(),
            "o_linear": rs.ring_linear_attention(q, k, v, None).numpy(),
            "o_host": rs.ring_sla_attention(torch.tensor(payload["q"]), torch.tensor(payload["k"]),
                                            torch.tensor(payload["v"]), None, topk, bm,
                                            bm).numpy()}


def job_causal_denoiser(rank, world, payload):
    """The causal Stage-2 denoiser sequence-sharded as causal ring attention:
    this rank's T / world frames with their global positions, gathered."""
    import torch

    from interpolated_diffusion_tpu_torch.models.denoisers import InterpLevelDenoiser
    from interpolated_diffusion_tpu_torch.parallel.collectives import all_gather

    m = InterpLevelDenoiser(**payload["kw"]).eval()
    m.load_state_dict({k: torch.tensor(v) for k, v in payload["sd"].items()})
    m.set_attn_impl("ring", None)
    T = payload["x"].shape[1]
    pos = torch.linspace(0.0, 1.0, T).chunk(world)[rank]
    with torch.no_grad():
        out = m(_chunk(payload["x"], rank, world, 1), torch.tensor(payload["s"]),
                _chunk(payload["mask"], rank, world, 1),
                {"cond_vec": torch.tensor(payload["cond_vec"])}, pos_frac=pos)
        return all_gather(out, None, dim=1).numpy()


def job_causal_pipeline(rank, world, payload):
    """sample/generate_causal.make_causal_pipeline with Stage 2 sharded over
    the world (seq_group), on seeded models and given draws."""
    import torch

    from interpolated_diffusion_tpu_torch.models.denoisers import (InterpLevelDenoiser,
                                                                   KeypointDenoiser)
    from interpolated_diffusion_tpu_torch.ops.schedules import make_schedule
    from interpolated_diffusion_tpu_torch.sample.generate_causal import make_causal_pipeline

    kp = KeypointDenoiser(**payload["kp_kw"]).eval()
    kp.load_state_dict({k: torch.tensor(v) for k, v in payload["kp_sd"].items()})
    it = InterpLevelDenoiser(**payload["it_kw"]).eval()
    it.load_state_dict({k: torch.tensor(v) for k, v in payload["it_sd"].items()})
    pipe = make_causal_pipeline(kp, it, make_schedule("linear", 100),
                                seq_group=torch.distributed.group.WORLD, **payload["kw"])
    with torch.no_grad():
        return pipe({k: torch.tensor(v) for k, v in payload["cond"].items()},
                    draws=payload["draws"]).numpy()


def job_pipeline(rank, world, payload):
    """parallel/pp.pipeline_blocks over the world on a stack of residual tanh
    layers, a head after it: output, the loss's gradients of x, of the head
    and of this rank's stage."""
    import torch

    from interpolated_diffusion_tpu_torch.parallel.pp import pipeline_blocks

    Ws = [torch.tensor(w, requires_grad=True) for w in payload["W"]]
    head = torch.tensor(payload["head"], requires_grad=True)
    x = torch.tensor(payload["x"], requires_grad=True)
    per = len(Ws) // world
    mine = Ws[rank * per:(rank + 1) * per]

    def stage_fn(h, c):
        for W in mine:
            h = h + torch.tanh(h @ W + c["shift"])
        return h

    shift = torch.tensor(payload["shift"], requires_grad=True)
    out = pipeline_blocks(stage_fn, x, {"shift": shift}, None, payload["M"])
    ((out @ head) ** 2).sum().backward()
    return {"out": out.detach().numpy(), "dx": x.grad.numpy(), "dhead": head.grad.numpy(),
            "dshift": shift.grad.numpy(), "dW": {rank * per + i: W.grad.numpy()
                                                  for i, W in enumerate(mine)}}


def _wan(payload):
    import torch

    from interpolated_diffusion_tpu_torch.models.wan_dit import WanDiT

    m = WanDiT(**payload["cfg"]).eval()
    m.load_state_dict({k: torch.tensor(v) for k, v in payload["sd"].items()})
    return m, [torch.tensor(payload[k]) for k in ("lat", "t", "ctx")]


def job_wan_pp(rank, world, payload):
    """models/wan_pp: the stage's blocks only (keep_stage), the block stack
    pipelined over the world; output and the gradients of mean(out^2) of
    this rank's blocks and of the replicated head and embeds."""
    from interpolated_diffusion_tpu_torch.models.wan_pp import keep_stage, wan_pp_apply

    m, (lat, t, ctx) = _wan(payload)
    keep_stage(m, None)
    out = wan_pp_apply(m, lat, t, ctx, group=None, n_microbatches=payload["M"])
    (out ** 2).mean().backward()
    return {"out": out.detach().numpy(),
            "grads": {k: p.grad.numpy() for k, p in m.named_parameters()
                      if p.grad is not None}}


def job_tensor_parallel(rank, world, payload):
    """One train step of a WanDiT under parallel/tp on a (data 1, model
    world) mesh: loss, grad norm and the params after, gathered whole."""
    import torch

    from interpolated_diffusion_tpu_torch.parallel.collectives import all_gather
    from interpolated_diffusion_tpu_torch.parallel.mesh import make_mesh
    from interpolated_diffusion_tpu_torch.parallel.tp import apply_tp
    from interpolated_diffusion_tpu_torch.train.state import (init_train_state, make_optimizer,
                                                              make_train_step)

    m, (lat, t, ctx) = _wan(payload)
    mesh = make_mesh(n_data=1, n_model=world)
    apply_tp(m, mesh.model_group)
    params = dict(m.named_parameters())
    state = init_train_state(params, make_optimizer(1e-3), use_ema=False)
    step = make_train_step(lambda p, b, rng: ((m(b["lat"], b["t"], b["ctx"]) ** 2).mean(), {}),
                           mesh=mesh)
    state, metrics = step(state, {"lat": lat, "t": t, "ctx": ctx}, None)
    whole = {k: (all_gather(p.detach(), mesh.model_group, p.tp_dim)
                 if getattr(p, "tp_dim", None) is not None else p.detach()).numpy()
             for k, p in state.params.items()}
    return {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "params": whole, "split": sorted(k for k, p in params.items()
                                             if getattr(p, "tp_dim", None) is not None)}


if __name__ == "__main__":
    _main()
