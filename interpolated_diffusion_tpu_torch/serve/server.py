"""HTTP serving front-end with linger-based request batching (port of
serve/server.py; standard library and numpy only).

Concurrent clients post independent (start, goal) requests; a batcher
thread coalesces whatever arrives within a linger window (default 20 ms)
into ONE padded pipeline call: the marginal cost of a larger bucket is far
below a call per request, so coalescing multiplies throughput at a bounded
latency cost. Requests with different grid shapes, SDF presence or seeds
never batch together.

Endpoints (JSON):
  POST /generate  {"start_goal": [[x0,y0,xg,yg], ...], "occ": [[...]]?,
                   "seed": int?} -> {"refined": ..., "interp": ...,
                   "keypoints": ..., "idx": ..., "served_batch": N}
  GET  /healthz   service/bucket/grid info

Run:  python -m interpolated_diffusion_tpu_torch.serve.server \
          --kp_ckpt runs/kp --interp_ckpt runs/il \
          --prepared_path runs/prep/dp.npz --port 8787 [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ..kernels.tuning import add_attn_policy_arg
from .service import GenerationService


class _Pending:
    __slots__ = ("start_goal", "occ", "sdf", "seed", "event", "result", "error")

    def __init__(self, start_goal, occ, sdf, seed):
        self.start_goal, self.occ, self.sdf = start_goal, occ, sdf
        self.seed = seed
        self.event = threading.Event()
        self.result = None
        self.error: Optional[str] = None


class RequestBatcher(threading.Thread):
    """Coalesce requests arriving within `linger_s` into one dispatch."""

    def __init__(self, service: GenerationService, linger_s: float = 0.02):
        super().__init__(daemon=True)
        self.service = service
        self.linger_s = linger_s
        self.q: "queue.Queue[_Pending]" = queue.Queue()
        self.running = True

    def submit(self, pending: _Pending) -> None:
        self.q.put(pending)

    def _grid_key(self, p: _Pending):
        # requests only share a dispatch when their conditioning composes:
        # same occ shape (or both server-default), same sdf presence, same
        # seed (one seed per dispatch)
        return (None if p.occ is None else p.occ.shape[-2:],
                p.sdf is not None, p.seed)

    def run(self) -> None:
        while self.running:
            try:
                first = self.q.get(timeout=0.2)
            except queue.Empty:
                continue
            group = [first]
            deadline = time.time() + self.linger_s
            max_b = self.service.buckets[-1]
            while time.time() < deadline:
                have = sum(p.start_goal.shape[0] for p in group)
                if have >= max_b:
                    break
                try:
                    nxt = self.q.get(timeout=max(0.0, deadline - time.time()))
                except queue.Empty:
                    break
                # only composable requests share a dispatch, and never past
                # the top bucket (each request must still fit after concat)
                if (self._grid_key(nxt) == self._grid_key(first)
                        and have + nxt.start_goal.shape[0] <= max_b):
                    group.append(nxt)
                else:
                    self.q.put(nxt)
                    break
            self._dispatch(group)

    def _dispatch(self, group) -> None:
        try:
            sg = np.concatenate([p.start_goal for p in group])
            occ = (None if group[0].occ is None
                   else np.concatenate([p.occ for p in group]))
            sdf = (np.concatenate([p.sdf for p in group])
                   if group[0].sdf is not None else None)
            out = self.service.generate(sg, occ, sdf, seed=group[0].seed)
            ofs = 0
            for p in group:
                n = p.start_goal.shape[0]
                p.result = {k: (v[ofs:ofs + n] if isinstance(v, np.ndarray)
                                else v)
                            for k, v in out.items()}
                p.result["coalesced_requests"] = len(group)
                ofs += n
                p.event.set()
        except Exception as e:  # surface server-side errors to every waiter
            for p in group:
                p.error = f"{type(e).__name__}: {e}"
                p.event.set()


def make_handler(batcher: RequestBatcher, service: GenerationService,
                 timeout_s: float = 120.0):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                return self._send(404, {"error": "unknown path"})
            self._send(200, {
                "ok": True, "T": service.T, "K": service.K,
                "data_dim": service.data_dim, "buckets": service.buckets,
                "use_sdf": service.use_sdf,
            })

        def do_POST(self):
            if self.path != "/generate":
                return self._send(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                sg = np.asarray(req["start_goal"], np.float32)

                def grid(key):
                    if key not in req:
                        return None
                    g = np.asarray(req[key], np.float32)
                    return g[None] if g.ndim == 2 else g   # [H,W] → [1,H,W]

                occ, sdf = grid("occ"), grid("sdf")
                pending = _Pending(np.atleast_2d(sg), occ, sdf,
                                   int(req.get("seed", 0)))
            except (KeyError, ValueError, json.JSONDecodeError) as e:
                return self._send(400, {"error": str(e)})
            batcher.submit(pending)
            if not pending.event.wait(timeout_s):
                return self._send(504, {"error": "generation timed out"})
            if pending.error:
                return self._send(500, {"error": pending.error})
            out = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                   for k, v in pending.result.items()}
            self._send(200, out)

    return Handler


def serve(service: GenerationService, host: str = "127.0.0.1",
          port: int = 8787, linger_s: float = 0.02):
    """Start batcher + HTTP server; returns (server, batcher) — call
    server.serve_forever() (blocking) or drive it from a thread in tests."""
    batcher = RequestBatcher(service, linger_s)
    batcher.start()
    server = ThreadingHTTPServer((host, port),
                                 make_handler(batcher, service))
    return server, batcher


def main(argv=None):
    p = argparse.ArgumentParser("interpolated_diffusion_tpu_torch serving")
    p.add_argument("--kp_ckpt", type=str, required=True)
    p.add_argument("--interp_ckpt", type=str, required=True)
    p.add_argument("--dphi_ckpt", type=str, default="")
    p.add_argument("--prepared_path", type=str, default="",
                   help="prepared npz whose first sample provides the "
                        "default occupancy grid (+sdf) for grid-less "
                        "requests, and the warmup shapes")
    p.add_argument("--ddim_steps", type=int, default=20)
    p.add_argument("--stage1_solver", type=str, default="ddim",
                   choices=["ddim", "pfdiff"])
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; no fallback when there is no GPU) or cpu")
    add_attn_policy_arg(p)
    p.add_argument("--stage1_best_of", type=int, default=1)
    p.add_argument("--buckets", type=str, default="1,4,16,64")
    p.add_argument("--idx_policy", type=str, default="uniform:1.0")
    p.add_argument("--linger_ms", type=float, default=20.0)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8787)
    p.add_argument("--bf16", type=int, default=1)
    args = p.parse_args(argv)

    service = GenerationService(
        args.kp_ckpt, args.interp_ckpt, dphi_ckpt=args.dphi_ckpt,
        ddim_steps=args.ddim_steps, stage1_solver=args.stage1_solver,
        stage1_best_of=args.stage1_best_of,
        idx_policy=args.idx_policy,
        buckets=[int(b) for b in args.buckets.split(",")],
        bf16=bool(args.bf16), device=args.device, attn_policy=args.attn_policy)
    if args.prepared_path:
        with np.load(args.prepared_path) as f:
            occ = f["occ"][0]
            sdf = f["sdf"][0] if "sdf" in f.files else None
        service.set_default_grid(occ, sdf)
    print("warming buckets", service.buckets, flush=True)
    service.warmup()
    server, _ = serve(service, args.host, args.port,
                      linger_s=args.linger_ms / 1e3)
    print(f"serving on http://{args.host}:{args.port}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
