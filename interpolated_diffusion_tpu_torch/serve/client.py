"""Minimal stdlib client for the serving front-end (port of serve/client.py;
it speaks to serve/server.py of either package).

    from interpolated_diffusion_tpu_torch.serve.client import GenerationClient
    c = GenerationClient("127.0.0.1", 8787)
    c.health()                       # {"ok": True, "T": 64, ...}
    out = c.generate([[0.1, 0.1, 0.9, 0.9]])
    out["refined"].shape             # (1, T, D) numpy

Also usable as a CLI smoke tool:
    python -m interpolated_diffusion_tpu_torch.serve.client --port 8787 \
        --start 0.1 0.1 --goal 0.9 0.9
"""
from __future__ import annotations

import argparse
import json
from http.client import HTTPConnection
from typing import Dict, Optional, Sequence

import numpy as np


class GenerationClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 8787,
                 timeout_s: float = 120.0):
        self.host, self.port, self.timeout_s = host, port, timeout_s

    def _request(self, method: str, path: str,
                 body: Optional[dict] = None) -> dict:
        conn = HTTPConnection(self.host, self.port, timeout=self.timeout_s)
        try:
            payload = json.dumps(body) if body is not None else None
            conn.request(method, path, payload,
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = json.loads(resp.read())
            if resp.status != 200:
                raise RuntimeError(
                    f"{method} {path} -> {resp.status}: "
                    f"{data.get('error', data)}")
            return data
        finally:
            conn.close()

    def health(self) -> dict:
        return self._request("GET", "/healthz")

    def generate(
        self,
        start_goal: Sequence[Sequence[float]],
        occ: Optional[np.ndarray] = None,
        sdf: Optional[np.ndarray] = None,
        seed: int = 0,
    ) -> Dict[str, np.ndarray]:
        req: dict = {"start_goal": np.asarray(start_goal, np.float32).tolist(),
                     "seed": int(seed)}
        if occ is not None:
            req["occ"] = np.asarray(occ, np.float32).tolist()
        if sdf is not None:
            req["sdf"] = np.asarray(sdf, np.float32).tolist()
        out = self._request("POST", "/generate", req)
        return {k: (np.asarray(v, np.float32) if isinstance(v, list) else v)
                for k, v in out.items()}


def main(argv=None):
    p = argparse.ArgumentParser("serving client smoke")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8787)
    p.add_argument("--start", type=float, nargs=2, default=[0.1, 0.1])
    p.add_argument("--goal", type=float, nargs=2, default=[0.9, 0.9])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    c = GenerationClient(args.host, args.port)
    print(json.dumps(c.health()))
    out = c.generate([args.start + args.goal], seed=args.seed)
    x = out["refined"]
    print(f"refined {x.shape}: start={x[0, 0, :2].round(3).tolist()} "
          f"end={x[0, -1, :2].round(3).tolist()} "
          f"coalesced={out.get('coalesced_requests')}")


if __name__ == "__main__":
    main()
