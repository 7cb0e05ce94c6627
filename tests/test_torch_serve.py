"""The port's serving layer (serve/service.py, serve/server.py,
serve/client.py) and its plots (eval/visualize.py, the sampling CLI's
--save_plots / --save_steps) on the CPU.

Tiny seeded checkpoints in the port's format (the trainers' metas; d 32,
2 layers, T=32, K=4, 2 levels) and the same weights as JAX checkpoints
(models/torch_import.convert_state_dict):
  * the service chooses the JAX GenerationService's anchor indices for the
    same seed and policy (the same host RandomState), pads to the same
    bucket, and its output is the port's make_pipeline on the service's own
    draws (a torch.Generator seeded by the seed, through make_draws), to
    f32 equality;
  * the HTTP server (in-process, an ephemeral port on 127.0.0.1, every socket
    wait under a timeout) coalesces concurrent requests of one seed, speaks
    the JAX server's JSON, and the client round-trips (tests/test_serve.py's
    cases, which skip here without runs/maze_q10k).
"""
import json
import os
import sys
import threading
from http.client import HTTPConnection

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu.models.torch_import import convert_state_dict
from interpolated_diffusion_tpu.serve.service import GenerationService as JService
from interpolated_diffusion_tpu.utils import checkpoint as jckpt
from interpolated_diffusion_tpu_torch.models.loading import load_interp_model, load_keypoint_model
from interpolated_diffusion_tpu_torch.ops.schedules import make_schedule
from interpolated_diffusion_tpu_torch.sample import generate
from interpolated_diffusion_tpu_torch.serve import client as pclient
from interpolated_diffusion_tpu_torch.serve import server as pserver
from interpolated_diffusion_tpu_torch.serve.service import GenerationService
from interpolated_diffusion_tpu_torch.train import train_interp_levels, train_keypoints
from interpolated_diffusion_tpu_torch.utils.checkpoint import save_checkpoint

T, K, G = 32, 4, 9
NET = ["--T", str(T), "--d_model", "32", "--n_layers", "2", "--n_heads", "2", "--d_ff", "64",
       "--d_cond", "16", "--maze_channels", "8,8", "--maze_h", str(G), "--maze_w", str(G),
       "--bf16", "0", "--device", "cpu"]
TIMEOUT = 60


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Seeded Stage-1 / Stage-2 checkpoints (port and JAX) with a non-zero
    Stage-2 head, so that Stage 2 acts."""
    root = tmp_path_factory.mktemp("serve")
    out = {"root": root}
    for name, mod, flags, kind in (
            ("kp", train_keypoints, ["--K", str(K), "--N_train", "20"], "keypoint"),
            ("il", train_interp_levels, ["--K_min", str(K), "--levels", "2"], "interp")):
        args = mod.build_argparser().parse_args(NET + flags)
        model = mod.build_model(args, 2, torch.device("cpu"))
        if name == "il":
            with torch.no_grad():
                model.out.weight.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(1))
        sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
        meta = mod.make_meta(args, 2)
        save_checkpoint(str(root / name / "ckpt_1"), sd, None, 1, sd, meta)
        conv = jax.tree.map(jnp.asarray, convert_state_dict({k: v.numpy() for k, v in sd.items()},
                                                            kind))
        jckpt.save_checkpoint(str(root / f"j_{name}" / "ckpt_1"), conv, None, 1, conv, meta)
        out[name], out[f"j_{name}"] = str(root / name), str(root / f"j_{name}")
    return out


@pytest.fixture(scope="module")
def service(ckpts):
    svc = GenerationService(ckpts["kp"], ckpts["il"], ddim_steps=3, buckets=(1, 4, 8),
                            bf16=False, device="cpu", attn_policy="block")
    svc.set_default_grid((np.random.default_rng(0).uniform(size=(G, G)) < 0.2).astype(np.float32))
    svc.warmup()
    return svc


def _requests(n, seed=0):
    r = np.random.default_rng(seed)
    return (r.uniform(0.05, 0.95, size=(n, 4)).astype(np.float32),
            (r.uniform(size=(n, 1, G, G)) < 0.2).astype(np.float32))


@pytest.mark.parametrize("policy", ["uniform:1.0", "random:0.5,uniform:0.5"])
def test_service_chooses_the_jax_services_anchors(ckpts, policy):
    """The same seed and policy give the JAX service's anchor indices, bucket
    and shapes; the samples are another draw (torch.Generator, not JAX's
    PRNG), both finite with the start / goal clamped."""
    kw = dict(ddim_steps=3, buckets=(1, 4, 8), bf16=False, idx_policy=policy)
    ours = GenerationService(ckpts["kp"], ckpts["il"], device="cpu", **kw)
    theirs = JService(ckpts["j_kp"], ckpts["j_il"], **kw)
    sg, occ = _requests(3, seed=1)
    for seed in (0, 7):
        a = ours.generate(sg, occ, seed=seed)
        b = theirs.generate(sg, occ, seed=seed)
        assert set(a) == set(b) and a["served_batch"] == b["served_batch"] == 4
        np.testing.assert_array_equal(a["idx"], b["idx"])
        assert a["idx"].dtype == b["idx"].dtype
        for k in ("interp", "refined", "keypoints"):
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
            assert np.isfinite(a[k]).all()
        np.testing.assert_allclose(a["refined"][:, 0, :2], sg[:, :2], atol=1e-6)
        np.testing.assert_allclose(a["refined"][:, -1, :2], sg[:, 2:], atol=1e-6)


def test_service_is_make_pipeline_on_its_own_draws(ckpts, service):
    """A request of B=3 is served at bucket 4: the first 3 rows of the port's
    make_pipeline on the padded batch and the service's own draws."""
    sg, occ = _requests(3, seed=2)
    timing = {}
    out = service.generate(sg, occ, seed=5, timing=timing)
    assert out["served_batch"] == 4 and timing["served_batch"] == 4
    assert set(timing) == {"prep_s", "put_s", "dispatch_s", "pull_s", "served_batch"}
    assert all(timing[k] >= 0 for k in timing)
    kp, kp_meta = load_keypoint_model(ckpts["kp"], bf16=False, device="cpu")
    it, _ = load_interp_model(ckpts["il"], bf16=False, device="cpu")
    for m in (kp, it):
        m.set_attn_policy("block")
    pipe = generate.make_pipeline(kp, it, make_schedule(kp_meta["schedule"],
                                                       int(kp_meta["N_train"])), service.cfg, 2)
    pad = lambda a: torch.as_tensor(np.concatenate([a, a[-1:]]))
    idx = _idx(5)
    np.testing.assert_array_equal(out["idx"], idx[:3])
    want = pipe(torch.as_tensor(idx).long(), {"occ": pad(occ), "start_goal": pad(sg)},
                **service.draws(4, 5))
    for k, w in zip(("interp", "refined", "keypoints"), want):
        np.testing.assert_array_equal(out[k], w[:3].numpy(), err_msg=k)
    # the default grid serves grid-less requests; a shared grid broadcasts
    out1 = service.generate(sg[:1], seed=1)
    assert out1["served_batch"] == 1 and out1["refined"].shape == (1, T, 2)
    shared = service.generate(sg, occ[:1], seed=5)
    assert shared["refined"].shape == (3, T, 2)
    with pytest.raises(ValueError, match="largest bucket"):
        service.generate(np.tile(sg, (3, 1)), seed=0)
    with pytest.raises(ValueError, match="does not match"):
        service.generate(sg, occ[:2], seed=0)


def _idx(seed):
    """The service's anchors for a served batch of 4 under `seed`."""
    from interpolated_diffusion_tpu_torch.train.common import sample_idx_policy

    return sample_idx_policy(np.random.RandomState(seed), "uniform:1.0", 4, T, K, None, 0.0)


def test_service_defaults_to_the_card(ckpts):
    import inspect

    assert inspect.signature(GenerationService).parameters["device"].default == "cuda"
    assert inspect.signature(GenerationService).parameters["attn_policy"].default == "fused"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GenerationService(ckpts["kp"], ckpts["il"])


def _serving(service, linger_s):
    server, batcher = pserver.serve(service, "127.0.0.1", 0, linger_s=linger_s)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, batcher, server.server_address[1]


def _stop(server, batcher):
    server.shutdown()
    server.server_close()
    batcher.running = False
    batcher.join(timeout=5)


def _post(port, body, path="/generate"):
    conn = HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def test_http_server_coalesces_concurrent_requests(service):
    server, batcher, port = _serving(service, linger_s=0.3)
    try:
        results = []
        lock = threading.Lock()

        def post(i):
            out = _post(port, {"start_goal": [[0.2, 0.2, 0.8, 0.8 - 0.01 * i]], "seed": 11})
            with lock:
                results.append(out)

        threads = [threading.Thread(target=post, args=(i,)) for i in range(6)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=TIMEOUT)
        assert len(results) == 6 and all(s == 200 for s, _ in results), results
        for _, payload in results:
            assert set(payload) == {"interp", "refined", "keypoints", "idx", "served_batch",
                                    "coalesced_requests"}
            assert np.asarray(payload["refined"]).shape == (1, T, 2)
            assert np.asarray(payload["idx"]).shape == (1, K)
        assert max(p["coalesced_requests"] for _, p in results) >= 2
        # other seeds never share a dispatch
        status, alone = _post(port, {"start_goal": [[0.3, 0.3, 0.7, 0.7]], "seed": 12})
        assert status == 200 and alone["coalesced_requests"] == 1
        # errors: unknown paths, a malformed body, a batch over the top bucket
        assert _post(port, {}, "/nope")[0] == 404
        assert _post(port, {"seed": 1})[0] == 400
        status, err = _post(port, {"start_goal": [[0.1, 0.1, 0.9, 0.9]] * 9})
        assert status == 500 and "largest bucket" in err["error"]
        conn = HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
        conn.request("GET", "/healthz")
        h = json.loads(conn.getresponse().read())
        conn.close()
        assert h == {"ok": True, "T": T, "K": K, "data_dim": 2, "buckets": [1, 4, 8],
                     "use_sdf": False}
    finally:
        _stop(server, batcher)


def test_client_roundtrip(service, capsys):
    server, batcher, port = _serving(service, linger_s=0.01)
    try:
        c = pclient.GenerationClient("127.0.0.1", port, timeout_s=TIMEOUT)
        assert c.health()["ok"]
        sg, occ = _requests(1, seed=3)
        out = c.generate(sg, occ=occ[0, 0], seed=5)
        assert out["refined"].shape == (1, T, 2) and out["idx"].shape == (1, K)
        assert out["served_batch"] == 1 and out["coalesced_requests"] == 1
        direct = service.generate(sg, occ[:1], seed=5)
        np.testing.assert_allclose(out["refined"], direct["refined"], atol=1e-6)
        with pytest.raises(RuntimeError, match="404"):
            c._request("GET", "/nope")
        pclient.main(["--port", str(port), "--seed", "2"])
        assert "coalesced=1" in capsys.readouterr().out
    finally:
        _stop(server, batcher)


# --- plots ----------------------------------------------------------------------

def test_visualize_writes_pngs(tmp_path):
    pytest.importorskip("matplotlib")
    from interpolated_diffusion_tpu_torch.eval import visualize

    r = np.random.default_rng(0)
    occ = (r.uniform(size=(3, 1, G, G)) < 0.2).astype(np.float32)
    trajs = r.uniform(size=(3, T, 2)).astype(np.float32)
    sg = r.uniform(size=(3, 4)).astype(np.float32)
    paths = [visualize.plot_occupancy_trajectories(occ[0], [trajs[0], trajs[1]], ["a", "b"],
                                                   trajs[0, ::8], sg[0], str(tmp_path / "o.png"),
                                                   flip_y=True, title="t"),
             visualize.plot_wall_polygons([(0.1, 0.1, 0.3, 0.2)], [trajs[0]], ["a"],
                                          out_path=str(tmp_path / "w.png")),
             visualize.save_sample_grid(occ, {"x": trajs, "y": trajs}, str(tmp_path / "g.png"),
                                        sg)]
    for p in paths:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_plots_need_matplotlib_and_name_it(monkeypatch):
    from interpolated_diffusion_tpu_torch.eval import visualize

    import subprocess

    # importing the sampler and the plot module loads no plotting package
    code = ("import sys, interpolated_diffusion_tpu_torch.sample.generate, "
            "interpolated_diffusion_tpu_torch.eval.visualize; "
            "sys.exit(int('matplotlib' in sys.modules or 'PIL' in sys.modules))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert subprocess.run([sys.executable, "-c", code], cwd=root, timeout=120).returncode == 0
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        visualize.plot_occupancy_trajectories(np.zeros((G, G)), [np.zeros((T, 2))])


def test_cli_save_plots_and_steps(ckpts, tmp_path):
    """--save_plots 2 --save_steps 1 on the CPU: two sample PNGs, one frame
    per Stage-1 step and Stage-2 level, and the GIF."""
    pytest.importorskip("matplotlib")
    pytest.importorskip("PIL")
    out_dir = str(tmp_path / "s")
    generate.main(["--kp_ckpt", ckpts["kp"], "--interp_ckpt", ckpts["il"], "--device", "cpu",
                   "--batch", "4", "--num_batches", "1", "--num_samples", "32", "--maze_h",
                   str(G), "--maze_w", str(G), "--bf16", "0", "--ddim_steps", "3",
                   "--save_plots", "2", "--save_steps", "1", "--out_dir", out_dir])
    assert sorted(os.listdir(os.path.join(out_dir, "plots"))) == ["sample_000.png",
                                                                  "sample_001.png"]
    # the states after the 2 DDIM transitions of 3 timesteps + the 2 Stage-2 levels
    assert len(os.listdir(os.path.join(out_dir, "steps"))) == 4
    with open(os.path.join(out_dir, "diffusion_steps.gif"), "rb") as f:
        assert f.read(3) == b"GIF"
