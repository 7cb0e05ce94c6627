"""The D4RL maze2d data route and the native tar reader of the port against
the JAX package, bit for bit: data/d4rl.py (maze specs, windowing with its
rejection tests, the unified grid, both CLIs), data/maze2d_synth.py (the
gym-free episode synthesiser on the port's A*), data/mujoco_walls.py and
data/d4rl_live.py (on stand-in env and dataset objects; the export refuses
without gym with the JAX module's message), and data/native_tar.py (the
native reader's yields against tarfile's and against the JAX reader's; the
dispatch of data/wan_synth.iter_tar_samples, IDT_NATIVE_TAR=0 included).
Everything here is numpy, so the arrays must be equal, not close.
"""
import io
import tarfile

import jax
import numpy as np
import pytest
import torch

from interpolated_diffusion_tpu.data import d4rl as jd4rl
from interpolated_diffusion_tpu.data import d4rl_live as jlive
from interpolated_diffusion_tpu.data import maze2d_synth as jsynth
from interpolated_diffusion_tpu.data import mujoco_walls as jwalls
from interpolated_diffusion_tpu.data import native_tar as jtar
from interpolated_diffusion_tpu_torch.data import d4rl as pd4rl
from interpolated_diffusion_tpu_torch.data import d4rl_live as plive
from interpolated_diffusion_tpu_torch.data import maze2d_synth as psynth
from interpolated_diffusion_tpu_torch.data import mujoco_walls as pwalls
from interpolated_diffusion_tpu_torch.data import native_tar as ptar
from interpolated_diffusion_tpu_torch.data import wan_synth as pws
from test_torch_interpolators import jparams


def _same(a, b):
    """Equal trees of arrays (dtype, shape and every bit)."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
        return
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def episodes():
    occ = jd4rl.maze_map_to_occ(jd4rl.MAZE_SPECS["maze2d-medium-v1"])
    return occ, jsynth.simulate_episodes(occ, 12, max_steps=160, seed=3)


# --- maze specs and episode handling ------------------------------------------------

def test_maze_specs_and_occupancy_match_jax():
    assert pd4rl.MAZE_SPECS == jd4rl.MAZE_SPECS
    for spec in jd4rl.MAZE_SPECS.values():
        _same(pd4rl.parse_maze_spec(spec), jd4rl.parse_maze_spec(spec))
        _same(pd4rl.maze_map_to_occ(spec), jd4rl.maze_map_to_occ(spec))
    r = np.random.default_rng(0)
    for arr in (r.integers(0, 2, (7, 9)), r.integers(10, 13, (6, 5)), r.integers(0, 5, (4, 4))):
        _same(pd4rl.maze_map_to_occ(arr), jd4rl.maze_map_to_occ(arr))
    with pytest.raises(ValueError, match="Unsupported"):
        pd4rl.maze_map_to_occ(np.zeros(3))


def test_split_and_normalize_match_jax(episodes):
    occ, (obs, terms, touts) = episodes
    _same(pd4rl.split_episodes(terms, touts), jd4rl.split_episodes(terms, touts))
    _same(pd4rl.split_episodes(terms), jd4rl.split_episodes(terms))
    for flip in (False, True):
        _same(pd4rl.normalize_positions(obs[:, :2], occ, flip),
              jd4rl.normalize_positions(obs[:, :2], occ, flip))


@pytest.mark.parametrize("kw", [
    dict(window_mode="end"),
    dict(window_mode="random", with_velocity=True),
    dict(window_mode="episode", with_velocity=True, vel_mode="obs", flip_y=True),
    dict(window_mode="random", with_velocity=True, vel_mode="obs", max_collision_rate=0.0,
         min_goal_dist=0.2, min_path_len=0.3, min_tortuosity=1.05, min_turns=1,
         turn_angle_deg=20.0, max_resample_tries=8),
])
def test_window_episodes_matches_jax(episodes, kw):
    occ, (obs, terms, touts) = episodes
    for T in (16, 128):     # 128 is longer than most episodes: the linspace route
        args = (obs, terms, occ, T, 24, touts)
        _same(pd4rl.window_episodes(*args, seed=5, **kw), jd4rl.window_episodes(*args, seed=5, **kw))


def test_rejecting_everything_raises_as_jax(episodes):
    occ, (obs, terms, touts) = episodes
    for mod in (pd4rl, jd4rl):
        with pytest.raises(ValueError, match="rejected everything"):
            mod.window_episodes(obs, terms, occ, 16, 4, touts, min_goal_dist=10.0,
                                max_resample_tries=2)


def test_synthesiser_and_clis_match_jax(tmp_path):
    """maze2d_synth, then d4rl's prepared and unified CLIs, through each
    package's main: the files hold the same arrays."""
    occ = pd4rl.maze_map_to_occ(pd4rl.MAZE_SPECS["maze2d-large-v1"])
    _same(psynth.simulate_episodes(occ, 6, max_steps=120, seed=9),
          jsynth.simulate_episodes(occ, 6, max_steps=120, seed=9))
    out = {}
    for name, synth, d4 in (("p", psynth, pd4rl), ("j", jsynth, jd4rl)):
        ep, d = str(tmp_path / f"{name}_ep.npz"), {}
        synth.main(["--env_id", "maze2d-large-v1", "--n_episodes", "10", "--max_steps", "200",
                    "--seed", "2", "--out_path", ep])
        for env, flags in (("maze2d-large-v1", ["--T", "128", "--with_velocity", "1"]),
                           ("maze2d-umaze-v1", ["--T", "32", "--window_mode", "random",
                                                "--use_sdf", "1", "--max_collision_rate", "1"])):
            prep = str(tmp_path / f"{name}_{env}.npz")
            d4.main(["--episodes", ep, "--env_id", env, "--num_samples", "20", "--seed", "4",
                     "--out_path", prep] + flags)
            d[env] = _npz(prep)
        umaze = str(tmp_path / f"{name}_maze2d-umaze-v1.npz")
        uni = str(tmp_path / f"{name}_uni.npz")
        d4.main_unified(["--inputs", umaze, umaze, "--out_path", uni, "--seed", "1"])
        d["unified"] = _npz(uni)
        out[name] = d
    _same(out["p"], out["j"])
    assert out["p"]["maze2d-large-v1"]["x"].shape == (20, 128, 4)
    # an episodes file without a maze layout and an unknown env raises
    bare = str(tmp_path / "bare.npz")
    np.savez(bare, observations=np.zeros((4, 4), np.float32), terminals=np.zeros(4, bool))
    with pytest.raises(ValueError, match="no maze_map"):
        pd4rl.main(["--episodes", bare, "--env_id", "maze2d-open-v0", "--out_path",
                    str(tmp_path / "x.npz")])


def test_build_unified_pads_two_layouts_as_jax(tmp_path):
    paths = []
    for i, env in enumerate(("maze2d-umaze-v1", "maze2d-large-v1")):
        occ = jd4rl.maze_map_to_occ(jd4rl.MAZE_SPECS[env])
        obs, terms, touts = jsynth.simulate_episodes(occ, 6, max_steps=150, seed=i)
        data = jd4rl.window_episodes(obs, terms, occ, 24, 10, touts, with_velocity=True, seed=i)
        paths.append(str(tmp_path / f"{i}.npz"))
        np.savez(paths[-1], **data)
    for sdf in (True, False):
        _same(pd4rl.build_unified(paths, sdf, 3), jd4rl.build_unified(paths, sdf, 3))


# --- MuJoCo walls and the live export -------------------------------------------------

def _geoms(n, seed, names=True, floor=True):
    r = np.random.default_rng(seed)
    q = r.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    size = r.uniform(0.1, 1.0, size=(n, 3)).astype(np.float32)
    types = np.full(n, jwalls.GEOM_BOX)
    types[1] = 2                                      # a sphere: never a wall
    nm = [f"wall_{i}" for i in range(n)]
    if floor:
        size[0] = (20.0, 20.0, 0.01)                  # a ground plane
        nm[0] = "floor"
    return types, size, r.normal(size=(n, 3)).astype(np.float32), q, (nm if names else None)


class _Model:
    def __init__(self, types, size, pos, quat, names):
        self.geom_type, self.geom_size, self.geom_pos, self.geom_quat = types, size, pos, quat
        self.ngeom = len(types)
        self.geom_names = [n.encode() for n in names] if names else None


class _Sim:
    def __init__(self, model):
        self.model = model


class _Env:
    """A stand-in gym env: a sim with a model, a maze layout and a dataset."""

    def __init__(self, model=None, via_sim=True, **attrs):
        if model is not None:
            if via_sim:
                self.sim = _Sim(model)
            else:
                self.model = model
        self.__dict__.update(attrs)


def test_mujoco_walls_match_jax():
    q = np.random.default_rng(0).normal(size=(5, 4)).astype(np.float32)
    _same(pwalls.quats_to_rotmats(q), jwalls.quats_to_rotmats(q))
    for seed, names, floor in ((0, True, True), (1, False, True), (2, True, False)):
        g = _geoms(9, seed, names, floor)
        _same(pwalls.walls_from_geom_arrays(*g), jwalls.walls_from_geom_arrays(*g))
        walls = pwalls.walls_from_geom_arrays(*g)
        _same(pwalls.walls_to_boxes(walls), jwalls.walls_to_boxes(walls))
        for via_sim in (True, False):
            env = _Env(_Model(*g), via_sim)
            _same(pwalls.walls_from_env(env), jwalls.walls_from_env(env))
    assert pwalls.walls_from_geom_arrays(np.zeros(0), np.zeros((0, 3)), np.zeros((0, 3)),
                                         np.zeros((0, 4))) is None
    assert pwalls.walls_from_env(_Env()) is None


class _MazeObj:
    def __init__(self, maze_map):
        self.maze_map = maze_map


def test_live_export_matches_jax():
    spec = jd4rl.MAZE_SPECS["maze2d-umaze-v1"]
    arr = jd4rl.parse_maze_spec(spec)
    g = _geoms(6, 4)
    obs = np.random.default_rng(1).normal(size=(30, 4))
    dones = np.zeros(30, bool)
    dones[[9, 19]] = True
    cases = [
        (_Env(_Model(*g), str_maze_spec=spec, maze_size_scaling=4.0),
         {"observations": obs, "terminals": dones, "timeouts": ~dones}),
        (_Env(maze=_MazeObj(arr), maze_size_scale=2), {"observations": obs, "dones": dones}),
        (_Env(maze_arr=arr.tolist()), {"observations": obs}),
    ]
    for env, data in cases:
        assert type(plive.extract_maze_map(env)) is type(jlive.extract_maze_map(env))
        _same(plive.extract_maze_map(env), jlive.extract_maze_map(env))
        _same(plive.export_episodes(env, data), jlive.export_episodes(env, data))
    env = _Env()
    env.get_dataset = lambda: {"observations": obs, "terminals": dones}
    env.get_maze_map = lambda: arr
    _same(plive.export_episodes(env), jlive.export_episodes(env))
    assert plive.extract_maze_map(_Env()) is None


def test_live_export_refuses_without_gym(tmp_path):
    try:
        import gym  # noqa: F401
        pytest.skip("gym is installed")
    except ImportError:
        pass
    msgs = []
    for mod in (plive, jlive):
        with pytest.raises(SystemExit) as e:
            mod.main(["--out_path", str(tmp_path / "x.npz")])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "gym/d4rl unavailable" in msgs[0]


# --- the native tar reader ------------------------------------------------------------

def _shards(tmp_path):
    """Two shards: Wan-shaped samples, and long keys (GNU longname / PAX
    members), f-ordered and 0-d arrays, a non-npy member, a directory."""
    ds = pws.SyntheticWanDataset(n_samples=5, T=5, C=4, H=8, W=8, text_len=3, text_dim=16, seed=0)
    a = str(tmp_path / "a.tar")
    pws.write_tar_shard(a, [{"__key__": f"{i:08d}", **ds.get(i)} for i in range(5)])
    b = str(tmp_path / "b.tar")
    r = np.random.default_rng(2)
    with tarfile.open(b, "w", format=tarfile.GNU_FORMAT) as tf:
        dir_info = tarfile.TarInfo("sub")
        dir_info.type = tarfile.DIRTYPE
        tf.addfile(dir_info)
        for i, key in enumerate(["k" * 120, "short", "x.y" * 50]):
            for field, arr in (("a", r.normal(size=(3, 4)).astype(np.float32)),
                               ("f", np.asfortranarray(r.normal(size=(2, 5)))),
                               ("s", np.int64(i)), ("u", r.integers(0, 9, 7).astype(np.uint8))):
                buf = io.BytesIO()
                np.save(buf, arr)
                info = tarfile.TarInfo(f"sub/{key}.{field}.npy")
                info.size = len(buf.getvalue())
                tf.addfile(info, io.BytesIO(buf.getvalue()))
            info = tarfile.TarInfo(f"sub/{key}.json")
            info.size = 2
            tf.addfile(info, io.BytesIO(b"{}"))
    c = str(tmp_path / "c.tar")
    with tarfile.open(c, "w", format=tarfile.PAX_FORMAT) as tf:
        for key in ("p" * 150, "q"):
            buf = io.BytesIO()
            np.save(buf, np.arange(6, dtype=np.float16).reshape(2, 3))
            info = tarfile.TarInfo(f"{key}.v.npy")
            info.size = len(buf.getvalue())
            tf.addfile(info, io.BytesIO(buf.getvalue()))
    return [a, b, c]


def _read(path, monkeypatch, native):
    monkeypatch.setenv("IDT_NATIVE_TAR", "1" if native else "0")
    return list(pws.iter_tar_samples(path))


def test_native_tar_yields_equal_tarfile_and_jax(tmp_path, monkeypatch):
    assert ptar.native_tar_available(), ptar.build_error()
    assert ptar.build_library().parent.parent.name == "native"   # build/native/<hash>/
    for path in _shards(tmp_path):
        before = ptar.NATIVE_READS["shards"]
        native = _read(path, monkeypatch, True)
        assert ptar.NATIVE_READS["shards"] == before + 1         # routed natively
        plain = _read(path, monkeypatch, False)
        assert ptar.NATIVE_READS["shards"] == before + 1         # IDT_NATIVE_TAR=0: tarfile
        _same(native, plain)
        monkeypatch.setenv("IDT_NATIVE_TAR", "1")
        _same(native, list(ptar.iter_tar_samples_native(path)))
        if jtar.native_tar_available():
            _same(native, list(jtar.iter_tar_samples_native(path)))
    monkeypatch.setenv("IDT_NATIVE_TAR", "0")
    with pytest.raises(RuntimeError, match="unavailable"):
        list(ptar.iter_tar_samples_native(path))
    monkeypatch.setenv("IDT_NATIVE_TAR", "1")
    with pytest.raises(FileNotFoundError):
        list(ptar.iter_tar_samples_native(str(tmp_path / "missing.tar")))


def test_native_tar_feeds_the_wan_dataset(tmp_path):
    """WanSynthTarDataset (the trainers' tar route) reads through the native
    reader and gives the arrays the shards hold."""
    ds = pws.SyntheticWanDataset(n_samples=4, T=5, C=4, H=8, W=8, text_len=3, text_dim=16, seed=1)
    root = tmp_path / "d"
    pws.write_tar_shard(str(root / "s_00000.tar"),
                        [{"__key__": f"{i:08d}", **ds.get(i)} for i in range(4)])
    before = ptar.NATIVE_READS["shards"]
    got = {s["__key__"]: s for s in pws.WanSynthTarDataset(str(root), T=5, seed=0)}
    assert ptar.NATIVE_READS["shards"] > before
    for i in range(4):
        want = ds.get(i)
        for field in ("latents", "text_embed"):
            np.testing.assert_array_equal(got[f"{i:08d}"][field], want[field])


# --- the Stage-2 trainer on the D4RL route at T = 128 -----------------------------------

def _corrupt_draws(key, B, T, Kn, jitter):
    k_jit, k_use, k_anchor, k_noise = jax.random.split(key, 4)
    return {"jit": jax.random.randint(k_jit, (B, Kn), -jitter, jitter + 1) if jitter else None,
            "use": jax.random.uniform(k_use, (B, Kn)),
            "anchor": jax.random.normal(k_anchor, (B, Kn, 2)),
            "noise": jax.random.normal(k_noise, (B, T, 2))}


def _stage2_draws(rng, args, B, T):
    """train_interp_levels.loss_fn's draws from its key, in JAX's split order
    (tests/test_torch_maze_train_trainers.py's _s2_draws at any B, T), drawn
    under one jit: op by op, every shape of every level compiles its own
    program."""
    from interpolated_diffusion_tpu_torch.ops.keyframes import compute_k_schedule
    from interpolated_diffusion_tpu_torch.train import batches

    kn = compute_k_schedule(T, args.K_min, args.levels, args.k_schedule)
    jitters = [batches.compute_jitter_for_level(kn[s], args.K_min, args.corrupt_index_jitter_max,
                                                args.corrupt_index_jitter_pow)
               for s in range(args.levels + 1)]

    @jax.jit
    def draw(rng):
        k_mask, k_s, k_batch, _, k_rep = jax.random.split(rng, 5)
        k1, k2 = jax.random.split(k_s)
        lvl_keys = jax.random.split(jax.random.split(k_batch, 3)[2], args.levels + 1)
        return {"mask_rand": jax.random.uniform(k_mask, (B, T - 2)),
                "base_rand": jax.random.uniform(k_mask, (B, T)),
                "s_uni": jax.random.randint(k1, (B,), 1, args.levels + 1),
                "s_high": jax.random.uniform(k2, (B,)),
                "boot_rep": jax.random.uniform(k_rep, (B,)),
                "levels": [_corrupt_draws(lvl_keys[s], B, T, kn[s], jitters[s])
                           for s in range(args.levels + 1)]}

    return jax.tree.map(lambda a: torch.tensor(np.array(a)), draw(rng))


def test_d4rl_stage2_trainer_t128_matches_jax(tmp_path):
    """The D4RL route's data (maze2d-large episodes windowed at T 128 with
    velocities, D = 4) through --dataset prepared into the Stage-2 trainer
    under the JAX regression test's configuration (K_min 8, levels 8, geom,
    adj, uniform base masks, anchor confidence, dist corruption, pos_clip):
    loss and every leaf's gradient against the JAX trainer's."""
    import jax.numpy as jnp

    from interpolated_diffusion_tpu.train import train_interp_levels as js2
    from interpolated_diffusion_tpu_torch.data.dataset import PreparedTrajectoryDataset
    from interpolated_diffusion_tpu_torch.models.jax_import import params_to_state_dict
    from interpolated_diffusion_tpu_torch.train import train_interp_levels as ps2

    ep, prep = str(tmp_path / "ep.npz"), str(tmp_path / "prep.npz")
    psynth.main(["--env_id", "maze2d-large-v1", "--n_episodes", "12", "--seed", "1",
                 "--out_path", ep])
    pd4rl.main(["--episodes", ep, "--env_id", "maze2d-large-v1", "--T", "128",
                "--with_velocity", "1", "--num_samples", "8", "--out_path", prep])
    ds = PreparedTrajectoryDataset(prep)
    assert (ds.T, ds.data_dim) == (128, 4)
    B, T, D = 4, 128, 4
    flags = ["--dataset", "prepared", "--prepared_path", prep, "--T", "128", "--with_velocity",
             "1", "--maze_h", "12", "--maze_w", "9", "--d_model", "32", "--n_layers", "1",
             "--n_heads", "4", "--d_ff", "64", "--d_cond", "16", "--maze_channels", "8,8",
             "--batch", str(B), "--bf16", "0", "--K_min", "8", "--levels", "8", "--k_schedule",
             "geom", "--mode", "adj", "--mask_policy", "uniform", "--anchor_conf", "1",
             "--anchor_conf_anneal", "1", "--w_anchor", "0.1", "--corrupt_mode", "dist",
             "--corrupt_sigma_max", "0.02", "--corrupt_sigma_min", "0.003",
             "--corrupt_sigma_pow", "0.75", "--corrupt_anchor_frac", "0.25", "--pos_clip", "1"]
    jargs = js2.build_argparser().parse_args(flags)
    pargs = ps2.build_argparser().parse_args(flags + ["--device", "cpu"])
    jmodel = js2.build_model(jargs, D)
    mc = js2.mask_channels_for(jargs)
    b = ds.get_batch(np.arange(B))
    # numpy-drawn, no leaf zero (flax zero-initialises biases and the head)
    params = jparams(jmodel, np.zeros((2, T, D), np.float32), np.zeros((2,), np.int32),
                     np.zeros((2, T, mc), np.float32),
                     {"occ": b["occ"][:2], "start_goal": b["start_goal"][:2]})
    model = ps2.build_model(pargs, D, torch.device("cpu"))
    model.load_state_dict(params_to_state_dict(params, "interp"), strict=True)
    host = ps2.host_batch(pargs, b, 0, np.random.RandomState(1))
    rng = jax.random.PRNGKey(3)
    (loss_j, _), grads_j = jax.jit(jax.value_and_grad(js2.make_loss_fn(jmodel, jargs),
                                                      has_aux=True))(
        jax.tree.map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in host.items()}, rng)
    loss, _ = ps2.make_loss_fn(model, pargs)(
        None, {k: torch.tensor(np.array(v)) for k, v in host.items()},
        _stage2_draws(rng, pargs, B, T))
    assert abs(float(loss) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    want = params_to_state_dict(jax.tree.map(np.asarray, grads_j), "interp")
    names = [n for n, _ in model.named_parameters()]
    for n, g in zip(names, torch.autograd.grad(loss, [p for _, p in model.named_parameters()])):
        err = float((g - want[n]).abs().max()) / max(float(want[n].abs().max()), 1e-12)
        assert err <= 1e-4, (n, err)
