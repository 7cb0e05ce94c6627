"""Checkpoint -> model loaders shared by the samplers, the trainers and the
service (port of models/loading.py: the two maze denoisers, the keypoint
selector and the segment-cost model D_phi, and the D_phi cost function of
the kp_feat channels), and the wansynth checkpoints of both phases
(`load_wansynth_model`: WanDiT + frame projector, or the token denoisers),
and the video interpolators' stages (`load_stage_model`: the flow and
Sinkhorn interpolators, the straighteners, the video selector and D_phi),
the toy-video denoisers (`load_toy_video_model`), the temporal-conv
interpolator (`load_video_interpolator`) and the DiDeMo token denoisers
(`load_didemo_model`).

Reads the port's own checkpoints and the JAX package's (utils/checkpoint.py
routes a directory with `params.msgpack` through utils/jax_checkpoint.py and
models/jax_import.py): the meta dict rebuilds the model, the EMA weights (by
default) or the params fill it (the selector and D_phi trainers keep no
EMA). A causal Stage-2 meta builds the causal denoiser; Stage 1 ignores
`causal`, as the JAX loader does. Models come back with f32 parameters on
`device` (the card unless the caller asks for the CPU), computing in bf16
under `bf16=True`, in eval mode. Reference-PyTorch `.pt` files are not read
here.
"""
from __future__ import annotations

import os
import warnings
from typing import Dict, Optional, Tuple

import torch

from ..utils.checkpoint import latest_checkpoint, load_checkpoint, read_meta
from .denoisers import InterpLevelDenoiser, KeypointDenoiser
from .selector import KeypointSelector, SegmentCostPredictor
from .transformer import set_compute_dtype


def resolve_ckpt(path: str) -> str:
    """`path` if it is a checkpoint, else the newest `ckpt_<step>` under it."""
    if os.path.exists(os.path.join(path, "meta.json")):
        return path
    found = latest_checkpoint(path)
    if not found:
        raise FileNotFoundError(f"no checkpoint found under {path}")
    return found


def _maze_ch(meta) -> Tuple[int, ...]:
    return tuple(int(c) for c in str(meta["maze_channels"]).split(","))


def _check_meta(meta: Dict, path: str, stage: str) -> None:
    if meta.get("stage") != stage:
        raise ValueError(f"{path} is not a {stage} checkpoint (stage {meta.get('stage')!r})")


def _fill(model, path: str, bf16: bool, use_ema: bool, device):
    _, payload = load_checkpoint(path, map_location=device, with_opt_state=False)
    weights = payload["ema"] if (use_ema and "ema" in payload) else payload["params"]
    model.load_state_dict(weights)
    set_compute_dtype(model, torch.bfloat16 if bf16 else None)
    return model.to(device).eval().requires_grad_(False)


def load_keypoint_model(path: str, bf16: bool = True, use_ema: bool = True, device="cuda"):
    """(model, meta) of a Stage-1 checkpoint (or the newest under a run dir)."""
    path = resolve_ckpt(path)
    _, meta = read_meta(path)
    _check_meta(meta, path, "keypoints")
    model = KeypointDenoiser(
        d_model=meta["d_model"], n_layers=meta["n_layers"], n_heads=meta["n_heads"],
        d_ff=meta["d_ff"], d_cond=meta["d_cond"], use_sdf=bool(meta["use_sdf"]),
        use_start_goal=bool(meta["cond_start_goal"]), data_dim=int(meta["data_dim"]),
        kp_feat_dim=int(meta.get("kp_feat_dim", 0)) if meta.get("use_kp_feat") else 0,
        maze_channels=_maze_ch(meta))
    return _fill(model, path, bf16, use_ema, device), meta


def load_interp_model(path: str, bf16: bool = True, use_ema: bool = True, device="cuda"):
    """(model, meta) of a Stage-2 checkpoint (or the newest under a run dir)."""
    path = resolve_ckpt(path)
    _, meta = read_meta(path)
    _check_meta(meta, path, "interp_levels")
    model = InterpLevelDenoiser(
        d_model=meta["d_model"], n_layers=meta["n_layers"], n_heads=meta["n_heads"],
        d_ff=meta["d_ff"], d_cond=meta["d_cond"], use_sdf=bool(meta["use_sdf"]),
        use_start_goal=bool(meta["cond_start_goal"]), data_dim=int(meta["data_dim"]),
        max_levels=max(8, int(meta["levels"])), mask_channels=int(meta["mask_channels"]),
        maze_channels=_maze_ch(meta), causal=bool(meta.get("causal", 0)))
    return _fill(model, path, bf16, use_ema, device), meta


def load_selector_model(path: str, bf16: bool = True, device="cuda"):
    """(model, meta) of a keypoint-selector checkpoint (or the newest under a run dir)."""
    path = resolve_ckpt(path)
    _, meta = read_meta(path)
    _check_meta(meta, path, "selector")
    model = KeypointSelector(
        T=int(meta["T"]), d_model=meta["d_model"], n_heads=meta["n_heads"],
        d_ff=meta["d_ff"], n_layers=meta["n_layers"], pos_dim=meta["pos_dim"],
        use_sdf=bool(meta["use_sdf"]), use_start_goal=bool(meta["cond_start_goal"]),
        use_sg_map=bool(meta["use_sg_map"]), use_sg_token=bool(meta["use_sg_token"]),
        use_goal_dist_token=bool(meta["use_goal_dist_token"]),
        use_cond_bias=bool(meta["use_cond_bias"]), cond_bias_mode=meta["cond_bias_mode"],
        use_level=bool(meta["use_level"]), sg_map_sigma=float(meta["sg_map_sigma"]),
        maze_channels=_maze_ch(meta))
    return _fill(model, path, bf16, False, device), meta


def load_segment_cost_model(path: str, bf16: bool = True, device="cuda"):
    """(model, meta) of a D_phi checkpoint (or the newest under a run dir)."""
    path = resolve_ckpt(path)
    _, meta = read_meta(path)
    _check_meta(meta, path, "segment_cost")
    model = SegmentCostPredictor(
        d_cond=meta["d_cond"], seg_feat_dim=meta["seg_feat_dim"],
        hidden_dim=meta["hidden_dim"], n_layers=meta["n_layers"],
        use_sdf=bool(meta["use_sdf"]), use_start_goal=bool(meta["cond_start_goal"]),
        maze_channels=_maze_ch(meta))
    return _fill(model, path, bf16, False, device), meta


def make_dphi_seg_cost_fn(path: str, T: int, use_sdf=None, bf16: bool = True, device="cuda"):
    """Load D_phi and return (seg_cost_fn, meta): seg_cost_fn(cond, idx) ->
    [B, K-1] predicted costs of the consecutive segments of `idx` [B, K],
    for the kp_feat cost channels. T and use_sdf must match the checkpoint's
    meta."""
    from ..ops.selection import build_segment_features_from_idx

    model, meta = load_segment_cost_model(path, bf16, device)
    if meta.get("T") is not None and int(meta["T"]) != int(T):
        raise ValueError(f"dphi_ckpt T mismatch: ckpt={meta['T']} args={T}")
    if use_sdf is not None and meta.get("use_sdf") is not None \
            and bool(meta["use_sdf"]) != bool(use_sdf):
        raise ValueError("dphi_ckpt use_sdf mismatch")
    seg_feat_dim = int(meta.get("seg_feat_dim", 3))

    def seg_cost_fn(cond, idx):
        with torch.no_grad():
            return model(cond, build_segment_features_from_idx(idx, T, seg_feat_dim))

    return seg_cost_fn, meta


def load_stage_model(path: str, stage: str, from_meta, device="cuda", bf16: bool = False,
                     use_ema: bool = False):
    """(model, meta) of a checkpoint of `stage` (or the newest under a run
    dir), either package's: `from_meta(meta)` builds the module, the params
    (the EMA weights with `use_ema` when saved) fill it (f32, on `device`),
    bf16 compute under `bf16`, eval mode without gradients. The video
    interpolators', toy-video and DiDeMo stages use it."""
    path = resolve_ckpt(path)
    _, meta = read_meta(path)
    _check_meta(meta, path, stage)
    with torch.device("meta"):
        model = from_meta(meta)
    model = model.to_empty(device=device)
    return _fill(model, path, bf16, use_ema, device), meta


TOY_VIDEO_STAGES = ("keypoints_toy_video", "interp_levels_toy_video")


def toy_video_model_from_meta(meta: Dict, stage: str):
    """The toy-video denoiser of `stage` (the maze denoisers over flat frame
    latents, no maze encoder; Stage 2 with max(8, levels) level embeddings)."""
    common = dict(d_model=int(meta["d_model"]), n_layers=int(meta["n_layers"]),
                  n_heads=int(meta["n_heads"]), d_ff=int(meta["d_ff"]),
                  data_dim=int(meta["data_dim"]), use_start_goal=False, maze_cond=False)
    if stage == "keypoints_toy_video":
        return KeypointDenoiser(**common)
    return InterpLevelDenoiser(max_levels=max(8, int(meta["levels"])),
                               mask_channels=int(meta["mask_channels"]), **common)


def load_toy_video_model(path: str, stage: str, bf16: bool = True, use_ema: bool = True,
                         device="cuda"):
    """(model, meta) of a toy-video checkpoint of `stage` (either package's),
    its EMA weights by default, as JAX's sample_toy_video loads them."""
    if stage not in TOY_VIDEO_STAGES:
        raise ValueError(f"{stage!r} is not a toy-video stage {TOY_VIDEO_STAGES}")
    return load_stage_model(path, stage, lambda m: toy_video_model_from_meta(m, stage), device,
                            bf16, use_ema)


def load_video_interpolator(path: str, device="cuda", bf16: bool = False):
    """(TinyTemporalInterpolator, meta) of a video_interpolator checkpoint."""
    from .interpolators import TinyTemporalInterpolator

    return load_stage_model(path, "video_interpolator", lambda m: TinyTemporalInterpolator(
        int(m["data_dim"]), int(m["kernel_size"]), int(m["n_layers"])), device, bf16)


DIDEMO_STAGES = ("keypoints_didemo", "interp_levels_didemo")


def load_didemo_model(path: str, stage: str, bf16: bool = True, use_ema: bool = True,
                      device="cuda"):
    """(model, meta) of a DiDeMo checkpoint of `stage` (either package's):
    the text-conditioned token denoiser, its EMA weights by default."""
    if stage not in DIDEMO_STAGES:
        raise ValueError(f"{stage!r} is not a DiDeMo stage {DIDEMO_STAGES}")
    return load_stage_model(path, stage, lambda m: _token_model(m, stage), device, bf16, use_ema)


def load_flow_interpolator(path: str, device="cuda", bf16: bool = False):
    """(LatentFlowInterpolator, meta) of a flow_interpolator checkpoint."""
    from .flow_interpolator import flow_interpolator_from_meta

    return load_stage_model(path, "flow_interpolator", flow_interpolator_from_meta, device, bf16)


def load_sinkhorn_interp(path: str, device="cuda"):
    """(SinkhornWarpInterpolator, meta) of a sinkhorn_interp checkpoint (f32)."""
    from .sinkhorn_warp import SinkhornWarpInterpolator

    return load_stage_model(path, "sinkhorn_interp", SinkhornWarpInterpolator.from_meta, device)


def load_video_selector(path: str, device="cuda", bf16: bool = False):
    """(VideoKeyframeSelector, meta) of a video_selector checkpoint."""
    from .video_selector import video_selector_from_meta

    return load_stage_model(path, "video_selector", video_selector_from_meta, device, bf16)


def load_video_segment_cost(path: str, device="cuda", bf16: bool = False):
    """(VideoSegmentCostPredictor, meta) of a segment_cost_wansynth checkpoint."""
    from ..train.train_segment_cost_wansynth import segment_cost_from_meta

    return load_stage_model(path, "segment_cost_wansynth", segment_cost_from_meta, device, bf16)


WANSYNTH_STAGES = ("keypoints_wansynth", "interp_levels_wansynth")


def _token_model(meta: Dict, stage: str):
    from .video_denoisers import VideoTokenInterpLevelDenoiser, VideoTokenKeypointDenoiser

    p = int(meta["patch_size"])
    common = dict(d_model=int(meta["d_model"]), n_layers=int(meta["n_layers"]),
                  n_heads=int(meta["n_heads"]), d_ff=int(meta["d_ff"]),
                  data_dim=int(meta["latent_c"]) * p * p, text_dim=int(meta["text_dim"]))
    if stage.startswith("keypoints"):
        return VideoTokenKeypointDenoiser(**common)
    return VideoTokenInterpLevelDenoiser(max_levels=max(8, int(meta["levels"])),
                                         mask_channels=int(meta["mask_channels"]), **common)


def load_wansynth_model(path: str, stage: str, bf16: bool = True, device="cuda",
                        base: Optional[Dict[str, torch.Tensor]] = None, use_ema: bool = False,
                        **wan_over):
    """(model, fc, meta) of a wansynth checkpoint of `stage` (or the newest
    under a run dir), either package's, on `device`, in eval mode without
    gradients.

    use_wan: `model` is the WanDiT built from the meta (train/wansynth_common
    .wan_args_from_meta with `wan_over` on top: the precompute's attention
    overrides, the Phase-2 frame_cond_dim), LoRA in the meta's form as f32
    masters, the base in the compute dtype (bf16 under `bf16`), `fc` its
    FrameCondProjector. The base comes from the checkpoint's "wan_base"; a
    checkpoint without one (written before the trainers saved it) takes
    `base` when given, else keeps the seeded initialisation with a warning.
    A base without the SLA projection (a dense run sampled under sla) keeps
    the projection's zero initialisation.
    use_wan 0: `model` is the token denoiser of the stage (its EMA weights
    with `use_ema` when saved), fc None."""
    from ..train.wansynth_common import build_wan, check_wan_meta, init_wan_trainables, \
        wan_args_from_meta

    path = resolve_ckpt(path)
    _, meta = read_meta(path)
    _check_meta(meta, path, stage)
    _, payload = load_checkpoint(path, map_location=device, with_opt_state=False)
    params = payload["params"]
    if not meta.get("use_wan", 1):
        model = _token_model(meta, stage)
        model.load_state_dict(payload["ema"] if (use_ema and "ema" in payload) else params)
        set_compute_dtype(model, torch.bfloat16 if bf16 else None)
        return model.to(device).eval().requires_grad_(False), None, meta
    check_wan_meta(meta)
    ns = wan_args_from_meta(meta, **wan_over)
    wan, fc = build_wan(ns, bf16, device=device,
                        generator=torch.Generator(device=device).manual_seed(0))
    init_wan_trainables(ns, wan, fc, bf16)
    named = dict(wan.named_parameters())
    base_sd = params.get("wan_base", params.get("wan", base))
    with torch.no_grad():
        if base_sd is None:
            warnings.warn(f"{path} holds no wan_base: the WanDiT base weights are the seeded "
                          "initialisation, not the trained model's", stacklevel=2)
        else:
            unknown = sorted(set(base_sd) - set(named))
            missing = sorted(k for k in set(named) - set(base_sd) - set(params.get("lora", {}))
                             if ".sla.proj_l." not in k)
            if unknown or missing:
                raise ValueError(f"{path}: the Wan base does not fit the model built from its "
                                 f"meta (unknown {unknown[:3]}, missing {missing[:3]})")
            for name, value in base_sd.items():
                named[name].copy_(value)
        for name, value in params.get("lora", {}).items():
            named[name].copy_(value)
        if fc is not None:
            fc.load_state_dict({k: v.float() for k, v in params["frame_cond"].items()})
    wan.eval().requires_grad_(False)
    if fc is not None:
        fc.eval().requires_grad_(False)
    return wan, fc, meta
