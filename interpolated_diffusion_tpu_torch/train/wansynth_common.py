"""Shared wansynth trainer plumbing (port of train/wansynth_common.py): the
command-line arguments, the data loader, Wan / LoRA construction and the
trainable / frozen partition, pretrained weights, and the Phase-1 index
helpers.

`build_wan` makes the WanDiT (and FrameCondProjector) the wansynth trainers,
the Phase-1 anchor precompute and the Phase-2 evaluation use, from the same
argument names, with seeded parameters (models/init.py) and, with
--wan_pretrained, a diffusers Wan2.1 checkpoint over them
(`load_pretrained_into`, models/wan_convert.py). `wan_args_from_meta`
rebuilds those arguments from a checkpoint's meta. `init_wan_trainables`
splits the model into the trainable dict (LoRA leaves and the projector, f32
masters) and the frozen base (compute dtype). LoRA takes either form
(models/wan_dit.LoRALinear: runtime, or merged as models/lora.py merges);
`split_lora_state_dict` / `join_lora_state_dict` / `merged_wan_params` are
the partition and its join. `--ffn_mode moe` builds every block's FFN as the
Switch-MoE FFN (models/moe.py, `--n_experts`, `--capacity_factor`).

`--dit` (the Phase-1 trainer's, `add_hunyuan_args`) chooses the backbone:
`wan` (WanDiT, the default) or `hunyuan_video`
(models/hunyuan_video.HunyuanVideoTransformer3DModel, its published sizes
but for `--hy_*`, runtime LoRA). `build_wan` and `make_wansynth_loader` are
the two places that read the choice: the latter reads a prompt mask and a
pooled text vector beside the text states, which the synthetic rows then
carry (`--text_valid_min` / `--text_valid_max` valid prompt tokens,
`--pooled_dim`), and the Phase-1 loss hands the model whatever the batch
carries.
"""
from __future__ import annotations

import argparse
import warnings
from typing import Dict, Optional, Tuple

import torch

from ..data.dataset import BatchLoader
from ..data.wan_synth import SyntheticWanDataset, WanSynthTarDataset
from ..models.init import build_model
from ..models.lora import apply_lora, init_lora, leaves_to_tree, tree_to_leaves
from ..models.hunyuan_video import HunyuanVideoTransformer3DModel
from ..models.wan_dit import FrameCondProjector, WanDiT, set_compute_dtype
from ..parallel.mesh import Mesh, shard_batch
from ..utils.memguard import add_memguard_args

_LORA_LEAVES = ("lora_A", "lora_B")


def add_wansynth_data_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--data", type=str, default="synthetic", choices=["synthetic", "tar"])
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--anchors_root", type=str, default=None)
    p.add_argument("--num_samples", type=int, default=1000)
    p.add_argument("--T", type=int, default=21)
    p.add_argument("--latent_c", type=int, default=16)
    p.add_argument("--latent_h", type=int, default=60)
    p.add_argument("--latent_w", type=int, default=104)
    p.add_argument("--text_len", type=int, default=512)
    p.add_argument("--text_dim", type=int, default=4096)
    p.add_argument("--prefetch_depth", type=int, default=2,
                   help="device-ready batches prefetched on a background "
                        "thread (utils/prefetch.py); 0 disables")
    add_memguard_args(p)


DITS = ("wan", "hunyuan_video")


def add_hunyuan_args(p: argparse.ArgumentParser) -> None:
    """The backbone choice, HunyuanVideo's heads and depths (the published
    ones by default; the rest of its sizes are the model's published
    defaults) and its inputs: the Phase-1 trainer's flags, which no other CLI
    takes (a checkpoint's meta carries them to the loaders)."""
    p.add_argument("--dit", type=str, default="wan", choices=DITS,
                   help="the backbone: WanDiT (--wan_*) or HunyuanVideo (--hy_*)")
    p.add_argument("--hy_heads", type=int, default=24, help="heads of 128")
    p.add_argument("--hy_double", type=int, default=20, help="dual-stream blocks")
    p.add_argument("--hy_single", type=int, default=40, help="single-stream blocks")
    p.add_argument("--text_valid_min", type=int, default=24,
                   help="--dit hunyuan_video: fewest valid prompt tokens of a synthetic row")
    p.add_argument("--text_valid_max", type=int, default=160,
                   help="--dit hunyuan_video: most valid prompt tokens of a synthetic row")
    p.add_argument("--pooled_dim", type=int, default=768,
                   help="--dit hunyuan_video: width of the pooled text vector (CLIP-L)")


def add_wan_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--use_wan", type=int, default=1)
    p.add_argument("--wan_dim", type=int, default=1536)
    p.add_argument("--wan_layers", type=int, default=30)
    p.add_argument("--wan_heads", type=int, default=12)
    p.add_argument("--wan_ffn", type=int, default=8960)
    p.add_argument("--attn_mode", type=str, default="sla",
                   choices=["dense", "sla", "sage_sla"],
                   help="sage_sla: int8-quantized Q/K block-sparse kernel")
    p.add_argument("--sla_topk", type=float, default=0.1)
    p.add_argument("--sla_block", type=int, default=256)
    p.add_argument("--lora_rank", type=int, default=8)
    p.add_argument("--lora_alpha", type=float, default=16.0)
    p.add_argument("--lora_targets", type=str, default="attn,ffn",
                   help="comma set of {attn, ffn}")
    p.add_argument("--lora_form", type=str, default="runtime",
                   choices=["runtime", "merged"],
                   help="runtime: y += (a/r)(x A)B inside each Linear, no merged "
                        "weight copy; merged: W' = W + a/r A B per call (the reference form)")
    p.add_argument("--ffn_mode", type=str, default="dense", choices=["dense", "moe"],
                   help="moe: Switch top-1 expert FFN in every block (models/moe.py)")
    p.add_argument("--n_experts", type=int, default=8)
    p.add_argument("--capacity_factor", type=float, default=1.25)
    p.add_argument("--use_remat", type=int, default=1,
                   help="recompute each block's forward in the backward pass")
    p.add_argument("--layer_mode", type=str, default="scan", choices=["loop", "scan"],
                   help="the JAX package's parameter layout; recorded in the meta. "
                        "Here the blocks are one Python loop either way, and "
                        "--use_remat bounds the saved activations to one tensor a block")
    p.add_argument("--wan_pretrained", type=str, default=None,
                   help="a diffusers Wan2.1 transformer checkpoint (a directory of "
                        ".safetensors shards or one file), read into the frozen base")
    p.add_argument("--frame_cond", type=int, default=1)
    p.add_argument("--frame_cond_dim", type=int, default=5)
    p.add_argument("--patch_size", type=int, default=2)


def _hunyuan(args) -> bool:
    """Whether the backbone is HunyuanVideo (`--dit`; only the Phase-1
    trainer and its checkpoints' meta carry the choice)."""
    choice = str(getattr(args, "dit", "wan"))
    if choice not in DITS:
        raise ValueError(f"--dit {choice!r} not in {DITS}")
    return choice == "hunyuan_video"


def check_wan_args(args) -> None:
    """Raise for options the Wan builders do not take."""
    if _lora_form(args) not in ("runtime", "merged"):
        raise ValueError(f"--lora_form {_lora_form(args)!r} not in ('runtime', 'merged')")


class _StatefulIter:
    """next()-able view of a BatchLoader that exposes its resume marker."""

    def __init__(self, loader, mesh: Optional[Mesh] = None):
        self._loader, self._mesh = loader, mesh
        self._it = iter(loader)

    @property
    def state(self):
        return self._loader.state

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self._it)
        return shard_batch(batch, self._mesh) if self._mesh is not None else batch


def make_wansynth_loader(args, seed: int, state: Optional[dict] = None,
                         mesh: Optional[Mesh] = None):
    """The streaming batch loader; `state` (a previous loader's `.state`)
    resumes the data stream where a checkpoint left it. Both iterator kinds
    expose `.state` (JSON-able) for the checkpoint meta. With the device
    prefetcher in front, the marker can run ahead of the consumed position by
    the prefetch depth: resume then skips (never repeats) at most that many
    batches.

    With a data-parallel `mesh` the loader yields this rank's rows: tar
    shards are split over the processes (split_by_process) and each rank
    reads --batch / n_data samples from its own; the synthetic data is the
    same global batch on every rank, cut to the rank's rows."""
    n_data = mesh.n_data if mesh is not None else 1
    if args.data == "tar":
        if not args.data_root:
            raise ValueError("--data_root required for --data tar")
        ds = WanSynthTarDataset(args.data_root, T=args.T, seed=seed,
                                anchors_root=args.anchors_root)
        return ds.batches(args.batch // n_data, state=state)
    if getattr(args, "anchors_root", None):
        raise ValueError("--anchors_root joins are defined over tar shards; write the synthetic "
                         "data to tar shards first (data/wan_synth.write_tar_shard) and pass "
                         "--data tar --data_root <dir>: otherwise anchors would be silently "
                         "ignored")
    hy = _hunyuan(args)
    ds = SyntheticWanDataset(n_samples=args.num_samples, T=args.T, C=args.latent_c,
                             H=args.latent_h, W=args.latent_w, text_len=args.text_len,
                             text_dim=args.text_dim, seed=seed,
                             text_valid=(args.text_valid_min, args.text_valid_max) if hy
                             else None, pooled_dim=args.pooled_dim if hy else 0)
    return _StatefulIter(BatchLoader(ds, batch_size=args.batch, seed=seed,
                                     start_batch=int((state or {}).get("batches", 0))), mesh)


# WanDiT head-modulation semantics version. "t_emb": the final layer's
# scale/shift table is modulated by the raw time embedding (diffusers-Wan
# semantics, needed for pretrained weights). Checkpoints written before this
# stamp existed were trained under the older t_mod[:, :2] semantics and would
# be silently mis-evaluated by the current forward: check_wan_meta flags them.
WAN_HEAD_MOD_VERSION = "t_emb"


def check_wan_meta(meta: Dict) -> None:
    """Warn when a Wan checkpoint predates the head-modulation change; raise
    when its stamp names another version. Call on the meta of any checkpoint
    trained with use_wan."""
    if not meta.get("use_wan"):
        return
    ver = meta.get("wan_head_mod")
    if ver is None:
        warnings.warn("Wan checkpoint meta carries no 'wan_head_mod' stamp: it was trained "
                      "before the head-modulation change (t_mod[:, :2] -> t_emb). Sampling with "
                      "the current WanDiT forward will apply mismatched head-modulation "
                      "semantics to this checkpoint.", stacklevel=2)
    elif ver != WAN_HEAD_MOD_VERSION:
        raise ValueError(f"Wan checkpoint head-modulation version {ver!r} is incompatible "
                         f"with this build ({WAN_HEAD_MOD_VERSION!r}).")


def _lora_form(args) -> str:
    return str(getattr(args, "lora_form", "merged"))


def build_wan(args, bf16: bool = True, *, generator: torch.Generator,
              device: Optional[torch.device] = None, zero_init_scale: float = 0.0
              ) -> Tuple[WanDiT, Optional[FrameCondProjector]]:
    """(WanDiT, FrameCondProjector or None) from wansynth arguments
    (wan_dim, wan_layers, wan_heads, wan_ffn, latent_c, text_dim, attn_mode,
    sla_topk, sla_block, lora_rank, lora_alpha, lora_form, lora_targets,
    ffn_mode, n_experts, capacity_factor, use_remat, remat_group, frame_cond, frame_cond_dim,
    wan_pretrained), parameters drawn from `generator`.

    LoRA lives inside the model (LoRALinear) in either form; the merged
    form's A is drawn as the JAX package's init_lora draws it (N(0, 1) / r),
    the runtime form's as its LoRADense does. --wan_pretrained then
    overwrites the base weights. zero_init_scale > 0 makes the
    zero-initialised leaves (lora_B, sla.proj_l, the projector's output)
    small and non-zero.
    """
    check_wan_args(args)
    frame_cond = bool(getattr(args, "frame_cond", 0))
    # a LoRA run's frozen base lives in the compute dtype; a full fine-tune
    # (lora_rank 0) keeps every weight as an f32 master from the start
    dtype = torch.bfloat16 if bf16 and int(args.lora_rank) > 0 else torch.float32
    if _hunyuan(args):
        return _build_hunyuan(args, dtype, generator, device, zero_init_scale, frame_cond)
    wan = build_model(
        WanDiT, generator=generator, device=device, dtype=dtype,
        zero_init_scale=zero_init_scale,
        dim=args.wan_dim, n_layers=args.wan_layers, n_heads=args.wan_heads,
        ffn_dim=args.wan_ffn, in_channels=args.latent_c, out_channels=args.latent_c,
        text_dim=args.text_dim, attn_mode=args.attn_mode, sla_topk=args.sla_topk,
        sla_block=args.sla_block, lora_rank=int(args.lora_rank),
        lora_alpha=float(args.lora_alpha),
        lora_targets=str(getattr(args, "lora_targets", "attn,ffn")),
        ffn_mode=str(getattr(args, "ffn_mode", "dense")),
        n_experts=int(getattr(args, "n_experts", 8)),
        capacity_factor=float(getattr(args, "capacity_factor", 1.25)), extra_context=frame_cond,
        use_remat=bool(getattr(args, "use_remat", 0)),
        remat_group=int(getattr(args, "remat_group", 1)), lora_form=_lora_form(args))
    if int(args.lora_rank) > 0 and _lora_form(args) == "merged":
        targets = {t.strip() for t in str(getattr(args, "lora_targets", "attn,ffn")).split(",")}
        pats = (["q_proj|k_proj|v_proj|o_proj"] if "attn" in targets else []) + (
            ["ffn_in|ffn_out"] if "ffn" in targets else [])
        tree = init_lora(generator, wan.state_dict(), int(args.lora_rank),
                         float(args.lora_alpha), filter_regex="(" + "|".join(pats) + ")")
        with torch.no_grad():
            params = dict(wan.named_parameters())
            for name, value in tree_to_leaves(tree).items():
                params[name].copy_(value)
    load_pretrained_into(wan, args)
    fc = None
    if frame_cond:
        fc = build_model(FrameCondProjector, generator=generator, device=device, dtype=dtype,
                         zero_init_scale=zero_init_scale,
                         feat_dim=int(getattr(args, "frame_cond_dim", 5)),
                         text_dim=args.text_dim)
    return wan.eval(), (fc.eval() if fc is not None else None)


def hunyuan_kwargs(args) -> Dict:
    """HunyuanVideoTransformer3DModel's arguments from wansynth arguments."""
    return dict(in_channels=args.latent_c, out_channels=args.latent_c,
                num_attention_heads=int(args.hy_heads), num_layers=int(args.hy_double),
                num_single_layers=int(args.hy_single),
                patch_size=int(getattr(args, "patch_size", 2)), text_embed_dim=args.text_dim,
                pooled_projection_dim=int(args.pooled_dim), lora_rank=int(args.lora_rank),
                lora_alpha=float(args.lora_alpha),
                lora_targets=str(getattr(args, "lora_targets", "attn,ffn")),
                lora_form=_lora_form(args), use_remat=bool(getattr(args, "use_remat", 0)))


def _build_hunyuan(args, dtype, generator, device, zero_init_scale: float, frame_cond: bool):
    """(HunyuanVideo model, FrameCondProjector or None), seeded as build_wan's."""
    if int(args.lora_rank) > 0 and _lora_form(args) != "runtime":
        raise ValueError("--dit hunyuan_video takes runtime LoRA only")
    if getattr(args, "wan_pretrained", None) or str(getattr(args, "ffn_mode",
                                                            "dense")) != "dense":
        raise ValueError("--wan_pretrained and --ffn_mode moe are WanDiT's")
    model = build_model(HunyuanVideoTransformer3DModel, generator=generator, device=device,
                        dtype=dtype, zero_init_scale=zero_init_scale, **hunyuan_kwargs(args))
    fc = None
    if frame_cond:
        fc = build_model(FrameCondProjector, generator=generator, device=device, dtype=dtype,
                         zero_init_scale=zero_init_scale,
                         feat_dim=int(getattr(args, "frame_cond_dim", 5)),
                         text_dim=args.text_dim)
    return model.eval(), (fc.eval() if fc is not None else None)


def load_pretrained_into(wan: WanDiT, args) -> int:
    """Overwrite the base weights of a built WanDiT with a converted diffusers
    checkpoint (--wan_pretrained; none: nothing happens). LoRA leaves and the
    weights the checkpoint lacks keep their values; every checkpoint tensor
    must name a parameter of the model with its shape. Returns the count."""
    path = getattr(args, "wan_pretrained", None)
    if not path:
        return 0
    from ..models.wan_convert import load_wan_safetensors

    pre = load_wan_safetensors(path)
    params = dict(wan.named_parameters())
    for name, value in pre.items():
        if name not in params:
            raise ValueError(f"pretrained param {name} not in model")
        if tuple(params[name].shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch at {name}: model {tuple(params[name].shape)} vs "
                             f"checkpoint {tuple(value.shape)}")
    with torch.no_grad():
        for name, value in pre.items():
            params[name].copy_(value.to(params[name].dtype))
    print(f"loaded {len(pre)} pretrained tensors from {path}")
    return len(pre)


def wan_args_from_meta(meta: Dict, **over) -> argparse.Namespace:
    """The build_wan arguments of a wansynth checkpoint's meta, with `over`
    on top (the precompute's attention overrides, its sla_block 128, the
    Phase-2 frame_cond_dim). Keys an older meta lacks take the trainers'
    defaults: lora_alpha 16, lora_form merged (the JAX package's reading),
    lora_targets attn,ffn, ffn_mode dense, sla_topk 0.1, sla_block 256."""
    ns = argparse.Namespace(
        wan_dim=int(meta["wan_dim"]), wan_layers=int(meta["wan_layers"]),
        wan_heads=int(meta["wan_heads"]), wan_ffn=int(meta["wan_ffn"]),
        latent_c=int(meta["latent_c"]), text_dim=int(meta["text_dim"]),
        attn_mode=meta.get("attn_mode", "dense"), sla_topk=float(meta.get("sla_topk", 0.1)),
        sla_block=int(meta.get("sla_block", 256)), use_remat=0,
        lora_rank=int(meta.get("lora_rank", 0)), lora_alpha=float(meta.get("lora_alpha", 16.0)),
        lora_form=meta.get("lora_form", "merged"),
        lora_targets=meta.get("lora_targets", "attn,ffn"),
        layer_mode=meta.get("layer_mode", "loop"), ffn_mode=meta.get("ffn_mode", "dense"),
        n_experts=int(meta.get("n_experts", 8)),
        capacity_factor=float(meta.get("capacity_factor", 1.25)),
        frame_cond=int(meta.get("frame_cond", 1)), frame_cond_dim=5, T=int(meta["T"]),
        dit=meta.get("dit", "wan"), hy_heads=int(meta.get("hy_heads", 24)),
        hy_double=int(meta.get("hy_double", 20)), hy_single=int(meta.get("hy_single", 40)),
        pooled_dim=int(meta.get("pooled_dim", 768)), patch_size=int(meta.get("patch_size", 2)))
    for k, v in over.items():
        setattr(ns, k, v)
    return ns


def split_lora_state_dict(sd: Dict[str, torch.Tensor]
                          ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(LoRA leaves, frozen rest): the rest has exactly the keys of a
    lora_rank=0 WanDiT, so plain base weights interchange with it."""
    lora = {k: v for k, v in sd.items() if k.rsplit(".", 1)[-1] in _LORA_LEAVES}
    return lora, {k: v for k, v in sd.items() if k not in lora}


def join_lora_state_dict(lora: Dict[str, torch.Tensor],
                         base: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Inverse of split_lora_state_dict: the union of the two partitions."""
    return {**base, **lora}


def merged_wan_params(params: Dict, base: Optional[Dict[str, torch.Tensor]], args
                      ) -> Dict[str, torch.Tensor]:
    """Effective WanDiT state_dict: the frozen base joined with the runtime
    LoRA leaves (params["lora"]), the base with the merged-form adapters
    merged into its weights (models/lora.apply_lora; a state_dict for a
    lora_rank 0 model), or params["wan"] without LoRA."""
    if int(args.lora_rank) > 0:
        if _lora_form(args) == "merged":
            return apply_lora(base, leaves_to_tree(params["lora"]), int(args.lora_rank),
                              float(args.lora_alpha))
        return join_lora_state_dict(params["lora"], base)
    return params["wan"]


def init_wan_trainables(args, wan: WanDiT, fc: Optional[FrameCondProjector],
                        bf16: bool = True) -> Tuple[Dict, Optional[Dict[str, torch.Tensor]]]:
    """(trainable, base): the partition the trainer differentiates and the
    frozen rest, both as dicts of the modules' own parameters.

    With lora_rank > 0 the LoRA leaves (`trainable["lora"]`) and the
    projector (`trainable["frame_cond"]`) become f32 masters that require
    gradients; every other WanDiT parameter is the frozen base, kept in the
    compute dtype and requiring none. Both modules then compute in the
    compute dtype (bf16 or f32), casting the masters per call. Without LoRA
    the whole model trains (`trainable["wan"]`, base None): every WanDiT
    weight becomes an f32 master that requires gradients, computing in the
    compute dtype, as JAX's init_wan_trainables keeps wan_params as the
    trainable tree under flax's dtype=bfloat16.
    """
    check_wan_args(args)
    compute = torch.bfloat16 if bf16 else torch.float32
    trainable: Dict = {}
    if fc is not None:
        fc.float().requires_grad_(True)
        set_compute_dtype(fc, compute)
        trainable["frame_cond"] = dict(fc.named_parameters())
    named = dict(wan.named_parameters())
    if int(args.lora_rank) > 0:
        lora, base = split_lora_state_dict(named)
        for p in lora.values():
            p.data = p.data.float()
            p.requires_grad_(True)
        for p in base.values():
            p.data = p.data.to(compute)
            p.requires_grad_(False)
        trainable["lora"] = lora
    else:
        wan.float().requires_grad_(True)
        trainable["wan"], base = named, None
    set_compute_dtype(wan, compute)
    return trainable, base


def midpoint_indices(idx: torch.Tensor) -> torch.Tensor:
    return (idx[:, :-1] + idx[:, 1:]) // 2


def meanpool_between_anchors(tokens: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Mean of the strictly interior frames of each segment ([B, K-1, N, D]);
    the midpoint frame where a gap has no interior. tokens [B, T, N, D]."""
    csum = torch.cumsum(tokens, dim=1)
    csum = torch.cat([torch.zeros_like(csum[:, :1]), csum], dim=1)     # [B, T+1, ...]
    i, j = idx[:, :-1].long(), idx[:, 1:].long()
    take = lambda x, at: torch.gather(x, 1, at[..., None, None].expand(-1, -1, *x.shape[2:]))
    upper = take(csum, j)            # sum up to j - 1
    lower = take(csum, i + 1)        # sum up to i
    interior = (j - i - 1)[..., None, None].to(tokens.dtype)
    mean = (upper - lower) / torch.clamp(interior, min=1.0)
    mid = take(tokens, midpoint_indices(idx).long())
    return torch.where(interior > 0, mean, mid)
