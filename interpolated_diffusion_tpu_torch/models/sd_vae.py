"""SD AutoencoderKL with the diffusers weight names (port of models/sd_vae.py).

The frame VAE of Stable Diffusion 1.x (sd-vae-ft-ema): RGB frames in [0, 1]
to 4-channel latents at 1/8 the size, scaled by 0.18215, and back. The
module's own state-dict names are the diffusers names, so a diffusers
AutoencoderKL file loads with no renaming (`load_sd_vae_safetensors`).

Encoder: conv_in, 4 down blocks of 2 resnets (a stride-2 conv after blocks
0-2, padded (0, 1, 0, 1) first), mid (resnet, one-head attention, resnet),
GroupNorm / SiLU / conv_out to 2 x 4 moments; quant / post-quant 1x1
convs; the decoder mirrors it with 4 up blocks of 3 resnets (a nearest 2x
upsample and a conv after blocks 0-2). Every GroupNorm has 32 groups and
eps 1e-6 with flax's statistics (f32, var = E[x^2] - mu^2 clipped at 0;
torch's nn.GroupNorm has eps 1e-5 and a two-pass variance). The mid-block
attention is plain PyTorch, products by torch.matmul and f32 logits, as the
JAX block computes it with einsum outside any Pallas kernel.

`convert_sd_vae_state_dict` (diffusers state dict -> the JAX package's
SDVAE param tree, numpy; attention projections as Linear or as the legacy
1x1 convs under query/key/value/proj_attn) and `export_sd_vae_state_dict`
(its inverse) are copies of the JAX functions; `canonical_state_dict` runs
the two to give this module's state dict from any such file.
"""
from __future__ import annotations

import os
import re
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .transformer import Conv2d, Linear

SD_SCALE = 0.18215
SD_BLOCK_OUT = (128, 256, 512, 512)


class GroupNorm(nn.Module):
    """flax GroupNorm over NCHW: f32 statistics per (sample, group), var =
    E[x^2] - mu^2 clipped at 0, (x - mu) * (rsqrt(var + eps) * scale) + bias;
    output in the input's dtype."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def init_seeded(self, uniform_) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[:2]
        G = self.groups
        xf = x.float()
        g = xf.reshape(B, G, -1)
        mu = g.mean(dim=-1)
        var = torch.clamp((g * g).mean(dim=-1) - mu * mu, min=0.0)
        rs = torch.rsqrt(var + self.eps)                                  # [B, G]
        per_ch = lambda v: v.repeat_interleave(C // G, dim=1).reshape(B, C, *([1] * (x.ndim - 2)))
        mul = per_ch(rs) * self.weight.float().reshape(1, C, *([1] * (x.ndim - 2)))
        y = (xf - per_ch(mu)) * mul + self.bias.float().reshape(1, C, *([1] * (x.ndim - 2)))
        return y.to(x.dtype)


def _conv3(cin: int, cout: int) -> Conv2d:
    return Conv2d(cin, cout, 3, padding=1)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1, self.conv1 = GroupNorm(in_ch), _conv3(in_ch, out_ch)
        self.norm2, self.conv2 = GroupNorm(out_ch), _conv3(out_ch, out_ch)
        self.conv_shortcut = Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the spatial positions (mid block)."""

    def __init__(self, ch: int):
        super().__init__()
        self.group_norm = GroupNorm(ch)
        self.to_q, self.to_k, self.to_v = Linear(ch, ch), Linear(ch, ch), Linear(ch, ch)
        self.to_out = nn.ModuleList([Linear(ch, ch)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        flat = self.group_norm(x).reshape(B, C, H * W).transpose(1, 2)   # [B, HW, C]
        q, k, v = self.to_q(flat), self.to_k(flat), self.to_v(flat)
        logits = torch.matmul(q, k.transpose(1, 2)).float()
        p = torch.softmax(logits * (C ** -0.5), dim=-1).to(v.dtype)
        o = self.to_out[0](torch.matmul(p, v))
        return x + o.transpose(1, 2).reshape(B, C, H, W)


class Downsample(nn.Module):
    """diffusers Downsample2D: pad (0, 1, 0, 1), then a VALID stride-2 conv."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    """Nearest 2x (jax.image.resize "nearest" at exactly 2x), then a conv."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = _conv3(ch, ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class MidBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(ch, ch), ResnetBlock(ch, ch)])
        self.attentions = nn.ModuleList([AttnBlock(ch)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _Stage(nn.Module):
    """One down (up) block: its resnets, then the optional resampler."""

    def __init__(self, in_ch: int, ch: int, n_res: int, resample: Optional[str]):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(in_ch if j == 0 else ch, ch)
                                      for j in range(n_res)])
        if resample == "down":
            self.downsamplers = nn.ModuleList([Downsample(ch)])
        elif resample == "up":
            self.upsamplers = nn.ModuleList([Upsample(ch)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for r in self.resnets:
            x = r(x)
        for m in getattr(self, "downsamplers", getattr(self, "upsamplers", ())):
            x = m(x)
        return x


class SDEncoder(nn.Module):
    def __init__(self, block_out: Sequence[int] = SD_BLOCK_OUT, layers_per_block: int = 2,
                 latent_channels: int = 4):
        super().__init__()
        n = len(block_out)
        self.conv_in = _conv3(3, block_out[0])
        self.down_blocks = nn.ModuleList([
            _Stage(block_out[max(i - 1, 0)], ch, layers_per_block, "down" if i < n - 1 else None)
            for i, ch in enumerate(block_out)])
        self.mid_block = MidBlock(block_out[-1])
        self.conv_norm_out = GroupNorm(block_out[-1])
        self.conv_out = _conv3(block_out[-1], 2 * latent_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # [B, 3, H, W] in [-1, 1]
        x = self.conv_in(x)
        for blk in self.down_blocks:
            x = blk(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class SDDecoder(nn.Module):
    def __init__(self, block_out: Sequence[int] = SD_BLOCK_OUT, layers_per_block: int = 2,
                 latent_channels: int = 4):
        super().__init__()
        rev = tuple(reversed(block_out))
        n = len(rev)
        self.conv_in = _conv3(latent_channels, rev[0])
        self.mid_block = MidBlock(rev[0])
        self.up_blocks = nn.ModuleList([
            _Stage(rev[max(i - 1, 0)], ch, layers_per_block + 1, "up" if i < n - 1 else None)
            for i, ch in enumerate(rev)])
        self.conv_norm_out = GroupNorm(rev[-1])
        self.conv_out = _conv3(rev[-1], 3)

    def forward(self, z: torch.Tensor) -> torch.Tensor:   # [B, 4, h, w]
        x = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            x = blk(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class SDVAE(nn.Module):
    """Pretrained-compatible SD AutoencoderKL with the FrameVAE contract:
    encode [B, T, 3, H, W] in [0, 1] -> [B, T, 4, H/8, W/8] (0.18215-scaled),
    decode back. Outputs are f32; the compute dtype follows
    models/transformer.set_compute_dtype (the parameters' dtype by default)."""

    def __init__(self, block_out: Sequence[int] = SD_BLOCK_OUT, layers_per_block: int = 2,
                 latent_channels: int = 4):
        super().__init__()
        self.latent_channels = latent_channels
        self.encoder = SDEncoder(block_out, layers_per_block, latent_channels)
        self.decoder = SDDecoder(block_out, layers_per_block, latent_channels)
        self.quant_conv = Conv2d(2 * latent_channels, 2 * latent_channels, 1)
        self.post_quant_conv = Conv2d(latent_channels, latent_channels, 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.quant_conv.compute_dtype or self.quant_conv.weight.dtype

    def encode(self, frames: torch.Tensor, noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The posterior's mean, or a sample of it with `noise` (standard
        normals in the output's shape [B, T, 4, h, w]) or with normals drawn
        from `generator`."""
        B, T = frames.shape[:2]
        x = frames.reshape(B * T, *frames.shape[2:]).to(self.dtype) * 2.0 - 1.0
        mean, logvar = torch.chunk(self.quant_conv(self.encoder(x)), 2, dim=1)
        z = mean
        if noise is None and generator is not None:
            noise = torch.randn(mean.shape, generator=generator, device=generator.device)
        if noise is not None:
            noise = noise.reshape(mean.shape).to(device=mean.device, dtype=mean.dtype)
            z = mean + torch.exp(0.5 * torch.clamp(logvar, -30, 20)) * noise
        z = z * SD_SCALE
        return z.reshape(B, T, *z.shape[1:]).float()

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        B, T = latents.shape[:2]
        z = (latents.reshape(B * T, *latents.shape[2:]) / SD_SCALE).to(self.dtype)
        x = self.decoder(self.post_quant_conv(z))
        x = torch.clamp((x + 1.0) / 2.0, 0.0, 1.0)
        return x.reshape(B, T, *x.shape[1:]).float()

    def forward(self, frames: torch.Tensor, noise: Optional[torch.Tensor] = None):
        z = self.encode(frames, noise)
        return self.decode(z), z


# ---------------------------------------------------------------------------
# diffusers weight conversion (copies of the JAX package's numpy functions)
# ---------------------------------------------------------------------------

def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().float().numpy() if v.dtype == torch.bfloat16 else \
            v.detach().cpu().numpy()
    return np.asarray(v)


def _conv(sd, name):
    w = _np(sd[f"{name}.weight"])
    return {"kernel": np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
            "bias": _np(sd[f"{name}.bias"])}


def _gn(sd, name):
    return {"scale": _np(sd[f"{name}.weight"]), "bias": _np(sd[f"{name}.bias"])}


def _lin(sd, name):
    """Attention projection: Linear [out, in] or legacy 1x1 conv [out, in, 1, 1]."""
    w = _np(sd[f"{name}.weight"])
    if w.ndim == 4:
        w = w[:, :, 0, 0]
    return {"kernel": np.ascontiguousarray(w.T), "bias": _np(sd[f"{name}.bias"])}


def _resnet(sd, p):
    out = {"norm1": _gn(sd, f"{p}.norm1"), "conv1": _conv(sd, f"{p}.conv1"),
           "norm2": _gn(sd, f"{p}.norm2"), "conv2": _conv(sd, f"{p}.conv2")}
    if f"{p}.conv_shortcut.weight" in sd:
        out["conv_shortcut"] = _conv(sd, f"{p}.conv_shortcut")
    return out


def _attn(sd, p):
    to_out = f"{p}.to_out.0" if f"{p}.to_out.0.weight" in sd else f"{p}.proj_attn"
    qn = "to_q" if f"{p}.to_q.weight" in sd else "query"
    kn = "to_k" if f"{p}.to_k.weight" in sd else "key"
    vn = "to_v" if f"{p}.to_v.weight" in sd else "value"
    return {"group_norm": _gn(sd, f"{p}.group_norm"), "to_q": _lin(sd, f"{p}.{qn}"),
            "to_k": _lin(sd, f"{p}.{kn}"), "to_v": _lin(sd, f"{p}.{vn}"),
            "to_out": _lin(sd, to_out)}


def _mid(sd, side):
    return {"resnet_0": _resnet(sd, f"{side}.mid_block.resnets.0"),
            "attn": _attn(sd, f"{side}.mid_block.attentions.0"),
            "resnet_1": _resnet(sd, f"{side}.mid_block.resnets.1")}


def convert_sd_vae_state_dict(sd: Dict, block_out: Sequence[int] = SD_BLOCK_OUT,
                              layers_per_block: int = 2) -> Dict:
    """diffusers AutoencoderKL state dict -> the JAX SDVAE param tree (numpy)."""
    n = len(block_out)
    enc: Dict = {"conv_in": _conv(sd, "encoder.conv_in"),
                 "conv_norm_out": _gn(sd, "encoder.conv_norm_out"),
                 "conv_out": _conv(sd, "encoder.conv_out"), "mid": _mid(sd, "encoder")}
    for i in range(n):
        for j in range(layers_per_block):
            enc[f"down_{i}_res_{j}"] = _resnet(sd, f"encoder.down_blocks.{i}.resnets.{j}")
        if i < n - 1:
            enc[f"down_{i}_ds"] = {"conv": _conv(
                sd, f"encoder.down_blocks.{i}.downsamplers.0.conv")}
    dec: Dict = {"conv_in": _conv(sd, "decoder.conv_in"),
                 "conv_norm_out": _gn(sd, "decoder.conv_norm_out"),
                 "conv_out": _conv(sd, "decoder.conv_out"), "mid": _mid(sd, "decoder")}
    for i in range(n):
        for j in range(layers_per_block + 1):
            dec[f"up_{i}_res_{j}"] = _resnet(sd, f"decoder.up_blocks.{i}.resnets.{j}")
        if i < n - 1:
            dec[f"up_{i}_us"] = {"conv": _conv(sd, f"decoder.up_blocks.{i}.upsamplers.0.conv")}
    return {"encoder": enc, "decoder": dec, "quant_conv": _conv(sd, "quant_conv"),
            "post_quant_conv": _conv(sd, "post_quant_conv")}


def export_sd_vae_state_dict(params: Dict) -> Dict[str, np.ndarray]:
    """Inverse of convert_sd_vae_state_dict: a JAX SDVAE param tree ->
    diffusers names and layouts (numpy), which are this module's."""
    sd: Dict[str, np.ndarray] = {}

    def put_conv(name, tree):
        sd[f"{name}.weight"] = np.ascontiguousarray(_np(tree["kernel"]).transpose(3, 2, 0, 1))
        sd[f"{name}.bias"] = _np(tree["bias"])

    def put_gn(name, tree):
        sd[f"{name}.weight"] = _np(tree["scale"])
        sd[f"{name}.bias"] = _np(tree["bias"])

    def put_lin(name, tree):
        sd[f"{name}.weight"] = np.ascontiguousarray(_np(tree["kernel"]).T)
        sd[f"{name}.bias"] = _np(tree["bias"])

    def put_resnet(name, tree):
        put_gn(f"{name}.norm1", tree["norm1"])
        put_conv(f"{name}.conv1", tree["conv1"])
        put_gn(f"{name}.norm2", tree["norm2"])
        put_conv(f"{name}.conv2", tree["conv2"])
        if "conv_shortcut" in tree:
            put_conv(f"{name}.conv_shortcut", tree["conv_shortcut"])

    def put_attn(name, tree):
        put_gn(f"{name}.group_norm", tree["group_norm"])
        for proj in ("to_q", "to_k", "to_v"):
            put_lin(f"{name}.{proj}", tree[proj])
        put_lin(f"{name}.to_out.0", tree["to_out"])

    for side, tname in (("encoder", "down"), ("decoder", "up")):
        t = params[side]
        put_conv(f"{side}.conv_in", t["conv_in"])
        put_gn(f"{side}.conv_norm_out", t["conv_norm_out"])
        put_conv(f"{side}.conv_out", t["conv_out"])
        put_resnet(f"{side}.mid_block.resnets.0", t["mid"]["resnet_0"])
        put_attn(f"{side}.mid_block.attentions.0", t["mid"]["attn"])
        put_resnet(f"{side}.mid_block.resnets.1", t["mid"]["resnet_1"])
        for key, tree in t.items():
            m = re.match(rf"{tname}_(\d+)_res_(\d+)$", key)
            if m:
                i, j = m.groups()
                put_resnet(f"{side}.{tname}_blocks.{i}.resnets.{j}", tree)
                continue
            m = re.match(rf"{tname}_(\d+)_(ds|us)$", key)
            if m:
                sub = "downsamplers" if m.group(2) == "ds" else "upsamplers"
                put_conv(f"{side}.{tname}_blocks.{m.group(1)}.{sub}.0.conv", tree["conv"])
    put_conv("quant_conv", params["quant_conv"])
    put_conv("post_quant_conv", params["post_quant_conv"])
    return sd


def canonical_state_dict(sd: Dict, block_out: Sequence[int] = SD_BLOCK_OUT,
                         layers_per_block: int = 2) -> Dict[str, torch.Tensor]:
    """A diffusers SD-VAE state dict (legacy attention layout accepted; keys
    outside the AutoencoderKL, such as a checkpoint's extras, dropped) ->
    this module's state dict as f32 tensors."""
    tree = convert_sd_vae_state_dict(sd, block_out, layers_per_block)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in export_sd_vae_state_dict(tree).items()}


def load_sd_vae_safetensors(path: str, block_out: Sequence[int] = SD_BLOCK_OUT,
                            layers_per_block: int = 2) -> Dict[str, torch.Tensor]:
    """The state dict of an SD VAE safetensors checkpoint (a file, or a
    directory of them) for SDVAE(block_out, layers_per_block)."""
    from ..utils.safetensors import read_safetensors

    files = ([path] if path.endswith(".safetensors") else sorted(
        os.path.join(path, f) for f in os.listdir(path) if f.endswith(".safetensors")))
    sd: Dict[str, torch.Tensor] = {}
    for f in files:
        sd.update(read_safetensors(f))
    return canonical_state_dict(sd, block_out, layers_per_block)
