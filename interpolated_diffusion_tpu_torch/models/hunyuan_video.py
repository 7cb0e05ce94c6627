"""HunyuanVideo's text-to-video transformer (Tencent, 13B), as a Phase-1
backbone beside models/wan_dit.WanDiT.

The blocks follow diffusers' `HunyuanVideoTransformer3DModel`, and so do the
module names, so that a published checkpoint's state dict maps straight on
(the LoRA leaves `*.lora_A` / `*.lora_B` sit beside each adapted Linear). With
LN the LayerNorm without affine (eps 1e-6) and mod(x, shift, scale) =
LN(x) * (1 + scale) + shift:

- `x_embedder`: the (1, 2, 2) patch Conv3d, run as reshape + Linear;
- `context_embedder` (the token refiner): c = t_emb(t) + MLP(masked mean of
  the valid text tokens); h = proj_in(text); 2 blocks of
  h += gate_msa * attn(LN_affine(h)), h += gate_mlp * ff(LN_affine(h)) with
  (gate_msa, gate_mlp) = Lin(SiLU(c)), 24-head attention with biases and no
  q/k norm under the mask m_i & m_j (column 0 always visible), ff
  Linear-SiLU-Linear;
- temb = t_emb(t) + g_emb(guidance) + MLP(pooled CLIP vector), the time
  embeddings 256-wide [cos | sin] sinusoids through Linear, SiLU, Linear;
- 20 dual-stream blocks: video (`img`) and text (`txt`) keep weights of their
  own (norm1 / norm1_context, to_q.. / add_q_proj.., to_out / to_add_out,
  ff / ff_context), q and k go through RMSNorm over each head's 128 lanes,
  RoPE rotates the video q and k, and one attention runs over [img; txt];
- 40 single-stream blocks over x = [img; txt]: h = mod(x); attention (RoPE on
  the video rows only) and a tanh-GELU MLP run in parallel off h, and
  x += g * proj_out([attn; mlp]);
- the head: (scale, shift) = Lin(SiLU(temb)), scale first, then
  proj_out(mod(img)) and unpatchify.

RoPE rotates interleaved pairs over the t / h / w axes with widths 16 / 56 /
56 and theta 256, t at the frames' absolute indices (the Phase-1 keyframes
keep the positions of the frames they came from). The text's valid tokens are
a prefix of its rows (the Phase-1 trainer's K frame-condition tokens, then the
prompt's valid tokens), so the joint attention's mask is a key length per
sample: L_video + valid text. It runs through the port's flash kernels with
that length per row (kernels/block_sparse_attention.flash_attention's
kv_lens), so padded text keys get no weight and no gradient; the refiner's
261-token attention is plain masked attention. Each block's q and k norms
(and RoPE) are one `qk_norm_rope` launch each way (its per-head form, told by
the [Dh] weight), and each mod() one `ln_modulate` launch each way (the
dual block's video and text slices of x read in place); the refiner's affine
LNs keep LayerNorm.

The compute dtype is the parameters' unless `set_compute_dtype` names
another, as in WanDiT; `use_remat` puts one activation checkpoint around each
block. The spans `idt.hy.refiner`, `idt.hy.double` and `idt.hy.single` (each
with its backward) and `idt.hy.attn` (the joint attention) mark the work in a
profiler trace (utils/profiling.py).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.block_sparse_attention import flash_attention
from ..kernels.ln_modulate import ln_modulate
from ..kernels.qk_norm_rope import qk_norm_rope
from ..utils.profiling import backward_span, span
from .transformer import LayerNorm
from .wan_dit import FeedForward, LoRALinear, RMSNorm, build_rope_freqs, wan_rope_tables

REFINER = "idt.hy.refiner"
DOUBLE = "idt.hy.double"
SINGLE = "idt.hy.single"
ATTN = "idt.hy.attn"
# the embedded guidance scale a call without `guidance` trains or samples at
# (HunyuanVideo's default), fed x 1000 as diffusers feeds it
EMBEDDED_GUIDANCE = 6.0
FLASH_BLOCKS = (512, 1024)   # the twin's key tile (where it rounds P), as WanAttention's


def time_proj(t: torch.Tensor, dim: int = 256) -> torch.Tensor:
    """diffusers' Timesteps(dim, flip_sin_to_cos=True, shift 0): [cos | sin]
    of t * exp(-ln(10000) i / (dim / 2)), f32 [B, dim]."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    a = t.float()[:, None] * freqs
    return torch.cat([torch.cos(a), torch.sin(a)], dim=-1)


def joint_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_lens: torch.Tensor) -> torch.Tensor:
    """Attention of head-major q / k / v [B, H, L, Dh], row (b, h) over its
    first kv_lens[b * H + h] keys (int32 [B * H]), through the flash kernels
    (bf16 on the card; the twin in the inputs' dtype on the CPU) ->
    [B, L, H * Dh] in q's dtype."""
    B, H, L, Dh = q.shape
    with span(ATTN):
        dt = torch.bfloat16 if q.is_cuda else q.dtype
        heads = lambda t: t.reshape(B * H, L, Dh).to(dt).contiguous()
        out = flash_attention(heads(q), heads(k), heads(v), *FLASH_BLOCKS, kv_lens=kv_lens)
    return out.reshape(B, H, L, Dh).to(q.dtype).transpose(1, 2).reshape(B, L, H * Dh)


def _heads(t: torch.Tensor, H: int) -> torch.Tensor:
    B, L, D = t.shape
    return t.reshape(B, L, H, D // H).transpose(1, 2)


def _mod(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor):
    """mod(x, shift, scale) through kernels/ln_modulate (its twin on the CPU)."""
    return ln_modulate(x, scale, shift, form="adaln")


class _Lin(LoRALinear):
    """A frozen Linear (no LoRA) that computes in the compute dtype."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__(d_in, d_out, 0)


class _SiluFF(nn.Module):
    """diffusers' FeedForward(activation_fn="linear-silu"): net.0.proj, SiLU,
    net.2 (the refiner's MLP)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.net = nn.ModuleList([nn.Module(), nn.Identity(), _Lin(hidden, dim)])
        self.net[0].proj = _Lin(dim, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](F.silu(self.net[0].proj(x)))


class _Embedding(nn.Module):
    """diffusers' TimestepEmbedding / PixArtAlphaTextProjection: linear_1,
    SiLU, linear_2."""

    def __init__(self, d_in: int, dim: int):
        super().__init__()
        self.linear_1 = _Lin(d_in, dim)
        self.linear_2 = _Lin(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class _AdaLinear(nn.Module):
    """Lin(SiLU(temb)) split into n modulation vectors [B, dim] (diffusers'
    AdaLayerNormZero / -Single / -Continuous / HunyuanVideoAdaNorm `linear`)."""

    def __init__(self, dim: int, n: int):
        super().__init__()
        self.n = n
        self.linear = _Lin(dim, n * dim)

    def forward(self, temb: torch.Tensor):
        return self.linear(F.silu(temb)).chunk(self.n, dim=-1)


class _RefinerAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_q, self.to_k, self.to_v = _Lin(dim, dim), _Lin(dim, dim), _Lin(dim, dim)
        self.to_out = nn.ModuleList([_Lin(dim, dim)])

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x [B, L, dim], mask [B, L, L] bool (True: attend); f32 softmax."""
        H = self.heads
        q, k, v = (_heads(f(x), H) for f in (self.to_q, self.to_k, self.to_v))
        logits = (q @ k.transpose(-1, -2)).float() * q.shape[-1] ** -0.5
        p = torch.softmax(logits.masked_fill(~mask[:, None], float("-inf")), dim=-1)
        o = (p.to(v.dtype) @ v).transpose(1, 2).reshape(x.shape)
        return self.to_out[0](o)


class _RefinerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = _RefinerAttention(dim, heads)
        self.norm2 = LayerNorm(dim)
        self.ff = _SiluFF(dim, int(dim * mlp_ratio))
        self.norm_out = _AdaLinear(dim, 2)

    def forward(self, h, temb, mask):
        gate_msa, gate_mlp = self.norm_out(temb)
        h = h + self.attn(self.norm1(h), mask) * gate_msa[:, None]
        return h + self.ff(self.norm2(h)) * gate_mlp[:, None]


class _IndividualTokenRefiner(nn.Module):
    def __init__(self, dim: int, heads: int, n_layers: int, mlp_ratio: float):
        super().__init__()
        self.refiner_blocks = nn.ModuleList([_RefinerBlock(dim, heads, mlp_ratio)
                                             for _ in range(n_layers)])


class _TimeTextEmbed(nn.Module):
    """CombinedTimestep(Guidance)TextProjEmbeddings: t_emb(t) (+ g_emb(g)) +
    MLP(pooled)."""

    def __init__(self, dim: int, pooled_dim: int, guidance: bool):
        super().__init__()
        self.timestep_embedder = _Embedding(256, dim)
        self.guidance_embedder = _Embedding(256, dim) if guidance else None
        self.text_embedder = _Embedding(pooled_dim, dim)

    def forward(self, t, pooled, guidance=None, dtype=torch.bfloat16):
        emb = self.timestep_embedder(time_proj(t).to(dtype))
        if self.guidance_embedder is not None:
            emb = emb + self.guidance_embedder(time_proj(guidance).to(dtype))
        return emb + self.text_embedder(pooled.to(dtype))


class HunyuanVideoTokenRefiner(nn.Module):
    """The context embedder: text states [B, Lt, text_dim] and their mask
    [B, Lt] (valid tokens a prefix) -> refined tokens [B, Lt, dim]."""

    def __init__(self, text_dim: int, dim: int, heads: int, n_layers: int,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.time_text_embed = _TimeTextEmbed(dim, text_dim, guidance=False)
        self.proj_in = _Lin(text_dim, dim)
        self.token_refiner = _IndividualTokenRefiner(dim, heads, n_layers, mlp_ratio)

    def forward(self, text, t, mask, dtype):
        m = mask.float()[..., None]
        pooled = (text.float() * m).sum(dim=1) / m.sum(dim=1)
        temb = self.time_text_embed(t, pooled, dtype=dtype)
        h = self.proj_in(text.to(dtype))
        valid = mask.bool()
        attend = valid[:, :, None] & valid[:, None, :]
        attend[:, :, 0] = True
        for blk in self.token_refiner.refiner_blocks:
            h = blk(h, temb, attend)
        return h


class HunyuanVideoAttention(nn.Module):
    """to_q / to_k / to_v with per-head RMSNorm on q and k; the dual-stream
    form adds to_out.0 and the text stream's add_{q,k,v}_proj,
    norm_added_{q,k} and to_add_out (the single-stream form is diffusers'
    pre_only: its block's proj_out takes the attention's output)."""

    def __init__(self, dim: int, heads: int, lora: tuple, dual: bool):
        super().__init__()
        self.heads, dh = heads, dim // heads
        self.to_q, self.to_k, self.to_v = (LoRALinear(dim, dim, *lora) for _ in range(3))
        self.norm_q, self.norm_k = RMSNorm(dh), RMSNorm(dh)
        if dual:
            self.add_q_proj, self.add_k_proj, self.add_v_proj = (
                LoRALinear(dim, dim, *lora) for _ in range(3))
            self.norm_added_q, self.norm_added_k = RMSNorm(dh), RMSNorm(dh)
            self.to_out = nn.ModuleList([LoRALinear(dim, dim, *lora)])
            self.to_add_out = LoRALinear(dim, dim, *lora)

    def qk(self, x, q_proj, k_proj, q_norm, k_norm, rope, rope_rows=None):
        """Head-major normed q, k [B, H, L, Dh] of x, RoPE on the first
        rope_rows tokens (all with rope_rows None, none without rope)."""
        H = self.heads
        out = []
        for proj, norm in ((q_proj, q_norm), (k_proj, k_norm)):
            if rope is None:
                y = qk_norm_rope(proj(x), norm.weight, n_heads=H, eps=norm.eps)
                out.append(_heads(y, H))
            else:
                out.append(qk_norm_rope(proj(x), norm.weight, *rope, n_heads=H, eps=norm.eps,
                                        rope_rows=rope_rows))
        return out


class HunyuanVideoTransformerBlock(nn.Module):
    """Dual-stream block over x = [img (L_v rows); txt] [B, L, dim]."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float, lora_attn: tuple,
                 lora_ffn: tuple):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.norm1, self.norm1_context = _AdaLinear(dim, 6), _AdaLinear(dim, 6)
        self.attn = HunyuanVideoAttention(dim, heads, lora_attn, dual=True)
        self.ff = FeedForward(dim, hidden, *lora_ffn)
        self.ff_context = FeedForward(dim, hidden, *lora_ffn)

    def forward(self, x, temb, rope, kv_len, L_v: int):
        with span(DOUBLE):
            return backward_span(DOUBLE, self._forward, x, temb, rope, kv_len, L_v)

    def _forward(self, x, temb, rope, kv_len, L_v):
        img, txt = x[:, :L_v], x[:, L_v:]
        sh, sc, g, sh2, sc2, g2 = self.norm1(temb)
        csh, csc, cg, csh2, csc2, cg2 = self.norm1_context(temb)
        a = self.attn
        h_img, h_txt = _mod(img, sh, sc), _mod(txt, csh, csc)
        q_i, k_i = a.qk(h_img, a.to_q, a.to_k, a.norm_q, a.norm_k, rope)
        q_t, k_t = a.qk(h_txt, a.add_q_proj, a.add_k_proj, a.norm_added_q, a.norm_added_k, None)
        v = torch.cat([_heads(a.to_v(h_img), a.heads), _heads(a.add_v_proj(h_txt), a.heads)],
                      dim=2)
        o = joint_attention(torch.cat([q_i, q_t], dim=2), torch.cat([k_i, k_t], dim=2), v,
                            kv_len)
        img = img + a.to_out[0](o[:, :L_v]) * g[:, None]
        txt = txt + a.to_add_out(o[:, L_v:]) * cg[:, None]
        img = img + g2[:, None] * self.ff(_mod(img, sh2, sc2))
        txt = txt + cg2[:, None] * self.ff_context(_mod(txt, csh2, csc2))
        return torch.cat([img, txt], dim=1)


class HunyuanVideoSingleTransformerBlock(nn.Module):
    """Single-stream block over x = [img (L_v rows); txt] [B, L, dim]."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float, lora_attn: tuple,
                 lora_ffn: tuple, lora_out: tuple):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.attn = HunyuanVideoAttention(dim, heads, lora_attn, dual=False)
        self.norm = _AdaLinear(dim, 3)
        self.proj_mlp = LoRALinear(dim, hidden, *lora_ffn)
        self.proj_out = LoRALinear(dim + hidden, dim, *lora_out)

    def forward(self, x, temb, rope, kv_len, L_v: int):
        with span(SINGLE):
            return backward_span(SINGLE, self._forward, x, temb, rope, kv_len, L_v)

    def _forward(self, x, temb, rope, kv_len, L_v):
        sh, sc, g = self.norm(temb)
        h = _mod(x, sh, sc)
        a = self.attn
        q, k = a.qk(h, a.to_q, a.to_k, a.norm_q, a.norm_k, rope, rope_rows=L_v)
        o = joint_attention(q, k, _heads(a.to_v(h), a.heads), kv_len)
        m = F.gelu(self.proj_mlp(h), approximate="tanh")
        return x + g[:, None] * self.proj_out(torch.cat([o, m], dim=-1))


class HunyuanVideoTransformer3DModel(nn.Module):
    """The HunyuanVideo transformer over [B, C, T, H, W] latents.

    Defaults are the published config (hunyuanvideo-community/HunyuanVideo,
    transformer/config.json): 24 heads of 128, 20 dual- and 40
    single-stream blocks, 2 refiner blocks, mlp_ratio 4, patch (1, 2, 2),
    text states 4096 wide, a pooled 768-wide CLIP vector, guidance
    embedding, RoPE axes 16 / 56 / 56 at theta 256. LoRA (rank, alpha, form
    as LoRALinear's) adapts the dual-stream blocks' attention projections
    and FFNs and the single-stream blocks' q / k / v, proj_mlp and proj_out
    (`lora_targets` "attn", "ffn" or both; proj_out follows either); the
    refiner, the embedders and the modulation Linears carry none.
    """

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, in_channels: int = 16, out_channels: int = 16,
                 num_attention_heads: int = 24, attention_head_dim: int = 128,
                 num_layers: int = 20, num_single_layers: int = 40,
                 num_refiner_layers: int = 2, mlp_ratio: float = 4.0, patch_size: int = 2,
                 patch_size_t: int = 1, guidance_embeds: bool = True,
                 text_embed_dim: int = 4096, pooled_projection_dim: int = 768,
                 rope_theta: float = 256.0, rope_axes_dim: Tuple[int, int, int] = (16, 56, 56),
                 lora_rank: int = 0, lora_alpha: float = 16.0, lora_targets: str = "attn,ffn",
                 lora_form: str = "runtime", use_remat: bool = False, max_seq_len: int = 1024):
        super().__init__()
        dim = num_attention_heads * attention_head_dim
        if sum(rope_axes_dim) != attention_head_dim:
            raise ValueError(f"rope_axes_dim {rope_axes_dim} must sum to the head dim "
                             f"{attention_head_dim}")
        self.dim, self.heads, self.out_channels = dim, num_attention_heads, out_channels
        self.patch_size = (patch_size_t, patch_size, patch_size)
        self.rope_theta, self.rope_axes_dim = rope_theta, tuple(rope_axes_dim)
        self.use_remat, self.max_seq_len = use_remat, max_seq_len
        targets = {t.strip() for t in lora_targets.split(",")}
        on = lambda used: (lora_rank if used else 0, lora_alpha, lora_form)
        l_attn, l_ffn = on("attn" in targets), on("ffn" in targets)
        l_out = on(bool(targets & {"attn", "ffn"}))
        self.x_embedder = nn.Module()
        self.x_embedder.proj = nn.Conv3d(in_channels, dim, self.patch_size,
                                         stride=self.patch_size)
        self.context_embedder = HunyuanVideoTokenRefiner(text_embed_dim, dim,
                                                         num_attention_heads,
                                                         num_refiner_layers, mlp_ratio)
        self.time_text_embed = _TimeTextEmbed(dim, pooled_projection_dim, guidance_embeds)
        self.transformer_blocks = nn.ModuleList([
            HunyuanVideoTransformerBlock(dim, num_attention_heads, mlp_ratio, l_attn, l_ffn)
            for _ in range(num_layers)])
        self.single_transformer_blocks = nn.ModuleList([
            HunyuanVideoSingleTransformerBlock(dim, num_attention_heads, mlp_ratio, l_attn,
                                               l_ffn, l_out)
            for _ in range(num_single_layers)])
        self.norm_out = _AdaLinear(dim, 2)
        self.proj_out = _Lin(dim, out_channels * math.prod(self.patch_size))

    def _run(self, block, x, temb, rope, kv_len, L_v):
        if self.use_remat and torch.is_grad_enabled():
            # non-reentrant: with only LoRA leaves training, the tokens
            # entering the first block require no gradient
            return checkpoint(block, x, temb, rope, kv_len, L_v, use_reentrant=False,
                              preserve_rng_state=False)
        return block(x, temb, rope, kv_len, L_v)

    def forward(self, latents: torch.Tensor, t: torch.Tensor, text: torch.Tensor,
                frame_indices: Optional[torch.Tensor] = None,
                extra_context: Optional[torch.Tensor] = None, *, text_mask: torch.Tensor,
                pooled: torch.Tensor, guidance: Optional[torch.Tensor] = None) -> torch.Tensor:
        """latents [B, C, T, H, W], t [B] (the diffusion step), text [B, Lt,
        text_dim] with text_mask [B, Lt] (valid tokens first), frame_indices
        [B, T] (absolute-time RoPE), extra_context [B, L_extra, text_dim]
        (WanDiT's positions: the frame-condition tokens, which go ahead of
        the prompt into the token refiner, all valid, so that the valid
        tokens stay a prefix), pooled [B, pooled_dim], guidance [B] (the
        embedded guidance scale x 1000; EMBEDDED_GUIDANCE when None) ->
        [B, C_out, T, H, W] f32."""
        dtype = self.compute_dtype or self.proj_out.weight.dtype
        B, C, T, H, W = latents.shape
        pt, ph, pw = self.patch_size
        ppf, pph, ppw = T // pt, H // ph, W // pw
        L_v = ppf * pph * ppw

        z = latents.reshape(B, C, ppf, pt, pph, ph, ppw, pw).permute(0, 2, 4, 6, 1, 3, 5, 7)
        z = z.reshape(B, L_v, C * pt * ph * pw)
        proj = self.x_embedder.proj
        img = F.linear(z.to(dtype), proj.weight.flatten(1).to(dtype), proj.bias.to(dtype))

        if extra_context is not None:
            text = torch.cat([extra_context.to(text.dtype), text], dim=1)
            text_mask = torch.cat([torch.ones_like(text_mask[:, :extra_context.shape[1]]),
                                   text_mask], dim=1)
        if guidance is None:
            guidance = torch.full((B,), EMBEDDED_GUIDANCE * 1000.0, device=latents.device)
        temb = self.time_text_embed(t, pooled, guidance, dtype=dtype)
        with span(REFINER):
            txt = backward_span(REFINER, self.context_embedder, text, t, text_mask, dtype)
        # keys per (sample, head): the video and the valid text, a prefix
        kv_len = (L_v + text_mask.sum(dim=1)).to(torch.int32).repeat_interleave(self.heads)

        if frame_indices is not None and pt != 1:
            frame_indices = frame_indices // pt
        tables, dims = wan_rope_tables(self.max_seq_len, self.dim // self.heads, self.rope_theta,
                                       latents.device, self.rope_axes_dim)
        rope = build_rope_freqs(tables, dims, ppf, pph, ppw, frame_indices)

        x = torch.cat([img, txt.to(dtype)], dim=1)
        for block in self.transformer_blocks:
            x = self._run(block, x, temb, rope, kv_len, L_v)
        for block in self.single_transformer_blocks:
            x = self._run(block, x, temb, rope, kv_len, L_v)

        scale, shift = self.norm_out(temb)
        out = self.proj_out(_mod(x[:, :L_v], shift, scale))
        out = out.reshape(B, ppf, pph, ppw, self.out_channels, pt, ph, pw)
        out = out.permute(0, 4, 1, 5, 2, 6, 3, 7).reshape(B, self.out_channels, T, H, W)
        return out.float()
