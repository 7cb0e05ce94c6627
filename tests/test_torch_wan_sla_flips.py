"""What flipped SLA top-k blocks do to Wan Phase-1 training, on the CPU.

SLA's LUT is a discrete top-k over pooled q / k scores. On the card, the
kernel path and the plain-twin path of one training step differ upstream by
single bf16 ulps, and ~1% of LUT rows then name another set of key blocks
(PERF.md §7). This test trains the tiny Wan config of
tests/test_torch_wan_trainer_e2e.py twice from the same seed, batches and
draws: once with the path's own LUTs, once with LUTs from q and k moved by
one bf16 ulp each (up or down at random, zeros kept) before `get_block_map`.
The attention itself always runs on the unperturbed q, k, v, so the LUT is
the only difference between the runs.

The configuration: the tiny model (64d x 2 layers x 2 heads, bf16, remat)
under --attn_mode sla with --phase1_input_mode full (9 frames of 4 x 4
tokens, L = 144) and --sla_block 16, so that each query block picks 4 of 9
key blocks; lr 1e-3 so that 20 steps move the loss.

Bounds: the share of flipped rows must lie in [0.1%, 10%] (the perturbation
reproduces the card's ~1% regime, and the test is not vacuous); the largest
loss gap between the runs over the 20 steps must stay under a tenth of the
mean change of the loss from one step to the next in the run with its own
LUTs: flipped blocks may move training by less than a tenth of what one
batch moves it. Measured when the test was written: 1.25% of rows flipped
(36 of 2880), a gap of 4.0e-4 against a mean step change of 5.4e-2, so a
bound of 5.4e-3.
"""
import numpy as np
import torch

from interpolated_diffusion_tpu_torch.kernels import sla
from interpolated_diffusion_tpu_torch.train import train_keypoints_wansynth as ptrainer
from interpolated_diffusion_tpu_torch.train import wansynth_common as pcommon

TINY = ["--num_samples", "12", "--T", "9", "--latent_c", "4", "--latent_h", "8",
        "--latent_w", "8", "--text_len", "8", "--text_dim", "64", "--wan_dim", "64",
        "--wan_layers", "2", "--wan_heads", "2", "--wan_ffn", "128", "--batch", "2",
        "--K", "3", "--N_train", "20", "--lora_rank", "2"]
ARGS = TINY + ["--device", "cpu", "--attn_mode", "sla", "--sla_block", "16", "--sla_topk", "0.5",
               "--phase1_input_mode", "full", "--prefetch_depth", "0", "--lr", "1e-3"]
STEPS = 20


def one_ulp(x: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """x rounded to bf16 and moved by one bf16 ulp, up or down in magnitude
    at random (bf16 is sign-magnitude: +-1 on the bit pattern); zeros kept."""
    bits = x.to(torch.bfloat16).view(torch.int16)
    step = torch.randint(0, 2, bits.shape, generator=gen, dtype=torch.int16) * 2 - 1
    step = torch.where(bits & 0x7FFF == 0, torch.zeros_like(step), step)
    return (bits + step).view(torch.bfloat16).to(x.dtype)


def _train(monkeypatch, perturb: bool):
    """Losses of STEPS steps from seed 0, and [flipped rows, rows] of the
    LUTs (flipped: the set of key blocks differs from the own choice)."""
    args = ptrainer.build_argparser().parse_args(ARGS)
    device = torch.device("cpu")
    wan, fc = pcommon.build_wan(args, bool(args.bf16), generator=torch.Generator().manual_seed(0),
                                zero_init_scale=1e-2)
    state, base, train_step, _, _ = ptrainer.make_trainer(args, device, wan, fc)
    loader = pcommon.make_wansynth_loader(args, args.seed)
    own, stats, gen = sla.get_block_map, [0, 0], torch.Generator().manual_seed(5)

    def get_block_map(q, k, *a, **kw):
        sparse_map, lut, topk = own(q, k, *a, **kw)
        stats[1] += lut.shape[0] * lut.shape[1]
        if not perturb:
            return sparse_map, lut, topk
        sparse_map, moved, _ = own(one_ulp(q, gen), one_ulp(k, gen), *a, **kw)
        stats[0] += int((lut.sort(dim=-1).values != moved.sort(dim=-1).values).any(-1).sum())
        return sparse_map, moved, topk

    monkeypatch.setattr(sla, "get_block_map", get_block_map)
    N = (args.latent_h // 2) * (args.latent_w // 2)
    z_shape = (args.batch, ptrainer.noised_frames(args), N, args.latent_c * 4)
    losses = []
    for i in range(STEPS):
        batch = {k: torch.as_tensor(v) for k, v in next(loader).items()}
        draws = ptrainer.draw_phase1(torch.Generator().manual_seed(100 + i), args, args.batch,
                                     z_shape)
        state, metrics = train_step(state, base, batch, draws)
        losses.append(float(metrics["loss"]))
    monkeypatch.setattr(sla, "get_block_map", own)
    return np.array(losses), stats


def test_lut_flips_move_training_less_than_a_batch(monkeypatch):
    own_losses, own_stats = _train(monkeypatch, perturb=False)
    flip_losses, (flipped, rows) = _train(monkeypatch, perturb=True)
    assert rows == own_stats[1] > 0
    share = flipped / rows
    gap = np.abs(flip_losses - own_losses).max()
    step_change = np.abs(np.diff(own_losses)).mean()
    print(f"LUT rows flipped by one bf16 ulp of q / k: {flipped} of {rows} ({100 * share:.2f}%); "
          f"largest loss gap over {STEPS} steps {gap:.3e}, mean step change {step_change:.3e}")
    assert np.isfinite(own_losses).all() and np.isfinite(flip_losses).all()
    assert 1e-3 <= share <= 0.1, share
    assert gap <= 0.1 * step_change, (gap, step_change)
