"""Causal Stage-2 trainer: train/train_interp_levels.py with `--causal 1`
forced (port of train/train_interp_levels_causal.py: the same trainer, a
causal attention mask in the denoiser).

    python -m interpolated_diffusion_tpu_torch.train.train_interp_levels_causal [flags]
"""
import sys

from .train_interp_levels import build_argparser, main as _main  # noqa: F401


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--causal" not in argv:
        argv += ["--causal", "1"]
    return _main(argv)


if __name__ == "__main__":
    main()
