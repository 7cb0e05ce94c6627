"""TinyTemporalInterpolator on wansynth latents: train_video_interpolator
with `--workload wansynth` unless the flag is given (port of
train/train_video_interpolator_wansynth.py)."""
from .train_video_interpolator import build_argparser  # noqa: F401
from .train_video_interpolator import main as _main


def main(argv=None):
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--workload" not in argv:
        argv += ["--workload", "wansynth"]
    return _main(argv)


if __name__ == "__main__":
    main()
