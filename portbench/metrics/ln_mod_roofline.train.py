"""The LayerNorm + modulation kernel pair's share of its roofline, in %: the
bytes of a step's launches over 3.35 TB/s, per traced step, against the
device time of the pair's kernels in the traced steps.

The bytes are counted here from the shapes (bf16 rows; each input read once,
each output written once): a forward launch reads x and writes y, a per-row
f32 mean and rstd, and reads the modulation (adaLN: the scale and shift rows
of each batch row, f32 in Wan and bf16 in HunyuanVideo; affine: a bf16 weight
and bias); a backward launch reads dy, x, the mean and rstd and the scale (or
weight) and writes dx. A LoRA step under remat runs every block's forward
twice and the head's once, and every backward once:

- Wan: three LNs a block over B x L rows (norm1, norm3 adaLN, norm2 affine)
  and the head's; no backward for the first block's norm1, whose input and
  modulation want no gradient;
- HunyuanVideo: four a dual-stream block (two over the video rows, two over
  the text rows: K frame-condition tokens and the prompt slots), one a
  single-stream block over the joint rows, the head's over the video rows.

The program before this kernel pair has no such kernels, and this returns
None."""
from portbench.harness.program_spans import traced
from portbench.harness.work import PEAK_HBM

NAMES = ("ln_mod_fwd_kernel", "ln_mod_bwd_kernel")
BF16, F32 = 2, 4


def _ours(name: str) -> bool:
    return any(n in name for n in NAMES)


def _launch(rows: int, d: int, bwd: bool, mod_bytes: int) -> float:
    """Bytes of one launch over `rows` token rows of width d."""
    row = (3 if bwd else 2) * d * BF16 + 2 * F32
    return rows * row + (1 if bwd else 2) * mod_bytes


def step_bytes(cfg, B: int, L: int, L_text: int = 0) -> float:
    """Bytes of the pair's launches in one LoRA training step under remat."""
    if "num_single_layers" in cfg:   # HunyuanVideo
        d = cfg["num_attention_heads"] * cfg["attention_head_dim"]
        n2, n1 = cfg["num_layers"], cfg["num_single_layers"]
        mod = B * d * BF16

        def once(bwd: bool) -> float:
            dual = 2 * (_launch(B * L, d, bwd, mod) + _launch(B * L_text, d, bwd, mod))
            return n2 * dual + n1 * _launch(B * (L + L_text), d, bwd, mod)

        head = _launch(B * L, d, False, mod) + _launch(B * L, d, True, mod)
        return 2 * once(False) + once(True) + head
    d, n = cfg["dim"], cfg["num_layers"]
    ada, affine = B * d * F32, d * BF16
    fwd = 2 * n * (2 * _launch(B * L, d, False, ada) + _launch(B * L, d, False, affine))
    bwd = n * (2 * _launch(B * L, d, True, ada) + _launch(B * L, d, True, affine))
    bwd -= _launch(B * L, d, True, ada)   # the first block's norm1
    head = _launch(B * L, d, False, ada) + _launch(B * L, d, True, ada)
    return fwd + bwd + head


def read(run):
    trace = traced(run, "train")
    if trace is None:
        return None
    busy = trace.device_s([op for op in trace.device if _ours(op[0])])
    if busy <= 0:
        return None
    cfg, tr = run["cfg"], run["traffic"]
    L_text = tr["K"] + tr["text_len"] if "num_single_layers" in cfg else 0
    least = trace.units["steps"] * step_bytes(cfg, run["batch"], run["tokens"], L_text) / PEAK_HBM
    return 100.0 * least / busy
