"""The HunyuanVideo and Wan Phase-2 cells cut to CPU sizes: their files
resolve through the manifest, each generator runs its loop and its plain
reference end to end, and the reference agrees with the port on the same
weights and draws."""
import pytest
import torch

from portbench.harness import core


def tiny_hy():
    cell = core.find_cell("hy13b-p1-lora-540p")
    cell.config = dict(cell.config, num_attention_heads=2, num_layers=2, num_single_layers=2,
                       in_channels=4, out_channels=4, text_embed_dim=32,
                       pooled_projection_dim=16, lora_rank=2, frame_cond_hidden=16)
    cell.traffic = dict(cell.traffic, T=7, K=3, latents=[4, 8, 8], text_len=10,
                        text_valid=[2, 8], check_steps=2, trace_steps=1)
    return cell


def tiny_p2():
    cell = core.find_cell("wan13b-p2-L32760-sla")
    cell.config = dict(cell.config, dim=64, num_layers=2, num_heads=2, ffn_dim=128, in_dim=4,
                       out_dim=4, text_dim=32, lora_rank=2, frame_cond_hidden=16)
    cell.traffic = dict(cell.traffic, T=9, latents=[4, 16, 16], text_len=6, sla_block=64,
                        sla_topk=0.5, check_steps=2, trace_steps=1)
    return cell


def test_the_new_cells_resolve():
    for name, gen, ref in (("hy13b-p1-lora-540p", "hy_train", "hunyuan_ref.py"),
                           ("wan13b-p2-L32760-sla", "wan_p2_train", "wan_ref.py")):
        cell = core.find_cell(name)
        assert cell.traffic["generator"] == gen and cell.chips == 1
        assert cell.config["reference"].endswith(ref)
        assert hasattr(core.generator_module(cell), "run")
        assert {m["name"] for m in cell.end_to_end} >= {"train_tokens_per_s", "setup_s",
                                                        "peak_mem_gib"}
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(core.metric_reader(cell, m["name"]))


@pytest.mark.parametrize("make", [tiny_hy, tiny_p2], ids=["hy", "p2"])
def test_a_tiny_run_agrees_with_the_reference_on_the_cpu(make):
    """bf16 on the CPU against the f32 reference: the loss and gradient gaps
    under the cell's limits, the change gap well under the float8
    control's at the same size (the limits are set at the cell's own size,
    on the card)."""
    from portbench.control_video import reference_control

    cell = make()
    seed = 2 ** 31 + 17
    out = core.generator_module(cell).run(cell, seed, 0.5, False, device="cpu")
    gaps = {c.name: c.value for c in out.checks}
    limits = {c.name: c.limit for c in out.checks}
    fp8 = {c.name: c.value for c in reference_control(cell, seed, "cpu")}
    for name in ("loss_gap", "grad_gap_median"):
        assert gaps[name] <= limits[name], gaps
    assert gaps["change_gap_median"] < fp8["change_gap_median"] / 3, (gaps, fp8)
    assert out.failed == 0 and out.attempted >= 1 and out.e2e["train_tokens_per_s"] > 0


@pytest.mark.parametrize("make,name", [(tiny_hy, "state_unchanged"), (tiny_hy, "mask_ignored"),
                                       (tiny_p2, "state_unchanged"), (tiny_p2, "half_batch")],
                         ids=["hy-unchanged", "hy-mask", "p2-unchanged", "p2-half"])
def test_planted_faults_fail_the_comparison(make, name):
    from portbench.control_video import fault

    cell = make()
    with fault(cell.traffic["generator"], name):
        out = core.generator_module(cell).run(cell, 5, 0.0, False, device="cpu")
    assert not out.correct, {c.name: c.value for c in out.checks}


@pytest.mark.parametrize("make", [tiny_hy, tiny_p2], ids=["hy", "p2"])
def test_the_float8_reference_fails_the_comparison(make):
    from portbench.control_video import reference_control

    checks = reference_control(make(), 7, "cpu")
    assert not all(c.ok for c in checks), {c.name: c.value for c in checks}
