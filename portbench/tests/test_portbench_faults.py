"""Each cell's comparison on the CPU at tiny widths: a sound run of the
program is correct; the control (the reference one precision below, float8)
and the program broken underneath in each way the cell can be broken are
not. The harness's look for a chip is skipped (device="cpu"); the rest of a
run is driven as on the card."""
import pytest

from pb_tiny import tiny_maze, tiny_wan
from portbench import control
from portbench.faults import FAULTS
from portbench.harness import core

SEED = 2 ** 31 + 977


def _run(cell, seconds=0.3):
    return core.generator_module(cell).run(cell, SEED, seconds, False, device="cpu")


def test_wan_sound_run_is_correct():
    out = _run(tiny_wan())
    assert out.correct, [(c.name, c.value, c.limit) for c in out.checks]


@pytest.mark.parametrize("policy", ["block", "fused"])
def test_maze_sound_run_is_correct(policy):
    out = _run(tiny_maze(policy))
    assert out.correct and out.failed == 0, [(c.name, c.value) for c in out.checks]


@pytest.mark.parametrize("which", ["wan", "maze"])
def test_control_float8_reference_is_not_correct(which):
    if which == "wan":
        checks = control.wan_control(tiny_wan(), SEED, "cpu", "fp8")
    else:
        checks = control.maze_control(tiny_maze(), SEED, "cpu", "fp8", n_calls=4)
    assert not all(c.ok for c in checks), [(c.name, c.value, c.limit) for c in checks]


@pytest.mark.parametrize("fault,cell", [("state_unchanged", "wan"), ("half_batch", "wan"),
                                        ("altered_answer", "maze"), ("half_requests", "maze")])
def test_planted_fault_is_not_correct(fault, cell):
    with FAULTS[fault]():
        out = _run(tiny_wan() if cell == "wan" else tiny_maze("block"))
    assert not out.correct, [(c.name, c.value, c.limit) for c in out.checks]
    if fault == "altered_answer":
        assert out.failed == 0   # only the comparison with the reference sees it
