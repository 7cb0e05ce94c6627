"""On the card only (marked gpu; the fixture skips where there is none): a
short run of each maze cell at its own size is correct and runs the path it
names, launches included."""
import pytest

from portbench.harness import core


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["maze-plan-b4096-block", "maze-plan-b4096-fused"])
def test_maze_cell_on_the_card(cuda_device, cell):
    c = core.find_cell(cell)
    out = core.generator_module(c).run(c, 2 ** 31 + 5, 1.0, False, device=cuda_device)
    names = {ch.name for ch in out.checks}
    assert {"launches_fused_film_block", "launches_small_mha_packed"} <= names
    assert out.correct, [(ch.name, ch.value, ch.limit) for ch in out.checks]
