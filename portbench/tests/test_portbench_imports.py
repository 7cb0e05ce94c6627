"""Nothing a benchmark run loads imports JAX or the JAX package, and the
plain references import nothing of the program either. Names are compared
by their top-level module, whole: the port's name begins with the JAX
package's."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.harness import core

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "interpolated_diffusion_tpu"}
PORT = "interpolated_diffusion_tpu_torch"


def _modules():
    return sorted(p for p in core.BENCH_DIR.rglob("*.py")
                  if "__pycache__" not in p.parts and "tests" not in p.parts)


def _imported_tops(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".", 1)[0]


@pytest.mark.parametrize("path", _modules(), ids=lambda p: p.relative_to(core.BENCH_DIR).as_posix())
def test_no_jax_in_what_a_run_loads(path):
    assert not set(_imported_tops(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((core.BENCH_DIR / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert PORT not in set(_imported_tops(path))
    assert not set(_imported_tops(path)) & FORBIDDEN


def test_forbidden_names_compared_whole():
    assert core.FORBIDDEN_MODULES == tuple(sorted(FORBIDDEN, key=list(core.FORBIDDEN_MODULES).index))
    sys.modules.setdefault("interpolated_diffusion_tpu_torch_fake_mod", type(sys)("x"))
    assert "interpolated_diffusion_tpu_torch_fake_mod" not in core.forbidden_loaded()


def test_run_refuses_without_a_card():
    """No CUDA device here: non-zero exit and no result on standard output."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, str(core.BENCH_DIR / "run.py"), "--workload",
                           "maze-plan-b4096-block", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, cwd=core.ROOT,
                          timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
