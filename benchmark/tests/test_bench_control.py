"""The control comes out not correct.

The control is the reference put in the program's place and computed in
TF32, the precision below the configurations' float32 with TF32 off: its
answers, held against the float64 reference by the cell's own comparison,
must fail at least one of the cell's limits, on three seeds. On the CPU the
cells run at the tests' tiny size against the tiny limits, with TF32's
rounding of every matrix product's operands done in the reference itself;
the ``cuda`` case runs the cells at their own size on the card against
their own limits (benchmark/control.py prints the same readings).

    python -m pytest benchmark/tests -q
"""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import checks, harness, reference  # noqa: E402
from benchmark.tests.test_bench_harness import tiny_tree  # noqa: E402

CELLS = ("odom_kitti64.stream", "loc_corridor16m.scan", "odom_kitti64.fleet8")
SEEDS = (21, 22, 23)


def control_fails(root, cell, seed, device):
    _, cfg, traffic, limits = harness.cell_of(harness.spec_of(root), cell, root)
    drv = harness.driver_of(traffic["kind"], root)(cfg, traffic, seed, torch.device(device),
                                                   lambda *a: None)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ctl = drv.reference(reference.TF32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    correct, rows = checks.judge(drv.compare(ctl, drv.reference(reference.FLOAT64)), limits)
    return not correct, rows


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_a_limit(root, cell, seed):
    failed, rows = control_fails(root, cell, seed, "cpu")
    assert failed, rows


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_a_limit_on_the_card(cell, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells at their own size")
    failed, rows = control_fails(harness.HERE, cell, seed, "cuda")
    assert failed, rows
