"""The control, the reference with float8 e4m3 operands in the program's
place, comes out not correct under every cell's limits: on the CPU at a
tiny size, and (marked ``cuda``) on the card at a cell's own size, where
the program's own readings pass the same limits."""

import pytest

import benchmark.run as R
from benchmark.harness import check, sample, train
from benchmark.harness.registry import Registry
from benchmark.reference.models import PRECISIONS
from benchmark.tests.conftest import ROOT, cpu_context

FP8 = PRECISIONS["float8_e4m3"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_sampling_control_fails(seed, tiny_config, tiny_sample_traffic):
    ctx = cpu_context(tiny_config, tiny_sample_traffic, seed=seed)
    served = sample.run(ctx)["served"]
    numbers = check.sample_numbers(*ctx.reference(), tiny_sample_traffic, served, FP8, seed=seed)
    for cell in ("d16-fid50", "d30-demo8"):
        assert not R.judge(numbers, Registry(ROOT).limits(cell))[0], (cell, numbers)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_training_control_fails(seed, tiny_config, tiny_train_traffic):
    ctx = cpu_context(tiny_config, tiny_train_traffic, seed=seed)
    numbers = check.train_numbers(train.reference_steps(ctx, FP8), train.reference_steps(ctx))
    assert not R.judge(numbers, Registry(ROOT).limits("d16-train32"))[0], numbers


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["d16-fid50", "d16-train32"])
def test_cell_size_program_passes_and_control_fails(cell, cuda_device):
    from benchmark.control import readings

    reg = Registry(ROOT)
    row = readings(reg, reg.cell(cell), 3_500_000_001, 5.0, cuda_device)
    assert R.judge(row["program"], reg.limits(cell))[0], row
    assert not R.judge(row["control"], reg.limits(cell))[0], row
