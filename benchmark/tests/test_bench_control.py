"""The control of each cell: the reference computed in the precision
below the cell's (``control`` in ``benchmark/checks/<cell>.json``) put in
the program's place.  On the card, at the cell's own sizes, it fails the
cell's limits; on the CPU, at small sizes, it reads at least three times
what the program reads on one of the numbers compared."""

import time

import pytest

from benchmark.harness import compare, drivers, runner, spec
from benchmark.tests.bench_small import SECONDS, card, cell_names, \
    small_cell  # noqa: F401  (card is a fixture)

EXACT = ("flags_differ", "shape_differs")
CONTROL_SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


@pytest.mark.parametrize("name", cell_names())
def test_control_separates_at_small_size(name):
    cell = small_cell(name)
    seed = 2 ** 31 + 17
    program = runner.run_cell(cell, seed, SECONDS[cell.traffic["kind"]],
                              False, "cpu", 0.0,
                              time.perf_counter())["numbers"]
    control = drivers.control_numbers(cell, seed, "cpu",
                                      cell.check["control"])
    ratios = [control[k] / program[k] for k in cell.check["limits"]
              if k not in EXACT and program[k] > 0]
    assert ratios and max(ratios) >= 3.0, (program, control)


@pytest.mark.cuda
@pytest.mark.parametrize("name", cell_names())
def test_control_fails_at_the_cells_size(name, card):  # noqa: F811
    cell = spec.load_cell(name)
    for seed in CONTROL_SEEDS:
        numbers = drivers.control_numbers(cell, seed, card,
                                          cell.check["control"])
        ok, rows = compare.judge(numbers, cell.check["limits"])
        assert not ok, rows
