"""The controls at a size a test run holds (small.py): each control that
fails a cell's limits at the cell's size on the card (control.py; the
readings in limits/<workload>.json), put in the port's place, fails them
here too, where the sound port passes, and so does the half-batch fault.
In the packed cell ref_fp8_matmul reads under three times the sound runs
on the card and sets no limit (PERF.md, section 6)."""

import pytest

from benchmark import check, control, traffic
from benchmark import reference as ref
from benchmark.tests.small import small_cell

SEED = 2**31 + 515


@pytest.mark.parametrize("workload,variant", [
    ("dlrm-packed.multihot", "port_bf16_tables"),
    ("dlrm-packed.multihot", "half_batch"),
    ("dlrm-capacity.multihot", "ref_fp8_tables"),
    ("dlrm-capacity.multihot", "ref_fp8_matmul"),
])
def test_control_fails_the_cells_limits(workload, variant):
    cell = small_cell(workload)
    config = cell.config
    assert variant in control.variants(config)
    batches = [traffic.make_batch(config, cell.traffic, SEED, i)
               for i in range(2 * ref.CHECK_STEPS)]
    found = control.variant_numbers(variant, config, cell.traffic, SEED,
                                    "cpu", batches)
    correct, compared = check.judge(found, cell.limits)
    assert not correct, compared
    # Read after steps of its own too, as a run reads the port.
    assert {"late_change_gap", "late_change_gap_wide_leaf"} <= set(found)
