"""Kernel B3's share of its byte roofline: the least bytes of the bf16
row scatter of the profiled batches' distinct rows (counts.py) at 3.35
TB/s, over the device time of `scatter_rows_kernel` in the trace (one
launch per step in capacity mode: the table's rows alone)."""

from benchmark import counts

KERNEL = "scatter_rows_kernel"


def read(run):
    if run.trace is None or not run.profiled_batches:
        return None
    seconds = run.trace.seconds_of(KERNEL)
    if seconds is None:
        return None
    rows = sum(counts.unique_rows(run.config, b)
               for b in run.profiled_batches)
    return 100.0 * counts.update_floor_s(run.config, rows) / seconds
