"""Kernel B1's share of its byte roofline: the least bytes the packed f32
table + Adagrad update of the profiled batches needs (counts.py, from
each batch's distinct rows) at 3.35 TB/s, over the device time of the
kernel `apply_scatter_row_blocks_kernel` in the trace."""

from benchmark import counts

KERNEL = "apply_scatter_row_blocks_kernel"


def read(run):
    if run.trace is None or not run.profiled_batches:
        return None
    seconds = run.trace.seconds_of(KERNEL)
    if seconds is None:
        return None
    rows = sum(counts.unique_rows(run.config, b)
               for b in run.profiled_batches)
    return 100.0 * counts.update_floor_s(run.config, rows) / seconds
