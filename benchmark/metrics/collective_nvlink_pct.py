"""The exchange's share of its roofline on rank 0: the least bytes rank
0 must send in the profiled steps (counts_sharded.floor_s, from the
configuration's shapes and each batch) at NVLink's 450 GB/s, over the
device time of the NCCL kernels in the trace. None where no NCCL kernel
ran (one card)."""

from benchmark import counts_sharded


def read(run):
    if run.trace is None or not run.profiled_batches:
        return None
    seconds = run.trace.seconds_of(counts_sharded.NCCL_KERNEL)
    if seconds is None:
        return None
    floor = sum(counts_sharded.floor_s(run.config, b)
                for b in run.profiled_batches)
    return 100.0 * floor / seconds
