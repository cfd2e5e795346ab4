"""Device milliseconds per profiled step of the exchange on rank 0: the
NCCL kernels (counts_sharded.NCCL_KERNEL; inside a step only the
collectives of the port's parallel/collectives.py launch them, each in a
`collective.<kind>` span), summed and divided by the profiled steps.
Their time includes the wait for the other ranks. None where no NCCL
kernel ran (one card)."""

from benchmark import counts_sharded


def read(run):
    if run.trace is None or not run.trace.steps:
        return None
    seconds = run.trace.seconds_of(counts_sharded.NCCL_KERNEL)
    if seconds is None:
        return None
    return 1e3 * seconds / run.trace.steps
