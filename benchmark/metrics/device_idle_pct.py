"""Share of a step's wall time in which no device operation runs: 100 x
(1 - device busy per profiled step / wall time per unprofiled step). The
busy time is the union of the device operations' intervals in the trace;
the wall time comes from the unprofiled stretch, because the profiler
slows the host."""


def read(run):
    if run.trace is None or not run.trace.ops or not run.steps:
        return None
    busy = run.trace.busy_s / run.trace.steps
    return 100.0 * (1.0 - busy / (run.wall_s / run.steps))
