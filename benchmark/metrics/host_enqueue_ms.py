"""Mean host milliseconds of one `train_step` call in the unprofiled
stretch: the Python and launch work that enqueues a step (the call does
not wait for the device unless the step reads a value back)."""

import statistics


def read(run):
    return statistics.fmean(run.enqueue_s) * 1e3 if run.enqueue_s else None
