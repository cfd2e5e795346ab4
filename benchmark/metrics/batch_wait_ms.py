"""Mean host milliseconds of one `next(loader)` in the unprofiled
stretch: the wait for the loader's queue and the pinned copy of the raw
batch to the device, enqueued in the consuming thread."""

import statistics


def read(run):
    return statistics.fmean(run.wait_s) * 1e3 if run.wait_s else None
