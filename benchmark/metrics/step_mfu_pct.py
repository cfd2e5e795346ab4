"""The whole step's share of the H100's bf16 peak: the dense stack's
forward and backward FLOPs per step (counts.py, from the configuration's
shapes) times the unprofiled steps, over their wall time and 989 TFLOP/s.
The embedding engine's work is not counted, so this bounds every kernel
roofline of the step from below in what it claims."""

from benchmark import counts


def read(run):
    if not run.steps:
        return None
    flops = counts.dense_flops_per_step(run.config) * run.steps
    return 100.0 * flops / run.wall_s / counts.PEAK_BF16_FLOPS
