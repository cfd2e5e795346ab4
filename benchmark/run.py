"""Runs one cell of BENCHMARK.json once and prints one JSON line.

  python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
      --trace <0|1>

Set-up (timed as `setup_s`, from the process's start): import, the pool
of raw batches (traffic.py), the port's model (port.build) with the
benchmark's weights written over its draw, the loader and step as
main.py assembles them, the first three steps (whose readings the output
check keeps; the readings' own time is left out of `setup_s`) and two
more, then a synchronize. Every shape the cell uses has then run.

The window is a closed loop: `next(loader)`, then the step, until
`--seconds` have passed; it ends in `torch.cuda.synchronize()`.
`train_examples_per_s` is every window step's examples over that wall
time. With `--trace 1` the window is followed by PROFILED_STEPS steps
under torch.profiler, and the line holds the per-layer metrics
(metrics/<name>.py) instead of the end-to-end ones.

Then the peak memory is read and the output check's second reading is
taken: the port's state as the next three batches will find it is copied
(port.snapshot), and those three steps run through the same loader and
step. Then the port's state is freed, and the reference (reference.py)
follows the first three steps again from the same weights and batches,
and the three after the window from the copied state; check.py compares
both with the port's and decides `correct`. The numbers compared close
standard error and the JSON line.

Exit codes: 0 with a result; 3 without a CUDA device (or fewer than the
cell asks for); 4 if jax, jaxlib, flax or the JAX package is loaded once
the window has closed; 5 without the port beside the benchmark.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: Top-level module names the run may not hold, compared whole (the
#: port's own name begins with the JAX package's).
FORBIDDEN = {"jax", "jaxlib", "flax", "keras_rs_tpu"}
WARM_STEPS = 2
PROFILED_STEPS = 12
#: torch's intra-op threads on the host. With torch's default of one a
#: core, the idle ones spin after each parallel copy, a run takes twice the
#: CPU time, and the host-paced step's examples/s spread 19-20% between
#: runs of a cell; with one thread, 3-4% (PERF.md, section 6).
HOST_THREADS = 1


def log(msg: str) -> None:
    print(f"[benchmark {time.perf_counter() - T_START:8.3f}s] {msg}",
          file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & FORBIDDEN)


def cache_dirs(root: Path) -> None:
    """Every kernel cache inside the checkout, at fixed paths (the port
    builds its CUDA sources into build/keras_rs_tpu_torch/ itself)."""
    base = root / "build" / "benchmark"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float = T_START) -> tuple[dict, int]:
    """Runs `cell` (spec.Cell) once on `device`; returns (the result
    object, exit code). On a CPU device it runs the same path without
    device timing (the tests' rehearsal)."""
    import torch

    from benchmark import check
    from benchmark.record import RunRecord
    from benchmark.spec import metric_reader

    cuda = device.type == "cuda"

    def sync() -> None:
        if cuda:
            torch.cuda.synchronize(device)

    config, mix = cell.config, cell.traffic
    port, ref, traffic = cell.modules()
    B = int(config["global_batch_size"])
    parts = {"import_s": time.perf_counter() - t_start}
    t = time.perf_counter()
    pool = traffic.make_pool(config, mix, seed)
    parts["pool_s"] = time.perf_counter() - t
    log(f"pool of {len(pool)} batches of {B}")
    t = time.perf_counter()
    model = port.build(config, mix, seed, device)
    sync()
    parts["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    port.load_weights(model, config, seed)
    sync()
    parts["weights_s"] = time.perf_counter() - t
    log("model built, weights written")
    t = time.perf_counter()
    trainer = port.Trainer(model, config, pool)
    prog, check_s = port.first_readings(trainer, config, seed, pool, sync)
    for _ in range(WARM_STEPS):
        trainer.step(next(trainer.loader))
    sync()
    parts["first_steps_s"] = time.perf_counter() - t - check_s
    parts["check_readings_s"] = check_s
    setup_s = time.perf_counter() - t_start - check_s
    log(f"set-up {setup_s:.3f} s {parts}")

    done = ref.CHECK_STEPS + WARM_STEPS  # batches the loader handed over
    enqueue, wait, losses = [], [], []
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        batch = next(trainer.loader)
        b = time.perf_counter()
        losses.append(trainer.step(batch))
        c = time.perf_counter()
        wait.append(b - a)
        enqueue.append(c - b)
        if c - t0 >= seconds:
            break
    sync()
    wall_s = time.perf_counter() - t0
    steps = len(losses)
    done += steps
    log(f"window: {steps} steps in {wall_s:.3f} s")

    record = RunRecord(config=config, traffic=mix, steps=steps,
                       wall_s=wall_s, enqueue_s=enqueue, wait_s=wait)
    if trace and cuda:
        from torch.profiler import ProfilerActivity, profile, record_function

        from benchmark import trace as trace_lib

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tp = time.perf_counter()
            for _ in range(PROFILED_STEPS):
                with record_function("bench.next_batch"):
                    batch = next(trainer.loader)
                with record_function("bench.train_step"):
                    losses.append(trainer.step(batch))
            sync()
            traced_s = time.perf_counter() - tp
        record.trace = trace_lib.from_profiler(prof, traced_s,
                                               PROFILED_STEPS)
        record.profiled_batches = [pool[(done + j) % len(pool)]
                                   for j in range(PROFILED_STEPS)]
        done += PROFILED_STEPS
        log(f"traced {PROFILED_STEPS} steps in {traced_s:.3f} s")

    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": (torch.cuda.get_device_name(device) if cuda
                            else device.type),
                   "count": 1,
                   "memory_peak_bytes": (torch.cuda.max_memory_allocated(
                       device) if cuda else 0)}
    attempted = len(losses)
    failed = int((~torch.isfinite(torch.stack(losses))).sum())

    t = time.perf_counter()
    late_batches = [pool[(done + j) % len(pool)]
                    for j in range(ref.CHECK_STEPS)]
    late_prog, late_start = port.late_readings(trainer, config,
                                               late_batches, sync)
    log(f"steps after the window read: {time.perf_counter() - t:.3f} s")
    trainer.stop()
    del trainer, model, batch, losses
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    reference = ref.readings(
        config, pool[: ref.CHECK_STEPS],
        ref.initial_start(config, seed, pool[: ref.CHECK_STEPS], device),
        device)
    late_reference = ref.readings(config, late_batches, late_start, device)
    del late_start
    log(f"reference: {time.perf_counter() - t:.3f} s")
    found = {**check.numbers(prog, reference),
             **check.numbers(late_prog, late_reference, prefix="late_")}
    forbidden = forbidden_modules()
    if forbidden:
        print(f"loaded once the window closed: {', '.join(forbidden)}",
              file=sys.stderr)
        return {}, 4
    correct, compared = check.judge(found, cell.limits)
    compared["failed_steps"] = {"value": failed, "limit": 0,
                                "at": "the window's losses"}
    for leaf in reference.change_norms:
        log(f"leaf {leaf} first-gradient {prog.grad_norms[leaf]!r} "
            f"{reference.grad_norms[leaf]!r} change "
            f"{prog.change_norms[leaf]!r} {reference.change_norms[leaf]!r}"
            f" late-change {late_prog.change_norms[leaf]!r} "
            f"{late_reference.change_norms[leaf]!r}")

    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = metric_reader(m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {
            "train_examples_per_s": steps * B / wall_s,
            "peak_mem_gib": device_info["memory_peak_bytes"] / 2**30,
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    if record.trace is not None:
        device_info["busy_s"] = record.trace.busy_s
        device_info["window_s"] = record.trace.window_s
    result = {
        "correct": bool(correct and failed == 0),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": device_info,
    }
    if record.trace is not None:
        result["breakdown"] = {
            "device_ops": record.trace.top_ops(),
            "idle_gaps": [[n, s] for n, s in record.trace.gaps],
        }
    result["setup_parts"] = parts
    periods = sorted(1e3 * (a + b) for a, b in zip(wait, enqueue))
    result["host_step_ms_quartiles"] = (
        statistics.quantiles(periods, n=4) if len(periods) > 1 else periods)
    result["readings"] = {n: v["value"] for n, v in found.items()}
    if cuda:
        result["card"] = card_line()
    result["check"] = compared
    return result, 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cache_dirs(ROOT)
    from benchmark.spec import load_cell

    cell = load_cell(args.workload, ROOT)
    import torch

    torch.set_num_threads(HOST_THREADS)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    try:
        import keras_rs_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the port keras_rs_tpu_torch is not importable: {e}",
              file=sys.stderr)
        return 5
    log(f"{args.workload} seed {args.seed} on "
        f"{torch.cuda.get_device_name(0)}")
    result, code = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            torch.device("cuda", 0))
    if code:
        return code
    from benchmark.check import lines

    for line in lines(result["check"]):
        print(line, file=sys.stderr)
    print(json.dumps(finite(result)), flush=True)
    return 0


def finite(obj):
    """`obj` with every infinite or NaN float as the largest finite one
    (above any limit), so that the line stays strict JSON."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return sys.float_info.max
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    return obj


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.exit(code)
