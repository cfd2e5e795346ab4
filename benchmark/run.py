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

A cell whose `chips` is N > 1 runs as N ranks, one process per card
(`Ranks`): the process started here is rank 0 and spawns ranks 1..N-1;
each starts the process group through the port's own
`parallel/multihost.initialize` (NCCL on cuda:r; gloo on the CPU) and
runs `run_cell` on its part of the model, whose configuration names an
adapter for D ranks (port_sharded.py). Every rank runs the same K window
steps, K agreed once before the window from rank 0's timing of the last
set-up steps; the wall time is rank 0's, from a barrier before the first
window step to the synchronize and barrier after the last. Only rank 0
writes to standard output and runs the reference; the others log to
standard error and exit once their readings and numbers are gathered.

Exit codes: 0 with a result; 3 without a CUDA device (or fewer than the
cell asks for); 4 if jax, jaxlib, flax or the JAX package is loaded once
the window has closed (in any rank); 5 without the port beside the
benchmark; 6 if another rank failed or the run passed RUN_LIMIT_S.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import multiprocessing as mp  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from datetime import timedelta  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: Top-level module names the run may not hold, compared whole (the
#: port's own name begins with the JAX package's).
FORBIDDEN = {"jax", "jaxlib", "flax", "keras_rs_tpu"}
WARM_STEPS = 2
#: Several ranks: set-up steps after the warm-up whose mean time on rank
#: 0 sets the window's steps. Two warm-up steps read up to 2.3 times a
#: window step on four cards (a window of 4.4 s for 10).
AGREE_STEPS = 8
PROFILED_STEPS = 12
#: torch's intra-op threads on the host. With torch's default of one a
#: core, the idle ones spin after each parallel copy, a run takes twice the
#: CPU time, and the host-paced step's examples/s spread 19-20% between
#: runs of a cell; with one thread, 3-4% (PERF.md, section 6).
HOST_THREADS = 1
#: Several ranks. The process group's timeout: a rank that waits this
#: long in a collective for another is aborted. Well above the longest
#: wait of one rank for another in a sound run (uneven set-up, and in
#: the first run of a checkout each rank's build of the port's CUDA
#: sources: seconds to tens of seconds), and under the 360 s a run has,
#: so that a hung rank ends the run.
PG_TIMEOUT_S = 180
#: Rank 0's watchdog ends the run (killing every rank, exit 6) when
#: another rank exits with an error, within WATCH_S, or when the run
#: outlasts RUN_LIMIT_S, the time the first run of a cell may take: the
#: last resort against a hang outside any collective.
WATCH_S = 0.2
RUN_LIMIT_S = 1200
#: How long rank 0 waits for the other ranks to exit after their part,
#: and how often a rank looks whether rank 0 still runs.
JOIN_S = 60
PARENT_POLL_S = 1.0
EXIT_RANK_FAILED = 6


def log(msg: str) -> None:
    rank = os.environ.get("RANK", "0")
    tag = "" if rank == "0" else f"[rank {rank}] "
    # One write a line: the ranks share standard error.
    sys.stderr.write(f"{tag}[benchmark {time.perf_counter() - T_START:8.3f}s]"
                     f" {msg}\n")
    sys.stderr.flush()


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
             t_start: float = T_START) -> tuple[dict | None, int]:
    """Runs `cell` (spec.Cell) once on `device`; returns (the result
    object, exit code). On a CPU device it runs the same path without
    device timing (the tests' rehearsal). Where a process group of D > 1
    ranks is initialized, this is one rank's part: rank 0 returns the
    result, the others (None, code)."""
    import torch
    import torch.distributed as dist

    from benchmark import check
    from benchmark.record import RunRecord
    from benchmark.spec import metric_reader

    cuda = device.type == "cuda"
    rank, world = ((dist.get_rank(), dist.get_world_size())
                   if dist.is_initialized() else (0, 1))

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
    window_steps = None
    if world > 1:
        t_agree = time.perf_counter()
        for _ in range(AGREE_STEPS):
            trainer.step(next(trainer.loader))
        sync()
        t_wait = time.perf_counter()
        window_steps = agree_steps(
            seconds, (t_wait - t_agree) / AGREE_STEPS, device)
        dist.barrier()
        log(f"{window_steps} window steps agreed, "
            f"{time.perf_counter() - t_wait:.3f} s at the barrier")
    parts["first_steps_s"] = time.perf_counter() - t - check_s
    parts["check_readings_s"] = check_s
    setup_s = time.perf_counter() - t_start - check_s
    log(f"set-up {setup_s:.3f} s {parts}")

    # Batches the loader handed over.
    done = ref.CHECK_STEPS + WARM_STEPS + (AGREE_STEPS if world > 1 else 0)
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
        if (c - t0 >= seconds if window_steps is None
                else len(losses) == window_steps):
            break
    sync()
    if world > 1:
        dist.barrier()
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
    if world > 1:
        forbidden = forbidden_modules()
        if forbidden:
            print(f"loaded once the window closed: {', '.join(forbidden)}",
                  file=sys.stderr)
        ranks = gather_ranks(
            [steps, device_info["memory_peak_bytes"], failed,
             record.trace.busy_s if record.trace else 0.0,
             record.trace.window_s if record.trace else 0.0,
             float(bool(forbidden))], device)
        if rank:
            return None, 0
        if any(ranks[:, 5]):
            return {}, 4
        failed = int(ranks[:, 2].max())
        device_info.update(
            count=world, memory_peak_bytes=int(ranks[:, 1].max()),
            memory_peak_bytes_per_rank=[int(v) for v in ranks[:, 1]])
        if record.trace is not None:
            device_info.update(
                busy_s_per_rank=ranks[:, 3].tolist(),
                window_s_per_rank=ranks[:, 4].tolist())
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
        device_info["busy_s"] = (record.trace.busy_s if world == 1
                                 else statistics.fmean(ranks[:, 3]))
        device_info["window_s"] = (record.trace.window_s if world == 1
                                   else statistics.fmean(ranks[:, 4]))
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
    if world > 1:
        result["window_steps_per_rank"] = [int(v) for v in ranks[:, 0]]
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
    chips = int(cell.workload["chips"])
    # The other ranks start first: their imports then overlap this one's.
    ranks = (Ranks(cell, args.seed, args.seconds, bool(args.trace), "cuda")
             if chips > 1 else None)
    try:
        import torch

        torch.set_num_threads(HOST_THREADS)
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < chips):
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
        if ranks is not None:
            result, code = ranks.run()
        else:
            result, code = run_cell(cell, args.seed, args.seconds,
                                    bool(args.trace), torch.device("cuda", 0))
    finally:
        if ranks is not None:  # run() has waited for them; else not needed
            ranks.stop(wait=False)
    if code:
        return code
    emit(result)
    return 0


def emit(result: dict) -> None:
    """The compared numbers beside their limits on standard error, then
    the result's line on standard output."""
    from benchmark.check import lines

    for line in lines(result["check"]):
        print(line, file=sys.stderr)
    print(json.dumps(finite(result)), flush=True)


def agree_steps(seconds: float, step_s: float, device) -> int:
    """The window's steps on every rank: rank 0's `seconds` / `step_s`,
    rounded up, broadcast once."""
    import torch
    import torch.distributed as dist

    k = torch.tensor([max(1, math.ceil(seconds / step_s))],
                     dtype=torch.int64, device=device)
    dist.broadcast(k, src=0)
    return int(k)


def gather_ranks(values: list[float], device):
    """[D, len(values)] float64 numpy array: every rank's `values` (one
    all-gather)."""
    import torch
    import torch.distributed as dist

    mine = torch.tensor(values, dtype=torch.float64, device=device)
    out = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(out, mine)
    return torch.stack(out).cpu().numpy()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """Ranks 1..N-1 of a cell on N cards, spawned by rank 0 with the
    variables torchrun sets; `run` runs rank 0's part while a watchdog
    ends the run when another rank fails (watch)."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool,
                 device_type: str) -> None:
        self.args = (cell, seed, seconds, trace, device_type)
        world = int(cell.workload["chips"])
        os.environ.update(MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(_free_port()),
                          WORLD_SIZE=str(world), RANK="0", LOCAL_RANK="0")
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=rank_main, args=(r, *self.args),
                                  daemon=True) for r in range(1, world)]
        for r, p in enumerate(self.procs, 1):
            p.start()
            log(f"rank {r} started, pid {p.pid}")

    def run(self) -> tuple[dict | None, int]:
        """Rank 0's part; (its result, exit code) once every other rank
        has ended well, else (None, EXIT_RANK_FAILED)."""
        done = threading.Event()
        watcher = threading.Thread(target=watch, args=(self.procs, done),
                                   daemon=True)
        watcher.start()
        try:
            result, code = run_rank(*self.args, T_START)
        except BaseException:
            self.stop(wait=False)  # they may wait for rank 0 in a collective
            raise
        finally:
            done.set()
            watcher.join()
        self.stop()
        failed = [(r, p.exitcode) for r, p in enumerate(self.procs, 1)
                  if p.exitcode != 0]
        if failed:
            log(f"ranks that failed (rank, exit code): {failed}")
            return None, EXIT_RANK_FAILED
        return result, code

    def stop(self, wait: bool = True) -> None:
        """Waits up to JOIN_S for each rank to exit (`wait`), then kills
        what is left."""
        for r, p in enumerate(self.procs, 1):
            if wait:
                p.join(JOIN_S)
            if p.is_alive():
                if wait:
                    log(f"rank {r} did not exit in {JOIN_S} s: killed")
                p.kill()
                p.join()


def watch(procs, done: threading.Event) -> None:
    """Rank 0's watchdog: ends the process, with every rank, when another
    rank exits with an error or the run outlasts RUN_LIMIT_S."""
    while not done.wait(WATCH_S):
        why = [f"rank {r} exited with {p.exitcode}"
               for r, p in enumerate(procs, 1) if p.exitcode not in (None, 0)]
        if time.perf_counter() - T_START > RUN_LIMIT_S:
            why.append(f"the run passed {RUN_LIMIT_S} s")
        if why:
            log(f"ending the run: {'; '.join(why)}")
            for p in procs:
                p.kill()
            for p in procs:
                p.join(JOIN_S)
            os._exit(EXIT_RANK_FAILED)


def run_rank(cell, seed: int, seconds: float, trace: bool,
             device_type: str, t_start: float) -> tuple[dict | None, int]:
    """One rank: the process group over RANK / WORLD_SIZE / MASTER_* as
    the port's multihost.initialize starts it, then this rank's part of
    `run_cell`."""
    import torch
    import torch.distributed as dist
    from torch.distributed import distributed_c10d

    from keras_rs_tpu_torch.parallel import multihost

    cache_dirs(ROOT)
    torch.set_num_threads(HOST_THREADS)
    device = (multihost.rank_device() if device_type == "cuda"
              else torch.device(device_type))
    multihost.initialize(device)
    distributed_c10d._set_pg_timeout(timedelta(seconds=PG_TIMEOUT_S))
    log(f"rank {dist.get_rank()} of {dist.get_world_size()} on {device}, "
        f"{dist.get_backend()}")
    out = run_cell(cell, seed, seconds, trace, device, t_start)
    dist.destroy_process_group()
    return out


def rank_main(rank: int, cell, seed: int, seconds: float, trace: bool,
              device_type: str) -> None:
    """A spawned rank 1..N-1: standard output goes to standard error,
    and the rank ends itself when rank 0 is gone."""
    os.dup2(sys.stderr.fileno(), sys.stdout.fileno())
    sys.stdout = sys.stderr
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank))
    parent = os.getppid()

    def orphaned() -> None:
        while os.getppid() == parent:
            time.sleep(PARENT_POLL_S)
        os._exit(EXIT_RANK_FAILED)

    threading.Thread(target=orphaned, daemon=True).start()
    sys.exit(run_rank(cell, seed, seconds, trace, device_type,
                      time.perf_counter())[1])


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
