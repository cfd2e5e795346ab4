"""Readings that set the output check's upper limits, at a cell's own
size: the controls and the planted faults, each compared with the
reference as check.py compares the port. The benchmark's runs do not run
this; the limits in `limits/<workload>.json` cite what it printed.

  python3 -m benchmark.control --workload <name> --seeds 1 2 3

Each variant is read twice, as a run reads the port: over the first
three batches of the run from the seed's weights, and over the next
three from the state the variant itself left after the first three
(the `late_` numbers; a run reads them after its window, from the state
several hundred steps left), against the reference from that same state.

Variants (each on every seed):
  port_bf16_tables  the port with its own bf16 table path switched on
                    (the packed configuration states f32 tables: the
                    control where the program has the lower path itself);
  ref_fp8_tables    the reference with e4m3 tables, rounded to nearest
                    (the capacity configuration states bf16 tables, and the
                    port has no lower training path);
  ref_fp8_matmul    the reference with every product's operands in e4m3
                    (both configurations state bf16 dense compute);
  half_batch        the reference in the port's place with the loss the
                    mean over the first half of the batch.
A step that leaves the state unchanged reads 1 by check.py's measure and
needs no run.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from benchmark import check, port, traffic
from benchmark import reference as ref
from benchmark.spec import load_cell


def port_readings(config: dict, mix: dict, seed: int, device,
                  batches: list[dict]) -> tuple[ref.Readings, ref.Readings,
                                                ref.Start]:
    """The port's readings of its first steps over batches[:3] and of the
    next three over batches[3:6], and the state those started from."""
    device = torch.device(device)
    model = port.build(config, mix, seed, device)
    port.load_weights(model, config, seed)
    trainer = port.Trainer(model, config, batches)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    first, _ = port.first_readings(trainer, config, seed, batches, sync)
    late, start = port.late_readings(
        trainer, config, batches[ref.CHECK_STEPS:], sync)
    trainer.stop()
    del trainer, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return first, late, start


def variants(config: dict) -> list[str]:
    out = ["ref_fp8_matmul", "half_batch"]
    if config["table_dtype"] == "float32":
        out.insert(0, "port_bf16_tables")
    else:
        out.insert(0, "ref_fp8_tables")
    return out


def variant_numbers(name: str, config: dict, mix: dict, seed: int, device,
                    batches: list[dict]) -> dict[str, dict]:
    """check.numbers of variant `name` in the port's place, first and
    late, each against the reference from the same start."""
    first_b, late_b = batches[: ref.CHECK_STEPS], batches[ref.CHECK_STEPS:]
    base = ref.readings(config, first_b,
                        ref.initial_start(config, seed, first_b, device),
                        device)
    if name == "port_bf16_tables":
        low = dict(config, table_dtype="bfloat16")
        first, late, start = port_readings(low, mix, seed, device, batches)
    else:
        options = {"ref_fp8_tables": {"tables": "float8_e4m3"},
                   "ref_fp8_matmul": {"matmul": "float8_e4m3"},
                   "half_batch": {"fault": "half_batch"}}[name]
        first = ref.readings(
            config, first_b, ref.initial_start(config, seed, first_b, device),
            device, keep_end=True, **options)
        start = ref.restart(config, seed, first.end, late_b, device)
        first.end = None
        late = ref.readings(config, late_b, start, device, **options)
    late_base = ref.readings(config, late_b, start, device)
    return {**check.numbers(first, base),
            **check.numbers(late, late_base, prefix="late_")}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--variants", nargs="*", default=None)
    args = parser.parse_args(argv)
    cell = load_cell(args.workload)
    if cell.modules() != (port, ref, traffic):
        raise ValueError("control.py reads the DLRM-DCNv2 family's cells")
    device = torch.device("cuda", 0) if torch.cuda.is_available() else (
        torch.device("cpu"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config, mix = cell.config, cell.traffic
    rows = []
    for seed in args.seeds:
        batches = [traffic.make_batch(config, mix, seed, i)
                   for i in range(2 * ref.CHECK_STEPS)]
        for name in args.variants or variants(config):
            found = variant_numbers(name, config, mix, seed, device, batches)
            row = {"workload": args.workload, "seed": seed, "variant": name,
                   **{k: v["value"] for k, v in found.items()},
                   "at": {k: v["at"] for k, v in found.items()}}
            rows.append(row)
            print(json.dumps(row), flush=True)
    summary = {}
    for row in rows:
        for k in check.NUMBERS:
            if k not in row:
                continue
            key = f"{row['variant']}.{k}"
            summary[key] = min(summary.get(key, float("inf")), row[k])
    print("least reading of each variant and number:", file=sys.stderr)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
