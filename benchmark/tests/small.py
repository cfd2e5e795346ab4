"""A cell at a size the CPU tests hold: the published widths, each
vocabulary capped at 3,000 rows (vocabularies of 1,000 rows or more go to
the stacked engine), a small batch, the cell's own limits."""

import copy

from benchmark.spec import load_cell


def small_cell(workload, batch=64, pool=4):
    cell = load_cell(workload)
    config = copy.deepcopy(cell.config)
    config["vocab_sizes"] = [min(v, 3000) for v in config["vocab_sizes"]]
    config["embedding_threshold"] = 1000
    config["global_batch_size"] = batch
    cell.config = config
    cell.traffic = dict(cell.traffic, pool_batches=pool)
    return cell
