"""The plain reference against the port on the CPU, at a small size with
the published widths: in float32 (the port's compute and activations in
f32, f32 tables) the two agree to round-off, so the reference's equations
are the port's model; in the configurations' bf16 compute they differ by
bf16's rounding alone."""

import copy
import json

import pytest
import torch

from benchmark import check, port, traffic
from benchmark import reference as ref
from benchmark.spec import HERE, load_cell

SEED = 2**31 + 4242


def small(workload, batch=32, **changes):
    cell = load_cell(workload)
    config = copy.deepcopy(cell.config)
    config["vocab_sizes"] = [min(v, 3000) for v in config["vocab_sizes"]]
    config["embedding_threshold"] = 1000
    config["global_batch_size"] = batch
    config.update(changes)
    return config, dict(cell.traffic, pool_batches=ref.CHECK_STEPS)


def ref_readings(config, pool, seed=SEED):
    return ref.readings(config, pool,
                        ref.initial_start(config, seed, pool, "cpu"), "cpu")


def port_readings(config, mix, pool):
    model = port.build(config, mix, SEED, "cpu")
    port.load_weights(model, config, SEED)
    trainer = port.Trainer(model, config, pool)
    try:
        return port.first_readings(trainer, config, SEED, pool,
                                   lambda: None)[0]
    finally:
        trainer.stop()


@pytest.mark.parametrize("optimizer", ["adagrad", "rowwise_adagrad"])
def test_reference_is_the_ports_model_in_float32(optimizer):
    config, mix = small("dlrm-packed.multihot", compute_dtype=None,
                        dense_output_dtype="float32",
                        embedding_optimizer=optimizer)
    pool = traffic.make_pool(config, mix, SEED)
    found = check.numbers(port_readings(config, mix, pool),
                          ref_readings(config, pool))
    assert found["loss_gap"]["value"] < 1e-6
    assert found["grad_gap"]["value"] < 1e-4
    assert found["change_gap"]["value"] < 1e-4


def test_bf16_compute_differs_by_rounding_only():
    config, mix = small("dlrm-packed.multihot")
    pool = traffic.make_pool(config, mix, SEED)
    found = check.numbers(port_readings(config, mix, pool),
                          ref_readings(config, pool))
    assert 1e-7 < found["loss_gap"]["value"] < 1e-3
    assert found["grad_gap"]["value"] < 0.05
    assert found["change_gap"]["value"] < 0.05


def test_reference_loads_its_weights_and_steps_from_the_seed():
    config, _ = small("dlrm-packed.multihot", batch=16)
    mix = dict(json.loads((HERE / "traffic" / "multihot.json").read_text()),
               valences=[1] * 26, pool_batches=ref.CHECK_STEPS)
    pool = traffic.make_pool(config, mix, SEED)
    a = ref_readings(config, pool)
    b = ref_readings(config, pool)
    assert a == b
    c = ref_readings(config, pool, SEED + 1)
    assert c.losses != a.losses
    # Every leaf moves, and three steps move a leaf more than one.
    assert all(v > 0 for v in a.change_norms.values())
    assert sum(a.change_norms.values()) > sum(a.grad_norms.values()) / (
        ref.grad_scale(config))


def test_stochastic_rounding_moments():
    w0 = torch.tensor([0.15, -0.15, 1.0], dtype=torch.bfloat16).float()
    upd = torch.tensor([1e-4, 1e-4, 0.0])
    mean, var = ref._sr_moments(w0, upd)
    t = w0 + upd
    assert torch.equal(mean, t - w0)
    step = 2.0 ** -10  # bf16 spacing in [0.125, 0.25)
    frac = (mean[:2].abs() / step)
    # Moving up from 0.15 and toward zero from -0.15: the chance of the
    # rounding that moves, one step, against staying.
    assert var[0] == pytest.approx(float(frac[0] * (1 - frac[0])) * step**2,
                                   rel=1e-3)
    assert var[2] == 0.0


@pytest.mark.parametrize("optimizer", ["adagrad", "rowwise_adagrad"])
def test_reference_follows_the_ports_state_after_its_steps(optimizer):
    """The late reading: the reference from the port's copied state
    (port.snapshot) over the three steps after it agrees with the port in
    float32, as the first reading does."""
    config, mix = small("dlrm-packed.multihot", compute_dtype=None,
                        dense_output_dtype="float32",
                        embedding_optimizer=optimizer)
    mix = dict(mix, pool_batches=2 * ref.CHECK_STEPS)
    pool = traffic.make_pool(config, mix, SEED)
    model = port.build(config, mix, SEED, "cpu")
    port.load_weights(model, config, SEED)
    trainer = port.Trainer(model, config, pool)
    try:
        port.first_readings(trainer, config, SEED, pool, lambda: None)
        late, start = port.late_readings(
            trainer, config, pool[ref.CHECK_STEPS:], lambda: None)
    finally:
        trainer.stop()
    assert all(a.numel() for a in start.acc.values())
    found = check.numbers(late, ref.readings(
        config, pool[ref.CHECK_STEPS:], start, "cpu"), prefix="late_")
    assert found["late_loss_gap"]["value"] < 1e-6
    assert found["late_change_gap"]["value"] < 1e-4
    assert found["late_change_gap_wide_leaf"]["value"] < 1e-3
    assert found["late_table_change_gap"]["value"] < 1e-4


def test_restart_continues_the_reference_where_it_stopped():
    """A restart from the end of three steps starts the next three from
    that end's rows and accumulators where it holds them, and from the
    seed's elsewhere."""
    config, mix = small("dlrm-packed.multihot", batch=16)
    mix = dict(mix, pool_batches=2 * ref.CHECK_STEPS)
    pool = traffic.make_pool(config, mix, SEED)
    k = ref.CHECK_STEPS
    first = ref.readings(config, pool[:k],
                         ref.initial_start(config, SEED, pool[:k], "cpu"),
                         "cpu", keep_end=True)
    start = ref.restart(config, SEED, first.end, pool[k:], "cpu")
    seed_start = ref.initial_start(config, SEED, pool[k:], "cpu")
    late = ref.readings(config, pool[k:], start, "cpu")
    fresh = ref.readings(config, pool[k:], seed_start, "cpu")
    assert late.losses != fresh.losses
    for n, p in first.end.dense.items():
        assert torch.equal(start.dense[n], p)
    n_held = n_fresh = 0
    for i, u in start.ids.items():
        pos = torch.searchsorted(first.end.ids[i], u).clamp(
            max=first.end.ids[i].numel() - 1)
        held = first.end.ids[i][pos] == u
        n_held += int(held.sum())
        n_fresh += int((~held).sum())
        assert torch.equal(start.rows[i][held], first.end.rows[i][pos[held]])
        assert torch.equal(start.acc[i][held], first.end.acc[i][pos[held]])
        assert torch.equal(start.rows[i][~held], seed_start.rows[i][~held])
        assert bool((start.acc[i][~held] == 0.1).all())
    assert n_held and n_fresh
