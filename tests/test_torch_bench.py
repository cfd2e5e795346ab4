"""keras_rs_tpu_torch.bench against the repository's bench.py (the JAX
benchmark), on the CPU at batch 64, vocabulary 42,000 (both large tables,
42,000 and 21,000 rows, stacked), dim 128 and bench.py's dense widths, on
a one-device JAX mesh.

Tolerances (the bf16 default dense stack of tests/test_torch_dlrm.py):
  * losses and whole tables within 5e-3, as test_torch_dlrm.py's
    bf16_default case;
  * what two steps changed, in relative L2 of the JAX change, within
    0.1 for each table, each dense parameter and each small table
    (measured up to 0.041: the packages round the bf16 stack at
    different points, C4 in ROADMAP.md). An update that did nothing
    gives 1.0. In the bf16 + row-wise Adagrad mix the row-wise
    accumulators are held so, and the bf16 tables per element within one
    bf16 ulp per step plus 1e-4, test_torch_dlrm.py's capacity bound
    (their updates are far below one ulp and each package rounds them
    stochastically);
  * the dense-only step's activations, one f32 lookup, within 1e-6
    (measured equal).
`dense_flops_per_step`, the config arithmetic and the flagship's counted
uniques are held exactly.
"""

import bench as jax_bench
import numpy as np
import optax
import pytest
import torch
from examples.ml_perf import configs as jax_configs
from torch_parity import bf16_ulp, jax_attr, jax_dlrm_params, one_device_mesh

import jax
from keras_rs_tpu import training as jax_training
from keras_rs_tpu.data import synthetic as jax_synthetic
from keras_rs_tpu.models import dlrm as jax_dlrm
from keras_rs_tpu_torch import bench, convert
from keras_rs_tpu_torch.examples.ml_perf import configs
from keras_rs_tpu_torch.utils.timing import PEAK_FLOPS

B = 64
VOCAB = 42_000
DIM = 128
BF16_TOL = 5e-3
CHANGE_TOL = 0.1

CONFIG_FIELDS = (
    "vocab_sizes", "multi_hot_sizes", "num_dense_features",
    "embedding_dim", "bottom_mlp", "top_mlp", "num_dcn_layers",
    "dcn_projection_dim", "embedding_threshold", "max_ids_per_partition",
    "max_unique_ids_per_partition", "learning_rate", "global_batch_size",
    "table_placement", "table_dtype", "embedding_optimizer",
    "dense_output_dtype", "embedding_comm_dtype",
)
ENV_KNOBS = {
    "BENCH_TABLE_DTYPE": "bfloat16",
    "BENCH_EMB_OPTIMIZER": "rowwise_adagrad",
    "BENCH_DENSE_OUTPUT_DTYPE": "float32",
    "BENCH_COMM_DTYPE": "bfloat16",
}
#: The bf16 tables + row-wise Adagrad mix that chip_smoke.py runs for B3.
CAPACITY_ENV = {"BENCH_TABLE_DTYPE": "bfloat16",
                "BENCH_EMB_OPTIMIZER": "rowwise_adagrad"}


class _Captured(Exception):
    def __init__(self, cfg):
        super().__init__("config captured")
        self.cfg = cfg


def jax_bench_config(monkeypatch, *args, **kwargs):
    """The DLRMConfig bench.build makes, taken where it builds the model
    (which is not built)."""
    def capture(cfg, **_):
        raise _Captured(cfg)

    with monkeypatch.context() as m:
        m.setattr(jax_dlrm, "DLRMDCNv2", capture)
        with pytest.raises(_Captured) as got:
            jax_bench.build(*args, **kwargs)
    return got.value.cfg


def _flagship_vocab(sizes):
    return [min(v, 1_000_000) for v in sizes]


@pytest.mark.parametrize("case", ["default", "flagship", "env_knobs"])
def test_config_and_dense_flops_equal_bench(monkeypatch, case):
    """The port's config is bench.py's field for field (capacities
    included), under the env knobs too, and its dense FLOPs are equal."""
    batch, kw, jax_kw = B, {}, {}
    if case == "flagship":
        batch = 8192
        kw = dict(vocab_sizes=_flagship_vocab(configs.CRITEO_VOCAB_SIZES),
                  multi_hot_sizes=configs.CRITEO_MULTI_HOT_SIZES,
                  max_unique=1_234_568)
        jax_kw = dict(
            vocab_sizes=_flagship_vocab(jax_configs.CRITEO_VOCAB_SIZES),
            multi_hot_sizes=jax_configs.CRITEO_MULTI_HOT_SIZES,
            max_unique=1_234_568)
    if case == "env_knobs":
        for k, v in ENV_KNOBS.items():
            monkeypatch.setenv(k, v)
    want = jax_bench_config(monkeypatch, "sharded", one_device_mesh(), batch,
                            VOCAB, DIM, **jax_kw)
    got = bench.model_config("sharded", batch, VOCAB, DIM, **kw)
    for field in CONFIG_FIELDS:
        a, b = getattr(got, field), getattr(want, field)
        if isinstance(b, (list, tuple)):
            a, b = list(a), list(b)
        assert a == b, field
    assert (bench.dense_flops_per_step(got, batch)
            == jax_bench.dense_flops_per_step(want, batch))
    if case == "flagship":
        assert sum(m for v, m in zip(got.vocab_sizes, got.multi_hot_sizes)
                   if v >= got.embedding_threshold) == 172


def relative_change_gap(got, want, start) -> float:
    """|(got - start) - (want - start)| / |want - start| in L2."""
    start = np.asarray(start, np.float32)
    d_got = np.asarray(got, np.float32) - start
    d_want = np.asarray(want, np.float32) - start
    return float(np.linalg.norm(d_got - d_want) / np.linalg.norm(d_want))


def jax_param(jmodel, name: str):
    """The JAX model's array of the port's parameter `name` (the JAX
    model keeps its small tables in a dict)."""
    if name.startswith("small_embeddings."):
        return jmodel.small_embeddings[name.split(".")[1]].embeddings
    return jax_attr(jmodel, name)


def assert_dense_changes_match(tmodel, jmodel, params) -> None:
    """Each parameter of the port outside the embedding layer (small
    tables included) changed as the JAX one did, within CHANGE_TOL."""
    names = [n for n, _ in tmodel.named_parameters()
             if not n.startswith("embedding_layer.")]
    assert any(n.startswith("small_embeddings.") for n in names)
    for name in names:
        p = dict(tmodel.named_parameters())[name]
        gap = relative_change_gap(p.detach().numpy(),
                                  jax_param(jmodel, name), params[name])
        assert gap < CHANGE_TOL, (name, gap)


def build_pair(placement):
    """bench.build of both packages, the port's model with the JAX
    model's parameters; returns (JAX state, JAX step, JAX batch, the
    port's step and batch and model, the starting params and tables)."""
    jstate, jstep, jbatch, _, jmodel = jax_bench.build(
        placement, one_device_mesh(), B, VOCAB, DIM)
    params, tables = jax_dlrm_params(jmodel)
    _, tstep, tbatch, _, tmodel = bench.build(placement, B, VOCAB, DIM,
                                              device="cpu")
    if placement == "default_device":
        # The naive model's tables are dense parameters of the layer.
        params.update({f"embedding_layer.dense_tables.{n}.embeddings": t
                       for n, t in tables.items()})
    convert.load_params(tmodel, params, tables)
    return jstate, jstep, jbatch, tstep, tbatch, tmodel, params, tables


@pytest.mark.parametrize("placement, env", [
    ("sharded", {}), ("default_device", {}), ("sharded", CAPACITY_ENV)],
    ids=["ours", "naive", "ours_bf16_rowwise"])
def test_two_steps_match_bench(monkeypatch, placement, env):
    """Ours (stacked engine, in-step device COO, fused update), the naive
    baseline (dense tables, dense gradients, whole-table Adagrad) and
    ours in the bf16 + row-wise Adagrad mix: the same raw batch and
    initial parameters, two steps each."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jstate, jstep, jbatch, tstep, tbatch, tmodel, params, tables = (
        build_pair(placement))
    j_losses, t_losses = [], []
    for _ in range(2):
        jstate, loss = jstep(jstate, jbatch)
        j_losses.append(float(loss))
        t_losses.append(float(tstep(tbatch)))
    np.testing.assert_allclose(t_losses, j_losses, rtol=BF16_TOL,
                               atol=BF16_TOL)
    jemb = jstate.model.embedding_layer
    j_tables = jemb.get_embedding_tables()
    t_tables = tmodel.embedding_layer.get_embedding_tables()
    assert sorted(t_tables) == sorted(tables) == ["table_0", "table_1"]
    for name, t in t_tables.items():
        got = t.float().numpy()
        want = np.asarray(j_tables[name], np.float32)
        np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL)
        if env:
            # bf16 tables: an update is far below one ulp and each package
            # rounds it stochastically with its own random bits, so the
            # change is held per element, test_torch_dlrm.py's capacity
            # bound for two steps (one ulp per step plus 1e-4).
            assert t.dtype == torch.bfloat16
            bound = 2 * bf16_ulp(np.maximum(np.abs(got), np.abs(want))) + 1e-4
            assert (np.abs(got - want) <= bound).all(), name
        else:
            gap = relative_change_gap(got, want, tables[name])
            assert gap < CHANGE_TOL, (name, gap)
    emb = tmodel.embedding_layer
    if placement == "default_device":
        assert not emb.stacks and sorted(emb.dense_tables) == sorted(tables)
    elif not env:
        assert len(emb.stacks) == 1 and emb.stacks[0].packed_state
        assert float(emb.stack_state(0)["step"]) == 2.0
    else:
        (stack,) = emb.stacks
        assert stack.dtype == "bfloat16" and not stack.packed_state
        assert stack.optimizer.name == "rowwise_adagrad"
        state = emb.stack_state(0)
        assert float(state["step"]) == 2.0
        n = sum(t.vocabulary_size for t in stack.tables)
        acc = state["slots"]["accumulator"][:n].numpy()
        j_acc = np.asarray(
            jemb.state.value[stack.name]["slots"]["accumulator"])[:n]
        start = np.full_like(acc, stack.optimizer.initial_accumulator_value)
        gap = relative_change_gap(acc, j_acc, start)
        assert gap < CHANGE_TOL, ("accumulator", gap)
    assert_dense_changes_match(tmodel, jstate.model, params)


def test_dense_only_step_matches_bench():
    """The dense-only step against bench.py's: the JAX model with
    `replace(embedding_layer=None)` fed the activations of one lookup as
    `large_acts`, with optax.adagrad over what is left."""
    _, _, raw, jcfg, jmodel = jax_bench.build(
        "sharded", one_device_mesh(), B, VOCAB, DIM)
    params, tables = jax_dlrm_params(jmodel)
    acts = jax.jit(lambda m, b: m.embedding_layer(
        m.preprocess_on_device(b)["large_pre"]))(jmodel, raw)
    opt = optax.adagrad(jcfg.learning_rate)
    jstate = jax_training.create_train_state(
        jmodel.replace(embedding_layer=None), opt)
    jbatch = dict(raw, large_acts=acts)
    jstep = jax_training.make_train_step(
        lambda m, b: jax_dlrm.bce_loss(m, b), opt)

    _, _, tbatch, tcfg, tmodel = bench.build("sharded", B, VOCAB, DIM,
                                             device="cpu")
    convert.load_params(tmodel, params, tables)
    _, tstep, tbatch = bench.dense_only(tmodel, tbatch, tcfg)
    assert tmodel.embedding_layer is None
    assert not any(n.startswith("embedding_layer")
                   for n, _ in tmodel.named_parameters())
    assert not list(tmodel.buffers())  # the stacked state is gone
    for name, a in acts.items():
        np.testing.assert_allclose(tbatch["large_acts"][name].numpy(),
                                   np.asarray(a), rtol=0, atol=1e-6)
    j_losses, t_losses = [], []
    for _ in range(2):
        jstate, loss = jstep(jstate, jbatch)
        j_losses.append(float(loss))
        t_losses.append(float(tstep(tbatch)))
    np.testing.assert_allclose(t_losses, j_losses, rtol=BF16_TOL,
                               atol=BF16_TOL)
    assert_dense_changes_match(tmodel, jstate.model, params)


@pytest.mark.parametrize("env, unique_rows, want_bytes", [
    # 64 samples x (3 + 2) large ids = 320 entries. Packed f32 + Adagrad:
    # table rows of 4 x 128 = 512 bytes: forward 320 x 512, cotangent
    # 320 x 512, and per unique row 2 x 2 x 512 (the [2, 128] f32 block
    # read and written) + 512 (gradient) + 4 (index).
    ({}, None, 320 * 512 + 320 * 512 + 320 * (2048 + 512 + 4)),
    ({}, 100, 320 * 512 + 320 * 512 + 100 * (2048 + 512 + 4)),
    # bf16 + row-wise Adagrad: table rows of 2 x 128 = 256 bytes, one f32
    # accumulator per row: forward 320 x 256, the f32 cotangent 320 x
    # 512, and per unique row 2 x (256 + 4) + 512 + 4.
    (CAPACITY_ENV, None, 320 * 256 + 320 * 512 + 320 * (520 + 512 + 4)),
    (CAPACITY_ENV, 100, 320 * 256 + 320 * 512 + 100 * (520 + 512 + 4)),
], ids=["f32_adagrad", "f32_adagrad_100", "bf16_rowwise",
        "bf16_rowwise_100"])
def test_embedding_floor_is_a_hand_count(monkeypatch, env, unique_rows,
                                         want_bytes):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = bench.model_config("sharded", B, VOCAB, DIM)
    got = bench.embedding_floor_ms(cfg, B, unique_rows=unique_rows)
    assert got == pytest.approx(want_bytes / 3.35e12 * 1e3, rel=1e-12)


def test_flagship_shape_counts_bench_uniques():
    """bench.py's flagship sizing (main, at its defaults): capped
    vocabularies, the distinct ids of each large table in the JAX batch
    of the same seed, and that count x 1.07 rounded up to 8; inf
    headroom sizes no dedup."""
    vocab, multi_hot, uniq, max_u = bench.flagship_shape(B)
    jv = _flagship_vocab(jax_configs.CRITEO_VOCAB_SIZES)
    assert vocab == jv
    assert multi_hot == list(jax_configs.CRITEO_MULTI_HOT_SIZES)
    raw = jax_synthetic.criteo_like_batch(
        B, vocab_sizes=jv, multi_hot_sizes=jax_configs.CRITEO_MULTI_HOT_SIZES,
        seed=0)
    want = sum(len(np.unique(raw[f"cat_{i}"]))
               for i, v in enumerate(jv) if v >= 21_000)
    assert uniq == want
    assert max_u == int(-(-want * 1.07 // 8) * 8) and max_u % 8 == 0
    assert bench.flagship_shape(B, headroom=float("inf"))[3] is None


def test_pipelined_step_starts_as_ours():
    """The pipelined variant's first step reads the lookup it prefetched
    from the untouched tables, so its loss equals ours' first loss (the
    same weights and batch); the steps after it stay finite."""
    _, step, batch, _, _ = bench.build("sharded", B, VOCAB, DIM,
                                       device="cpu")
    step_p, raw = bench.build_pipelined(B, VOCAB, DIM, device="cpu")
    assert float(step_p(raw)) == pytest.approx(float(step(batch)),
                                               rel=1e-6, abs=1e-6)
    losses = [float(step_p(raw)) for _ in range(2)]
    assert np.isfinite(losses).all()


PEAK = PEAK_FLOPS["bfloat16"]


@pytest.mark.parametrize("step_s, dense_s, flops, withheld", [
    (0.010, 0.004, 0.5 * PEAK * 0.004, False),  # mfu 0.5, dense < step
    (0.010, 0.010, 0.5 * PEAK * 0.010, True),  # dense == step
    (0.010, 0.012, 0.5 * PEAK * 0.012, True),  # dense > step
    (0.010, 0.004, 1.0 * PEAK * 0.004, False),  # mfu exactly 1
    (0.010, 0.004, 1.5 * PEAK * 0.004, True),  # mfu > 1
])
def test_roofline_fields_withheld(step_s, dense_s, flops, withheld):
    out = bench.roofline_fields(step_s, dense_s, flops, floor_ms=1.5)
    keys = ("mfu_dense", "embedding_ms", "embedding_floor_frac")
    if withheld:
        assert all(out[k] is None for k in keys)
        assert "implausible" in out["dense_error"]
    else:
        assert "dense_error" not in out
        assert out["mfu_dense"] == round(flops / dense_s / PEAK, 3)
        assert out["embedding_ms"] == round((step_s - dense_s) * 1e3, 3)
        assert out["embedding_floor_frac"] == round(
            1.5 / ((step_s - dense_s) * 1e3), 3)


def test_main_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main()
