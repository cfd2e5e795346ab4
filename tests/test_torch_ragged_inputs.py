"""Ragged and sparse inputs in the port against the JAX package: `Ragged`
and `sparse_densify` against `Ragged` and `bcoo_densify`, EmbedReduce with
Ragged, sparse and weighted inputs (and the reference's errors), and
DistributedEmbedding trained on Ragged batches narrower than their
valence, which take the lookup's sorted forward in both packages.

Tolerances: densified ids, masks and the integer COO arrays bit-exact;
activations within 1e-6 relative; losses and tables after 3 training
steps within 1e-5 (f32 segment-sums add in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental import sparse as jsparse
from torch_parity import one_device_mesh

from keras_rs_tpu import training as jax_training
from keras_rs_tpu.data import ragged as jax_ragged
from keras_rs_tpu.data import sparse_utils as jax_sparse
from keras_rs_tpu.layers.embedding import config as jax_config
from keras_rs_tpu.layers.embedding import (
    distributed_embedding as jax_de,
)
from keras_rs_tpu.layers.embedding import embed_reduce as jax_er
from keras_rs_tpu_torch.data.ragged import Ragged
from keras_rs_tpu_torch.data.sparse_utils import is_sparse, sparse_densify
from keras_rs_tpu_torch.layers.embedding import config
from keras_rs_tpu_torch.layers.embedding import distributed_embedding
from keras_rs_tpu_torch.layers.embedding.device_preprocessing import (
    preprocess_stack_device,
)
from keras_rs_tpu_torch.layers.embedding.embed_reduce import EmbedReduce
from keras_rs_tpu_torch.layers.embedding.preprocessing import (
    preprocess_stack,
)

RTOL = 1e-6


def _lists(rng, batch, max_len, vocab, floats=False):
    lengths = rng.integers(0, max_len + 1, size=batch)
    if floats:
        return [list(rng.uniform(0.5, 2.0, n).astype(np.float32))
                for n in lengths]
    return [list(rng.integers(0, vocab, n)) for n in lengths]


def _both(rows):
    """The same rows as the port's and the JAX package's Ragged, int64
    ids or f32 weights. (`from_lists` takes the type of the concatenated
    rows, so a batch with an empty row would come out float: both
    packages alike, see test_ragged_to_padded_bit_exact.)"""
    floats = any(isinstance(v, (float, np.floating)) for r in rows
                 for v in r)
    values = np.asarray([v for r in rows for v in r],
                        np.float32 if floats else np.int64)
    lengths = np.asarray([len(r) for r in rows], np.int32)
    return Ragged(values, lengths), jax_ragged.Ragged(values, lengths)


def _sparse_pair(rng, batch, width, vocab, density=0.5):
    """A sparse id matrix as a torch sparse COO tensor and a BCOO."""
    keep = rng.random((batch, width)) < density
    idx = np.argwhere(keep)  # [nnz, 2], BCOO's layout
    data = rng.integers(1, vocab, size=len(idx))
    bcoo = jsparse.BCOO((jnp.asarray(data), jnp.asarray(idx)),
                        shape=(batch, width))
    sp = torch.sparse_coo_tensor(torch.from_numpy(idx.T.copy()),
                                 torch.from_numpy(data), (batch, width))
    return sp, bcoo


# --- Ragged and sparse adapters -------------------------------------------


@pytest.mark.parametrize("max_length", [None, 2, 6])
@pytest.mark.parametrize("floats", [False, True])
def test_ragged_to_padded_bit_exact(max_length, floats):
    rng = np.random.default_rng(0)
    rows = _lists(rng, 9, 5, 100, floats)
    rows[3] = []
    ours = Ragged.from_lists(rows)
    ref = jax_ragged.Ragged.from_lists(rows)
    np.testing.assert_array_equal(ours.row_lengths, ref.row_lengths)
    assert ours.values.dtype == ref.values.dtype
    assert ours.batch_size == ref.batch_size == 9
    for got, want in zip(ours.to_padded(max_length),
                         ref.to_padded(max_length)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_ragged_empty_batch_and_empty_rows():
    for rows in ([], [[], []]):
        ours = Ragged.from_lists(rows)
        ref = jax_ragged.Ragged.from_lists(rows)
        for got, want in zip(ours.to_padded(), ref.to_padded()):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype


@pytest.mark.parametrize("duplicate", [False, True])
def test_sparse_densify_matches_bcoo_densify(duplicate):
    rng = np.random.default_rng(1)
    sp, bcoo = _sparse_pair(rng, 6, 4, 50)
    if duplicate:  # a repeated index sums, in both packages
        idx = np.array([[0, 1], [0, 1], [2, 3]])
        data = np.array([3, 4, 5])
        bcoo = jsparse.BCOO((jnp.asarray(data), jnp.asarray(idx)),
                            shape=(3, 4))
        sp = torch.sparse_coo_tensor(torch.from_numpy(idx.T.copy()),
                                     torch.from_numpy(data), (3, 4))
    assert is_sparse(sp) and not is_sparse(sp.to_dense())
    ids, mask = sparse_densify(sp)
    want_ids, want_mask = jax_sparse.bcoo_densify(bcoo)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    assert mask.dtype == torch.float32


# --- EmbedReduce ----------------------------------------------------------


def _er_pair(combiner):
    table = np.random.default_rng(2).normal(size=(100, 16)).astype(
        np.float32)
    return (EmbedReduce(100, 16, table=torch.from_numpy(table),
                        combiner=combiner),
            jax_er.EmbedReduce(100, 16, table=table, combiner=combiner))


@pytest.mark.parametrize("combiner", ["mean", "sum", "sqrtn"])
def test_embed_reduce_ragged_sparse_and_weighted(combiner):
    ours, ref = _er_pair(combiner)
    rng = np.random.default_rng(3)
    ids_rows = _lists(rng, 8, 5, 100)
    ids_rows[2] = []
    w_rows = [list(rng.uniform(0.5, 2.0, len(r)).astype(np.float32))
              for r in ids_rows]
    t_ids, j_ids = _both(ids_rows)
    t_w, j_w = _both(w_rows)
    sp, bcoo = _sparse_pair(rng, 8, 5, 100)
    dense_w = rng.random((8, 5)).astype(np.float32)
    sp_w = torch.sparse_coo_tensor(sp._indices(), torch.ones(
        sp._indices().shape[1]), (8, 5))
    bcoo_w = jsparse.BCOO((jnp.ones(bcoo.nse), bcoo.indices), shape=(8, 5))
    cases = [
        ((t_ids,), (j_ids,)),
        ((t_ids, t_w), (j_ids, j_w)),
        ((sp,), (bcoo,)),
        ((sp, torch.from_numpy(dense_w)), (bcoo, dense_w)),
        ((sp, sp_w), (bcoo, bcoo_w)),
    ]
    for t_args, j_args in cases:
        got = ours(*t_args).detach().numpy()
        want = np.asarray(ref(*j_args))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)
        # The densified form gives the same activations.
        assert got.shape == (8, 16)


def test_embed_reduce_ragged_with_dense_weights():
    ours, ref = _er_pair("mean")
    rows = [[1, 2], [3], [4, 5]]
    t_ids, j_ids = _both(rows)
    w = np.array([[1.0, 2.0], [3.0, 9.0], [0.5, 0.5]], np.float32)
    np.testing.assert_allclose(ours(t_ids, torch.from_numpy(w)).detach(),
                               np.asarray(ref(j_ids, w)), rtol=RTOL)


def test_embed_reduce_input_errors_match_jax():
    ours, ref = _er_pair("mean")
    ids = np.array([[1, 2], [3, 4]])
    sp, bcoo = _sparse_pair(np.random.default_rng(4), 2, 2, 100, 1.0)
    t_a, j_a = _both([[1, 2], [3]])
    t_b, j_b = _both([[1.0], [2.0, 3.0]])
    cases = [
        ((torch.from_numpy(ids), sp), (ids, bcoo),
         "Sparse weights require sparse ids"),
        ((t_a, t_b), (j_a, j_b), "row_lengths must equal"),
        ((torch.from_numpy(ids), t_b), (ids, j_b),
         "Ragged weights require Ragged ids"),
    ]
    for t_args, j_args, msg in cases:
        with pytest.raises(ValueError, match=msg):
            ref(*j_args)
        with pytest.raises(ValueError, match=msg):
            ours(*t_args)


# --- DistributedEmbedding -------------------------------------------------

B = 32
LR = 0.05
# (name, vocab, valence, combiner): every feature of one stack.
TABLES = [("t_a", 500, 4, "sum"), ("t_b", 300, 3, "mean"),
          ("t_c", 200, 2, "sqrtn")]


def _configs(cfg_mod, dim):
    return {
        f"f_{name}": cfg_mod.FeatureConfig(
            name=f"f_{name}",
            table=cfg_mod.TableConfig(
                name=name, vocabulary_size=vocab, embedding_dim=dim,
                optimizer="adagrad", combiner=combiner,
                placement="sharded",
                max_ids_per_partition=B * 9,
                max_unique_ids_per_partition=B * 9,
            ),
            input_shape=(B, valence),
            output_shape=(B, dim),
        )
        for name, vocab, valence, combiner in TABLES
    }


def _de_pair(dim):
    jlayer = jax_de.DistributedEmbedding(
        _configs(jax_config, dim), key=jax.random.key(0),
        mesh=one_device_mesh())
    tlayer = distributed_embedding.DistributedEmbedding(
        _configs(config, dim), generator=torch.Generator().manual_seed(0),
        device="cpu")
    tlayer.set_embedding_tables(jlayer.get_embedding_tables())
    return jlayer, tlayer


def _narrow_batch(seed):
    """f_a as Ragged ids (rows of 0-3 ids, valence 4), f_b as Ragged ids
    with Ragged weights (0-2 ids, valence 3), f_c as a sparse matrix at
    its valence: every stack entry is narrower than the declared width,
    so both packages take the sorted forward."""
    rng = np.random.default_rng(seed)
    a = _lists(rng, B, 3, 500)
    b = _lists(rng, B, 2, 300)
    bw = [list(rng.uniform(0.5, 2.0, len(r)).astype(np.float32)) for r in b]
    sp, bcoo = _sparse_pair(rng, B, 2, 200)
    t_a, j_a = _both(a)
    t_b, j_b = _both(b)
    t_bw, j_bw = _both(bw)
    ours = ({"f_t_a": t_a, "f_t_b": t_b, "f_t_c": sp}, {"f_t_b": t_bw})
    ref = ({"f_t_a": j_a, "f_t_b": j_b, "f_t_c": bcoo}, {"f_t_b": j_bw})
    return ours, ref


def _cot(seed, dim):
    rng = np.random.default_rng(100 + seed)
    return {f"f_{n}": rng.standard_normal((B, dim)).astype(np.float32)
            for n, *_ in TABLES}


@pytest.mark.parametrize("dim", [128, 32])  # packed and split states
def test_distributed_embedding_trains_on_narrow_ragged_batches(dim):
    jlayer, tlayer = _de_pair(dim)
    (stack,) = tlayer.stacks
    assert stack.packed_state == (dim == 128)
    opt = optax.sgd(0.0)  # the layer has no dense parameters
    state = jax_training.create_train_state(jlayer, opt)

    for step in range(3):
        (t_in, t_w), (j_in, j_w) = _narrow_batch(step)
        cot = _cot(step, dim)
        jpre = jlayer.preprocess(j_in, j_w)
        host = tlayer.preprocess_host(t_in, t_w)["sharded"][stack.name]
        # The integer COO arrays bit for bit; no construction arrays.
        assert host.fwd_slots is None
        assert "fwd_slots" not in jpre["sharded"][stack.name]
        for name, want in jpre["sharded"][stack.name].items():
            np.testing.assert_array_equal(getattr(host, name),
                                          np.asarray(want), err_msg=name)

        def jloss(m, pre, cot=cot):
            acts = m(pre)
            return sum(jnp.sum(acts[k] * cot[k]) for k in acts)

        jstep = jax_training.make_train_step(jloss, opt, donate=False)
        state, jl = jstep(state, jpre)
        t_acts = tlayer(tlayer.preprocess(t_in, t_w))
        tl = sum((t_acts[k] * torch.from_numpy(cot[k])).sum()
                 for k in t_acts)
        tl.backward()
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)

    j_tables = state.model.get_embedding_tables()
    for name, t in tlayer.get_embedding_tables().items():
        np.testing.assert_allclose(t.numpy(), np.asarray(j_tables[name]),
                                   rtol=1e-5, atol=1e-5)
    assert float(tlayer.stack_state(0)["step"]) == 3.0


def test_narrow_ragged_forward_matches_jax_activations():
    jlayer, tlayer = _de_pair(128)
    (t_in, t_w), (j_in, j_w) = _narrow_batch(7)
    want = jax.jit(lambda m, p: m(p))(jlayer, jlayer.preprocess(j_in, j_w))
    with torch.no_grad():
        got = tlayer(t_in, t_w)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=RTOL)
    # The frozen layer serves the same Ragged and sparse request.
    frozen = tlayer.freeze()(t_in, t_w)
    for k in want:
        np.testing.assert_allclose(frozen[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=RTOL,
                                   atol=RTOL)


def test_host_native_and_device_preprocessing_fall_back_together():
    """A narrow Ragged batch gives the same arrays, without construction-
    order arrays, from numpy, the C++ engine and the device transform; a
    full-width batch gives construction arrays from all three."""
    _, tlayer = _de_pair(128)
    (stack,) = tlayer.stacks
    (t_in, t_w), _ = _narrow_batch(3)
    rng = np.random.default_rng(5)
    full = {f"f_{n}": rng.integers(0, v, (B, val)) for n, v, val, _ in
            TABLES}
    for inputs, weights, construction in ((t_in, t_w, False),
                                          (full, None, True)):
        ids, w = tlayer._bind(inputs, weights, host=True)
        ids = {f.name: ids[f.name] for f in stack.features}
        w = {k: v for k, v in w.items() if v is not None}
        numpy_coo, _ = preprocess_stack(stack, ids, w, backend="numpy")
        native_coo, _ = preprocess_stack(stack, ids, w, backend="native")
        dev_coo, _ = preprocess_stack_device(
            stack, {k: torch.from_numpy(v) for k, v in ids.items()},
            {k: torch.from_numpy(v) for k, v in w.items()})
        for coo in (numpy_coo, native_coo, dev_coo):
            assert (coo.fwd_slots is not None) == construction
        for name, want in numpy_coo.arrays().items():
            np.testing.assert_array_equal(getattr(native_coo, name), want)
            np.testing.assert_array_equal(
                np.asarray(getattr(dev_coo, name)), want, err_msg=name)


def test_preprocess_on_device_takes_ragged_and_sparse():
    _, tlayer = _de_pair(32)
    (stack,) = tlayer.stacks
    (t_in, t_w), _ = _narrow_batch(4)
    host = tlayer.preprocess(t_in, t_w)["sharded"][stack.name]
    dev = tlayer.preprocess_on_device(t_in, t_w)["sharded"][stack.name]
    assert host.keys() == dev.keys() and "recv_slots" in dev
    for k in host:
        assert torch.equal(host[k], dev[k]), k


def test_distributed_embedding_input_errors_match_jax():
    jlayer, tlayer = _de_pair(32)
    (t_in, _), (j_in, _) = _narrow_batch(0)
    bad_t = Ragged.from_lists([[1.0]] * B)
    bad_j = jax_ragged.Ragged.from_lists([[1.0]] * B)
    with pytest.raises(ValueError, match="'f_t_a': Ragged weights row_"):
        jlayer.preprocess(j_in, {"f_t_a": bad_j})
    with pytest.raises(ValueError, match="'f_t_a': Ragged weights row_"):
        tlayer.preprocess(t_in, {"f_t_a": bad_t})
    dense = dict(t_in, f_t_a=np.zeros((B, 4), np.int64))
    dense_j = dict(j_in, f_t_a=np.zeros((B, 4), np.int64))
    with pytest.raises(ValueError, match="require Ragged ids"):
        jlayer.preprocess(dense_j, {"f_t_a": bad_j})
    with pytest.raises(ValueError, match="require Ragged ids"):
        tlayer.preprocess(dense, {"f_t_a": bad_t})
