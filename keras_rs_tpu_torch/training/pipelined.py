"""Pipelined embedding execution: one-step-stale lookups (counterpart of
keras_rs_tpu/training/pipelined.py, the reference TF backend's
`pipeline_execution_with_tensor_core`).

The lookup of batch t+1 runs before the update of batch t, so it does
not depend on anything the dense stack computes: on a CUDA device it
runs on a side stream, beside the dense forward and backward of batch
t, at the cost of activations one update old. Per step t:

  1. dense forward and backward of batch t on the carried activations
     `prefetched.acts` (gathered in step t - 1 from tables that lacked
     update t - 1), made leaves that require grad: the dense gradients
     land in `.grad` and the activations' cotangent `d_acts` in theirs;
  2. the prefetch: batch t+1's activations gathered from the tables
     BEFORE update t (`prime`); on CUDA it is enqueued first, on a side
     stream that waits for everything the main stream had enqueued (the
     tables after update t - 1, the next batch's copies), and the main
     stream waits on its event before the first table write of (3). In
     device-preprocessing mode the COO transform of the next raw batch
     runs there too. On the CPU it runs in program order;
  3. the table update of batch t from `d_acts` alone
     (`DistributedEmbedding.apply_cotangents` over batch t's COO, kept
     since its prefetch): the stacked tables' fused optimizer, with no
     second gather (the JAX step's vjp re-traces the forward, which XLA
     drops; eagerly it would cost the lookup again). Gradients of
     dense-placement tables accumulate into `.grad`; then the dense
     optimizer steps.

Step 0 consumes fresh activations (`prime`), so it equals the
unpipelined step; staleness starts at step 1.

Over a mesh of D > 1 ranks (`mesh`, as make_train_step takes it) each
rank runs the step on its B / D samples and its shard of the tables,
and every rank issues the same collectives in the same host order: the
prefetch's all_to_all (its COO transform, in device mode) and
reduce-scatter (its lookup), on the side stream while it is current;
then, on the main stream, the update's all-gather of the cotangent
(`apply_cotangents`) before B1 / B3 on the shard, and last the dense
gradients' all_reduce. As in make_train_step, each rank back-propagates
its local loss / D, which is also the cotangent scale the sharded update
needs, and the step returns the global batch's loss. The prefetch never
grows capacities (its COO transform runs without `training`, so no
stats merge joins the collectives): the capacities stay as built, as in
the JAX step, whose shapes are static.

The embedding half is reached through `embed_fn(model, pre) -> (layer,
layer_pre)`: the embedding layer and its preprocessed input for the
batch's `pre` (`get_pre(batch)`). The layer gathers with `layer(
layer_pre)` under no_grad and updates with `layer.apply_cotangents(
layer_pre, d_acts)` (a `DistributedEmbedding`). `inject(batch, acts)`
hands activations to the loss in place of the layer's forward.

Memory across the two streams: tensors the side stream makes and the
main stream frees (the activations, the next batch's COO) are marked
with `record_stream`, and so are the next batch's tensors the side
stream reads, so the caching allocator does not hand their memory to
the other stream while it is still in use.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch
from torch import nn

from keras_rs_tpu_torch.parallel import collectives
from keras_rs_tpu_torch.training.train_state import (
    map_tensors,
    sum_gradients,
)


class Prefetch(NamedTuple):
    """Activations gathered ahead, and the embedding layer's
    preprocessed input they were gathered for (its COO arrays: the
    update of that batch reads them)."""

    acts: Any
    pre: Any


@dataclasses.dataclass
class PipelinedTrainState:
    """The pipelined loop's state. `model` and `optimizer` are updated
    in place; `prefetched` holds the activations of the next batch to be
    consumed, gathered one update ago (fresh at step 0, `prime`).

    `state_dict` / `load_state_dict` make it a checkpoint state
    (training/checkpoint.py): the model, the dense optimizer and the
    step. The prefetch is not saved: `load_state_dict` keeps the live
    one, and a resumed loop re-primes it from its own next batch
    (`prime`)."""

    model: nn.Module
    optimizer: Any
    step: int
    prefetched: Prefetch

    def state_dict(self) -> dict[str, Any]:
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "step": self.step,
        }

    def load_state_dict(self, saved: dict[str, Any]) -> None:
        self.model.load_state_dict(saved["model"])
        self.optimizer.load_state_dict(saved["optimizer"])
        self.step = int(saved["step"])


def _tensors(tree: Any) -> list[torch.Tensor]:
    found: list[torch.Tensor] = []
    map_tensors(tree, found.append)
    return found


def _device_of(tree: Any) -> torch.device:
    return _tensors(tree)[0].device


def dlrm_pipeline_fns() -> tuple[Callable, Callable, Callable]:
    """(embed_fn, get_pre, inject) for models.dlrm.DLRMDCNv2 fed
    preprocessed batches (`model.preprocess`): the model prefers
    precomputed `large_acts` over running its embedding layer
    (models/dlrm.py), so injection is one dict entry."""

    def embed_fn(model, pre):
        return model.embedding_layer, pre

    def get_pre(batch):
        return batch["large_pre"]

    def inject(batch, acts):
        return {**batch, "large_acts": acts}

    return embed_fn, get_pre, inject


@torch.no_grad()
def _gather(model: nn.Module, pre: Any,
            embed_fn: Callable[[nn.Module, Any], tuple]) -> tuple:
    """(the embedding layer, the Prefetch of `pre`)."""
    layer, layer_pre = embed_fn(model, pre)
    return layer, Prefetch(layer(layer_pre), layer_pre)


def prime(model: nn.Module, pre: Any,
          embed_fn: Callable[[nn.Module, Any], tuple]) -> Prefetch:
    """Fresh activations of the batch whose embedding input is `pre`,
    with the layer input the update of that batch needs."""
    return _gather(model, pre, embed_fn)[1]


def create_pipelined_train_state(
    model: nn.Module,
    optimizer: Any,
    first_pre: Any,
    embed_fn: Callable[[nn.Module, Any], tuple],
) -> PipelinedTrainState:
    """The state before step 0: `prefetched` primed fresh from the first
    batch's `first_pre`."""
    return PipelinedTrainState(model=model, optimizer=optimizer, step=0,
                               prefetched=prime(model, first_pre, embed_fn))


def make_pipelined_train_step(
    loss_fn: Callable[[nn.Module, Any], Any],
    optimizer: Any,
    embed_fn: Callable[[nn.Module, Any], tuple],
    get_pre: Callable[[Any], Any],
    inject: Callable[[Any, Any], Any],
    has_aux: bool = False,
    mesh: Any = None,
) -> Callable[..., tuple[PipelinedTrainState, Any]]:
    """Builds the pipelined step

        step(state, batch, next_pre) -> (state, loss or (loss, aux))

    (the loss detached; with `has_aux`, `loss_fn` returns (loss, aux) and
    the aux comes back detached, with no host read). `state` is updated
    in place and returned. `batch` is the batch whose activations are
    `state.prefetched`; `next_pre` is the next batch's embedding input
    (`get_pre(next_batch)`; feed the batch's own again for the last
    step, whose prefetch is then discarded). `get_pre` is not called by
    the step: it names what `next_pre` is, as in the JAX package.
    `optimizer` is the dense optimizer over the model's parameters
    (DenseAdagrad, DenseAdam); the stacked tables take their own
    optimizer in the update. With a `mesh` of D > 1 ranks the step is
    data parallel as the module docstring says; the aux stays this
    rank's.
    """
    del get_pre  # the caller applies it to the next batch
    D = 1 if mesh is None else mesh.size
    group = None if D == 1 else mesh.group(mesh.axis_names)
    side_streams: dict[torch.device, torch.cuda.Stream] = {}

    def step(state: PipelinedTrainState, batch: Any, next_pre: Any):
        model = state.model
        device = _device_of(state.prefetched.acts)
        ready = None
        if device.type == "cuda":
            main = torch.cuda.current_stream(device)
            side = side_streams.get(device)
            if side is None:
                side = side_streams[device] = torch.cuda.Stream(device)
            # (2) first, on the side stream, after all the main stream
            # has enqueued: update t - 1 and the next batch's copies.
            side.wait_stream(main)
            with torch.cuda.stream(side):
                layer, nxt = _gather(model, next_pre, embed_fn)
                ready = torch.cuda.Event()
                ready.record(side)
            for t in _tensors(next_pre):
                t.record_stream(side)
        else:
            layer, nxt = _gather(model, next_pre, embed_fn)

        # (1) dense forward and backward on the carried activations.
        optimizer.zero_grad()
        acts = map_tensors(state.prefetched.acts,
                           lambda t: t.detach().requires_grad_())
        out = loss_fn(model, inject(batch, acts))
        loss = out[0] if has_aux else out
        (loss if D == 1 else loss / D).backward()
        d_acts = map_tensors(acts, lambda t: t.grad)

        # (3) the update of batch t, after the prefetch has read the
        # tables: the event sits before the first table write.
        if ready is not None:
            main.wait_event(ready)
            for t in _tensors(nxt):
                t.record_stream(main)
        layer.apply_cotangents(state.prefetched.pre, d_acts)
        del acts, d_acts
        if D > 1:
            sum_gradients(optimizer.params, group)
            loss = collectives.all_reduce(loss.detach().clone(), group) / D
        optimizer.step()

        state.prefetched = nxt
        state.step += 1
        if has_aux:
            return state, (loss.detach(),
                           map_tensors(out[1], torch.Tensor.detach))
        return state, loss.detach()

    return step
