"""Train step (counterpart of keras_rs_tpu/training/train_state.py).

A step has two halves, as in the JAX package:
  * dense parameters (MLPs, FeatureCross, small EmbedReduce tables, all
    of SASRec) are the model's `nn.Parameter`s and take Adagrad or Adam
    in optax's formula (`DenseAdagrad`, `DenseAdam`);
  * stacked embedding tables are buffers, not parameters: their fused
    optimizer runs inside the lookup's backward pass and writes the new
    rows in place (the Overwrite contract of the JAX package,
    lookup.py's `_StackLookup`).

Over a mesh of D > 1 ranks the step is data parallel in the dense
parameters: each rank holds a replica (equal from the start: every rank
builds the model from the same generator seed) and its B / D samples;
the loss of the global batch is the mean of the ranks' local means, so
each rank back-propagates its local loss / D (which is also the
cotangent scale the sharded lookup's update needs) and the dense
gradients are summed over the ranks in one all_reduce before the
optimizer, which then takes the same step on every rank.
"""

from __future__ import annotations

import collections
import itertools
import warnings
import weakref
from typing import Any, Callable, Iterable

import numpy as np
import torch
from torch import nn
from torch.utils import _pytree as pytree

from keras_rs_tpu_torch.parallel import collectives
from keras_rs_tpu_torch.utils import cuda_graph, tracing


class DenseAdagrad:
    """`optax.adagrad` (scale_by_rss + scale_by_learning_rate):

        acc += g^2
        p   += -lr * (g * rsqrt(acc + eps))   (0 where acc == 0)

    with initial_accumulator_value 0.1 and eps 1e-7 inside the root.
    (`torch.optim.Adagrad` computes g / (sqrt(acc) + eps) and starts its
    accumulator at 0, so it is a different optimizer.) Parameters whose
    gradient is None are left alone.
    """

    #: The update reads nothing but tensors, which it changes in place,
    #: and its constants: a CUDA graph of the step may replay it.
    capturable = True

    def __init__(
        self,
        params: Iterable[nn.Parameter],
        learning_rate: float,
        initial_accumulator_value: float = 0.1,
        eps: float = 1e-7,
    ):
        self.params = list(params)
        self.learning_rate = learning_rate
        self.eps = eps
        self.accumulators = [
            torch.full_like(p, initial_accumulator_value,
                            memory_format=torch.preserve_format)
            for p in self.params
        ]

    @torch.no_grad()
    def step(self) -> None:
        for p, acc in zip(self.params, self.accumulators):
            g = p.grad
            if g is None:
                continue
            acc.add_(g * g)
            inv = torch.where(
                acc > 0, torch.rsqrt(acc + self.eps), torch.zeros_like(acc)
            )
            p.add_((inv * g) * (-self.learning_rate))

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict[str, Any]:
        """The accumulators (the tensors themselves, in parameter order)."""
        return {"accumulators": list(self.accumulators)}

    @torch.no_grad()
    def load_state_dict(self, state: dict[str, Any]) -> None:
        """Copies a `state_dict` into the accumulators in place."""
        _copy_into(self.accumulators, state["accumulators"], "accumulators")


class DenseAdam:
    """`optax.adam` (scale_by_adam + scale_by_learning_rate) with optax's
    defaults b1 0.9, b2 0.999, eps_root 0, at step t = 1, 2, ...:

        mu = (1 - b1) * g   + b1 * mu
        nu = (1 - b2) * g^2 + b2 * nu
        p += -lr * ((mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps))

    with mu and nu from 0 and eps (default 1e-8) outside the root.
    Parameters whose gradient is None are left alone (their moments do
    not move, but t counts every step, as optax's count does).
    """

    B1, B2 = 0.9, 0.999
    #: The bias corrections are host numbers of `count`, which a replayed
    #: CUDA graph would freeze: the step stays eager.
    capturable = False

    def __init__(self, params: Iterable[nn.Parameter], learning_rate: float,
                 eps: float = 1e-8):
        self.params = list(params)
        self.learning_rate = learning_rate
        self.eps = eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self) -> None:
        self.count += 1
        # Bias corrections in f32, as optax computes decay**count, and as
        # Python numbers: no tensor crosses to the device (that copy would
        # wait for the device once per parameter).
        b1, b2 = np.float32(self.B1), np.float32(self.B2)
        c1 = float(np.float32(1) - b1 ** np.float32(self.count))
        c2 = float(np.float32(1) - b2 ** np.float32(self.count))
        for p, mu, nu in zip(self.params, self.mu, self.nu):
            g = p.grad
            if g is None:
                continue
            mu.copy_((1 - self.B1) * g + self.B1 * mu)
            nu.copy_((1 - self.B2) * (g * g) + self.B2 * nu)
            update = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            p.add_(update * (-self.learning_rate))

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict[str, Any]:
        """The step count and both moments (the tensors themselves)."""
        return {"count": self.count, "mu": list(self.mu),
                "nu": list(self.nu)}

    @torch.no_grad()
    def load_state_dict(self, state: dict[str, Any]) -> None:
        """Copies a `state_dict` into the moments in place."""
        _copy_into(self.mu, state["mu"], "mu")
        _copy_into(self.nu, state["nu"], "nu")
        self.count = int(state["count"])


def _copy_into(dst: list[torch.Tensor], src: list[torch.Tensor],
               name: str) -> None:
    if len(dst) != len(src):
        raise ValueError(f"{name}: {len(src)} tensors for {len(dst)} "
                         "parameters.")
    for i, (d, v) in enumerate(zip(dst, src)):
        if tuple(d.shape) != tuple(v.shape):
            raise ValueError(f"{name}[{i}]: shape {tuple(v.shape)} for "
                             f"{tuple(d.shape)}.")
        d.copy_(v)


def map_tensors(tree: Any, fn: Callable[[torch.Tensor], Any]) -> Any:
    """`fn` over every tensor of a dict / tuple / list / NamedTuple
    structure; other leaves are kept as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, map_tensors(v, fn)) for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        items = [map_tensors(v, fn) for v in tree]
        if hasattr(tree, "_fields"):  # NamedTuple
            return type(tree)(*items)
        return type(tree)(items)
    return tree


def sum_gradients(params: list[nn.Parameter], group) -> None:
    """Every parameter's gradient summed over the ranks of `group`, in
    place, in one all_reduce of the flattened gradients (a parameter
    without a gradient counts as zeros and gets them, so every rank
    flattens the same layout)."""
    if not params:
        return
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    flat = collectives.all_reduce(
        torch.cat([g.reshape(-1) for g in grads]), group)
    off = 0
    for g in grads:
        g.copy_(flat[off : off + g.numel()].view_as(g))
        off += g.numel()


def make_train_step(
    model: nn.Module,
    loss_fn: Callable[[nn.Module, Any], Any],
    optimizer: DenseAdagrad | DenseAdam,
    has_aux: bool = False,
    mesh: Any = None,
) -> Callable[[Any], Any]:
    """`step(batch) -> loss` (detached): forward, backward (which also
    updates the stacked embedding tables in place), dense optimizer.

    With `has_aux`, `loss_fn` returns `(loss, aux)` and the step returns
    `(loss, aux)`, both detached, the aux as the loss function gave it
    (no host read), as the JAX step does.

    With a `mesh` (parallel/mesh.py) of D > 1 ranks, `batch` is this
    rank's B / D samples and `loss_fn` their mean loss: the step is data
    parallel as the module docstring says, and returns the global
    batch's loss (an all_reduce of the ranks' losses); the aux stays
    this rank's.

    At D = 1 the step goes through a `StepGraph` (`step.graphs`; None at
    D > 1): on a CUDA device with a `capturable` optimizer, repeated
    calls of one batch signature replay the step as a CUDA graph.

    The step is the root span of utils/tracing.py ("step"), with the
    spans "step.forward", "step.backward" and "step.optimizer" inside
    (or "step.replay", where a graph replays it)."""
    D = 1 if mesh is None else mesh.size
    group = None if D == 1 else mesh.group(mesh.axis_names)

    def body(batch: Any) -> Any:
        optimizer.zero_grad()
        with tracing.span("step.forward"):
            out = loss_fn(model, batch)
        loss = out[0] if has_aux else out
        with tracing.span("step.backward"):
            if D == 1:
                loss.backward()
            else:
                (loss / D).backward()
                sum_gradients(optimizer.params, group)
        if D > 1:
            loss = collectives.all_reduce(loss.detach().clone(), group) / D
        with tracing.span("step.optimizer"):
            optimizer.step()
        if has_aux:
            return loss.detach(), map_tensors(out[1], torch.Tensor.detach)
        return loss.detach()

    graphs = StepGraph(model, optimizer, body) if D == 1 else None

    def step(batch: Any) -> Any:
        with tracing.span("step"):
            return body(batch) if graphs is None else graphs(batch)

    step.graphs = graphs
    return step


#: Replays the host may enqueue before the oldest of them has run.
REPLAYS_AHEAD = 2


def _tensor_key(t: torch.Tensor) -> tuple:
    return (t.data_ptr(), tuple(t.shape), t.dtype)


def _host_counts_since(before: dict[str, int]) -> dict[str, int]:
    return {k: n - before.get(k, 0)
            for k, n in tracing.host_counts().items()
            if n != before.get(k, 0)}


class StepGraph:
    """The one-card training step captured as a CUDA graph and replayed
    (utils/cuda_graph.py).

    Launched from Python, a step's several hundred kernels cost more host
    time than the device takes to run them; a graph launches them at
    once. What engages it is what a call can observe (`signature`):

      * the model's device is CUDA and the optimizer is `capturable`;
      * the batch is a pytree (dicts, tuples, lists, NamedTuples) of
        tensors on that device and plain values (None, bool, int, float,
        str): its structure, each tensor's shape, dtype and
        requires_grad, and each plain value;
      * the address, shape and dtype of every parameter and buffer of the
        model (stacked tables, slots, step counters) and of every tensor
        the optimizer holds, with its other fields (rate, eps): a grown,
        reallocated or replaced tensor means a new capture, and a replay
        never writes to freed memory;
      * the plain state that shapes the step: `graph_key()` of each of
        the model's modules that has one (a DistributedEmbedding's
        stacks, whose capacities size the device COO);
      * grad mode, the model's training flag, deterministic algorithms,
        TF32, autocast, and whether tracing is on and its generation
        (utils/tracing.py), so the device counters a graph adds into are
        the live ones.

    Consecutive calls of one signature (`plan`): the first runs eagerly,
    the second eagerly on the capture stream (the warm-up CUDA graphs
    ask for), the third captures the step on that stream and replays it
    once, every later one copies the batch into the captured inputs and
    replays. So every call advances the state once. One graph is kept at
    a time. A capture that raises (a host read inside the loss, say)
    warns, and the step runs eagerly from then on.

    A replay returns a clone of the captured loss (and aux), a tensor of
    its own each step. It runs no Python of the step: the kernels' launch
    counts (`fn.launches`) count the calls that ran it (eager, warm and
    capturing), while tracing's host-int counters, values of the batch's
    shapes, add on each replay what the capture counted. It first waits
    for the replay REPLAYS_AHEAD steps back, so the host runs at most
    that far ahead of the device. Once a graph is captured, dropping the
    StepGraph drops the parameters' gradients too: the graph allocated
    them, and they would keep its memory pool.

    Counters: "step.graph_captures", "step.graph_replays" (the capturing
    call's replay included) and "step.graph_eager" (calls on a CUDA
    device that ran eagerly), which `counts` also counts, by "captures",
    "replays" and "eager", with tracing on or off, and `totals` over
    every StepGraph of the process; span: "step.replay", the input copy
    and the launch.
    """

    totals: collections.Counter = collections.Counter()

    def __init__(self, model: nn.Module, optimizer: Any,
                 body: Callable[[Any], Any]) -> None:
        self.model = model
        self.optimizer = optimizer
        self.body = body
        self.counts: collections.Counter = collections.Counter()
        #: A capture raised: every call runs eagerly.
        self.broken = False
        #: The signature of the graph being captured or kept.
        self.key: tuple | None = None
        self._last: tuple | None = None
        self._seen = 0
        self._graph: cuda_graph.Graph | None = None
        #: Tracing's host-int counts that the capture added.
        self._added: dict[str, int] = {}
        self._stream = None
        self._pending: collections.deque = collections.deque()
        self._release = None

    def device(self) -> torch.device | None:
        for t in itertools.chain(self.model.parameters(),
                                 self.model.buffers()):
            return t.device
        return None

    @staticmethod
    def graphable(device: torch.device | None) -> bool:
        return device is not None and device.type == "cuda"

    def signature(self, batch: Any, device: torch.device
                  ) -> tuple[tuple, list, Any] | None:
        """(the call's signature, the batch's leaves, their structure), or
        None where the call runs eagerly."""
        if self.broken or not getattr(self.optimizer, "capturable", False):
            return None
        leaves, spec = pytree.tree_flatten(batch)
        inputs = []
        for x in leaves:
            sig = cuda_graph.leaf_signature(x)
            if sig[0] == "object" or (sig[0] == "tensor"
                                      and x.device != device):
                return None
            inputs.append(sig + (x.requires_grad,) if sig[0] == "tensor"
                          else sig)
        state = tuple(_tensor_key(t) for t in itertools.chain(
            self.model.parameters(), self.model.buffers()))
        fields, fields_spec = pytree.tree_flatten(vars(self.optimizer))
        optimizer = (fields_spec, tuple(
            _tensor_key(x) if isinstance(x, torch.Tensor)
            else cuda_graph.leaf_signature(x) for x in fields))
        modules = tuple(m.graph_key() for m in self.model.modules()
                        if hasattr(m, "graph_key"))
        switches = (
            torch.is_grad_enabled(), self.model.training,
            torch.are_deterministic_algorithms_enabled(),
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.is_autocast_enabled(device.type),
            tracing.enabled(), tracing.generation(),
        )
        return ((spec, tuple(inputs), state, optimizer, modules, switches),
                leaves, spec)

    def plan(self, key: tuple | None) -> str:
        """What the call of signature `key` does: "replay", "capture",
        "warm" (eager on the capture stream) or "eager"."""
        if key is None:
            self._last, self._seen = None, 0
            return "eager"
        if key == self.key:
            self._last, self._seen = None, 0
            return "replay"
        self._seen = self._seen + 1 if key == self._last else 1
        self._last = key
        if self._seen < 3:
            return ("eager", "warm")[self._seen - 1]
        self.key = key
        return "capture"

    def __call__(self, batch: Any) -> Any:
        device = self.device()
        if not self.graphable(device):
            return self.body(batch)
        sig = self.signature(batch, device)
        how = self.plan(None if sig is None else sig[0])
        if how == "replay":
            return self._replay(sig[1])
        if how == "capture":
            return self._capture(batch, sig[1], sig[2], device)
        self._count("eager")
        if how == "warm":
            return cuda_graph.run_on(self._capture_stream(device), self.body,
                                     batch)
        return self.body(batch)

    def _count(self, kind: str) -> None:
        self.counts[kind] += 1
        StepGraph.totals[kind] += 1
        tracing.count(f"step.graph_{kind}", 1)

    def _capture_stream(self, device: torch.device):
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream

    def _capture(self, batch: Any, leaves: list, spec: Any,
                 device: torch.device) -> Any:
        # The old graph's memory goes before the new capture, once none of
        # its replays is still running.
        while self._pending:
            self._pending.popleft().synchronize()
        self._graph = None
        before = tracing.host_counts()
        try:
            graph = cuda_graph.Graph(self.body, leaves, spec,
                                     self._capture_stream(device))
            failure = None
        except Exception as error:  # noqa: BLE001 - any failure: eager
            failure = f"{type(error).__name__}: {error}"
        # Nothing captured has run yet: what the capture's Python counted
        # goes back, and each replay adds it.
        added = _host_counts_since(before)
        for k, n in added.items():
            tracing.count(k, -n)
        if failure is not None:
            # The call runs eagerly, and so does every later one.
            self.broken, self.key = True, None
            warnings.warn(
                f"The training step could not be captured as a CUDA graph "
                f"({failure}); it runs eagerly from now on.",
                RuntimeWarning, stacklevel=4)
            self._count("eager")
            return self.body(batch)
        self._graph, self._added = graph, added
        if self._release is None:
            self._release = weakref.finalize(self, self.optimizer.zero_grad)
        self._count("captures")
        return self._replay(leaves)

    def _replay(self, leaves: list) -> Any:
        if len(self._pending) == REPLAYS_AHEAD:
            self._pending.popleft().synchronize()
        with tracing.span("step.replay"):
            out = self._graph(leaves)
            done = torch.cuda.Event()
            done.record()
            self._pending.append(done)
        for k, n in self._added.items():
            tracing.count(k, n)
        self._count("replays")
        return out
