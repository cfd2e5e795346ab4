"""The collectives of the sharded embedding, over torch.distributed.

Counterpart of the JAX package's `jax.lax` collectives inside its
`shard_map`s (keras_rs_tpu/layers/embedding/lookup.py):

  JAX                        here
  all_to_all (tiled)         all_to_all       (dist.all_to_all_single)
  psum_scatter (tiled)       reduce_scatter   (dist.reduce_scatter_tensor)
  all_gather (tiled)         all_gather       (dist.all_gather_into_tensor)
  psum                       all_reduce       (dist.all_reduce)

`all_gather_with_grad` is the all-gather inside a differentiated
function (the JAX package's global-batch losses under jit): its
backward sums each rank's gradient of the gathered rows into the rank
that owns them (a reduce-scatter).

Each takes the process group of a mesh axis (`Mesh.group`); a group of
one rank (None) makes every function the identity, so the one-device
path runs the same code without torch.distributed.

`count_bytes()` counts, while it is open, the bytes of every collective
this process runs through these functions, by kind ("all-to-all",
"reduce-scatter", "all-gather", "all-reduce", "broadcast", the JAX
tool's HLO names): each call adds its output tensor's numel() *
element_size(), the dtype actually sent (bf16 under
comm_dtype="bfloat16"), as tools/weak_scaling.py sums the output shapes
of the compiled step's collectives. The same bytes feed the tracing of
utils/tracing.py: each call runs inside the span
"collective.<kind>" ("collective.all_to_all", ".reduce_scatter",
".all_gather", ".all_reduce", ".broadcast") with the attribute `bytes`,
and adds them to the host counter "collective.<kind>_bytes". The
identity of a one-rank group sends nothing, counts nothing and opens no
span. Closed and off (the defaults), they cost a None check and two flag
checks per call and never read the device. The tensors stay on
their device: the group's backend must carry them (NCCL for CUDA
tensors; gloo carries CPU tensors, and on a CUDA tensor either carries
it or raises). The callers in this package look these functions up on
the module at call time, so a script may stand in its own versions.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Iterator

import torch
import torch.distributed as dist

from keras_rs_tpu_torch.utils import tracing

ProcessGroup = dist.ProcessGroup

# reduce_scatter_tensor and all_gather_into_tensor exist in every torch
# this package runs on; newer versions warn on each call that they are
# deprecated in favour of *_single names the older ones lack.
warnings.filterwarnings(
    "ignore", category=FutureWarning,
    message=r"`torch\.distributed\.(reduce_scatter_tensor|"
    r"all_gather_into_tensor)` is deprecated")


#: The kinds `count_bytes` counts.
KINDS = ("all-to-all", "reduce-scatter", "all-gather", "all-reduce",
         "broadcast")
#: The tracing span of each kind; its counter adds "_bytes".
SPANS = {kind: "collective." + kind.replace("-", "_") for kind in KINDS}
_counts: dict[str, int] | None = None


@contextlib.contextmanager
def count_bytes() -> Iterator[dict[str, int]]:
    """Yields {kind: bytes}, to which every collective of this process
    adds its output's bytes until the block ends (see the module
    docstring). Blocks nest: an inner one counts alone."""
    global _counts
    outer, _counts = _counts, dict.fromkeys(KINDS, 0)
    try:
        yield _counts
    finally:
        _counts = outer


def _count(kind: str, out: torch.Tensor) -> int:
    """Counts the bytes of one collective of `kind` whose output is
    `out`, for count_bytes and for the tracing counter; returns them."""
    n = out.numel() * out.element_size()
    if _counts is not None:
        _counts[kind] += n
    tracing.count(SPANS[kind] + "_bytes", n)
    return n


def _sent(kind: str, out: torch.Tensor):
    """The span to run one collective of `kind` in, its bytes counted."""
    return tracing.span(SPANS[kind], bytes=_count(kind, out))


def rank(group: ProcessGroup | None) -> int:
    """This process's rank in `group` (0 for None)."""
    return 0 if group is None else dist.get_rank(group)


def all_to_all(x: torch.Tensor, group: ProcessGroup | None) -> torch.Tensor:
    """`x` [D, ...]: block i goes to rank i; returns [D, ...] whose block
    i came from rank i (equal blocks, so equal splits)."""
    if group is None:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    with _sent("all-to-all", out):
        dist.all_to_all_single(out, x, group=group)
    return out


def reduce_scatter(x: torch.Tensor,
                   group: ProcessGroup | None) -> torch.Tensor:
    """`x` [D * n, ...] on every rank -> this rank's block [n, ...] of
    the sum over ranks."""
    if group is None:
        return x
    D = dist.get_world_size(group)
    x = x.contiguous()
    out = torch.empty((x.shape[0] // D, *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    with _sent("reduce-scatter", out):
        dist.reduce_scatter_tensor(out, x, group=group)
    return out


def all_gather(x: torch.Tensor, group: ProcessGroup | None) -> torch.Tensor:
    """`x` [n, ...] on every rank -> [D * n, ...], rank i's block i."""
    if group is None:
        return x
    D = dist.get_world_size(group)
    x = x.contiguous()
    out = torch.empty((D * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    with _sent("all-gather", out):
        dist.all_gather_into_tensor(out, x, group=group)
    return out


def all_reduce(x: torch.Tensor, group: ProcessGroup | None,
               op: str = "sum") -> torch.Tensor:
    """`x` reduced over the ranks in place ("sum" or "max"); returns
    it."""
    if group is not None:
        reduce_op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        with _sent("all-reduce", x):
            dist.all_reduce(x, op=reduce_op, group=group)
    return x


def broadcast(x: torch.Tensor, group: ProcessGroup | None,
              src: int = 0) -> torch.Tensor:
    """`x` of the group's rank `src` written into `x` on every rank, in
    place; returns it."""
    if group is not None:
        with _sent("broadcast", x):
            dist.broadcast(x, src=dist.get_global_rank(group, src),
                           group=group)
    return x


class _AllGatherWithGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return reduce_scatter(grad, ctx.group), None


def all_gather_with_grad(x: torch.Tensor,
                         group: ProcessGroup | None) -> torch.Tensor:
    """`all_gather` whose backward reduce-scatters the gathered rows'
    gradient: each rank's block gets the sum over the ranks of its
    rows' gradients."""
    if group is None:
        return x
    return _AllGatherWithGrad.apply(x, group)
