"""Plain PyTorch reference of the DLRM-DCNv2 training step.

The model the port's `models/dlrm.py` describes, written out in float32
from its equations, with no kernel, no COO transform, no stacking and no
import of the port:

  bottom = MLP(dense; relu between layers, none after the last)
  x0     = concat(bottom, one [B, dim] sum of rows per feature, in order)
  x      = x0;  x = x0 * ((x @ down_l) @ kernel_l + bias_l) + x  (3 times)
  logit  = MLP(x)  (relu between layers, none after the last)
  loss   = mean(max(z, 0) - z y + log1p(exp(-|z|)))

and the optimizers' formulas: dense parameters optax's Adagrad
(acc += g^2, p -= lr g rsqrt(acc + eps)); large tables Adagrad (acc +=
g^2, w -= lr g / (sqrt(acc) + eps)) or row-wise Adagrad (one accumulator
per row, acc += sum(g^2)), each starting from the configuration's
accumulator value. The large tables are held as the rows the three
batches touch; a row no batch of a step touches takes a zero gradient,
which leaves it and its accumulator as they are.

`readings` follows three steps from a `Start` and reads what the output
check compares (check.py): each step's loss, each leaf's first gradient
as the optimizer applied it, and each leaf's change after step 3. The
start is either the seed's weights with fresh accumulators
(`initial_start`, the run's first three steps) or the port's state as
read after the window (port.snapshot, the three steps that follow it).
The first gradient is worked out from the state after step 1 through the
change of the parameters: from fresh accumulators a0, Adagrad's first
step moves a leaf by lr g / sqrt(a0 + g^2), so while g^2 is far below a0
(0.1; every gradient of these cells is below 1e-3) the gradient's norm
is sqrt(a0) / lr times the change's, to a relative 1e-6. (The
accumulators themselves cannot show it: 0.1 + g^2 rounds back to 0.1 in
f32 for every |g| under 6e-5.) It also returns each leaf's exact first
gradient, for check.py's rule on leaves that do not move.

`tables` says how the tables are stored between steps:
  "float32"       f32 rows (the packed configuration);
  "bfloat16_sr"   bf16 rows rounded stochastically (capacity mode): the
                  rows are followed in f32, and a leaf's change is the
                  root of its expected square under the rounding, since
                  the port's random bits cannot be reproduced (below);
  "bfloat16", "float8_e4m3"  rounded to nearest (controls, control.py).
`matmul` is "float32", or "float8_e4m3" for a control: every product's
operands (forward and backward) rounded to e4m3 with a per-tensor scale.
`fault` plants a fault in the reference put in the port's place
(control.py): "half_batch", the loss the mean over the first half of the
batch only.

Stochastic rounding (ops/quant.py's rule: the bits of the f32 value plus
16 random low bits, truncated) moves a stored value w to the f32 target
t = fl(w + u) by one bf16 step with the chance of t's dropped low bits:
its mean is t - w, its variance frac (1 - frac) ulp^2. Over three steps
from w (each of which moves a row far less than one bf16 step, so the row
almost always starts at w), the expected square change of an element is
(sum of t - w)^2 + the sum of the variances.
"""

from __future__ import annotations

import dataclasses
import statistics

import numpy as np
import torch

from benchmark import weights as W
from benchmark.traffic import large_features

CHECK_STEPS = 3
E4M3_MAX = 448.0


@dataclasses.dataclass
class Readings:
    losses: list[float]
    grad_norms: dict[str, float]
    change_norms: dict[str, float]
    #: Exact first gradient of each leaf and its number of elements (the
    #: reference's only).
    grad_exact: dict[str, float] | None = None
    sizes: dict[str, int] | None = None
    #: The state after the last step (`readings(..., keep_end=True)`).
    end: "Start | None" = None


@dataclasses.dataclass
class Start:
    """The state three checked steps start from, f32 on one device: every
    dense leaf and its Adagrad accumulator by the port's parameter name,
    and for each large feature i the sorted distinct ids the steps' batches
    hold, those rows as stored, and their accumulators ([n, dim] for
    Adagrad, [n] for row-wise Adagrad)."""

    dense: dict[str, torch.Tensor]
    ids: dict[int, torch.Tensor]
    rows: dict[int, torch.Tensor]
    #: None: every accumulator at the configuration's starting value.
    dense_acc: dict[str, torch.Tensor] | None = None
    acc: dict[int, torch.Tensor] | None = None


def batch_ids(config: dict, batches: list[dict], device
              ) -> dict[int, torch.Tensor]:
    """Sorted distinct ids of each large feature over `batches`."""
    return {
        i: torch.unique(torch.cat([
            torch.as_tensor(np.asarray(b[f"cat_{i}"]), device=device)
            .reshape(-1) for b in batches]))
        for i in large_features(config)
    }


def initial_start(config: dict, seed: int, batches: list[dict],
                  device) -> Start:
    """The seed's weights (weights.py) and fresh accumulators, over the
    rows `batches` touch."""
    device = torch.device(device)
    ids = batch_ids(config, batches, device)
    return Start(
        dense={n: W.dense_leaf(seed, n, s, device)
               for n, s in dense_leaf_shapes(config).items()},
        ids=ids,
        rows={i: W.table_rows(config, seed, table_name(i),
                              config["vocab_sizes"][i], u)
              for i, u in ids.items()})


def table_name(i: int) -> str:
    return f"table_{i}"


def restart(config: dict, seed: int, end: Start, batches: list[dict],
            device) -> Start:
    """The start of `batches` after the steps that ended in `end`: the
    seed's rows and fresh accumulators, with `end`'s rows and accumulators
    where it holds them (`end` as `readings(..., keep_end=True)` left
    it)."""
    device = torch.device(device)
    out = initial_start(config, seed, batches, device)
    rowwise = config["embedding_optimizer"] == "rowwise_adagrad"
    a0 = float(config["initial_accumulator_value"])
    out.dense = {n: p.to(device).clone() for n, p in end.dense.items()}
    out.dense_acc = {n: a.to(device).clone()
                     for n, a in end.dense_acc.items()}
    out.acc = {}
    for i, u in out.ids.items():
        shape = (u.numel(),) if rowwise else tuple(out.rows[i].shape)
        out.acc[i] = torch.full(shape, a0, dtype=torch.float32,
                                device=device)
        pos = torch.searchsorted(end.ids[i], u).clamp_(
            max=end.ids[i].numel() - 1)
        held = end.ids[i][pos] == u
        out.rows[i][held] = end.rows[i][pos[held]].to(device)
        out.acc[i][held] = end.acc[i][pos[held]].to(device)
    return out


def dense_leaf_shapes(config: dict) -> dict[str, tuple[int, ...]]:
    """Every dense parameter, by the port's parameter name, in the port's
    order (`DLRMDCNv2.named_parameters()`)."""
    shapes: dict[str, tuple[int, ...]] = {}
    dim = config["embedding_dim"]
    large = set(large_features(config))
    for i, v in enumerate(config["vocab_sizes"]):
        if i not in large:
            shapes[f"small_embeddings.cat_{i}.embeddings"] = (v, dim)
    prev = config["num_dense_features"]
    for li, u in enumerate(config["bottom_mlp"]):
        shapes[f"bottom_mlp.layers.{li}.kernel"] = (prev, u)
        shapes[f"bottom_mlp.layers.{li}.bias"] = (u,)
        prev = u
    concat = config["bottom_mlp"][-1] + dim * len(config["vocab_sizes"])
    proj = config["dcn_projection_dim"]
    for li in range(config["num_dcn_layers"]):
        shapes[f"dcn_layers.{li}.down_proj_kernel"] = (concat, proj)
        shapes[f"dcn_layers.{li}.kernel"] = (proj, concat)
        shapes[f"dcn_layers.{li}.bias"] = (concat,)
    prev = concat
    for li, u in enumerate(config["top_mlp"]):
        shapes[f"top_mlp.layers.{li}.kernel"] = (prev, u)
        shapes[f"top_mlp.layers.{li}.bias"] = (u,)
        prev = u
    return shapes


def _quant_e4m3(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax()
    if float(amax) == 0.0:
        return x
    scale = amax / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _MatmulE4M3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _quant_e4m3(a), _quant_e4m3(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _quant_e4m3(g)
        return qg @ qb.T, qa.T @ qg


def _round_storage(x: torch.Tensor, tables: str) -> torch.Tensor:
    if tables == "bfloat16":
        return x.to(torch.bfloat16).float()
    if tables == "float8_e4m3":
        return x.to(torch.float8_e4m3fn).float()
    return x


def _sr_moments(w0: torch.Tensor, upd: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(t - w0, variance) of stochastically rounding t = fl(w0 + upd) to
    bf16, w0 on the bf16 grid."""
    t = w0 + upd
    bits = t.view(torch.int32)
    frac = (bits & 0xFFFF).float().div_(65536.0)
    trunc = (bits & ~0xFFFF).view(torch.float32)
    step = (((bits & ~0xFFFF) + 0x10000).view(torch.float32) - trunc).abs_()
    return t - w0, frac.mul_(1.0 - frac).mul_(step).mul_(step)


def grad_scale(config: dict) -> float:
    """sqrt(a0) / lr: a leaf's first gradient norm per unit of its first
    step's change under Adagrad, while g^2 is far below a0."""
    return (float(config["initial_accumulator_value"]) ** 0.5
            / float(config["learning_rate"]))


def readings(config: dict, batches: list[dict], start: Start, device,
             tables: str | None = None, matmul: str = "float32",
             fault: str | None = None, keep_end: bool = False) -> Readings:
    """The reference's readings over the first CHECK_STEPS of `batches`
    from `start` (whose ids are those batches' own)."""
    if tables is None:
        tables = ("bfloat16_sr" if config["table_dtype"] == "bfloat16"
                  else "float32")
    device = torch.device(device)
    lr = float(config["learning_rate"])
    emb_eps = float(config["embedding_epsilon"])
    dense_eps = float(config["dense_epsilon"])
    rowwise = config["embedding_optimizer"] == "rowwise_adagrad"
    if config["embedding_optimizer"] not in ("adagrad", "rowwise_adagrad"):
        raise ValueError(config["embedding_optimizer"])
    vocabs = config["vocab_sizes"]
    large = large_features(config)
    B = int(config["global_batch_size"])

    def mm(a, b):
        if matmul == "float8_e4m3":
            return _MatmulE4M3.apply(a, b)
        return a @ b

    # Dense leaves.
    if list(start.dense) != list(dense_leaf_shapes(config)):
        raise ValueError("the start's dense leaves are not the model's")
    dense = {n: p.to(device).clone().requires_grad_(True)
             for n, p in start.dense.items()}
    dense0 = {n: p.detach().clone() for n, p in dense.items()}
    a0 = float(config["initial_accumulator_value"])
    dense_acc = {n: (torch.full_like(p, a0) if start.dense_acc is None
                     else start.dense_acc[n].to(device).clone())
                 for n, p in dense0.items()}

    # Large tables: the rows the batches touch.
    steps = batches[:CHECK_STEPS]
    uniq = batch_ids(config, steps, device)
    inv = {i: [torch.searchsorted(uniq[i], torch.as_tensor(
        np.asarray(b[f"cat_{i}"]), device=device)) for b in steps]
        for i in large}
    w0, w, acc, sr = {}, {}, {}, {}
    for i in large:
        if not torch.equal(start.ids[i].to(device), uniq[i]):
            raise ValueError(f"the start's rows of table {i} are not the "
                             "batches' own")
        rows = _round_storage(start.rows[i].to(device), tables)
        w0[i] = rows
        w[i] = rows.clone().requires_grad_(True)
        shape = (rows.shape[0],) if rowwise else rows.shape
        acc[i] = (torch.full(shape, a0, dtype=torch.float32, device=device)
                  if start.acc is None
                  else start.acc[i].to(device).clone().reshape(shape))
        if tables == "bfloat16_sr":
            sr[i] = (torch.zeros_like(rows), torch.zeros_like(rows))

    def changes() -> dict[str, float]:
        """Each leaf's change so far (a bf16-SR table's expected one)."""
        out = {n: float((p.detach().double() - dense0[n].double()).norm())
               for n, p in dense.items()}
        for i in large:
            if tables == "bfloat16_sr":
                s1, s2 = sr[i]
                sq = s1.double().square() + s2.double()
            else:
                sq = (w[i].detach().double() - w0[i].double()).square()
            out[table_name(i)] = float(sq.sum().sqrt())
        return out

    out = Readings(losses=[], grad_norms={}, change_norms={},
                   grad_exact={},
                   sizes={**{n: p.numel() for n, p in dense.items()},
                          **{table_name(i): w[i].numel() for i in large}})
    for k, batch in enumerate(steps):
        x = torch.as_tensor(np.asarray(batch["dense"]), device=device)
        y = torch.as_tensor(np.asarray(batch["label"]), device=device)
        n_bot = len(config["bottom_mlp"])
        for li in range(n_bot):
            x = mm(x, dense[f"bottom_mlp.layers.{li}.kernel"]) + dense[
                f"bottom_mlp.layers.{li}.bias"]
            if li < n_bot - 1:
                x = torch.relu(x)
        parts = [x]
        for i in range(len(vocabs)):
            if i in uniq:
                parts.append(w[i][inv[i][k]].sum(dim=1))
            else:
                ids = torch.as_tensor(np.asarray(batch[f"cat_{i}"]),
                                      device=device)
                table = dense[f"small_embeddings.cat_{i}.embeddings"]
                parts.append(table[ids].sum(dim=1))
        x0 = torch.cat(parts, dim=-1)
        del parts
        x = x0
        for li in range(config["num_dcn_layers"]):
            h = mm(mm(x, dense[f"dcn_layers.{li}.down_proj_kernel"]),
                   dense[f"dcn_layers.{li}.kernel"])
            x = x0 * (h + dense[f"dcn_layers.{li}.bias"]) + x
        n_top = len(config["top_mlp"])
        for li in range(n_top):
            x = mm(x, dense[f"top_mlp.layers.{li}.kernel"]) + dense[
                f"top_mlp.layers.{li}.bias"]
            if li < n_top - 1:
                x = torch.relu(x)
        z = x[:, 0]
        per_example = (torch.clamp(z, min=0.0) - z * y
                       + torch.log1p(torch.exp(-torch.abs(z))))
        if fault == "half_batch":
            per_example = per_example[: B // 2]
        elif fault is not None:
            raise ValueError(f"unknown fault {fault!r}")
        loss = per_example.mean()
        names = list(dense)
        grads = torch.autograd.grad(
            loss, [dense[n] for n in names] + [w[i] for i in large])
        out.losses.append(float(loss.detach()))
        del x, x0, z, per_example, loss
        with torch.no_grad():
            for n, g in zip(names, grads[: len(names)]):
                if k == 0:
                    out.grad_exact[n] = float(g.double().norm())
                a = dense_acc[n]
                a.add_(g * g)
                inv_sqrt = torch.where(a > 0, torch.rsqrt(a + dense_eps),
                                       torch.zeros_like(a))
                dense[n].add_((inv_sqrt * g) * (-lr))
            for i, g in zip(large, grads[len(names):]):
                if k == 0:
                    out.grad_exact[table_name(i)] = float(g.double().norm())
                if rowwise:
                    acc[i].add_(torch.sum(g * g, dim=-1))
                    denom = torch.sqrt(acc[i])[:, None] + emb_eps
                else:
                    acc[i].add_(g * g)
                    denom = torch.sqrt(acc[i]) + emb_eps
                upd = -(lr * (g / denom))
                if tables == "bfloat16_sr":
                    mean, var = _sr_moments(w0[i], upd)
                    sr[i][0].add_(mean)
                    sr[i][1].add_(var)
                    w[i].add_(upd)
                else:
                    w[i].copy_(_round_storage(w[i] + upd, tables))
                del upd, denom
        del grads
        if k == 0:
            scale = grad_scale(config)
            out.grad_norms = {n: c * scale for n, c in changes().items()}
    out.change_norms = changes()
    if keep_end:
        # A bf16-SR row is followed in f32; stored, it is almost surely
        # the bf16 value nearest to that (it moves by far less than one
        # step).
        out.end = Start(
            dense={n: p.detach() for n, p in dense.items()},
            dense_acc=dense_acc, ids=uniq,
            rows={i: (_round_storage(w[i].detach(), "bfloat16")
                      if tables == "bfloat16_sr" else w[i].detach())
                  for i in large}, acc=acc)
    return out


def median(values) -> float:
    return float(statistics.median(list(values)))
