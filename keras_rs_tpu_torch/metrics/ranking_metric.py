"""Ranking metric base class (counterpart of
keras_rs_tpu/metrics/ranking_metric.py).

The state is an explicit `MeanState` of tensors on the metric's device,
so `update` is a function of (state, batch) and an evaluation loop
accumulates on the device; `update_state` / `result` / `reset_state`
are the stateful form for host loops.

Random tie-breaking (`shuffle_ties`, the default) draws from a
`torch.Generator` on the metric's device, seeded from `seed` and the
number of lists the state has seen, where the reference folds that count
into a `jax.random` key: the draws differ from the reference's, and
reading the count makes one host sync per update. Results that do not
depend on the order of tied scores agree.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from keras_rs_tpu_torch.losses.base import unpack_labels_and_mask
from keras_rs_tpu_torch.ops.ranking import standardize_call_inputs_ranks
from keras_rs_tpu_torch.utils.device import resolve_device

_EPSILON = 1e-7  # keras.config.epsilon()


class MeanState(NamedTuple):
    total: torch.Tensor
    count: torch.Tensor


class RankingMetric:
    """Base of DCG, NDCG, MAP, MRR, P@k and R@k.

    Subclasses implement `compute_metric(y_true, y_pred, mask,
    sample_weight, generator)` returning `(per_list_values,
    per_list_weights)`; the weighted mean over lists accumulates in
    `MeanState`.
    """

    def __init__(
        self,
        k: int | None = None,
        shuffle_ties: bool = True,
        seed: int | None = None,
        name: str | None = None,
        dtype: torch.dtype = torch.float32,
        device: Any = None,
    ) -> None:
        if k is not None and (not isinstance(k, int) or k < 1):
            raise ValueError(
                f"`k` should be a positive integer. Received: `k` = {k}."
            )
        self.k = k
        self.shuffle_ties = shuffle_ties
        self.seed = seed
        self.name = name or type(self).__name__
        self.dtype = dtype
        self.device = resolve_device(device)
        self._state: MeanState | None = None

    def compute_metric(
        self,
        y_true: torch.Tensor,
        y_pred: torch.Tensor,
        mask: torch.Tensor,
        sample_weight: torch.Tensor,
        generator: torch.Generator | None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    # -- functional API --------------------------------------------------
    def init_state(self) -> MeanState:
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        return MeanState(total=zero, count=zero.clone())

    def update(
        self,
        state: MeanState,
        y_true: Any,
        y_pred: Any,
        sample_weight: Any = None,
        generator: torch.Generator | None = None,
    ) -> MeanState:
        """A new MeanState with the batch's lists added."""
        values, weights = self.compute(
            y_true, y_pred, sample_weight=sample_weight,
            generator=generator, state=state,
        )
        return MeanState(
            total=state.total + (values * weights).sum(),
            count=state.count + weights.sum(),
        )

    def merge(self, a: MeanState, b: MeanState) -> MeanState:
        return MeanState(total=a.total + b.total, count=a.count + b.count)

    def result_from_state(self, state: MeanState) -> torch.Tensor:
        return torch.where(
            state.count > 0, state.total / state.count,
            torch.zeros((), dtype=self.dtype, device=state.count.device),
        )

    def compute(
        self,
        y_true: Any,
        y_pred: Any,
        sample_weight: Any = None,
        generator: torch.Generator | None = None,
        state: MeanState | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-list metric values and weights (before the mean): the
        dict-mask protocol, sample-weight upranking, and the rewriting of
        invalid entries (label 0, score below the list's minimum, weight
        0)."""
        y_true, passed_mask = unpack_labels_and_mask(y_true, self.device)
        y_true = y_true.to(self.dtype)
        y_pred = torch.as_tensor(y_pred, device=self.device).to(self.dtype)
        if sample_weight is None:
            sample_weight = torch.ones((), dtype=self.dtype,
                                       device=self.device)
        else:
            sample_weight = torch.as_tensor(
                sample_weight, device=self.device).to(self.dtype)

        if y_true.ndim not in (1, 2):
            raise ValueError(
                f"`y_true` must have rank 1 or 2, got {y_true.ndim}."
            )
        if sample_weight.ndim > y_true.ndim:
            raise ValueError(
                f"`sample_weight` rank ({sample_weight.ndim}) cannot exceed "
                f"`y_true` rank ({y_true.ndim})."
            )
        if y_true.ndim == 2 and sample_weight.ndim == 1:
            if sample_weight.shape[0] != y_true.shape[0]:
                raise ValueError(
                    "1-D `sample_weight` must have shape (batch_size,). "
                    f"Received {tuple(sample_weight.shape)} vs "
                    f"{tuple(y_true.shape)}."
                )
            sample_weight = sample_weight[:, None]
        sample_weight = torch.ones_like(y_true) * sample_weight

        valid_mask = y_true >= 0.0
        if passed_mask is not None:
            valid_mask = torch.logical_and(valid_mask, passed_mask)

        y_true, y_pred, valid_mask, batched = standardize_call_inputs_ranks(
            y_true, y_pred, valid_mask, check_y_true_rank=False)
        if not batched:
            sample_weight = sample_weight[None, :]

        mask = torch.logical_and(valid_mask, sample_weight > 0.0)
        y_true = torch.where(mask, y_true, torch.zeros_like(y_true))
        y_pred = torch.where(
            mask, y_pred,
            y_pred.min(dim=1, keepdim=True).values
            - _EPSILON * torch.ones_like(y_pred),
        )
        sample_weight = torch.where(mask, sample_weight,
                                    torch.zeros_like(sample_weight))

        if generator is None and self.shuffle_ties:
            # A draw fixed by the seed and the lists seen so far.
            seen = int(state.count) if state is not None else 0
            seed = self.seed if self.seed is not None else 0
            generator = torch.Generator(device=self.device).manual_seed(
                seed * 2**32 + seen)

        return self.compute_metric(
            y_true=y_true, y_pred=y_pred, mask=mask,
            sample_weight=sample_weight, generator=generator,
        )

    # -- stateful API (host loops) ----------------------------------------
    def reset_state(self) -> None:
        self._state = self.init_state()

    def update_state(self, y_true: Any, y_pred: Any,
                     sample_weight: Any = None) -> None:
        if self._state is None:
            self._state = self.init_state()
        self._state = self.update(self._state, y_true, y_pred,
                                  sample_weight=sample_weight)

    def result(self) -> torch.Tensor:
        if self._state is None:
            return torch.zeros((), dtype=self.dtype, device=self.device)
        return self.result_from_state(self._state)

    def get_config(self) -> dict[str, Any]:
        return {
            "k": self.k,
            "shuffle_ties": self.shuffle_ties,
            "seed": self.seed,
            "name": self.name,
        }
