"""The six ranking metrics: DCG, NDCG, MAP, MRR, Precision@k and
Recall@k (counterpart of keras_rs_tpu/metrics/ranking_metrics.py), each
a per-list computation over (batch, list) tensors."""

from __future__ import annotations

from typing import Any, Callable

import torch

from keras_rs_tpu_torch.core.serialization import export
from keras_rs_tpu_torch.metrics.ranking_metric import RankingMetric
from keras_rs_tpu_torch.ops.ranking import (
    compute_dcg,
    default_gain_fn,
    default_rank_discount_fn,
    divide_no_nan,
    get_list_weights,
    sort_by_scores,
)

Fn = Callable[[torch.Tensor], torch.Tensor]


def _binary_relevance(y: torch.Tensor) -> torch.Tensor:
    return (y >= 1.0).to(y.dtype)


@export("keras_rs_tpu_torch.metrics.DCG")
class DCG(RankingMetric):
    """Discounted cumulative gain."""

    def __init__(self, k: int | None = None,
                 gain_fn: Fn = default_gain_fn,
                 rank_discount_fn: Fn = default_rank_discount_fn,
                 **kwargs: Any) -> None:
        super().__init__(k=k, **kwargs)
        self.gain_fn = gain_fn
        self.rank_discount_fn = rank_discount_fn

    def compute_metric(self, y_true, y_pred, mask, sample_weight, generator):
        sorted_y_true, sorted_weights = sort_by_scores(
            [y_true, sample_weight], scores=y_pred, k=self.k, mask=mask,
            shuffle_ties=self.shuffle_ties, generator=generator,
        )
        dcg = compute_dcg(sorted_y_true, sorted_weights,
                          gain_fn=self.gain_fn,
                          rank_discount_fn=self.rank_discount_fn)
        per_list_weights = get_list_weights(
            weights=sample_weight, relevance=self.gain_fn(y_true))
        # dcg already includes item weights; divide by the per-list weight
        # so the weighted mean does not count it twice.
        return divide_no_nan(dcg, per_list_weights), per_list_weights


@export("keras_rs_tpu_torch.metrics.NDCG")
class NDCG(RankingMetric):
    """Normalized DCG."""

    def __init__(self, k: int | None = None,
                 gain_fn: Fn = default_gain_fn,
                 rank_discount_fn: Fn = default_rank_discount_fn,
                 **kwargs: Any) -> None:
        super().__init__(k=k, **kwargs)
        self.gain_fn = gain_fn
        self.rank_discount_fn = rank_discount_fn

    def compute_metric(self, y_true, y_pred, mask, sample_weight, generator):
        sorted_y_true, sorted_weights = sort_by_scores(
            [y_true, sample_weight], scores=y_pred, k=self.k, mask=mask,
            shuffle_ties=self.shuffle_ties, generator=generator,
        )
        dcg = compute_dcg(sorted_y_true, sorted_weights,
                          gain_fn=self.gain_fn,
                          rank_discount_fn=self.rank_discount_fn)
        weighted_gains = sample_weight * self.gain_fn(y_true)
        ideal_sorted_y_true, ideal_sorted_weights = sort_by_scores(
            [y_true, sample_weight], scores=weighted_gains, k=self.k,
            mask=mask, shuffle_ties=self.shuffle_ties, generator=generator,
        )
        ideal_dcg = compute_dcg(ideal_sorted_y_true, ideal_sorted_weights,
                                gain_fn=self.gain_fn,
                                rank_discount_fn=self.rank_discount_fn)
        per_list_weights = get_list_weights(
            weights=sample_weight, relevance=self.gain_fn(y_true))
        return divide_no_nan(dcg, ideal_dcg), per_list_weights


@export("keras_rs_tpu_torch.metrics.MeanAveragePrecision")
class MeanAveragePrecision(RankingMetric):
    """MAP over binary relevance (label >= 1)."""

    def compute_metric(self, y_true, y_pred, mask, sample_weight, generator):
        relevance = _binary_relevance(y_true)
        sorted_relevance, sorted_weights = sort_by_scores(
            [relevance, sample_weight], scores=y_pred, mask=mask, k=self.k,
            shuffle_ties=self.shuffle_ties, generator=generator,
        )
        relevant_counts = torch.cumsum(sorted_relevance, dim=1)
        cutoffs = torch.cumsum(torch.ones_like(sorted_relevance), dim=1)
        precisions = divide_no_nan(relevant_counts, cutoffs)
        total_precision = (precisions * sorted_weights
                           * sorted_relevance).sum(dim=1, keepdim=True)
        total_relevance = (sample_weight * relevance).sum(dim=1,
                                                         keepdim=True)
        per_list_map = divide_no_nan(total_precision, total_relevance)
        return per_list_map, get_list_weights(sample_weight, relevance)


@export("keras_rs_tpu_torch.metrics.MeanReciprocalRank")
class MeanReciprocalRank(RankingMetric):
    """MRR over binary relevance (label >= 1)."""

    def compute_metric(self, y_true, y_pred, mask, sample_weight, generator):
        (sorted_y_true,) = sort_by_scores(
            [y_true], scores=y_pred, mask=mask, k=self.k,
            shuffle_ties=self.shuffle_ties, generator=generator,
        )
        list_length = sorted_y_true.shape[1]
        relevance = _binary_relevance(sorted_y_true)
        reciprocal_rank = 1.0 / torch.arange(
            1, list_length + 1, dtype=y_pred.dtype, device=y_pred.device)
        mrr = (relevance * reciprocal_rank).max(dim=1, keepdim=True).values
        per_list_weights = get_list_weights(
            weights=sample_weight, relevance=_binary_relevance(y_true))
        return mrr, per_list_weights


@export("keras_rs_tpu_torch.metrics.PrecisionAtK")
class PrecisionAtK(RankingMetric):
    """P@k over binary relevance (label >= 1)."""

    def compute_metric(self, y_true, y_pred, mask, sample_weight, generator):
        (sorted_y_true,) = sort_by_scores(
            [y_true], scores=y_pred, mask=mask, k=self.k,
            shuffle_ties=self.shuffle_ties, generator=generator,
        )
        relevance = _binary_relevance(sorted_y_true)
        valid_list_length = torch.clamp(
            mask.to(torch.int32).sum(dim=1, keepdim=True),
            max=sorted_y_true.shape[1])
        per_list_precision = divide_no_nan(
            relevance.sum(dim=1, keepdim=True),
            valid_list_length.to(y_pred.dtype))
        per_list_weights = get_list_weights(
            weights=sample_weight, relevance=_binary_relevance(y_true))
        return per_list_precision, per_list_weights


@export("keras_rs_tpu_torch.metrics.RecallAtK")
class RecallAtK(RankingMetric):
    """R@k over binary relevance (label >= 1)."""

    def compute_metric(self, y_true, y_pred, mask, sample_weight, generator):
        (sorted_y_true,) = sort_by_scores(
            [y_true], scores=y_pred, mask=mask, k=self.k,
            shuffle_ties=self.shuffle_ties, generator=generator,
        )
        relevance = _binary_relevance(sorted_y_true)
        overall_relevance = _binary_relevance(y_true)
        per_list_recall = divide_no_nan(
            relevance.sum(dim=1, keepdim=True),
            overall_relevance.sum(dim=1, keepdim=True))
        per_list_weights = get_list_weights(
            weights=sample_weight, relevance=overall_relevance)
        return per_list_recall, per_list_weights
