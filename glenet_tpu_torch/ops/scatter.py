"""Segment reductions with a static segment count (torch counterpart of
glenet_tpu/ops/scatter.py), for the scatter-based dynamic VFEs.

Segment ids below 0 are dropped: they go to a dump row past the last
segment, which is cut off, so they take no part in a reduction and get no
gradient.  `segment_max` fills empty segments with `fill_value` and splits
a segment's cotangent evenly among the rows tied at its maximum, as JAX's
scatter-max does (index_reduce 'amax').
"""
from __future__ import annotations

import math
import warnings

import torch


def _dump_ids(segment_ids, num_segments: int):
    return torch.where(segment_ids >= 0, segment_ids,
                       num_segments).long()


def segment_sum(data, segment_ids, num_segments: int):
    """data (N, ...) summed per segment -> (num_segments, ...)."""
    ids = _dump_ids(segment_ids, num_segments)
    out = data.new_zeros((num_segments + 1, *data.shape[1:]))
    return out.index_add(0, ids, data)[:num_segments]


def segment_mean(data, segment_ids, num_segments: int):
    """The mean of each segment's rows; an empty segment divides by a count
    clipped at 1, so it is 0."""
    ids = _dump_ids(segment_ids, num_segments)
    total = data.new_zeros((num_segments + 1, *data.shape[1:])).index_add(
        0, ids, data)
    count = data.new_zeros(num_segments + 1).index_add(
        0, ids, data.new_ones(ids.shape[0]))
    count = count.reshape(-1, *([1] * (data.dim() - 1))).clamp_min(1.0)
    return (total / count)[:num_segments]


def segment_max(data, segment_ids, num_segments: int, fill_value=0.0):
    """The maximum of each segment's rows, `fill_value` where empty."""
    ids = _dump_ids(segment_ids, num_segments)
    # starts at -inf: index_reduce's backward counts a starting value equal
    # to the maximum among the ties even with include_self=False
    out = data.new_full((num_segments + 1, *data.shape[1:]), -math.inf)
    with warnings.catch_warnings():          # index_reduce is a beta API
        warnings.simplefilter('ignore', UserWarning)
        out = out.index_reduce(0, ids, data, 'amax', include_self=False)
    out = out[:num_segments]
    return torch.where(torch.isfinite(out), out, fill_value)
