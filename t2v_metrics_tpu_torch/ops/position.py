"""T5 relative-position bias (port of t2v_metrics_tpu/models/t5.py's
``relative_position_bucket`` and ``compute_position_bias``).

Shared by the T5 model (the dense bias) and the attention op (its plain
version, and the bucket table the per-head kernel reads)."""

from __future__ import annotations

import math

import torch


def relative_position_bucket(relative_position: torch.Tensor, bidirectional: bool,
                             num_buckets: int, max_distance: int) -> torch.Tensor:
    """HF T5's bucketing of relative positions (memory_pos - query_pos)."""
    rel = relative_position
    buckets = torch.zeros_like(rel)
    if bidirectional:
        num_buckets //= 2
        buckets = buckets + (rel > 0).to(rel.dtype) * num_buckets
        rel = rel.abs()
    else:
        rel = -torch.clamp(rel, max=0)
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    rel_large = max_exact + (
        torch.log(rel.float() / max_exact + 1e-9)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(rel.dtype)
    rel_large = torch.clamp(rel_large, max=num_buckets - 1)
    return buckets + torch.where(is_small, rel, rel_large)


def compute_position_bias(rel_emb: torch.Tensor, qlen: int, klen: int,
                          bidirectional: bool, num_buckets: int,
                          max_distance: int, q_offset: int = 0) -> torch.Tensor:
    """rel_emb: (num_buckets, heads) -> bias (1, heads, qlen, klen)."""
    dev = rel_emb.device
    ctx = torch.arange(qlen, device=dev)[:, None] + q_offset
    mem = torch.arange(klen, device=dev)[None, :]
    buckets = relative_position_bucket(mem - ctx, bidirectional, num_buckets,
                                       max_distance)
    return rel_emb[buckets].permute(2, 0, 1)[None]
