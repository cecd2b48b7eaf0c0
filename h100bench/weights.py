"""The benchmark's weight rule: every leaf is drawn from (``--seed``, the
leaf's path in the port's parameter tree) on the device, in float32, by a
``torch.Generator`` of its own, scaled and shifted by the family's rule, and
rounded once to the served dtype. The port's model is filled in place with
these values; the reference draws any leaf again by the same rule, so it
takes nothing the port made and can rebuild one layer at a time.
"""

from __future__ import annotations

import zlib

import torch


def leaf_seed(seed: int, path: str) -> int:
    """A 63-bit generator seed from the run's seed and a leaf's path."""
    return (int(seed) * 1_000_003 + zlib.crc32(path.encode())) % (1 << 63)


def draw(seed: int, path: str, shape, std, mean: float, device) -> torch.Tensor:
    """The float32 leaf: N(0, 1) draws times ``std`` (a number, or a tensor
    broadcast over the last axis) plus ``mean``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, path))
    t = torch.randn(tuple(shape), generator=gen, device=device, dtype=torch.float32)
    if isinstance(std, torch.Tensor):
        std = std.to(device)
    return t.mul_(std).add_(mean)


def served(seed: int, path: str, shape, rule, dtype, device) -> torch.Tensor:
    """The leaf as the port holds it (``dtype``), returned in float32."""
    std, mean = rule(path, tuple(shape))
    return draw(seed, path, shape, std, mean, device).to(dtype).float()


@torch.no_grad()
def fill_(module: torch.nn.Module, seed: int, rule) -> int:
    """Write every parameter of ``module`` in place by the rule; returns the
    number of leaves written."""
    n = 0
    for path, p in module.named_parameters():
        std, mean = rule(path, tuple(p.shape))
        p.copy_(draw(seed, path, p.shape, std, mean, p.device))
        n += 1
    return n
