"""The collectives the port calls, over a ``torch.distributed`` group.

NCCL takes every one of them on CUDA tensors. Gloo takes CUDA tensors for
broadcast and all-reduce only (the backend table of the ``torch.distributed``
documentation), and copies them through pinned host memory itself; on a
gloo group the all-gather, send and recv of a CUDA tensor go through host
memory explicitly, here. The route is chosen from the group's backend
before the call, never after an error. ``STAGED`` counts every byte of a
CUDA tensor that a gloo collective moves between the card and the host,
gloo's own copies included. A ``group`` of None is a group of one rank:
every collective returns its input.

Only the data moves through the host: the compute stays where the tensors
are.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# bytes a rank's gloo collectives moved between the card and the host
# (each copy counted once, in either direction) since ``reset_staged``
STAGED = {"bytes": 0}

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def reset_staged() -> None:
    STAGED["bytes"] = 0


def staged_through_host(t: torch.Tensor, group) -> bool:
    """Whether a collective of ``group`` moves ``t`` through host memory:
    a CUDA tensor on a gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _to_host(t: torch.Tensor) -> torch.Tensor:
    STAGED["bytes"] += _nbytes(t)
    return t.cpu()


def _count_gloo_copies(t: torch.Tensor, group) -> None:
    """Count gloo's own copy of ``t`` to pinned host memory and back, for the
    collectives it takes on CUDA tensors (all-reduce, broadcast)."""
    if staged_through_host(t, group):
        STAGED["bytes"] += 2 * _nbytes(t)


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over ``group`` (sum or max), in place; returns ``t``."""
    if group is not None:
        _count_gloo_copies(t, group)
        dist.all_reduce(t, op=_OPS[op], group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` (equal shapes) concatenated along ``dim`` in the
    order of their ranks in ``group``."""
    if group is None:
        return t
    src = t.contiguous()
    staged = staged_through_host(src, group)
    if staged:
        src = _to_host(src)
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    if staged:
        STAGED["bytes"] += _nbytes(out)
        out = out.to(t.device)
    return out


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` of global rank ``src`` written into every rank's ``t``, in
    place; returns ``t``."""
    if group is not None:
        _count_gloo_copies(t, group)
        dist.broadcast(t, src=src, group=group)
    return t


def send(t: torch.Tensor, dst: int, group=None) -> None:
    """Send ``t`` to global rank ``dst``."""
    src = t.contiguous()
    if staged_through_host(src, group):
        src = _to_host(src)
    dist.send(src, dst=dst, group=group)


def recv(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Receive into ``t`` (its shape and dtype) from global rank ``src``;
    returns ``t``."""
    if staged_through_host(t, group):
        buf = torch.empty(t.shape, dtype=t.dtype)
        STAGED["bytes"] += _nbytes(buf)
        dist.recv(buf, src=src, group=group)
        t.copy_(buf)
    else:
        dist.recv(t, src=src, group=group)
    return t
