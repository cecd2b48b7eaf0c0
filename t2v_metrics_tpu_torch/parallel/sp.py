"""Sequence parallelism (SP): each rank of the "sp" axis holds S/sp rows of
the T5 encoder's activations (port of t2v_metrics_tpu/parallel/sp.py).

The JAX package annotates the activations and lets GSPMD partition every
per-token op along S and insert the all-gathers around attention. PyTorch
has no such partitioner, so here SP is explicit: ``shard_seq`` keeps the
rank's rows, the norms and MLPs run on them, the attention all-gathers K|V
over the sp group and runs the rank's query rows against all keys (the
dense bias rows offset to the rank's rows, the key mask whole), and
``gather_seq`` joins the rows again. The batch axis is not split here: the
engines split their data over dp before the model runs.

Usage: build a mesh with an ``sp`` axis (``make_mesh(dp=1, sp=2, tp=1)``),
enter it (``with mesh:``) and run the normal scoring path. Without an
ambient mesh or without an ``sp`` axis every hook is a no-op.
"""

from __future__ import annotations

import threading

import torch

_AMBIENT = threading.local()


def push_mesh(mesh) -> None:
    """Make ``mesh`` the ambient mesh (``Mesh.__enter__``)."""
    if not hasattr(_AMBIENT, "stack"):
        _AMBIENT.stack = []
    _AMBIENT.stack.append(mesh)


def pop_mesh() -> None:
    _AMBIENT.stack.pop()


def current_mesh():
    """The ambient ``with mesh:`` context's mesh, or None."""
    stack = getattr(_AMBIENT, "stack", None)
    return stack[-1] if stack else None


def seq_shard(s: int):
    """(offset, rows) of this rank's share of a sequence of ``s`` rows under
    the ambient mesh's sp axis, or None without one."""
    mesh = current_mesh()
    if mesh is None or mesh.axis_size("sp") == 1:
        return None
    n = mesh.axis_size("sp")
    if s % n:
        raise ValueError(f"sequence parallelism: {s} rows are not divisible by sp {n}")
    rows = s // n
    return mesh.axis_index("sp") * rows, rows


def shard_seq(x: torch.Tensor, seq_axis: int = 1) -> torch.Tensor:
    """This rank's rows of ``x`` along ``seq_axis`` over the ambient mesh's
    sp axis; ``x`` itself when there is no ambient mesh or no sp axis."""
    if x.dim() < 2:
        return x
    share = seq_shard(x.shape[seq_axis])
    return x if share is None else x.narrow(seq_axis, *share)


def gather_seq(x: torch.Tensor, seq_axis: int = 1) -> torch.Tensor:
    """The ranks' rows of ``x`` joined along ``seq_axis`` in sp order (the
    inverse of ``shard_seq``); ``x`` itself without an sp axis."""
    mesh = current_mesh()
    if mesh is None or mesh.axis_size("sp") == 1 or x.dim() < 2:
        return x
    return mesh.all_gather(x, ("sp",), dim=seq_axis)
