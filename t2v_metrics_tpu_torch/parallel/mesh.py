"""Rank mesh, process groups and the tensor / expert / data sharding of the
port's modules (port of t2v_metrics_tpu/parallel/mesh.py).

Axes, as in the JAX package:
  * ``dp``: data; the engines split their images over it (``dcn`` with it
    when the mesh spans hosts);
  * ``sp``: sequence (``parallel/sp.py``);
  * ``ep``: the packed experts of an MoE;
  * ``tp``: tensor; attention heads and MLP hidden of every transformer.

A ``Mesh`` holds the world's ranks in the array layout and with the axis
names of the JAX ``Mesh`` the same call builds (``make_mesh``,
``make_multihost_mesh``), and, once ``torch.distributed`` is initialised,
one process group for each slice along each axis (and along ("dcn", "dp")
together), so a rank finds its groups and its coordinates. The layout
arithmetic needs no process group (``layout``, ``axis_slices``).

The partition specs follow the JAX path rules (mesh.py:92-160) over the
port's module names: q|k|v (cut by heads, each of q, k and v on its own:
the packed leaf is never cut into contiguous thirds), the MLP's first
projection (fc1, gate, up, wi, the packed wi_0|wi_1), the projector's fc1,
``lm_head`` and ``patch_w`` are split on their output; o, the MLP's second
projection (fc2, down, wo) and the projector's fc2 on their input;
``rel_bias`` on heads; a column leaf's bias with its weight; the W8A8
``w_qt`` (the transposed ``w_q``) and ``scale`` as the ``w`` they replace;
the packed MoE ``gate_up`` / ``down`` on experts over ``ep`` (over ``tp``
when the mesh has no ep axis). Everything else is replicated.

In the forward, a row-parallel leaf all-reduces its product over tp before
its bias is added (once, as GSPMD adds the replicated bias once), a column-
parallel ``lm_head`` / ``patch_w`` all-gathers its output columns, the
models read their local head counts from their leaves, and an MoE on a
share of the experts all-reduces its combine (``ops/moe.py``).
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..ops import quant as Q
from . import comm
from . import sp as psp

DATA_AXES = ("dcn", "dp")


# ---------------------------------------------------------------------------
# Layout and process groups
# ---------------------------------------------------------------------------

def layout(shape, devices) -> np.ndarray:
    """The first prod(shape) of ``devices`` (rank ids) in ``shape``, row
    major: the JAX ``Mesh.devices`` ids of the same call."""
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh {'x'.join(map(str, shape))} > {len(devices)} ranks")
    return np.asarray(list(devices)[:n], dtype=np.int64).reshape(tuple(shape))


def axis_slices(devices: np.ndarray, names, axes) -> np.ndarray:
    """(slices, ranks per slice): the ranks of each slice of ``devices``
    along ``axes`` (the other coordinates fixed), in axis order."""
    idx = [names.index(a) for a in axes]
    rest = [i for i in range(devices.ndim) if i not in idx]
    moved = np.transpose(devices, rest + idx)
    return moved.reshape(-1, int(np.prod([devices.shape[i] for i in idx])))


class Mesh:
    """Ranks ``devices`` (an int array) with ``axis_names``, and this rank's
    process group along each axis once ``torch.distributed`` is initialised
    (every rank must build the same meshes in the same order). Used as a
    context manager it is the ambient mesh of ``parallel/sp.py``."""

    def __init__(self, devices, axis_names):
        self.devices = np.asarray(devices, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} for axes {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        live = dist.is_available() and dist.is_initialized()
        self.rank = dist.get_rank() if live else int(self.devices.flat[0])
        found = np.argwhere(self.devices == self.rank)
        self._coords = ({a: int(i) for a, i in zip(self.axis_names, found[0])}
                        if len(found) else None)
        self._groups = {}
        if live:
            keys = [(a,) for a in self.axis_names]
            data = tuple(a for a in DATA_AXES if a in self.axis_names)
            if len(data) > 1:
                keys.append(data)
            for key in keys:
                slices = axis_slices(self.devices, self.axis_names, key)
                if slices.shape[1] == 1:
                    continue
                for ranks in slices.tolist():
                    group = dist.new_group(ranks)  # every rank takes part
                    if self.rank in ranks:
                        self._groups[key] = group

    def axis_ranks(self, axes) -> list[int]:
        """The ranks of this rank's slice along ``axes``, in axis order."""
        axes = (axes,) if isinstance(axes, str) else tuple(a for a in axes
                                                            if a in self.shape)
        for ranks in axis_slices(self.devices, self.axis_names, axes).tolist():
            if self.rank in ranks:
                return ranks
        raise ValueError(f"rank {self.rank} is not in this mesh")

    def axis_size(self, axes) -> int:
        """The size of an axis, or of several together (1 when absent)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape.get(a, 1) for a in axes)

    def axis_index(self, axes) -> int:
        """This rank's coordinate along an axis, or along several together
        (row major, the first the slowest); 0 when absent."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if self._coords is None:
            raise ValueError(f"rank {self.rank} is not in this mesh")
        index = 0
        for a in axes:
            index = index * self.shape.get(a, 1) + self._coords.get(a, 0)
        return index

    def group(self, axes):
        """This rank's process group along ``axes`` (a name or a tuple of
        names present in the mesh), or None for a slice of one rank."""
        axes = (axes,) if isinstance(axes, str) else tuple(a for a in axes
                                                            if a in self.shape)
        if self.axis_size(axes) == 1:
            return None
        if axes not in self._groups:
            raise ValueError(f"no process group along {axes}: is torch.distributed "
                             "initialised, and was the mesh built after it?")
        return self._groups[axes]

    def all_gather(self, t: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
        """The ranks' ``t`` along ``axes`` concatenated along ``dim`` in axis
        order (a process group orders its ranks by id)."""
        axes = (axes,) if isinstance(axes, str) else tuple(a for a in axes
                                                            if a in self.shape)
        group = self.group(axes)
        if group is None:
            return t
        out = comm.all_gather(t, group, dim)
        members = self.axis_ranks(axes)
        order = sorted(members)
        if order == members:
            return out
        parts = out.chunk(len(members), dim)
        return torch.cat([parts[order.index(r)] for r in members], dim)

    def __enter__(self):
        psp.push_mesh(self)
        return self

    def __exit__(self, *exc):
        psp.pop_mesh()
        return False

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, rank {self.rank})"


def world_ranks() -> list[int]:
    """The ranks of the default group, or [0] without one."""
    if dist.is_available() and dist.is_initialized():
        return list(range(dist.get_world_size()))
    return [0]


def make_mesh(dp: int = 1, tp: int | None = None, devices=None,
              ep: int = 1, sp: int = 1) -> Mesh:
    """A ("dp"[, "sp"][, "ep"], "tp") mesh over ``devices`` (rank ids; the
    world's by default). tp=None takes all the ranks left. A mesh larger
    than the ranks raises ``ValueError``."""
    devices = world_ranks() if devices is None else list(devices)
    if tp is None:
        tp = len(devices) // (dp * ep * sp)
    shape = [dp] + ([sp] if sp > 1 else []) + ([ep] if ep > 1 else []) + [tp]
    names = ["dp"] + (["sp"] if sp > 1 else []) + (["ep"] if ep > 1 else []) + ["tp"]
    return Mesh(layout(shape, devices), names)


def make_multihost_mesh(dcn: int | None = None, dp: int = 1, tp: int | None = None,
                        devices=None) -> Mesh:
    """A ("dcn", "dp", "tp") mesh: the leading axis spans hosts (data
    parallel only), dp and tp run within a host. dcn=None: the number of
    hosts, ``WORLD_SIZE / LOCAL_WORLD_SIZE`` from the environment (1
    without it)."""
    devices = world_ranks() if devices is None else list(devices)
    if dcn is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", len(devices)))
        dcn = max(len(devices) // max(local, 1), 1)
    if tp is None:
        tp = len(devices) // (dcn * dp)
    return Mesh(layout((dcn, dp, tp), devices), ("dcn", "dp", "tp"))


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           backend: str | None = None) -> None:
    """Join the process group: ``tcp://<coordinator_address>`` with the world
    size and rank given, or ``env://`` (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK) when they are None. The backend is NCCL when CUDA is
    available, else gloo; ``backend`` names another (gloo for CUDA ranks
    that share one card). A second call does nothing."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)


# ---------------------------------------------------------------------------
# Partition specs (the JAX path rules over the port's module names)
# ---------------------------------------------------------------------------

COL, ROW = "col", "row"
# a Q.Linear by (its parent module, its name)
_LEAF_RULES = {("attn", "qkv"): COL, ("attn", "o"): ROW,
               ("cross", "q"): COL, ("cross", "k"): COL, ("cross", "v"): COL,
               ("cross", "o"): ROW,
               ("mlp", "wi_0"): COL, ("mlp", "wi_1"): COL, ("mlp", "wi"): COL,
               ("mlp", "wi_01"): COL, ("mlp", "wo"): ROW,
               ("projector", "fc1"): COL, ("projector", "fc2"): ROW}
# a Q.Linear directly under ``blocks.<i>`` (the ViT blocks and the decoder)
_BLOCK_RULES = {"qkv": COL, "fc1": COL, "gate": COL, "up": COL,
                "o": ROW, "fc2": ROW, "down": ROW}
_COL_PARAMS = ("lm_head", "patch_w")


def leaf_kind(name: str) -> str | None:
    """COL, ROW or None (replicated) for the ``Q.Linear`` at module path
    ``name``."""
    parts = name.split(".")
    if len(parts) >= 3 and parts[-3] == "blocks" and parts[-2].isdigit():
        return _BLOCK_RULES.get(parts[-1])
    return _LEAF_RULES.get(tuple(parts[-2:])) if len(parts) >= 2 else None


def _linear_spec(kind, attr: str, ndim: int, tp: str) -> tuple:
    if kind is None:
        return (None,) * ndim
    if attr == "w":
        return (None, tp) if kind == COL else (tp, None)
    if attr == "w_qt":   # (out, in): the transpose of w_q's spec
        return (tp, None) if kind == COL else (None, tp)
    return (tp,) if kind == COL else (None,)   # scale, b


def _param_spec(name: str, ndim: int, tp: str, ep: str | None) -> tuple:
    parts = name.split(".")
    if parts[-1] in _COL_PARAMS or parts[-1] == "rel_bias":
        return (None, tp)
    if len(parts) >= 2 and parts[-2] == "moe" and parts[-1] in ("gate_up", "down"):
        return (ep or tp, None, None)
    return (None,) * ndim


def _linears(model: nn.Module) -> dict:
    """{parameter name: (its Q.Linear, the leaf's kind, the attribute)}."""
    out = {}
    for mname, mod in model.named_modules():
        if isinstance(mod, Q.Linear):
            kind = leaf_kind(mname)
            for attr, _ in mod.named_parameters(recurse=False):
                out[f"{mname}.{attr}" if mname else attr] = (mod, kind, attr)
    return out


def partition_specs(model: nn.Module, tp_axis: str = "tp",
                    ep_axis: str | None = None) -> dict[str, tuple]:
    """{parameter name: the mesh axis of each of its dims, or None}: the JAX
    ``partition_specs`` of the counterpart leaf (``w_qt`` the transpose of
    its ``w_q``'s). ``ep_axis``: the axis of the packed experts, ``tp_axis``
    when None."""
    linears = _linears(model)
    specs = {}
    for name, p in model.named_parameters():
        if name in linears:
            _, kind, attr = linears[name]
            specs[name] = _linear_spec(kind, attr, p.dim(), tp_axis)
        else:
            specs[name] = _param_spec(name, p.dim(), tp_axis, ep_axis)
    return specs


# ---------------------------------------------------------------------------
# Shards
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Shard:
    """How a rank's tensor is cut from the full one: along ``dim``, share
    ``index`` of ``count`` of each of the packed parts ``widths`` (one part
    for a leaf that packs nothing)."""

    full_shape: tuple
    dim: int
    index: int
    count: int
    widths: tuple

    @property
    def local_shape(self) -> tuple:
        shape = list(self.full_shape)
        shape[self.dim] //= self.count
        return tuple(shape)

    def take(self, full: torch.Tensor) -> torch.Tensor:
        """The rank's slice of ``full`` (a view when it packs one part)."""
        pieces, off = [], 0
        for w in self.widths:
            n = w // self.count
            pieces.append(full.narrow(self.dim, off + self.index * n, n))
            off += w
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, self.dim)


def full_shape(t: torch.Tensor) -> tuple:
    """The shape of the tensor ``t`` is a shard of (its own when unsharded)."""
    shard = getattr(t, "shard", None)
    return tuple(t.shape) if shard is None else shard.full_shape


def _shard_for(name: str, p: torch.Tensor, spec: tuple, mesh: Mesh, leaf) -> Shard | None:
    axes = [(d, a) for d, a in enumerate(spec) if a is not None]
    if not axes:
        return None
    (dim, axis), = axes
    count = mesh.axis_size(axis)
    if count == 1:
        return None
    widths = (p.shape[dim],)
    mod, _, attr = leaf if leaf is not None else (None, None, None)
    out_dim = {"w": 1, "w_qt": 0, "scale": 0, "b": 0}.get(attr)
    if mod is not None and mod.parts is not None and dim == out_dim:
        for label, units, _ in mod.parts:
            if units % count:
                raise ValueError(f"{name}: {axis} {count} does not divide its "
                                 f"{units} {label}")
        widths = tuple(units * width for _, units, width in mod.parts)
    elif p.shape[dim] % count:
        raise ValueError(f"{name}: {axis} {count} does not divide its dim {dim} "
                         f"of {p.shape[dim]}")
    return Shard(tuple(p.shape), dim, mesh.axis_index(axis), count, widths)


def _ep_axis(mesh: Mesh) -> str | None:
    return "ep" if "ep" in mesh.axis_names else None


def _shards(model: nn.Module, mesh: Mesh, tp_axis: str) -> dict[str, Shard]:
    specs = partition_specs(model, tp_axis, _ep_axis(mesh))
    linears = _linears(model)
    out = {}
    for name, p in model.named_parameters():
        shard = _shard_for(name, p, specs[name], mesh, linears.get(name))
        if shard is not None:
            out[name] = shard
    return out


def abstract_sharded_params(model: nn.Module, mesh: Mesh,
                            tp_axis: str = "tp") -> dict[str, torch.Tensor]:
    """{parameter name: a tensor on the meta device with the rank's shape
    and the parameter's dtype}: the per-rank layout without memory (the
    model may itself live on the meta device)."""
    shards = _shards(model, mesh, tp_axis)
    return {name: torch.empty(shards[name].local_shape if name in shards else p.shape,
                              dtype=p.dtype, device="meta")
            for name, p in model.named_parameters()}


def sharded_bytes(model: nn.Module, mesh: Mesh, tp_axis: str = "tp") -> int:
    """The bytes of one rank's parameters under ``shard_params``."""
    return sum(t.numel() * t.element_size()
               for t in abstract_sharded_params(model, mesh, tp_axis).values())


@torch.no_grad()
def shard_params(model: nn.Module, mesh: Mesh, tp_axis: str = "tp",
                 device=None) -> nn.Module:
    """Keep each rank's slice of every parameter, in place, and wire the
    forward's collectives: a row-parallel leaf's all-reduce over tp, a
    column-parallel ``lm_head`` / ``patch_w``'s all-gather, an MoE's share
    of the experts and its combine's group. A parameter on the meta device
    gets an uninitialised tensor of the rank's shape on ``device`` (fill it
    with a seeded init: ``clip.normal_`` draws the full tensor and keeps the
    slice; or with the bridge's loaders, which slice their sources). Each
    sharded parameter keeps its ``Shard`` as ``.shard``. A second call with
    the same mesh does nothing."""
    if getattr(model, "mesh", None) is not None:
        if model.mesh is not mesh:
            raise ValueError("shard_params: the model is already sharded over another mesh")
        return model
    shards = _shards(model, mesh, tp_axis)
    for name, p in list(model.named_parameters()):
        shard = shards.get(name)
        if p.is_meta:
            if device is None:
                raise ValueError(f"shard_params: {name} is on the meta device; pass device=")
            shape = shard.local_shape if shard is not None else p.shape
            local = torch.empty(shape, dtype=p.dtype, device=device)
        elif shard is not None:
            local = shard.take(p.detach()).clone(memory_format=torch.contiguous_format)
        else:
            continue
        owner, _, attr = name.rpartition(".")
        new = nn.Parameter(local, requires_grad=False)
        if shard is not None:
            new.shard = shard
        setattr(model.get_submodule(owner) if owner else model, attr, new)
    tp_group = mesh.group(tp_axis)
    for mname, mod in model.named_modules():
        if isinstance(mod, Q.Linear) and leaf_kind(mname) == ROW:
            mod.reduce_group = tp_group
        for attr in _COL_PARAMS:
            p = getattr(mod, attr, None)
            if isinstance(p, nn.Parameter) and hasattr(p, "shard"):
                p.gather_group = tp_group
        gate_up = getattr(mod, "gate_up", None)
        if isinstance(gate_up, nn.Parameter) and hasattr(gate_up, "shard"):
            axis = _ep_axis(mesh) or tp_axis
            mod.experts = (gate_up.shard.index * gate_up.shape[0], mesh.group(axis))
    model.mesh = mesh
    return model


def build_sharded(model_cls, args: tuple, device, dtype, mesh) -> nn.Module:
    """``model_cls(*args, device, dtype)``; with a ``mesh``, built on the
    meta device and given each parameter's share on ``device``
    (``shard_params``), uninitialised: the seeded inits and the bridge's
    loaders then fill each share from the whole tensor's draw or source."""
    if mesh is None:
        return model_cls(*args, device, dtype)
    return shard_params(model_cls(*args, "meta", dtype), mesh, device=device)


def gather_cols(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``y = x @ w`` for a column-parallel ``w`` (``lm_head``, ``patch_w``):
    the ranks' output columns joined over tp; ``y`` itself otherwise."""
    group = getattr(w, "gather_group", None)
    return y if group is None else comm.all_gather(y, group, dim=-1)


# ---------------------------------------------------------------------------
# Data sharding
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a batch's rows live: ``spec`` as the JAX ``NamedSharding``'s
    (the data axes on the leading dim, or nothing: replicated)."""

    mesh: Mesh
    spec: tuple

    @property
    def axes(self) -> tuple:
        return self.spec[0] if self.spec and self.spec[0] else ()

    @property
    def count(self) -> int:
        return self.mesh.axis_size(self.axes)

    def rows(self, n: int) -> slice:
        """The rows of an ``n``-row batch this rank takes: contiguous shares
        of ceil(n / count), the last ones shorter (or empty)."""
        chunk = -(-n // self.count)
        i = self.mesh.axis_index(self.axes) if self.axes else 0
        return slice(min(i * chunk, n), min((i + 1) * chunk, n))

    def gather(self, local: torch.Tensor, n: int) -> torch.Tensor:
        """The ranks' ``rows(n)`` of a batch (``local``, this rank's rows)
        joined back into all ``n`` rows, on every rank."""
        if self.count == 1:
            return local
        chunk = -(-n // self.count)
        pad = local.new_zeros((chunk - local.shape[0], *local.shape[1:]))
        return self.mesh.all_gather(torch.cat([local, pad]), self.axes)[:n]


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def data_sharding(mesh: Mesh, ndim: int) -> Sharding:
    """The leading (batch) dim over the data axes: ("dcn", "dp") when the
    mesh spans hosts, else "dp"."""
    data = tuple(a for a in DATA_AXES if a in mesh.axis_names)
    return Sharding(mesh, (data,) + (None,) * (ndim - 1))
