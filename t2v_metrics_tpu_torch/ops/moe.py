"""Mixture-of-experts dispatch: exact sort-based grouping and a grouped GEMM
(port of t2v_metrics_tpu/ops/moe.py).

  1. route: an fp32 router softmax, the top-k experts of each token, their
     weights renormalised when ``moe_norm_topk`` (every config but the
     Qwen3-Omni talker's);
  2. group: the token-expert assignments sorted by expert into a buffer
     whose every expert group starts at a row-block boundary
     (``plan_groups``), built as one row gather; no token is dropped;
  3. ``grouped_matmul``: each row block times its expert's weight matrix,
     the CUDA kernel of ``csrc/grouped_gemm.cu`` on the card (see the note
     there for what it replaces, what bounds it and its design); the
     dispatch passes ``num_blocks``, the row blocks that belong to an
     expert, so the E pad blocks past them are not computed (their rows are
     zeros; the JAX kernel computes them, and no token reads them);
  4. combine: each token's k outputs gathered back and summed with the
     router weights, in the activation dtype, plus the sigmoid-gated shared
     expert where the MoE has one (``add_shared_expert``, cuBLAS GEMMs).

Expert FLOPs: ~(T*k + E*block_m/2) * H * I against the dense path's T*E*H*I
(``models/decoder.py:_moe_mlp``, the numerics oracle). Everything here runs
on the device with static shapes and no host sync: the counts are a
``scatter_add_`` into zeros(E) (``torch.bincount`` on CUDA reads its maximum
back to the host) and the sort is stable, as ``jnp.argsort(stable=True)``.

``grouped_matmul_reference`` is the plain version: the CPU route, and the
kernel's oracle on the card. The JAX oracle gathers ``w[block_expert]`` into
an (nb, H, I) tensor, 1152 x 2048 x 1536 bf16 values at the 30b-a3b gate_up
shape; this one runs one ``torch.matmul`` per contiguous run of row blocks
with the same expert.
"""

from __future__ import annotations

import torch

from .. import tracing
from ..parallel import comm
from . import gemm as G
from . import layers as L
from . import quant as Q

BLOCK_M = 128   # rows per block: the kernel's row tile


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def plan_groups(expert_ids: torch.Tensor, num_experts: int, block_m: int):
    """Block-aligned grouping plan for (Tk,) expert assignments.

    Returns (order, dest, block_expert, P): ``order`` (Tk,) the assignments
    in buffer order (stable by expert), ``dest`` (Tk,) the buffer row of
    ``order[i]``, ``block_expert`` (P // block_m,) int32 the expert of each
    row block (0 for the pad blocks that belong to no expert), and the
    static buffer length P = round_up(Tk, block_m) + E * block_m.
    """
    return _plan(expert_ids, num_experts, block_m)[:4]


def _plan(expert_ids: torch.Tensor, num_experts: int, block_m: int,
          computed: int | None = None):
    """``plan_groups``'s four results, ``num_blocks``: a (1,) int32
    device tensor, the leading row blocks that belong to an expert (the
    rest are pad blocks no token reads), and ``counts``: (E,) the
    assignments of each expert, both from the counts, with no host sync.
    ``computed``: only the blocks of the first ``computed`` experts count in
    ``num_blocks`` (the last group is then a sink that is never computed,
    and its blocks name expert ``computed - 1``)."""
    tk = expert_ids.shape[0]
    dev = expert_ids.device
    p_rows = _round_up(tk, block_m) + num_experts * block_m
    ids = expert_ids.long()
    counts = torch.zeros(num_experts, dtype=torch.long, device=dev)
    counts.scatter_add_(0, ids, torch.ones_like(ids))
    padded = (counts + block_m - 1) // block_m * block_m
    starts = torch.cumsum(padded, 0) - padded                  # exclusive
    order = torch.sort(ids, stable=True).indices
    sorted_e = ids[order]
    group_start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(tk, device=dev) - group_start[sorted_e]
    dest = starts[sorted_e] + rank
    # block b is expert e's when starts[e] <= b*block_m < starts[e] +
    # padded[e]; a block of no expert takes the first index, 0
    block_row = torch.arange(p_rows // block_m, device=dev)[:, None] * block_m
    in_e = (block_row >= starts[None]) & (block_row < (starts + padded)[None])
    block_expert = in_e.int().argmax(dim=1).to(torch.int32)
    if computed is not None:
        block_expert.clamp_(max=computed - 1)
        padded = padded[:computed]
    num_blocks = (padded.sum() // block_m).to(torch.int32).reshape(1)
    return order, dest, block_expert, p_rows, num_blocks, counts


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def grouped_matmul_reference(xg: torch.Tensor, w: torch.Tensor,
                             block_expert: torch.Tensor,
                             block_m: int = BLOCK_M,
                             num_blocks: torch.Tensor | None = None) -> torch.Tensor:
    """Each row block of xg (P, H) times its expert's w (E, H, I) -> (P, I).

    One ``torch.matmul`` per contiguous run of row blocks with the same
    expert, in the input dtype (fp32 accumulation in cuBLAS and in the CPU
    BLAS, one rounding to the output dtype). With ``num_blocks`` (a
    1-element int tensor) only the leading ``num_blocks`` row blocks are
    computed and the rows past them are zeros, as the kernel does.
    ``block_expert`` and ``num_blocks`` are read on the host (a sync when
    they lie on a GPU; a CPU copy avoids it).
    """
    p = xg.shape[0]
    if p % block_m:
        raise ValueError(f"grouped_matmul: {p} rows are not whole blocks of {block_m}")
    be = block_expert.tolist()
    if len(be) != p // block_m:
        raise ValueError(f"grouped_matmul: {len(be)} block ids for {p // block_m} blocks")
    used = len(be)
    if num_blocks is not None:
        used = min(max(int(num_blocks.reshape(-1)[0]), 0), len(be))
    out = torch.empty((p, w.shape[2]), dtype=xg.dtype, device=xg.device)
    out[used * block_m:] = 0
    start = 0
    for b in range(1, used + 1):
        if b == used or be[b] != be[start]:
            rows = slice(start * block_m, b * block_m)
            out[rows] = torch.matmul(xg[rows], w[be[start]])
            start = b
    return out


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

def grouped_gemm_launch(xg: torch.Tensor, w: torch.Tensor,
                        block_expert: torch.Tensor,
                        block_m: int = BLOCK_M,
                        num_blocks: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; raise on what it does not take."""
    from ..build import grouped_gemm_lib

    if xg.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"grouped_gemm: xg and w must be bf16, got {xg.dtype}, {w.dtype}")
    if xg.dim() != 2 or w.dim() != 3 or w.shape[1] != xg.shape[1]:
        raise ValueError(f"grouped_gemm: xg {tuple(xg.shape)} does not fit w {tuple(w.shape)}")
    p, k = xg.shape
    e, _, n = w.shape
    if block_m != BLOCK_M or p % BLOCK_M or k % 32 or n % 128:
        raise ValueError(f"grouped_gemm: needs block_m {BLOCK_M}, P % {BLOCK_M}, "
                         f"K % 32 and N % 128 == 0; got block_m {block_m}, "
                         f"P {p}, K {k}, N {n}")
    if block_expert.dtype != torch.int32 or block_expert.shape != (p // BLOCK_M,):
        raise ValueError(f"grouped_gemm: block_expert must be int32 ({p // BLOCK_M},)")
    if num_blocks is not None and (num_blocks.dtype != torch.int32 or num_blocks.numel() != 1):
        raise ValueError("grouped_gemm: num_blocks must be a 1-element int32 tensor")
    for t, name in ((xg, "xg"), (w, "w"), (block_expert, "block_expert"),
                    (num_blocks, "num_blocks")):
        if t is None:
            continue
        if t.device != xg.device:
            raise ValueError("grouped_gemm: operands on different devices")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"grouped_gemm: {name} must be contiguous and 16-byte aligned")
    geo = G.geo_array(((xg, G.kmajor_map(xg, BLOCK_M, "grouped_gemm", "xg")),
                       (w, G.expert_map(w))))
    out = torch.empty((p, n), dtype=xg.dtype, device=xg.device)
    tiles = (p // BLOCK_M) * -(-n // G.BN)
    rc = grouped_gemm_lib()(geo, block_expert.data_ptr(),
                            None if num_blocks is None else num_blocks.data_ptr(),
                            out.data_ptr(), p, k, n, e, min(tiles, G.sm_count(xg.device)),
                            torch.cuda.current_stream(xg.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"grouped_gemm_forward launch failed: CUDA error {rc}")
    tracing.count("launch.grouped_gemm")
    return out


def grouped_matmul(xg: torch.Tensor, w: torch.Tensor,
                   block_expert: torch.Tensor,
                   block_m: int = BLOCK_M,
                   num_blocks: torch.Tensor | None = None) -> torch.Tensor:
    """Grouped GEMM: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. ``num_blocks`` (optional, a 1-element int32 tensor): only
    the leading row blocks are computed and the rows past them are zeros."""
    if xg.device.type == "cpu":
        return grouped_matmul_reference(xg, w, block_expert, block_m, num_blocks)
    if xg.device.type != "cuda":
        raise ValueError(f"grouped_matmul: no kernel for device {xg.device}")
    return grouped_gemm_launch(xg, w, block_expert, block_m, num_blocks)


# ---------------------------------------------------------------------------
# The MoE MLP
# ---------------------------------------------------------------------------

def add_shared_expert(p, cfg, xt: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``out`` plus the shared expert of ``p`` over the rows ``xt`` (T, H):
    sigmoid(xt @ shared_gate) * SwiGLU(xt), the gate cast to ``out``'s dtype
    (JAX ``models/decoder.py:_moe_mlp``); ``out`` as it is without one."""
    if p.shared is None:
        return out
    sh = p.shared
    h = L.ACT_FNS[cfg.act](Q.mm(xt, sh.gate)) * Q.mm(xt, sh.up)
    gate = torch.sigmoid(Q.mm(xt, p.shared_gate))
    return out + gate.to(out.dtype) * Q.mm(h, sh.down)


def _count_routing(rows: int, experts: int, num_blocks: torch.Tensor,
                   counts: torch.Tensor, block_m: int) -> None:
    """The routing counters of one dispatch (``tracing``; only while a
    session is open): ``moe_rows`` the T*k assignments and ``moe_mean_rows``
    T*k / E in hundredths, on the host; ``moe_block_rows`` the rows the
    grouped GEMM computes (each expert's group rounded up to ``block_m``)
    and ``moe_max_rows`` the largest expert group, added on the device with
    no host sync."""
    tracing.count("moe_rows", rows)
    tracing.count("moe_mean_rows", round(100 * rows / experts))
    tracing.count_device("moe_block_rows", num_blocks * block_m)
    tracing.count_device("moe_max_rows", counts.max())


def moe_mlp_dispatch(p, cfg, x: torch.Tensor,
                     block_m: int = BLOCK_M) -> torch.Tensor:
    """Top-k routed SwiGLU experts over x (B, S, H), exact (no token drops).

    p holds ``router`` (a leaf with ``w`` (H, E)), ``gate_up`` (E, H, 2I)
    and ``down`` (E, I, H), and ``shared`` / ``shared_gate`` (or None). The
    numerics of the dense ``_moe_mlp``: fp32 router softmax, top-k
    renormalised when ``cfg.moe_norm_topk`` (the JAX dispatch renormalises
    whatever it says; every config but the talker's sets it), the combine
    weighted in the activation dtype, then the shared expert.

    Expert parallelism (``p.experts`` = (first expert, group), set by
    ``parallel/mesh.py:shard_params``; ``gate_up`` / ``down`` then hold
    this rank's experts): the router runs replicated over all experts; the
    assignments to other ranks' experts go to a sink group past this rank's,
    which the grouped GEMM never computes, with zero combine weights; the
    combine is all-reduced in fp32 over the group (ep, or tp without an ep
    axis) and rounded once.
    The shared expert is replicated (the JAX rules match none of its leaves)
    and every rank adds it after the all-reduce, so it counts once with no
    collective of its own.

    Traced, a dispatch over all the experts counts its routing
    (``_count_routing``); an expert-parallel rank counts nothing.
    """
    b, s, h = x.shape
    xt = x.reshape(-1, h)
    t, k = xt.shape[0], cfg.experts_per_tok
    dev = x.device
    probs = torch.softmax(Q.mm(xt, p.router).float(), dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1)
    if cfg.moe_norm_topk:
        topv = topv / topv.sum(-1, keepdim=True)                 # (T, k)
    lo, group = getattr(p, "experts", (0, None))
    e_local = p.gate_up.shape[0]
    ids, computed = topi, None
    if group is not None:
        mine = (topi >= lo) & (topi < lo + e_local)
        ids = torch.where(mine, topi - lo, e_local)
        topv = topv * mine
        computed = e_local
    order, dest, block_expert, p_rows, used, counts = _plan(
        ids.reshape(-1), e_local + (group is not None), block_m, computed)
    if group is None and tracing.enabled():
        _count_routing(t * k, e_local, used, counts, block_m)
    # the grouped buffer as a row gather: each slot's source token; pad
    # slots read token row 0, a finite row whose outputs are never read
    token_of = torch.arange(t, device=dev).repeat_interleave(k)[order]
    src = torch.zeros(p_rows, dtype=torch.long, device=dev).scatter_(0, dest, token_of)
    xg = xt.index_select(0, src)
    # the pad blocks past `used` are not computed (their rows are zeros)
    gu = grouped_matmul(xg, p.gate_up, block_expert, block_m, used)   # (P, 2I)
    g, u = gu.chunk(2, dim=-1)
    act = (L.ACT_FNS[cfg.act](g) * u).to(x.dtype).contiguous()
    y = grouped_matmul(act, p.down, block_expert, block_m, used)  # (P, H)
    # combine: token t's k outputs sit at the dest rows of its assignments
    inv = torch.zeros(t * k, dtype=torch.long, device=dev).scatter_(0, order, dest)
    yk = y.index_select(0, inv).reshape(t, k, h)
    out = (yk * topv[..., None].to(y.dtype))
    if group is None:
        out = out.sum(dim=1)
    else:   # the ranks' fp32 sums of their experts' terms, rounded once after
        out = comm.all_reduce(out.float().sum(dim=1), group).to(y.dtype)
    out = add_shared_expert(p, cfg, xt, out)
    return out.reshape(b, s, h).to(x.dtype)
