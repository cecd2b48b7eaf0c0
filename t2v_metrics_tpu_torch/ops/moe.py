"""Mixture-of-experts dispatch: exact sort-based grouping and a grouped GEMM
(port of t2v_metrics_tpu/ops/moe.py).

  1. route: an fp32 router softmax, the top-k experts of each token, their
     weights renormalised;
  2. group: the token-expert assignments sorted by expert into a buffer
     whose every expert group starts at a row-block boundary
     (``plan_groups``), built as one row gather; no token is dropped;
  3. ``grouped_matmul``: each row block times its expert's weight matrix,
     the CUDA kernel of ``csrc/grouped_gemm.cu`` on the card (see the note
     there for what it replaces, what bounds it and its design);
  4. combine: each token's k outputs gathered back and summed with the
     router weights, in the activation dtype.

Expert FLOPs: ~(T*k + E*block_m) * H * I against the dense path's T*E*H*I
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
    return order, dest, block_expert, p_rows


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def grouped_matmul_reference(xg: torch.Tensor, w: torch.Tensor,
                             block_expert: torch.Tensor,
                             block_m: int = BLOCK_M) -> torch.Tensor:
    """Each row block of xg (P, H) times its expert's w (E, H, I) -> (P, I).

    One ``torch.matmul`` per contiguous run of row blocks with the same
    expert, in the input dtype (fp32 accumulation in cuBLAS and in the CPU
    BLAS, one rounding to the output dtype). ``block_expert`` is read on the
    host (a sync when it lies on a GPU; a CPU copy avoids it).
    """
    p = xg.shape[0]
    if p % block_m:
        raise ValueError(f"grouped_matmul: {p} rows are not whole blocks of {block_m}")
    be = block_expert.tolist()
    if len(be) != p // block_m:
        raise ValueError(f"grouped_matmul: {len(be)} block ids for {p // block_m} blocks")
    out = torch.empty((p, w.shape[2]), dtype=xg.dtype, device=xg.device)
    start = 0
    for b in range(1, len(be) + 1):
        if b == len(be) or be[b] != be[start]:
            rows = slice(start * block_m, b * block_m)
            out[rows] = torch.matmul(xg[rows], w[be[start]])
            start = b
    return out


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

def grouped_gemm_launch(xg: torch.Tensor, w: torch.Tensor,
                        block_expert: torch.Tensor,
                        block_m: int = BLOCK_M) -> torch.Tensor:
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
    for t, name in ((xg, "xg"), (w, "w"), (block_expert, "block_expert")):
        if t.device != xg.device:
            raise ValueError("grouped_gemm: operands on different devices")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"grouped_gemm: {name} must be contiguous and 16-byte aligned")
    out = torch.empty((p, n), dtype=xg.dtype, device=xg.device)
    rc = grouped_gemm_lib()(xg.data_ptr(), w.data_ptr(), block_expert.data_ptr(),
                            out.data_ptr(), p, k, n, e,
                            torch.cuda.current_stream(xg.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"grouped_gemm_forward launch failed: CUDA error {rc}")
    grouped_gemm_launch.launches += 1
    return out


grouped_gemm_launch.launches = 0


def grouped_matmul(xg: torch.Tensor, w: torch.Tensor,
                   block_expert: torch.Tensor,
                   block_m: int = BLOCK_M) -> torch.Tensor:
    """Grouped GEMM: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if xg.device.type == "cpu":
        return grouped_matmul_reference(xg, w, block_expert, block_m)
    if xg.device.type != "cuda":
        raise ValueError(f"grouped_matmul: no kernel for device {xg.device}")
    return grouped_gemm_launch(xg, w, block_expert, block_m)


# ---------------------------------------------------------------------------
# The MoE MLP
# ---------------------------------------------------------------------------

def moe_mlp_dispatch(p, cfg, x: torch.Tensor,
                     block_m: int = BLOCK_M) -> torch.Tensor:
    """Top-k routed SwiGLU experts over x (B, S, H), exact (no token drops).

    p holds ``router`` (a leaf with ``w`` (H, E)), ``gate_up`` (E, H, 2I)
    and ``down`` (E, I, H). The numerics of the JAX dispatch: fp32 router
    softmax, top-k renormalised, the combine weighted in the activation
    dtype.
    """
    b, s, h = x.shape
    xt = x.reshape(-1, h)
    t, k = xt.shape[0], cfg.experts_per_tok
    dev = x.device
    probs = torch.softmax(Q.mm(xt, p.router).float(), dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1)
    topv = topv / topv.sum(-1, keepdim=True)                     # (T, k)
    order, dest, block_expert, p_rows = plan_groups(topi.reshape(-1),
                                                    cfg.num_experts, block_m)
    # the grouped buffer as a row gather: each slot's source token; pad
    # slots read token row 0, a finite row whose outputs are never read
    token_of = torch.arange(t, device=dev).repeat_interleave(k)[order]
    src = torch.zeros(p_rows, dtype=torch.long, device=dev).scatter_(0, dest, token_of)
    xg = xt.index_select(0, src)
    gu = grouped_matmul(xg, p.gate_up, block_expert, block_m)     # (P, 2I)
    g, u = gu.chunk(2, dim=-1)
    act = (L.ACT_FNS[cfg.act](g) * u).to(x.dtype).contiguous()
    y = grouped_matmul(act, p.down, block_expert, block_m)        # (P, H)
    # combine: token t's k outputs sit at the dest rows of its assignments
    inv = torch.zeros(t * k, dtype=torch.long, device=dev).scatter_(0, order, dest)
    yk = y.index_select(0, inv).reshape(t, k, h)
    out = (yk * topv[..., None].to(y.dtype)).sum(dim=1)
    return out.reshape(b, s, h).to(x.dtype)
