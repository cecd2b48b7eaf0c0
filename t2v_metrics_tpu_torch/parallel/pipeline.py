"""Pipeline parallelism (PP): GPipe over a "pp" axis for the T5 encoder
(port of t2v_metrics_tpu/parallel/pipeline.py).

Rank s of the pp group holds encoder layers [s*L/pp, (s+1)*L/pp)
(``stage_encoder_`` drops the rest of the encoder's blocks; layer 0's
``rel_bias`` table is kept apart, since every stage adds the bias). The
batch is cut into ``n_micro`` microbatches; at step t stage s runs
microbatch t - s through its layers and sends the result to stage s + 1
(``comm.send`` / ``recv``; through host memory on gloo for CUDA tensors).
The last stage collects the finished microbatches and broadcasts the whole
buffer, and every rank applies ``ln_final``. Utilization is n_micro /
(n_micro + pp - 1), the GPipe bubble, as in the JAX schedule; here the
stages run as processes, not as ``shard_map`` programs.
"""

from __future__ import annotations

import torch

from ..models import t5 as tt5
from ..ops import layers as L
from ..ops.position import compute_position_bias
from . import comm


def stack_encoder_blocks(model: tt5.T5Model):
    """(the encoder's blocks, layer 0's ``rel_bias`` table (buckets,
    heads)): the blocks are uniform once the table, which HF T5 keeps in
    layer 0 only, is taken apart. A staged encoder (``stage_encoder_``)
    gives its own blocks and the table it kept."""
    enc = model.encoder
    table = getattr(enc, "rel_table", None)
    return list(enc.blocks), table if table is not None else enc.blocks[0].attn.rel_bias


def _stage(cfg: tt5.T5Config, mesh) -> tuple[int, int, int]:
    """(pp, this rank's stage, layers a stage); raises before any
    collective when the layers do not split."""
    pp = mesh.axis_size("pp")
    if cfg.enc_layers % pp:
        raise ValueError(f"enc_layers {cfg.enc_layers} not divisible by pp {pp}")
    return pp, mesh.axis_index("pp"), cfg.enc_layers // pp


@torch.no_grad()
def stage_encoder_(model: tt5.T5Model, cfg: tt5.T5Config, mesh) -> tt5.T5Model:
    """Keep only this rank's stage of the encoder's blocks, in place (and
    layer 0's ``rel_bias`` table as ``encoder.rel_table``)."""
    pp, s, lps = _stage(cfg, mesh)
    enc = model.encoder
    if len(enc.blocks) == lps and getattr(enc, "rel_table", None) is not None:
        return model
    enc.rel_table = enc.blocks[0].attn.rel_bias
    enc.blocks = torch.nn.ModuleList(list(enc.blocks)[s * lps:(s + 1) * lps])
    return model


def pipeline_encode(model: tt5.T5Model, cfg: tt5.T5Config, input_embeds: torch.Tensor,
                    mask: torch.Tensor | None, mesh, n_micro: int | None = None
                    ) -> torch.Tensor:
    """T5 ``encode`` over the mesh's "pp" axis, GPipe schedule.

    input_embeds: (B, S, D) with B divisible by n_micro (default pp), the
    same on every rank of the pp group. ``model``: the whole encoder or this
    rank's stage of it (``stage_encoder_``). Returns the post-final-norm
    hidden states on every rank, equal to ``t5.encode``.
    """
    pp, s, lps = _stage(cfg, mesh)
    n_micro = n_micro or pp
    b, sl, d = input_embeds.shape
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
    mb = b // n_micro
    blocks, rel_emb = stack_encoder_blocks(model)
    if len(blocks) == cfg.enc_layers:
        blocks = blocks[s * lps:(s + 1) * lps]
    if len(blocks) != lps:
        raise ValueError(f"the model holds {len(blocks)} encoder layers, not stage "
                         f"{s}'s {lps} or all {cfg.enc_layers}")
    group = mesh.group("pp")
    ranks = mesh.axis_ranks("pp")                   # stage order
    bias = compute_position_bias(rel_emb, sl, sl, True, cfg.num_buckets,
                                 cfg.max_distance).float().contiguous()
    micro = input_embeds.reshape(n_micro, mb, sl, d)
    mmask = None if mask is None else mask.reshape(n_micro, mb, sl)
    out = torch.zeros_like(micro)
    x = torch.empty((mb, sl, d), dtype=input_embeds.dtype, device=input_embeds.device)
    for t in range(n_micro + pp - 1):
        i = t - s                                   # this stage's microbatch
        if not 0 <= i < n_micro:
            continue
        if s == 0:
            x = micro[i]
        else:
            comm.recv(x, ranks[s - 1], group)
        kvm = None if mmask is None else mmask[i]
        y, branch = x, None
        for blk in blocks:
            y, branch = tt5._enc_block(blk, y, branch, cfg, bias, kvm)
        y = y + branch                              # a stage hands over whole sums
        if s < pp - 1:
            comm.send(y, ranks[s + 1], group)
        else:
            out[i] = y
    comm.broadcast(out, ranks[-1], group)
    out = out.reshape(b, sl, d)
    return L.rms_norm(out, model.encoder.ln_final.scale, cfg.eps)
