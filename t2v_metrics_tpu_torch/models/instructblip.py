"""InstructBLIP (FlanT5) scorer in PyTorch (port of
t2v_metrics_tpu/models/instructblip.py).

HF Salesforce/instructblip-flan-t5-* semantics, as in the JAX package:
  * the EVA ViT-g tower of BLIP-2 (``models/blip2_itm.py``);
  * the instruction-aware Q-Former: the 32 learned queries and the
    instruction's tokens form one self-attention stream (the text under its
    key mask), and only the queries cross-attend the image features;
  * the language projection (Q-Former hidden -> T5 d_model);
  * FlanT5: the encoder reads [projected queries] + the prompt's
    embeddings, and the answer is scored teacher-forced from the decoder
    (``t5.answer_log_probs``, CLIP-FlanT5's rule).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import torch
from torch import nn

from ..ops import layers as L
from ..ops import quant as Q
from . import blip2_itm as bitm
from . import t5 as tt5


@dataclasses.dataclass(frozen=True)
class InstructBlipConfig:
    vision: bitm.Blip2VisionConfig
    qformer: bitm.QFormerConfig
    t5: tt5.T5Config
    num_query_tokens: int = 32


_T5_XL = tt5.T5Config(vocab_size=32128, d_model=2048, d_kv=64, d_ff=5120,
                      num_heads=32, enc_layers=24, dec_layers=24)
_T5_XXL = tt5.T5Config(vocab_size=32128, d_model=4096, d_kv=64, d_ff=10240,
                       num_heads=64, enc_layers=24, dec_layers=24)

INSTRUCTBLIP_MODELS = {
    "instructblip-flant5-xl": {
        "hf": "Salesforce/instructblip-flan-t5-xl",
        "tokenizer": "google/flan-t5-xl",
        "config": InstructBlipConfig(bitm.Blip2VisionConfig(), bitm.QFormerConfig(), _T5_XL),
    },
    "instructblip-flant5-xxl": {
        "hf": "Salesforce/instructblip-flan-t5-xxl",
        "tokenizer": "google/flan-t5-xxl",
        "config": InstructBlipConfig(bitm.Blip2VisionConfig(), bitm.QFormerConfig(), _T5_XXL),
    },
    "instructblip-test": {
        "hf": None,
        "tokenizer": None,
        "config": InstructBlipConfig(
            bitm.Blip2VisionConfig(image_size=28, patch_size=14, width=32,
                                   layers=2, heads=4, mlp_dim=64),
            bitm.QFormerConfig(vocab_size=256, hidden=32, layers=2, heads=4,
                               mlp_dim=64, cross_attention_frequency=2,
                               max_position_embeddings=64),
            tt5.T5Config(vocab_size=512, d_model=64, d_kv=16, d_ff=128,
                         num_heads=4, enc_layers=2, dec_layers=2),
            num_query_tokens=4),
    },
}


class InstructBlipModel(nn.Module):
    """Parameters of the whole scorer: ``vision``, ``qformer``,
    ``query_tokens``, ``proj`` (the language projection) and ``t5``."""

    def __init__(self, cfg: InstructBlipConfig, device, dtype):
        super().__init__()
        self.vision = bitm.VisionTower(cfg.vision, device, dtype)
        self.qformer = bitm.QFormer(cfg.qformer, cfg.vision.width, device, dtype)
        self.query_tokens = nn.Parameter(
            torch.empty((cfg.num_query_tokens, cfg.qformer.hidden), device=device,
                        dtype=dtype), requires_grad=False)
        self.proj = Q.Linear.empty(cfg.qformer.hidden, cfg.t5.d_model, True, device, dtype)
        self.t5 = tt5.T5Model(cfg.t5, device, dtype)


@torch.no_grad()
def init_instructblip(cfg: InstructBlipConfig, seed: int, device,
                      dtype=torch.float32) -> InstructBlipModel:
    """Random parameters made on ``device`` in ``dtype`` from a
    ``torch.Generator`` seeded with ``seed``, with init_instructblip's
    distributions (the numbers differ from the JAX package's): the BLIP-2
    tower and Q-Former init, the projection N(0, 1/hidden) with a zero bias,
    the T5 init."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = InstructBlipModel(cfg, device, dtype)
    bitm.init_tower_qformer_(model, gen)
    bitm.init_linear_(gen, model.proj)
    tt5.init_t5(model.t5, gen)
    return model


def query_features_from_embeds(params: InstructBlipModel, cfg: InstructBlipConfig,
                               image_embeds: torch.Tensor, qf_ids: torch.Tensor,
                               qf_mask: torch.Tensor) -> torch.Tensor:
    """The tower's output (B, 1+P, width) of each pair's image + the
    instruction's Q-Former tokens (B, T) -> (B, nq, t5.d_model): queries and
    instruction in one self-attention stream (the instruction under
    ``qf_mask``), cross-attention from the queries only, the query rows
    through the language projection."""
    qf = cfg.qformer
    q = params.qformer
    b, t = qf_ids.shape
    nq = cfg.num_query_tokens
    text = q.word_emb[qf_ids] + q.pos_emb[:t]
    query = params.query_tokens.to(text.dtype).expand(b, nq, qf.hidden)
    embeds = L.layer_norm(torch.cat([query, text], dim=1), q.ln_emb.scale, q.ln_emb.bias,
                          qf.ln_eps)
    mask = torch.cat([torch.ones((b, nq), dtype=torch.bool, device=qf_ids.device),
                      qf_mask.bool()], dim=1)
    out = bitm.qformer(q, qf, embeds, mask, image_embeds, nq)
    return Q.linear(out[:, :nq], params.proj)


def query_features(params: InstructBlipModel, cfg: InstructBlipConfig,
                   pixels: torch.Tensor, qf_ids: torch.Tensor,
                   qf_mask: torch.Tensor) -> torch.Tensor:
    """Normalized (B, H, W*3) pixels + instruction tokens -> (B, nq,
    t5.d_model)."""
    return query_features_from_embeds(
        params, cfg, bitm.vision_tower(params.vision, cfg.vision, pixels), qf_ids, qf_mask)


def encoder_inputs(params: InstructBlipModel, cfg: InstructBlipConfig,
                   q_feats: torch.Tensor, ids: torch.Tensor,
                   enc_mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(T5 encoder input [queries] + prompt embeddings, its mask) in HF
    InstructBlipForConditionalGeneration's order."""
    tok = params.t5.shared_emb[ids]
    b, nq = ids.shape[0], cfg.num_query_tokens
    mask = torch.cat([torch.ones((b, nq), dtype=torch.bool, device=ids.device),
                      enc_mask.bool()], dim=1)
    return torch.cat([q_feats.to(tok.dtype), tok], dim=1), mask


def score_pairs(params: InstructBlipModel, cfg: InstructBlipConfig,
                pixels: torch.Tensor, qf_ids: torch.Tensor, qf_mask: torch.Tensor,
                ids: torch.Tensor, enc_mask: torch.Tensor, ans_ids: torch.Tensor,
                ans_mask: torch.Tensor) -> torch.Tensor:
    """(B,) mean answer-token log-probs of paired images and prompts."""
    return score_from_queries(params, cfg, query_features(params, cfg, pixels, qf_ids,
                                                           qf_mask),
                              ids, enc_mask, ans_ids, ans_mask)


def score_from_queries(params: InstructBlipModel, cfg: InstructBlipConfig, q_feats,
                       ids, enc_mask, ans_ids, ans_mask) -> torch.Tensor:
    enc_in, mask = encoder_inputs(params, cfg, q_feats, ids, enc_mask)
    return tt5.answer_log_probs(params.t5, cfg.t5, enc_in, mask, ans_ids, ans_mask)


class _ITMKeys(Mapping):
    """An InstructBLIP state dict seen in the blip2-itm key layout: the
    Q-Former's embedding keys under their ITM names, and a zero ITM head
    where the checkpoint has none (``convert_blip2_itm`` reads one)."""

    _ALIAS = {"embeddings.word_embeddings.weight": "qformer.embeddings.word_embeddings.weight",
              "embeddings.position_embeddings.weight":
                  "qformer.embeddings.position_embeddings.weight",
              "qformer.layernorm.weight": "qformer.embeddings.layernorm.weight",
              "qformer.layernorm.bias": "qformer.embeddings.layernorm.bias"}

    def __init__(self, sd: Mapping, hidden: int):
        self.sd = sd
        self.head = {"itm_head.weight": torch.zeros((2, hidden)),
                     "itm_head.bias": torch.zeros((2,))}

    def _key(self, key):
        src = self._ALIAS.get(key)
        return src if src is not None and src in self.sd else key

    def __getitem__(self, key):
        if key in self.head and key not in self.sd:
            return self.head[key]
        return self.sd[self._key(key)]

    def __contains__(self, key):
        return (key in self.head) or self._key(key) in self.sd

    def __iter__(self):
        return iter(self.sd)

    def __len__(self):
        return len(self.sd)


def convert_instructblip(sd, cfg: InstructBlipConfig):
    """HF InstructBlipForConditionalGeneration state dict -> tree of CPU
    tensor views in the JAX layout (port of the JAX
    ``convert_instructblip``). Keys: ``vision_model.*``, ``qformer.*`` (its
    embeddings under ``qformer.embeddings.*``, read through the blip2-itm
    converter), ``query_tokens``, ``language_projection.*`` and the T5 under
    ``language_model.*``."""
    from .convert import convert_t5, t2np

    itm_cfg = bitm.Blip2ITMConfig(cfg.vision, cfg.qformer, cfg.num_query_tokens)
    base = bitm.convert_blip2_itm(_ITMKeys(sd, cfg.qformer.hidden), itm_cfg)
    return {
        "vision": base["vision"],
        "qformer": base["qformer"],
        "query_tokens": base["query_tokens"],
        "proj": {"w": t2np(sd["language_projection.weight"]).t(),
                 "b": t2np(sd["language_projection.bias"])},
        "t5": convert_t5(sd, cfg.t5.enc_layers, cfg.t5.dec_layers, gated=cfg.t5.gated,
                         prefix="language_model."),
    }
