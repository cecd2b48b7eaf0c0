"""The port at true clip-flant5 widths on HF-initialised weights (port of
tests/test_real_dims_parity.py's clip-flant5 case), and the W8A8 modes
measured on those weights.

HF builds CLIP ViT-L/14-336 (width 1024, 16 heads, mlp 4096, 577 tokens,
penultimate-layer features) with 2 layers, the 2-layer 1024 -> d_model GELU
projector, and FlanT5 at its published widths (google/flan-t5-xl and -xxl
config.json: relative buckets 32 / max distance 128, gated-gelu, untied
head) with few layers: parity faults are per layer, the CPU's time bounds
the depth. HF's T5 init draws W_q with std (d_model * d_kv)^-1/2, the
attention scale real checkpoints carry, so the scores are not the
bf16-chaotic ones of a plain random init. HF draws the untied lm_head with
std 1, which puts the logits at std ~45 and P(answer) near e^-100, below
float32's range; the head (never quantized) is scaled to std d_model^-1/2,
the effective scale of a tied T5 head, so the scores are comparable.

  * fp32, xl widths (2 ViT + 2+2 T5 layers, the full 32128 vocabulary): the
    port's VQAScore from the HF weights (``params=`` the converted views)
    against HF's per-pair loss, <= 1e-4 in the mean answer log-prob (the
    JAX suite's bar; BASELINE's is 1e-3);
  * ``quant="int8"`` and ``"int8+vit"`` against fp32 on the same weights
    and pairs, at xl widths and with one xxl-width T5 layer a stack (1+1,
    the vocabulary cut to 512 to bound host memory): the measured |dP| and
    |d log P|, pinned with ~1.5x room (``INT8_LIMITS``).
"""

import numpy as np
import pytest
import torch

import t2v_metrics_tpu_torch as tt2v
from t2v_metrics_tpu_torch import SimpleT5Tokenizer
from t2v_metrics_tpu_torch.constants import (CLIP_MEAN, CLIP_STD,
                                             DEFAULT_QUESTION_TEMPLATE,
                                             IMAGE_TOKEN_INDEX)
from t2v_metrics_tpu_torch.models import clip as tclip
from t2v_metrics_tpu_torch.models import clip_flant5 as tcft5
from t2v_metrics_tpu_torch.models import t5 as tt5
from t2v_metrics_tpu_torch.ops import quant as TQ
from t2v_metrics_tpu_torch.tokenization import splice_image_tokens_t5

IMG, PATCH, WIDTH = 336, 14, 1024
TEXTS = ["a photo of a cat", "two dogs running on green grass", "a red cube", "an old city street"]
HF_ATOL = 1e-4
# measured on these seeds, max over the 2 x 4 pairs (|dP|, |d log P| nats):
# xl int8 3.12e-7, 1.28e-2; int8+vit 4.02e-7, 1.66e-2 (P ~2.5e-5); xxl one
# layer int8 2.20e-5, 1.60e-2; int8+vit 3.11e-5, 2.28e-2 (P ~1.3e-3)
INT8_LIMITS = {  # size -> {mode: (max |dP|, max |d log P| nats)}, ~1.5x the measured
    "flan-t5-xl": {"int8": (5e-7, 0.02), "int8+vit": (6e-7, 0.025)},
    "flan-t5-xxl": {"int8": (3.3e-5, 0.024), "int8+vit": (4.7e-5, 0.034)},
}


def _hf_models(size: str, layers: int, vocab: int, seed: int):
    from transformers import CLIPVisionConfig, CLIPVisionModel, T5Config
    from transformers import T5ForConditionalGeneration

    cfg = tt5.T5_CONFIGS[size]
    torch.manual_seed(seed)
    vis = CLIPVisionModel(CLIPVisionConfig(
        hidden_size=WIDTH, intermediate_size=4096, num_hidden_layers=2,
        num_attention_heads=16, image_size=IMG, patch_size=PATCH,
        hidden_act="quick_gelu")).eval()
    proj = torch.nn.Sequential(torch.nn.Linear(WIDTH, cfg.d_model), torch.nn.GELU(),
                               torch.nn.Linear(cfg.d_model, cfg.d_model)).eval()
    t5 = T5ForConditionalGeneration(T5Config(
        vocab_size=vocab, d_model=cfg.d_model, d_kv=cfg.d_kv, d_ff=cfg.d_ff,
        num_layers=layers, num_decoder_layers=layers, num_heads=cfg.num_heads,
        relative_attention_num_buckets=32, relative_attention_max_distance=128,
        dropout_rate=0.0, feed_forward_proj="gated-gelu", tie_word_embeddings=False,
        decoder_start_token_id=0, pad_token_id=0, eos_token_id=1)).eval()
    with torch.no_grad():
        t5.lm_head.weight.mul_(cfg.d_model ** -0.5)
    port_cfg = tcft5.CLIPT5Config(
        t5=tt5.T5Config(vocab_size=vocab, d_model=cfg.d_model, d_kv=cfg.d_kv,
                        d_ff=cfg.d_ff, num_heads=cfg.num_heads, enc_layers=layers,
                        dec_layers=layers),
        vision=tclip.CLIPVisionConfig(image_size=IMG, patch_size=PATCH, width=WIDTH,
                                      layers=2, heads=16, mlp_dim=4096, proj_dim=WIDTH),
        num_image_tokens=(IMG // PATCH) ** 2)
    return vis, proj, t5, port_cfg


def _llava_state_dict(vis, proj, t5) -> dict:
    sd = dict(t5.state_dict())
    for k, v in vis.state_dict().items():
        sd[f"encoder.vision_tower.vision_tower.{k}"] = v
    for i in (0, 2):
        sd[f"encoder.mm_projector.{i}.weight"] = proj[i].weight
        sd[f"encoder.mm_projector.{i}.bias"] = proj[i].bias
    return sd


def _hf_logprob(vis, proj, t5, tok, img, text) -> float:
    """HF's mean answer log-prob of one pair, the reference's per-pair
    semantics (tests/test_real_dims_parity.py)."""
    px = (img.astype(np.float32) / 255.0 - np.asarray(CLIP_MEAN, np.float32)) \
        / np.asarray(CLIP_STD, np.float32)
    qtext = tcft5.format_question(DEFAULT_QUESTION_TEMPLATE.format(text))
    with torch.no_grad():
        hs = vis(pixel_values=torch.from_numpy(px.transpose(2, 0, 1)[None]),
                 output_hidden_states=True).hidden_states
        feats = proj(hs[-2][:, 1:])
        spliced = splice_image_tokens_t5(qtext, tok)
        at = spliced.index(IMAGE_TOKEN_INDEX)
        emb = t5.get_input_embeddings()
        embeds = torch.cat([emb(torch.tensor(spliced[:at])[None]), feats,
                            emb(torch.tensor(spliced[at + 1:])[None])], dim=1)
        out = t5(inputs_embeds=embeds, labels=torch.tensor(tok("Yes").input_ids)[None])
    return -out.loss.item()


def _images(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (IMG, IMG, 3), dtype=np.uint8) for _ in range(n)]


def _int8_gaps(scorer, images) -> dict:
    """log-scores of fp32, then int8 (the T5 linears quantized in place),
    then int8+vit (the ViT's too) on the same weights and pairs ->
    {mode: (max |dP|, max |d log P|)}."""
    model = scorer.model.engine.params
    ref = np.log(scorer(images=images, texts=TEXTS))
    gaps = {}
    TQ.quantize_t5_(model.t5)
    for mode in ("int8", "int8+vit"):
        if mode == "int8+vit":
            TQ.quantize_clip_vision_(model.vision)
        got = np.log(scorer(images=images, texts=TEXTS))
        gaps[mode] = (float(np.abs(np.exp(got) - np.exp(ref)).max()),
                      float(np.abs(got - ref).max()))
    print("int8 gaps against fp32:", gaps, "fp32 log-scores:", ref.round(4).tolist())
    return gaps


def test_clip_flant5_xl_true_dims_matches_hf_and_int8_modes():
    vis, proj, t5, cfg = _hf_models("flan-t5-xl", 2, 32128, seed=0)
    tok = SimpleT5Tokenizer(32128)
    images = _images(2, 1)
    want = np.array([[_hf_logprob(vis, proj, t5, tok, img, t) for t in TEXTS]
                     for img in images])
    tree = tcft5.convert_clip_t5(_llava_state_dict(vis, proj, t5), cfg)
    scorer = tt2v.VQAScore("clip-flant5-xl", config=cfg, params=tree, tokenizer=tok,
                           device="cpu", dtype=torch.float32)
    del vis, proj, t5, tree
    got = np.log(scorer(images=images, texts=TEXTS))
    assert np.abs(got - want).max() <= HF_ATOL, (got, want)
    assert np.ptp(want) > 10 * HF_ATOL            # the pairs are told apart
    gaps = _int8_gaps(scorer, images)
    for mode, (dp, dlogp) in gaps.items():
        dp_max, dlogp_max = INT8_LIMITS["flan-t5-xl"][mode]
        assert 0 < dlogp <= dlogp_max and dp <= dp_max, (mode, dp, dlogp)


def test_clip_flant5_xxl_one_layer_int8_modes():
    vis, proj, t5, cfg = _hf_models("flan-t5-xxl", 1, 512, seed=2)
    tok = SimpleT5Tokenizer(512)
    tree = tcft5.convert_clip_t5(_llava_state_dict(vis, proj, t5), cfg)
    scorer = tt2v.VQAScore("clip-flant5-xxl", config=cfg, params=tree, tokenizer=tok,
                           device="cpu", dtype=torch.float32)
    del vis, proj, t5, tree
    gaps = _int8_gaps(scorer, _images(2, 3))
    for mode, (dp, dlogp) in gaps.items():
        dp_max, dlogp_max = INT8_LIMITS["flan-t5-xxl"][mode]
        assert 0 < dlogp <= dlogp_max and dp <= dp_max, (mode, dp, dlogp)
