"""Qwen3-Omni (thinker) scorer in PyTorch: audio + vision + MoE text (port of
t2v_metrics_tpu/models/qwen3omni.py: the scoring path and
``resolve_talker_config``; the talker itself is ``models/qwen3omni_talker.py``).

Composition (HF Qwen3OmniMoeThinkerForConditionalGeneration semantics):
  * audio tower: ``models/qwen3omni_audio.py`` (Whisper-style windowed
    encoder);
  * vision tower: Qwen3-VL's (deepstack, interpolated position embeddings),
    ``models/qwen3vl.py``;
  * text: the MoE decoder with interleaved M-RoPE (``models/decoder.py``);
    audio tokens take plain sequential positions (HF get_rope_index
    :335-345). The deepstack residuals reach the vision rows only.
"""

from __future__ import annotations

import dataclasses
import re
from collections.abc import Mapping

import torch
from torch import nn

from . import decoder as dec
from . import qwen2vl as q2
from . import qwen3omni_audio as qa
from . import qwen3vl as q3


@dataclasses.dataclass(frozen=True)
class Qwen3OmniConfig:
    audio: qa.AudioEncoderConfig
    vision: q3.Qwen3VisionConfig
    text: dec.DecoderConfig
    audio_token_id: int = 151646
    audio_start_token_id: int = 151647
    audio_end_token_id: int = 151648
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    vision_end_token_id: int = 151653


def _omni_text_30b():
    # Qwen3-Omni 30B-A3B thinker: MoE, 128 experts top-8
    return dataclasses.replace(
        dec.DecoderConfig(vocab_size=152064, d_model=2048, layers=48,
                          heads=32, kv_heads=4, head_dim=128, d_ff=0,
                          rope_theta=1_000_000.0, mrope_section=(24, 20, 20),
                          mrope_interleaved=True, qkv_bias=False, qk_norm=True),
        num_experts=128, experts_per_tok=8, moe_d_ff=768,
        moe_dispatch=True)


QWEN3_OMNI_MODELS = {
    # the JAX package's registry, in its order (reference qwen3omni_model.py:12-43)
    "qwen3-omni-30b-a3b": {
        "hf": "Qwen/Qwen3-Omni-30B-A3B-Instruct",
        "config": None},
    "qwen3-omni-30b-a3b-thinking": {
        "hf": "Qwen/Qwen3-Omni-30B-A3B-Thinking",
        "config": None},
    "qwen3-omni-30b-a3b-captioner": {
        "hf": "Qwen/Qwen3-Omni-30B-A3B-Captioner",
        "config": None},
    "qwen3-omni-test": {"hf": None, "config": "test"},
}


def resolve_config(name: str) -> Qwen3OmniConfig:
    spec = QWEN3_OMNI_MODELS[name]
    if spec["config"] == "test":
        return Qwen3OmniConfig(
            audio=qa.AudioEncoderConfig(d_model=32, layers=2, heads=4,
                                        ffn_dim=64, num_mel_bins=32,
                                        n_window=8, n_window_infer=32,
                                        downsample_hidden=12, output_dim=48),
            vision=q3.Qwen3VisionConfig(hidden=32, depth=2, heads=4,
                                        patch_size=4, d_ff=64, out_hidden=48,
                                        num_position_embeddings=16,
                                        deepstack_indexes=(0,)),
            text=dataclasses.replace(
                dec.DecoderConfig(vocab_size=512, d_model=48, layers=2,
                                  heads=4, kv_heads=2, head_dim=16, d_ff=0,
                                  rope_theta=1_000_000.0,
                                  mrope_section=(4, 2, 2),
                                  mrope_interleaved=True, qkv_bias=False,
                                  qk_norm=True),
                num_experts=4, experts_per_tok=2, moe_d_ff=32),
            audio_token_id=505, audio_start_token_id=506,
            audio_end_token_id=507, image_token_id=501, video_token_id=502,
            vision_start_token_id=503, vision_end_token_id=504)
    text = _omni_text_30b()
    # The audio tower's output rows are spliced into the thinker's 2048-wide
    # embeddings, so its output width is the thinker's d_model (as the
    # published 30B-A3B thinker's proj2 gives). The JAX package builds this
    # tower with AudioEncoderConfig()'s 3584 (Qwen2.5-Omni's width), which
    # cannot splice into a 2048-wide buffer; the port does not copy that.
    return Qwen3OmniConfig(audio=qa.AudioEncoderConfig(output_dim=text.d_model),
                           vision=q3.Qwen3VisionConfig(out_hidden=text.d_model),
                           text=text)


def resolve_talker_config():
    """Talker config for the 30B-A3B checkpoints, the JAX package's (HF
    Qwen3OmniMoeTalkerConfig defaults: a 20-layer 1024-wide MoE with 128
    experts top-8, not renormalised, and a shared expert; a 5-layer code
    predictor; a 16-quantizer Code2Wav at 24 kHz). Its 32 code groups
    against Code2Wav's 16 quantizers are kept as JAX and HF have them. One
    field differs: ``moe_dispatch`` is set, so the talker's experts run the
    sorted dispatch and the grouped GEMM kernel on the card (the JAX config
    leaves it off, and its talker runs the dense ``_moe_mlp``; the two agree
    to the summation order)."""
    from . import qwen3omni_talker as tk

    text = dataclasses.replace(
        dec.DecoderConfig(vocab_size=3072, d_model=1024, layers=20,
                          heads=16, kv_heads=2, head_dim=64, d_ff=0,
                          rope_theta=10000.0, mrope_section=(24, 20, 20),
                          mrope_interleaved=True, qkv_bias=False,
                          qk_norm=True),
        num_experts=128, experts_per_tok=8, moe_d_ff=384,
        moe_shared_ff=2048, moe_norm_topk=False, moe_dispatch=True)
    predictor = dec.DecoderConfig(
        vocab_size=2048, d_model=1024, layers=5, heads=16, kv_heads=8,
        head_dim=128, d_ff=3072, rope_theta=10000.0, mrope_section=None,
        qkv_bias=False, qk_norm=True)
    return tk.TalkerConfig(text=text, predictor=predictor,
                           code2wav=tk.Code2WavConfig())


class Qwen3OmniModel(nn.Module):
    """Parameters of the thinker's scoring path: ``audio``, ``vision`` and
    ``decoder``."""

    def __init__(self, cfg: Qwen3OmniConfig, device, dtype):
        super().__init__()
        self.audio = qa.AudioEncoder(cfg.audio, device, dtype)
        self.vision = q3.VisionTower(cfg.vision, device, dtype)
        self.decoder = dec.Decoder(cfg.text, device, dtype)


@torch.no_grad()
def init_qwen3omni(cfg: Qwen3OmniConfig, seed: int, device,
                   dtype=torch.float32) -> Qwen3OmniModel:
    """Random parameters made on ``device`` in ``dtype``: the vision tower and
    the decoder as ``qwen3vl.init_qwen3vl`` makes them from ``seed``, the
    audio tower as ``qwen3omni_audio.init_audio_encoder`` from ``seed + 1``
    (the numbers differ from the JAX package's). No host copy is made."""
    device = torch.device(device)
    model = Qwen3OmniModel(cfg, device, dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    q3.init_vision_(model.vision, gen)
    dec.init_decoder(model.decoder, gen)
    qa.init_audio_encoder(model.audio, torch.Generator(device=device).manual_seed(seed + 1))
    return model


def splice_and_score(params: Qwen3OmniModel, cfg: Qwen3OmniConfig,
                     ids, splice_feats, splice_mask, splice_slot,
                     position_ids, attn_mask, ans_ids, ans_pos, ans_mask,
                     deepstack_feats=None, vis_mask=None,
                     temperature: float = 1.0) -> torch.Tensor:
    """Teacher-forced mean log P(answer).

    splice_feats (B, T, D) holds the concatenated (vision + audio) feature
    rows of each sequence, written at ``splice_mask`` from slot
    ``splice_slot``; deepstack_feats (levels of (B, T, D), aligned with the
    splice slots) adds the vision deepstack residuals at the vision
    positions ``vis_mask`` only: audio rows get none, whatever their levels
    hold.
    """
    return q2.splice_and_score(params, cfg, ids, splice_feats, splice_mask, splice_slot,
                               position_ids, attn_mask, ans_ids, ans_pos, ans_mask,
                               temperature=temperature, deepstack_feats=deepstack_feats,
                               deepstack_mask=vis_mask)


# HF Qwen3OmniMoe names of the vision mergers -> the Qwen3-VL converter's
_MERGER_RENAMES = [(re.compile(r"^visual\.merger_list\."), "visual.deepstack_merger_list."),
                   (re.compile(r"^(visual\.(?:deepstack_merger_list\.\d+|merger))\.ln_q\."),
                    r"\1.norm."),
                   (re.compile(r"^(visual\.(?:deepstack_merger_list\.\d+|merger))\.mlp\.0\."),
                    r"\1.linear_fc1."),
                   (re.compile(r"^(visual\.(?:deepstack_merger_list\.\d+|merger))\.mlp\.2\."),
                    r"\1.linear_fc2.")]


class _ThinkerKeys(Mapping):
    """A state dict's thinker keys without their ``thinker.`` prefix, as the
    Qwen3-VL converter reads them: the vision tower's ``merger_list`` as
    ``deepstack_merger_list`` and HF's merger names (``ln_q``, ``mlp.0``,
    ``mlp.2``) as Qwen3-VL's (``norm``, ``linear_fc1``, ``linear_fc2``), and
    each MoE layer's per-expert modules (the layout HF writes) as the packed
    ``experts.gate_up_proj`` (E, H, 2I) and ``experts.down_proj`` (E, I, H),
    stacked when read. Other keys (``talker.*``, ``code2wav.*``) are not
    seen. A missing key is looked up in ``sd`` under its own name, so a
    recording mapping names it."""

    def __init__(self, sd: Mapping, prefix: str, num_experts: int):
        self.sd, self.prefix, self.num_experts = sd, prefix, num_experts
        self.names = {}
        for k in sd:
            if k.startswith(prefix):
                kk = k[len(prefix):]
                for pattern, repl in _MERGER_RENAMES:
                    kk = pattern.sub(repl, kk)
                self.names[kk] = k
        for kk in list(self.names):
            if kk.endswith(".mlp.experts.0.gate_proj.weight"):
                base = kk[:-len("0.gate_proj.weight")]
                self.names[base + "gate_up_proj"] = self.names[base + "down_proj"] = None

    def __getitem__(self, kk):
        src = self.names.get(kk, "")
        if src is not None:
            return self.sd[src or self.prefix + kk]
        from .convert import t2np

        base, what = kk.rsplit(".", 1)
        ex = [f"{base}.{e}" for e in range(self.num_experts)]
        if what == "down_proj":
            return torch.stack([t2np(self[f"{e}.down_proj.weight"]).t() for e in ex])
        return torch.stack([torch.cat([t2np(self[f"{e}.gate_proj.weight"]).t(),
                                       t2np(self[f"{e}.up_proj.weight"]).t()], dim=1)
                            for e in ex])

    def __iter__(self):
        return iter(self.names)

    def __len__(self):
        return len(self.names)

    def __contains__(self, kk):
        return kk in self.names


def convert_qwen3omni(sd, cfg: Qwen3OmniConfig) -> dict:
    """HF thinker state dict (``thinker.audio_tower.* / thinker.visual.* /
    thinker.model.* / thinker.lm_head``, or the same without ``thinker.``)
    -> tree of CPU tensor views in the JAX layout (port of the JAX
    ``convert_qwen3omni``, which reads packed experts and Qwen3-VL's
    merger names only; here the experts per module or packed, the mergers
    under either names)."""
    prefix = "thinker." if any(k.startswith("thinker.") for k in sd) else ""
    audio = qa.convert_audio_encoder(sd, cfg.audio, prefix=f"{prefix}audio_tower.")
    vl = q3.convert_qwen3vl(_ThinkerKeys(sd, prefix, cfg.text.num_experts),
                            q3.Qwen3VLConfig(vision=cfg.vision, text=cfg.text))
    return {"audio": audio, "vision": vl["vision"], "decoder": vl["decoder"]}
