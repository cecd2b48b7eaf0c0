"""The port loaded from staged checkpoint directories, against Hugging Face
and against the JAX package on the same directories.

Tiny HF models configured in code are staged the way the port meets real
checkpoints: safetensors shards with ``model.safetensors.index.json`` (or
``*.bin`` shards, or a native tree), ``config.json`` and a ``tokenizers``
``tokenizer.json``. The port loads them through its public
``VQAScore(..., checkpoint=dir, tokenizer=dir, device="cpu",
dtype=torch.float32)``. The HF reference scores the same prompt ids and
pixels the port's adapter built, so the comparison holds the weights and
the model numerics to HF.

Tolerances (fp32), the JAX suites' own: towers 3e-5 against HF; the mean
answer log-prob 1e-5 against HF's (2e-5 for Qwen3-VL); scores against the
JAX package loading the same directory rtol 1e-5, atol 1e-7.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import t2v_metrics_tpu_torch as tt2v
from t2v_metrics_tpu_torch.constants import (CLIP_MEAN, CLIP_STD,
                                             DEFAULT_QUESTION_TEMPLATE,
                                             IMAGE_TOKEN_INDEX)
from t2v_metrics_tpu_torch.models import checkpoint as ckpt
from t2v_metrics_tpu_torch.models import clip as tclip
from t2v_metrics_tpu_torch.models import clip_flant5 as tcft5
from t2v_metrics_tpu_torch.models import decoder as tdec
from t2v_metrics_tpu_torch.models import gemma3 as tg3
from t2v_metrics_tpu_torch.models import qwen2vl as tq2
from t2v_metrics_tpu_torch.models import qwen3vl as tq3
from t2v_metrics_tpu_torch.models import siglip as tsiglip
from t2v_metrics_tpu_torch.models import t5 as tt5
from t2v_metrics_tpu_torch.tokenization import splice_image_tokens_t5

TOWER_ATOL = 3e-5
SCORE_ATOL = 1e-5
QWEN3_SCORE_ATOL = 2e-5
JAX_RTOL, JAX_ATOL = 1e-5, 1e-7
TEXTS = ["a photo of a cat", "two dogs on grass"]


@pytest.fixture(autouse=True)
def _offline(monkeypatch):
    """Nothing here may reach a hub: the JAX adapters' loaders consult these
    before any lookup."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")


# ---------------------------------------------------------------------------
# Staging
# ---------------------------------------------------------------------------

def stage_safetensors(sd: dict, path: str, shards: int = 3, index: bool = True,
                      config: dict | None = None) -> str:
    """Write ``sd`` as ``shards`` safetensors files (keys dealt round-robin),
    with the index json when ``index``, and ``config.json`` when given."""
    from safetensors.torch import save_file

    os.makedirs(path, exist_ok=True)
    keys = sorted(sd)
    weight_map = {}
    for i in range(shards):
        name = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
        part = keys[i::shards]
        save_file({k: sd[k].detach().clone().contiguous() for k in part},
                  os.path.join(path, name))
        weight_map.update(dict.fromkeys(part, name))
    if index:
        with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {}, "weight_map": weight_map}, f)
    if config is not None:
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(config, f)
    return path


def stage_bin(sd: dict, path: str, shards: int = 2) -> str:
    """Write ``sd`` as PyTorch ``*.bin`` shards with their index json."""
    os.makedirs(path, exist_ok=True)
    keys = sorted(sd)
    weight_map = {}
    for i in range(shards):
        name = f"pytorch_model-{i + 1:05d}-of-{shards:05d}.bin"
        part = keys[i::shards]
        torch.save({k: sd[k].detach().clone().contiguous() for k in part},
                   os.path.join(path, name))
        weight_map.update(dict.fromkeys(part, name))
    with open(os.path.join(path, "pytorch_model.bin.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    return path


def stage_tokenizer(path: str, words: str, specials=(), t5: bool = False) -> str:
    """A real on-disk fast tokenizer (tokenizer.json): whitespace word
    level, ``specials`` as single tokens; with ``t5`` the T5 layout (pad 0,
    ``</s>`` 1 appended by the post-processor)."""
    from tokenizers import AddedToken, Tokenizer, models, pre_tokenizers, processors

    os.makedirs(path, exist_ok=True)
    vocab = {"<pad>": 0, "</s>": 1, "<unk>": 2}
    for w in [*specials, *words.split()]:
        vocab.setdefault(w, len(vocab))
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.add_special_tokens([AddedToken(s, special=True) for s in specials])
    if t5:
        tok.post_processor = processors.TemplateProcessing(
            single="$A </s>", pair="$A </s> $B </s>", special_tokens=[("</s>", 1)])
    tok.save(os.path.join(path, "tokenizer.json"))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", "eos_token": "</s>",
                   "pad_token": "<pad>", "unk_token": "<unk>",
                   "model_max_length": 4096}, f)
    return path


def stage_snapshot(cache: str, repo: str, rev: str = "0123abc") -> str:
    """An empty snapshot directory of ``repo`` in an HF hub cache layout
    (``models--org--name/snapshots/<rev>`` with ``refs/main``)."""
    root = os.path.join(cache, "models--" + repo.replace("/", "--"))
    os.makedirs(os.path.join(root, "refs"), exist_ok=True)
    with open(os.path.join(root, "refs", "main"), "w") as f:
        f.write(rev)
    snap = os.path.join(root, "snapshots", rev)
    os.makedirs(snap, exist_ok=True)
    return snap


def mean_answer_logprob(logits: torch.Tensor, n_prompt: int, answer: list) -> float:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return float(np.mean([logp[0, n_prompt - 1 + i, t].item() for i, t in enumerate(answer)]))


# ---------------------------------------------------------------------------
# CLIP-FlanT5
# ---------------------------------------------------------------------------

CLIP_IMG, CLIP_PATCH = 28, 14
T5_WORDS = ("Does this figure show a photo of cat dog two dogs on grass ? Please "
            "answer Yes No . yes no is an the USER: ASSISTANT: A chat between")
CLIP_T5_CFG = tcft5.CLIPT5Config(
    t5=tt5.T5Config(vocab_size=200, d_model=48, d_kv=12, d_ff=96, num_heads=4,
                    enc_layers=2, dec_layers=2, num_buckets=8, max_distance=20),
    vision=tclip.CLIPVisionConfig(image_size=CLIP_IMG, patch_size=CLIP_PATCH, width=32,
                                  layers=3, heads=4, mlp_dim=64, proj_dim=32),
    num_image_tokens=(CLIP_IMG // CLIP_PATCH) ** 2)


def clip_t5_hf(seed: int = 7):
    """(HF CLIP tower, projector, HF T5, the LLaVA-layout state dict)."""
    from transformers import CLIPVisionConfig, CLIPVisionModel, T5Config
    from transformers import T5ForConditionalGeneration

    torch.manual_seed(seed)
    vis = CLIPVisionModel(CLIPVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=3, num_attention_heads=4,
        image_size=CLIP_IMG, patch_size=CLIP_PATCH, hidden_act="quick_gelu")).eval()
    proj = torch.nn.Sequential(torch.nn.Linear(32, 48), torch.nn.GELU(),
                               torch.nn.Linear(48, 48)).eval()
    t5 = T5ForConditionalGeneration(T5Config(
        vocab_size=200, d_model=48, d_kv=12, d_ff=96, num_layers=2, num_decoder_layers=2,
        num_heads=4, relative_attention_num_buckets=8, relative_attention_max_distance=20,
        dropout_rate=0.0, feed_forward_proj="gated-gelu", tie_word_embeddings=False,
        decoder_start_token_id=0, pad_token_id=0, eos_token_id=1)).eval()
    sd = dict(t5.state_dict())
    for k, v in vis.state_dict().items():
        sd[f"encoder.vision_tower.vision_tower.{k}"] = v
    for i in (0, 2):
        sd[f"encoder.mm_projector.{i}.weight"] = proj[i].weight
        sd[f"encoder.mm_projector.{i}.bias"] = proj[i].bias
    return vis, proj, t5, sd


@pytest.fixture(scope="module")
def clip_t5(tmp_path_factory):
    vis, proj, t5, sd = clip_t5_hf()
    root = tmp_path_factory.mktemp("clip_t5")
    tok = stage_tokenizer(str(root / "tok"), T5_WORDS, t5=True)
    img = np.random.default_rng(0).integers(0, 256, (CLIP_IMG, CLIP_IMG, 3), dtype=np.uint8)
    return {"vis": vis, "proj": proj, "t5": t5, "sd": sd, "root": root, "tok": tok,
            "img": img}


def _clip_t5_dir(fx, storage: str) -> str:
    path = str(fx["root"] / storage)
    if os.path.isdir(path):
        return path
    if storage == "index":
        return stage_safetensors(fx["sd"], path)
    if storage == "no_index":
        return stage_safetensors(fx["sd"], path, shards=2, index=False)
    if storage == "bin":
        return stage_bin(fx["sd"], path)
    tree = tcft5.convert_clip_t5(fx["sd"], CLIP_T5_CFG)   # native
    ckpt.save_params(tree, path)
    return path


def _hf_clip_t5_reference(fx, tok, text):
    """HF's mean answer log-prob of one pair (the reference's per-pair
    semantics: penultimate ViT layer, projector, splice, T5 loss)."""
    px = (fx["img"].astype(np.float32) / 255.0 - np.asarray(CLIP_MEAN, np.float32)) \
        / np.asarray(CLIP_STD, np.float32)
    qtext = tcft5.format_question(DEFAULT_QUESTION_TEMPLATE.format(text))
    with torch.no_grad():
        hs = fx["vis"](pixel_values=torch.from_numpy(px.transpose(2, 0, 1)[None]),
                       output_hidden_states=True).hidden_states
        feats = fx["proj"](hs[-2][:, 1:])
        spliced = splice_image_tokens_t5(qtext, tok)
        at = spliced.index(IMAGE_TOKEN_INDEX)
        emb = fx["t5"].get_input_embeddings()
        embeds = torch.cat([emb(torch.tensor(spliced[:at])[None]), feats,
                            emb(torch.tensor(spliced[at + 1:])[None])], dim=1)
        out = fx["t5"](inputs_embeds=embeds, labels=torch.tensor(tok("Yes").input_ids)[None])
    return -out.loss.item(), feats[0].numpy()


@pytest.mark.parametrize("storage", ["index", "no_index", "bin", "native"])
def test_clip_flant5_checkpoint_matches_hf(clip_t5, storage):
    path = _clip_t5_dir(clip_t5, storage)
    s = tt2v.VQAScore("clip-flant5-xl", config=CLIP_T5_CFG, checkpoint=path,
                      tokenizer=clip_t5["tok"], device="cpu", dtype=torch.float32)
    tok = s.model.engine.tokenizer
    assert tok.__class__.__name__ == "PreTrainedTokenizerFast"
    got = s(images=[clip_t5["img"]], texts=TEXTS)
    assert got.shape == (1, 2)
    feats = s.model.engine.encode_images([clip_t5["img"]])[0].numpy()
    for j, text in enumerate(TEXTS):
        ref, ref_feats = _hf_clip_t5_reference(clip_t5, tok, text)
        np.testing.assert_allclose(feats, ref_feats, atol=TOWER_ATOL, rtol=0)
        assert abs(np.log(got[0, j]) - ref) <= SCORE_ATOL, (storage, text, got, ref)


@pytest.mark.parametrize("storage", ["index", "native"])
def test_clip_flant5_checkpoint_matches_jax(clip_t5, storage):
    """The JAX package's cold path on the same directory, the same tokenizer."""
    import jax.numpy as jnp

    import t2v_metrics_tpu as jt2v
    from t2v_metrics_tpu.models import clip as jclip
    from t2v_metrics_tpu.models import clip_flant5 as jcft5
    from t2v_metrics_tpu.models import t5 as jt5

    jcfg = jcft5.CLIPT5Config(
        t5=jt5.T5Config(**dataclasses.asdict(CLIP_T5_CFG.t5)),
        vision=jclip.CLIPVisionConfig(**dataclasses.asdict(CLIP_T5_CFG.vision)),
        num_image_tokens=CLIP_T5_CFG.num_image_tokens)
    path = _clip_t5_dir(clip_t5, storage)
    j = jt2v.VQAScore(model="clip-flant5-xl", config=jcfg, checkpoint=path,
                      tokenizer=clip_t5["tok"], dtype=jnp.float32)
    t = tt2v.VQAScore("clip-flant5-xl", config=CLIP_T5_CFG, checkpoint=path,
                      tokenizer=clip_t5["tok"], device="cpu", dtype=torch.float32)
    imgs = [clip_t5["img"], np.random.default_rng(1).integers(0, 256, (40, 52, 3), np.uint8)]
    np.testing.assert_allclose(t(images=imgs, texts=TEXTS), np.asarray(j(images=imgs, texts=TEXTS)),
                               rtol=JAX_RTOL, atol=JAX_ATOL)


def test_clip_flant5_tower_from_mm_vision_tower(clip_t5, tmp_path, monkeypatch):
    """A LLaVA checkpoint without the CLIP tower takes it from the local
    snapshot of the repo its config.json names in ``mm_vision_tower``; the
    scores equal those of the checkpoint that carries the tower."""
    cache = tmp_path / "hub"
    monkeypatch.setenv("HF_HUB_CACHE", str(cache))
    sd = clip_t5["sd"]
    prefix = "encoder.vision_tower.vision_tower."
    no_tower = {k: v for k, v in sd.items() if not k.startswith(prefix)}
    path = stage_safetensors(no_tower, str(tmp_path / "ckpt"),
                             config={"mm_vision_tower": "openai/clip-test-336"})
    kw = dict(config=CLIP_T5_CFG, tokenizer=clip_t5["tok"], device="cpu", dtype=torch.float32)
    with pytest.raises(ckpt.CheckpointError, match="openai/clip-test-336"):
        tt2v.VQAScore("clip-flant5-xl", checkpoint=path, **kw)   # not local yet
    tower = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    stage_safetensors(tower, stage_snapshot(str(cache), "openai/clip-test-336"), shards=1)
    got = tt2v.VQAScore("clip-flant5-xl", checkpoint=path, **kw)(
        images=[clip_t5["img"]], texts=TEXTS)
    want = tt2v.VQAScore("clip-flant5-xl", checkpoint=_clip_t5_dir(clip_t5, "index"), **kw)(
        images=[clip_t5["img"]], texts=TEXTS)
    np.testing.assert_array_equal(got, want)


def test_clip_flant5_pretrained_default_from_local_cache(clip_t5, tmp_path, monkeypatch):
    """Without checkpoint= or init='random' the adapter loads the registry's
    hf_repo from the local cache (here $HF_HOME/hub)."""
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    snap = stage_snapshot(str(tmp_path / "hub"), "zhiqiulin/clip-flant5-xl")
    stage_safetensors(clip_t5["sd"], snap)
    kw = dict(config=CLIP_T5_CFG, tokenizer=clip_t5["tok"], device="cpu", dtype=torch.float32)
    got = tt2v.VQAScore("clip-flant5-xl", **kw)(images=[clip_t5["img"]], texts=TEXTS)
    want = tt2v.VQAScore("clip-flant5-xl", checkpoint=snap, **kw)(
        images=[clip_t5["img"]], texts=TEXTS)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Qwen2.5-VL and Qwen3-VL (dense and MoE)
# ---------------------------------------------------------------------------

QWEN_SPECIALS = ("<|im_start|>", "<|im_end|>")
QWEN_WORDS = ("system You are a helpful assistant. user assistant Does this figure "
              "show \" a photo of cat \" ? Please answer Yes or No . two dogs on grass")
QWEN_IMG = 56   # the smart-resize size of itself (patch 4, merge 2)


def _qwen2_hf():
    from transformers import Qwen2_5_VLForConditionalGeneration
    from transformers.models.qwen2_5_vl.configuration_qwen2_5_vl import Qwen2_5_VLConfig

    torch.manual_seed(0)
    hf = Qwen2_5_VLForConditionalGeneration(Qwen2_5_VLConfig(
        text_config=dict(vocab_size=600, hidden_size=48, intermediate_size=96,
                         num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                         head_dim=12, hidden_act="silu", max_position_embeddings=512,
                         rms_norm_eps=1e-6, rope_theta=1000000.0,
                         rope_scaling={"type": "mrope", "mrope_section": [2, 2, 2]},
                         tie_word_embeddings=False),
        vision_config=dict(depth=4, hidden_size=32, intermediate_size=64, num_heads=4,
                           patch_size=4, temporal_patch_size=2, spatial_merge_size=2,
                           window_size=16, fullatt_block_indexes=[1, 3], out_hidden_size=48,
                           hidden_act="silu", tokens_per_second=2),
        image_token_id=591, video_token_id=592, vision_start_token_id=593,
        vision_end_token_id=594)).eval()
    cfg = tq2.Qwen2VLConfig(
        vision=tq2.QwenVisionConfig(hidden=32, depth=4, heads=4, patch_size=4, window_size=16,
                                    fullatt_block_indexes=(1, 3), d_ff=64, out_hidden=48),
        text=tdec.DecoderConfig(vocab_size=600, d_model=48, layers=2, heads=4, kv_heads=2,
                                head_dim=12, d_ff=96, mrope_section=(2, 2, 2)),
        image_token_id=591, video_token_id=592, vision_start_token_id=593,
        vision_end_token_id=594)
    return hf, cfg


_Q3_VISION = dict(depth=3, hidden_size=32, intermediate_size=64, num_heads=4, patch_size=4,
                  temporal_patch_size=2, spatial_merge_size=2, out_hidden_size=48,
                  num_position_embeddings=16, deepstack_visual_indexes=[0, 1],
                  hidden_act="gelu_pytorch_tanh")
_Q3_TEXT = dict(vocab_size=512, hidden_size=48, intermediate_size=96, num_hidden_layers=3,
                num_attention_heads=4, num_key_value_heads=2, head_dim=16, hidden_act="silu",
                max_position_embeddings=512, rms_norm_eps=1e-6, rope_theta=5_000_000.0,
                attention_bias=False, tie_word_embeddings=False,
                rope_scaling={"rope_type": "default", "mrope_section": [4, 2, 2],
                              "mrope_interleaved": True})
_Q3_IDS = dict(image_token_id=501, video_token_id=502, vision_start_token_id=503,
               vision_end_token_id=504)


def _qwen3_hf(moe: bool):
    torch.manual_seed(1)
    if moe:
        from transformers import Qwen3VLMoeForConditionalGeneration as HF
        from transformers.models.qwen3_vl_moe.configuration_qwen3_vl_moe import (
            Qwen3VLMoeConfig as HFC)

        text = dict(_Q3_TEXT, num_experts=4, num_experts_per_tok=2, moe_intermediate_size=32,
                    decoder_sparse_step=1, mlp_only_layers=[], norm_topk_prob=True)
        cfg = tq3.resolve_config("qwen3-vl-moe-test")
        cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, moe_dispatch=True))
    else:
        from transformers import Qwen3VLForConditionalGeneration as HF
        from transformers.models.qwen3_vl.configuration_qwen3_vl import Qwen3VLConfig as HFC

        text = _Q3_TEXT
        cfg = tq3.resolve_config("qwen3-vl-test")
    hf = HF(HFC(text_config=text, vision_config=_Q3_VISION, **_Q3_IDS)).eval()
    return hf, cfg


def _disk_layout(sd):
    """transformers 4.57 state-dict keys -> the on-disk ``visual.*`` /
    ``model.*`` layout of the released checkpoints."""
    out = {}
    for k, v in sd.items():
        if k.startswith("model.visual."):
            k = k[len("model."):]
        elif k.startswith("model.language_model."):
            k = "model." + k[len("model.language_model."):]
        out[k] = v
    return out


@pytest.fixture(scope="module")
def qwen_tok(tmp_path_factory):
    return stage_tokenizer(str(tmp_path_factory.mktemp("qwen_tok")), QWEN_WORDS, QWEN_SPECIALS)


def _qwen_dir(tmp_path, hf, layout: str) -> str:
    sd = hf.state_dict() if layout == "state_dict" else _disk_layout(hf.state_dict())
    path = stage_safetensors(sd, str(tmp_path / f"ckpt_{layout}"))
    hf.config.to_json_file(os.path.join(path, "config.json"))
    return path


def _qwen_reference(a, hf, img, text):
    """HF's mean answer log-prob on the prompt ids and patch rows the port's
    adapter builds for (img, text), and its merged features (and deepstack
    levels for Qwen3-VL)."""
    cfg = a.config
    h, w, _ = img.shape
    patches = tq2.image_patches(torch.from_numpy(img).reshape(1, h, w * 3), cfg.vision,
                                h, w)[0]
    grid = torch.tensor([[1, h // cfg.vision.patch_size, w // cfg.vision.patch_size]])
    n_vis = patches.shape[0] // cfg.vision.merge_unit
    prompt = a._build_ids('Does this figure show "{}"? Please answer Yes or No.'.format(text),
                          n_vis)
    answer = a._encode_text("Yes")
    with torch.no_grad():
        vis = hf.model.visual(patches, grid)
        logits = hf(input_ids=torch.tensor([prompt + answer]), pixel_values=patches,
                    image_grid_thw=grid).logits
    return mean_answer_logprob(logits, len(prompt), answer), vis


def _check_qwen(s, hf, img, score_atol):
    a = s.model
    got = s(images=[img], texts=TEXTS)
    feats = a._encode_visuals([img])[0][0]
    for j, text in enumerate(TEXTS):
        ref, vis = _qwen_reference(a, hf, img, text)
        levels = [vis] if isinstance(vis, torch.Tensor) else [vis[0], *vis[1]]
        ours = [feats] if feats.dim() == 2 else list(feats)
        assert len(ours) == len(levels)
        for o, r in zip(ours, levels):
            np.testing.assert_allclose(o.numpy(), r.numpy(), atol=TOWER_ATOL, rtol=0)
        assert abs(np.log(got[0, j]) - ref) <= score_atol, (text, np.log(got[0, j]), ref)
    return got


def _qwen_img(seed=0):
    return np.random.default_rng(seed).integers(0, 256, (QWEN_IMG, QWEN_IMG, 3), np.uint8)


@pytest.mark.parametrize("layout", ["state_dict", "disk"])
def test_qwen2vl_checkpoint_matches_hf(tmp_path, qwen_tok, layout):
    hf, cfg = _qwen2_hf()
    path = _qwen_dir(tmp_path, hf, layout)
    s = tt2v.VQAScore("qwen2.5-vl-7b", config=cfg, checkpoint=path, tokenizer=qwen_tok,
                      device="cpu", dtype=torch.float32)
    _check_qwen(s, hf, _qwen_img(), SCORE_ATOL)


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_qwen3vl_checkpoint_matches_hf(tmp_path, qwen_tok, moe):
    hf, cfg = _qwen3_hf(moe)
    path = _qwen_dir(tmp_path, hf, "state_dict" if moe else "disk")
    name = "qwen3-vl-30b-a3b" if moe else "qwen3-vl-8b"
    s = tt2v.VQAScore(name, config=cfg, checkpoint=path, tokenizer=qwen_tok, device="cpu",
                      dtype=torch.float32)
    assert (s.model.params.decoder.blocks[0].moe is not None) == moe
    _check_qwen(s, hf, _qwen_img(1), QWEN3_SCORE_ATOL)


@pytest.mark.parametrize("family", ["qwen2.5-vl", "qwen3-vl"])
def test_qwen_checkpoint_matches_jax(tmp_path, qwen_tok, family):
    """The JAX adapters load the same directory through transformers'
    from_pretrained; the dense Qwen3-VL only (the JAX adapter builds the
    dense HF class, so it cannot read a MoE directory)."""
    import jax.numpy as jnp

    import t2v_metrics_tpu as jt2v
    from t2v_metrics_tpu.models import decoder as jdec
    from t2v_metrics_tpu.models import qwen2vl as jq2
    from t2v_metrics_tpu.models import qwen3vl as jq3

    if family == "qwen2.5-vl":
        hf, cfg = _qwen2_hf()
        name = "qwen2.5-vl-7b"
        vision = {k: v for k, v in dataclasses.asdict(cfg.vision).items()
                  if k not in ("image_mean", "image_std")}      # CLIP's, as JAX's
        jcfg = jq2.Qwen2VLConfig(vision=jq2.QwenVisionConfig(**vision),
                                 text=jdec.DecoderConfig(**dataclasses.asdict(cfg.text)),
                                 **{k: getattr(cfg, k) for k in _Q3_IDS if k != "image_token_id"},
                                 image_token_id=cfg.image_token_id)
    else:
        hf, cfg = _qwen3_hf(False)
        name = "qwen3-vl-8b"
        jcfg = jq3.resolve_config("qwen3-vl-test")
        # the JAX package normalises with CLIP's mean and std, where the port
        # gives Qwen3-VL its published processor's 0.5
        cfg = dataclasses.replace(cfg, vision=dataclasses.replace(
            cfg.vision, image_mean=CLIP_MEAN, image_std=CLIP_STD))
    path = _qwen_dir(tmp_path, hf, "state_dict")
    imgs = [_qwen_img(2), _qwen_img(3)]
    t = tt2v.VQAScore(name, config=cfg, checkpoint=path, tokenizer=qwen_tok, device="cpu",
                      dtype=torch.float32)
    j = jt2v.VQAScore(name, config=jcfg, checkpoint=path, tokenizer=qwen_tok,
                      dtype=jnp.float32)
    np.testing.assert_allclose(t(images=imgs, texts=TEXTS), np.asarray(j(images=imgs, texts=TEXTS)),
                               rtol=JAX_RTOL, atol=JAX_ATOL)


# ---------------------------------------------------------------------------
# Gemma 3
# ---------------------------------------------------------------------------

GEMMA_IMG = 28
GEMMA_REPO = "google/gemma-3-4b-it"
GEMMA_WORDS = ("<start_of_turn>user <end_of_turn> <start_of_turn>model Does this figure "
               "show \" a photo of cat \" ? Please answer Yes or No . two dogs on grass")


def _gemma_hf():
    from transformers import Gemma3ForConditionalGeneration
    from transformers.models.gemma3.configuration_gemma3 import Gemma3Config

    torch.manual_seed(2)
    layer_types = ["sliding_attention", "full_attention", "sliding_attention"]
    hf = Gemma3ForConditionalGeneration(Gemma3Config(
        text_config=dict(vocab_size=512, hidden_size=48, intermediate_size=96,
                         num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
                         head_dim=16, hidden_activation="gelu_pytorch_tanh",
                         max_position_embeddings=512, rms_norm_eps=1e-6,
                         rope_theta=1_000_000.0, rope_local_base_freq=10_000.0,
                         rope_scaling={"rope_type": "linear", "factor": 8.0},
                         query_pre_attn_scalar=16, sliding_window=8, layer_types=layer_types,
                         attention_bias=False, tie_word_embeddings=True),
        vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                           num_attention_heads=4, image_size=GEMMA_IMG, patch_size=14,
                           hidden_act="gelu_pytorch_tanh", layer_norm_eps=1e-6),
        mm_tokens_per_image=4, image_token_index=501, boi_token_index=502,
        eoi_token_index=503)).eval()
    cfg = tg3.Gemma3Config(
        vision=tsiglip.SiglipVisionConfig(image_size=GEMMA_IMG, patch_size=14, width=32,
                                          layers=2, heads=4, mlp_dim=64),
        text=tdec.DecoderConfig(
            vocab_size=512, d_model=48, layers=3, heads=4, kv_heads=2, head_dim=16, d_ff=96,
            act="gelu_pytorch_tanh", rope_theta=1_000_000.0, mrope_section=None,
            qkv_bias=False, tie_embeddings=True, qk_norm=True, q_scale=16 ** -0.5,
            sandwich_norms=True, rms_offset=1.0, rms_cast_weight=False, sliding_window=8,
            layer_types=tuple(layer_types), local_rope_theta=10_000.0,
            rope_scaling_factor=8.0),
        mm_tokens_per_image=4, image_token_id=501, boi_token_id=502, eoi_token_id=503)
    return hf, cfg


def _stage_gemma_snapshot(root: str, hf) -> str:
    """A hub-cache snapshot of GEMMA_REPO: config.json, shards, tokenizer."""
    snap = stage_snapshot(root, GEMMA_REPO)
    stage_safetensors(hf.state_dict(), snap)
    hf.config.to_json_file(os.path.join(snap, "config.json"))
    stage_tokenizer(snap, GEMMA_WORDS)
    return snap


def _gemma_img(seed=0):
    return np.random.default_rng(seed).integers(0, 256, (GEMMA_IMG, GEMMA_IMG, 3), np.uint8)


def test_gemma3_cached_snapshot_matches_hf(tmp_path, monkeypatch):
    """The pretrained default loads the hub snapshot from the local cache
    ($HF_HUB_CACHE), as the JAX adapter does; checkpoint= loads the same."""
    from t2v_metrics_tpu_torch.models.gemma_adapters import siglip_preprocess

    hf, cfg = _gemma_hf()
    snap = _stage_gemma_snapshot(str(tmp_path / "hub"), hf)
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    s = tt2v.VQAScore(GEMMA_REPO.split("/")[1], config=cfg, tokenizer=snap, device="cpu",
                      dtype=torch.float32)
    img = _gemma_img()
    got = s(images=[img], texts=TEXTS)
    a = s.model
    px = siglip_preprocess(torch.from_numpy(img).reshape(1, GEMMA_IMG, GEMMA_IMG * 3),
                           GEMMA_IMG).reshape(1, GEMMA_IMG, GEMMA_IMG, 3).permute(0, 3, 1, 2)
    with torch.no_grad():
        ref_feats = hf.model.get_image_features(px)[0]
    np.testing.assert_allclose(a._encode_images([img])[0].numpy(), ref_feats.numpy(),
                               atol=TOWER_ATOL, rtol=0)
    for j, text in enumerate(TEXTS):
        prompt = a._assemble('Does this figure show "{}"? Please answer Yes or No.'.format(text))
        answer = a._encode_text("Yes")
        ids = torch.tensor([prompt + answer])
        with torch.no_grad():
            logits = hf(input_ids=ids, pixel_values=px,
                        token_type_ids=(ids == cfg.image_token_id).long()).logits
        ref = mean_answer_logprob(logits, len(prompt), answer)
        assert abs(np.log(got[0, j]) - ref) <= SCORE_ATOL, (text, np.log(got[0, j]), ref)
    again = tt2v.VQAScore("gemma-3-4b-it", config=cfg, checkpoint=snap, tokenizer=snap,
                          device="cpu", dtype=torch.float32)(images=[img], texts=TEXTS)
    np.testing.assert_array_equal(got, again)


def test_gemma3_cached_snapshot_matches_jax(tmp_path, monkeypatch):
    """The JAX adapter reads only the hub snapshot of its repo id through
    from_pretrained: here the id resolves as a local directory."""
    import jax.numpy as jnp

    import t2v_metrics_tpu as jt2v
    from t2v_metrics_tpu.models import decoder as jdec
    from t2v_metrics_tpu.models import gemma3 as jg3
    from t2v_metrics_tpu.models import siglip as jsiglip
    from t2v_metrics_tpu.tokenization import load_hf_tokenizer

    hf, cfg = _gemma_hf()
    snap = _stage_gemma_snapshot(str(tmp_path / "hub"), hf)
    local = tmp_path / "cwd" / GEMMA_REPO
    local.parent.mkdir(parents=True)
    os.symlink(snap, local)
    monkeypatch.chdir(tmp_path / "cwd")
    jcfg = jg3.Gemma3Config(vision=jsiglip.SiglipVisionConfig(**dataclasses.asdict(cfg.vision)),
                            text=jdec.DecoderConfig(**dataclasses.asdict(cfg.text)),
                            mm_tokens_per_image=4, image_token_id=501, boi_token_id=502,
                            eoi_token_id=503)
    j = jt2v.VQAScore("gemma-3-4b-it", config=jcfg, tokenizer=load_hf_tokenizer(snap),
                      dtype=jnp.float32)
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    t = tt2v.VQAScore("gemma-3-4b-it", config=cfg, tokenizer=snap, device="cpu",
                      dtype=torch.float32)
    imgs = [_gemma_img(1), _gemma_img(2)]
    np.testing.assert_allclose(t(images=imgs, texts=TEXTS), np.asarray(j(images=imgs, texts=TEXTS)),
                               rtol=JAX_RTOL, atol=JAX_ATOL)


# ---------------------------------------------------------------------------
# InternVL 3 / 3.5 (the JAX suites' tests/test_internvl_parity.py and
# tests/test_internvl35_parity.py: Qwen2 and Qwen3 text, the use_qk_norm RMS
# tower with a Qwen3-MoE text model of per-expert modules)
# ---------------------------------------------------------------------------

INTERNVL_IMG = 28
INTERNVL_SPECIALS = ("<|im_start|>", "<|im_end|>", "<img>", "</img>")
INTERNVL_WORDS = ("system user assistant Does this figure show \" a photo of cat \" ? "
                  "Please answer Yes or No . two dogs on grass")


def _internvl_hf(text: str):
    """(HF InternVLForConditionalGeneration, the port's registry name and
    config) for ``text`` "qwen2", "qwen3" or "qwen3_moe" (with the 6B-style
    RMS tower and flattened qk-norm)."""
    from transformers import InternVLForConditionalGeneration
    from transformers.models.internvl.configuration_internvl import InternVLConfig as HFC

    from t2v_metrics_tpu_torch.models import internvl as tivl

    rms = text == "qwen3_moe"
    vision = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                  num_attention_heads=4, image_size=[INTERNVL_IMG] * 2, patch_size=[14, 14],
                  hidden_act="gelu", layer_norm_eps=1e-6, use_absolute_position_embeddings=True,
                  layer_scale_init_value=0.1, use_qk_norm=rms,
                  norm_type="rms_norm" if rms else "layer_norm", attention_bias=not rms)
    tcfg = dict(model_type=text, vocab_size=512, hidden_size=48, intermediate_size=96,
                num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                hidden_act="silu", rms_norm_eps=1e-6, rope_theta=1_000_000.0,
                max_position_embeddings=512, tie_word_embeddings=False)
    if text != "qwen2":
        tcfg.update(head_dim=16, attention_bias=False)
    if rms:
        tcfg.update(moe_intermediate_size=32, num_experts=4, num_experts_per_tok=2,
                    norm_topk_prob=True, decoder_sparse_step=1, mlp_only_layers=[])
    torch.manual_seed({"qwen2": 0, "qwen3": 1, "qwen3_moe": 2}[text])
    hf = InternVLForConditionalGeneration(HFC(
        vision_config=vision, text_config=tcfg, image_token_id=500, downsample_ratio=0.5,
        vision_feature_layer=-1, vision_feature_select_strategy="default",
        projector_hidden_act="gelu")).eval()
    name = {"qwen2": "internvl3-test", "qwen3": "internvl3.5-test",
            "qwen3_moe": "internvl3.5-moe-test"}[text]
    return hf, name, tivl.INTERNVL_MODELS[name]["config"]


def _legacy_layout(sd):
    """transformers 4.57 keys -> the older ``vision_tower.*`` /
    ``multi_modal_projector.*`` / ``language_model.model.*`` layout."""
    out = {}
    for k, v in sd.items():
        for new, old in (("model.vision_tower.", "vision_tower."),
                         ("model.multi_modal_projector.", "multi_modal_projector."),
                         ("model.language_model.", "language_model.model.")):
            if k.startswith(new):
                k = old + k[len(new):]
        out[k] = v
    return out


@pytest.fixture(scope="module")
def internvl_tok(tmp_path_factory):
    return stage_tokenizer(str(tmp_path_factory.mktemp("internvl_tok")), INTERNVL_WORDS,
                           INTERNVL_SPECIALS)


@pytest.mark.parametrize("text,layout", [("qwen2", "state_dict"), ("qwen3", "legacy"),
                                         ("qwen3_moe", "state_dict")])
def test_internvl_checkpoint_matches_hf(tmp_path, internvl_tok, text, layout):
    """checkpoint= of the HF directory (the registry's real names with the
    test configs): the tile's features against HF's ``get_image_features``
    (3e-5) and P(first answer token) on the ids the adapter builds (1e-5)."""
    from t2v_metrics_tpu_torch.models import internvl as tivl

    hf, test_name, cfg = _internvl_hf(text)
    sd = hf.state_dict() if layout == "state_dict" else _legacy_layout(hf.state_dict())
    path = stage_safetensors(sd, str(tmp_path / "ckpt"))
    hf.config.to_json_file(os.path.join(path, "config.json"))
    name = {"qwen2": "internvl3-8b", "qwen3": "internvl3.5-8b",
            "qwen3_moe": "internvl3.5-30b-a3b"}[text]
    s = tt2v.VQAScore(name, config=cfg, checkpoint=path, tokenizer=internvl_tok, device="cpu",
                      dtype=torch.float32)
    a = s.model
    assert type(a.tokenizer).__name__ == "PreTrainedTokenizerFast"
    assert (a.params.vision.blocks[0].qkv is None) == (text == "qwen3_moe")
    img = np.random.default_rng(3).integers(0, 256, (INTERNVL_IMG, INTERNVL_IMG, 3), np.uint8)
    got = s(images=[img], texts=TEXTS)
    tiles = tivl.preprocess_tiles(torch.from_numpy(img.reshape(INTERNVL_IMG, -1)))[None]
    px = tiles.reshape(1, INTERNVL_IMG, INTERNVL_IMG, 3).permute(0, 3, 1, 2)
    with torch.no_grad():
        ref_feats = hf.model.get_image_features(px)
    ours = a._encode_visuals([img], 32)[0][1]
    np.testing.assert_allclose(ours.numpy(), ref_feats.reshape(ours.shape).numpy(),
                               atol=TOWER_ATOL, rtol=0)
    for j, text_ in enumerate(TEXTS):
        prompt = a._build_ids('Does this figure show "{}"? Please answer Yes or No.'.format(
            text_), 1)
        answer = a._encode_text("Yes")[0]
        with torch.no_grad():
            logits = hf(input_ids=torch.tensor([prompt + [answer]]), pixel_values=px).logits
        ref = float(torch.log_softmax(logits.float(), -1)[0, len(prompt) - 1, answer])
        assert abs(np.log(got[0, j]) - ref) <= SCORE_ATOL, (text_, np.log(got[0, j]), ref)


def test_internvl_moe_layouts_load_the_same(tmp_path):
    """Both MoE key layouts convert to the same experts: per-expert modules
    (Qwen3MoE, as HF writes them) and packed ``experts.gate_up_proj`` (E, H,
    2I) / ``experts.down_proj`` (E, I, H) (Qwen3VLMoe-style)."""
    hf, _, cfg = _internvl_hf("qwen3_moe")
    sd = dict(hf.state_dict())
    for i in range(cfg.text.layers):
        b = f"model.language_model.layers.{i}.mlp.experts"
        ex = range(cfg.text.num_experts)
        sd[f"{b}.gate_up_proj"] = torch.stack([torch.cat(
            [sd.pop(f"{b}.{e}.gate_proj.weight").t(), sd.pop(f"{b}.{e}.up_proj.weight").t()],
            dim=1) for e in ex])
        sd[f"{b}.down_proj"] = torch.stack([sd.pop(f"{b}.{e}.down_proj.weight").t() for e in ex])
    kw = dict(config=cfg, device="cpu", dtype=torch.float32,
              tokenizer=tt2v.SimpleT5Tokenizer(512))
    packed = tt2v.VQAScore("internvl3.5-30b-a3b", checkpoint=stage_safetensors(
        sd, str(tmp_path / "packed")), **kw).model.params.state_dict()
    split = tt2v.VQAScore("internvl3.5-30b-a3b", checkpoint=stage_safetensors(
        hf.state_dict(), str(tmp_path / "split")), **kw).model.params.state_dict()
    assert packed.keys() == split.keys()
    for k in packed:
        assert torch.equal(packed[k], split[k]), k


# ---------------------------------------------------------------------------
# Every family: native trees, adoption, errors
# ---------------------------------------------------------------------------

def _family(name):
    """(registry name, config, HF model, its state dict layout)."""
    if name == "qwen2.5-vl":
        hf, cfg = _qwen2_hf()
        return "qwen2.5-vl-7b", cfg, hf
    if name.startswith("qwen3-vl"):
        hf, cfg = _qwen3_hf(name.endswith("moe"))
        return ("qwen3-vl-30b-a3b" if name.endswith("moe") else "qwen3-vl-8b"), cfg, hf
    if name.startswith("internvl"):
        hf, _, cfg = _internvl_hf("qwen3_moe")
        return "internvl3.5-30b-a3b", cfg, hf
    hf, cfg = _gemma_hf()
    return "gemma-3-4b-it", cfg, hf


@pytest.mark.parametrize("family", ["qwen2.5-vl", "qwen3-vl", "qwen3-vl-moe", "gemma-3",
                                    "internvl3.5-moe"])
def test_native_tree_equals_hf_directory(tmp_path, qwen_tok, family):
    """A native tree written by the port's save_params (in bf16: the |V2
    records) from the family's converter loads to the same parameters as the
    HF directory it came from, cast to bf16 there."""
    name, cfg, hf = _family(family)
    path = stage_safetensors(hf.state_dict(), str(tmp_path / "hf"))
    kw = dict(config=cfg, device="cpu", dtype=torch.bfloat16, tokenizer=tt2v.SimpleT5Tokenizer())
    from_hf = tt2v.VQAScore(name, checkpoint=path, **kw).model.params
    from t2v_metrics_tpu_torch.models import internvl as tivl

    convert = {"qwen2.5-vl": tq2.convert_qwen2vl, "gemma-3": tg3.convert_gemma3,
               "internvl3.5-moe": tivl.convert_internvl}.get(family, tq3.convert_qwen3vl)
    sd = {k: v.to(torch.bfloat16) for k, v in ckpt.load_hf_state_dict(path).items()}
    ckpt.save_params(convert(sd, cfg), str(tmp_path / "native"))
    from_native = tt2v.VQAScore(name, checkpoint=str(tmp_path / "native"), **kw).model.params
    want, got = from_hf.state_dict(), from_native.state_dict()
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == torch.bfloat16 and torch.equal(got[k], want[k]), k


def test_qwen35_adopts_config_json_dims(tmp_path, qwen_tok):
    """qwen3.5's registry dims are provisional: the checkpoint's config.json
    text dims replace them, with the JAX adapter's warning."""
    hf, cfg = _qwen3_hf(False)
    path = _qwen_dir(tmp_path, hf, "state_dict")
    guess = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, layers=2, d_ff=80))
    with pytest.warns(UserWarning, match=r"qwen3.5-4b: adopted checkpoint dims over the "
                      r"provisional registry values: text.d_ff 80 -> 96, text.layers 2 -> 3"):
        s = tt2v.VQAScore("qwen3.5-4b", config=guess, checkpoint=path, tokenizer=qwen_tok,
                          device="cpu", dtype=torch.float32)
    assert s.model.config.text.layers == 3 and len(s.model.params.decoder.blocks) == 3


@pytest.mark.parametrize("family", ["qwen2.5-vl", "gemma-3"])
def test_missing_keys_are_named_with_the_path(tmp_path, family):
    name, cfg, hf = _family(family)
    sd = {k: v for k, v in hf.state_dict().items() if ".layers.1." not in k}
    path = stage_safetensors(sd, str(tmp_path / "partial"))
    with pytest.raises(ckpt.CheckpointError) as ei:
        tt2v.VQAScore(name, config=cfg, checkpoint=path, device="cpu")
    msg = str(ei.value)
    assert path in msg and ".layers.1.self_attn.q_proj.weight" in msg


# ---------------------------------------------------------------------------
# CLIPScore and ITMScore (bars: tests/test_clip_parity.py and
# tests/test_blip2_itm_parity.py: towers 2e-5 / 3e-5, CLIP's cosine matrix
# 1e-3, P(match) 1e-5)
# ---------------------------------------------------------------------------

CLIP_WORDS = "a photo of cat two dogs on grass red cube"
CLIP_VCFG = tclip.CLIPVisionConfig(image_size=32, patch_size=8, width=32, layers=2,
                                   heads=4, mlp_dim=64, proj_dim=24)


def stage_clip_tokenizer(path: str, words: str) -> tuple[str, int]:
    """A word-level tokenizer.json in CLIP's layout: ``<|startoftext|>``
    before and ``<|endoftext|>`` (the highest id, where CLIP pools) after
    every text. Returns (path, vocabulary size)."""
    from tokenizers import AddedToken, Tokenizer, models, pre_tokenizers, processors

    os.makedirs(path, exist_ok=True)
    vocab = {"<pad>": 0, "<unk>": 1}
    for w in words.split():
        vocab.setdefault(w, len(vocab))
    sot, eot = len(vocab), len(vocab) + 1
    vocab.update({"<|startoftext|>": sot, "<|endoftext|>": eot})
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.add_special_tokens([AddedToken(s, special=True)
                            for s in ("<|startoftext|>", "<|endoftext|>")])
    tok.post_processor = processors.TemplateProcessing(
        single="<|startoftext|> $A <|endoftext|>",
        special_tokens=[("<|startoftext|>", sot), ("<|endoftext|>", eot)])
    tok.save(os.path.join(path, "tokenizer.json"))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", "pad_token": "<pad>",
                   "unk_token": "<unk>", "model_max_length": 77}, f)
    return path, len(vocab)


@pytest.fixture(scope="module")
def clip_dirs(tmp_path_factory):
    from transformers import CLIPConfig, CLIPModel

    root = tmp_path_factory.mktemp("clipscore")
    tok, vocab = stage_clip_tokenizer(str(root / "tok"), CLIP_WORDS)
    torch.manual_seed(3)
    hf = CLIPModel(CLIPConfig(
        text_config=dict(vocab_size=vocab, hidden_size=32, intermediate_size=64,
                         num_hidden_layers=2, num_attention_heads=4,
                         max_position_embeddings=16, hidden_act="quick_gelu",
                         eos_token_id=vocab - 1),
        vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                           num_attention_heads=4, image_size=32, patch_size=8,
                           hidden_act="quick_gelu"),
        projection_dim=24)).eval()
    tcfg = tclip.CLIPTextConfig(vocab_size=vocab, context_length=16, width=32, layers=2,
                                heads=4, mlp_dim=64, proj_dim=24)
    path = stage_safetensors(hf.state_dict(), str(root / "ckpt"))
    return hf, path, tok, tcfg


def _clip_pixels(imgs):
    """The CLIP normalisation of size-matched uint8 images, NCHW for HF."""
    px = (np.stack(imgs).astype(np.float32) / 255.0 - np.asarray(CLIP_MEAN, np.float32)) \
        / np.asarray(CLIP_STD, np.float32)
    return torch.from_numpy(px.transpose(0, 3, 1, 2).copy())


def test_clipscore_checkpoint_matches_hf(clip_dirs):
    hf, path, tok, tcfg = clip_dirs
    s = tt2v.CLIPScore("openai:ViT-B-32", checkpoint=path, tokenizer=tok,
                       vision_config=CLIP_VCFG, text_config=tcfg, device="cpu",
                       dtype=torch.float32)
    eng = s.model.engine
    assert eng.tokenizer.__class__.__name__ == "PreTrainedTokenizerFast"
    rng = np.random.default_rng(8)
    imgs = [rng.integers(0, 256, (32, 32, 3), dtype=np.uint8) for _ in range(2)]
    texts = ["a photo of cat", "two dogs on grass", "red cube"]
    got = s(images=imgs, texts=texts)
    ids = torch.from_numpy(eng._tokenize(texts)).long()
    with torch.no_grad():
        imf = hf.get_image_features(pixel_values=_clip_pixels(imgs))
        txf = hf.get_text_features(input_ids=ids)
        ref = ((imf / imf.norm(dim=-1, keepdim=True))
               @ (txf / txf.norm(dim=-1, keepdim=True)).T).numpy()
        ours_i = tclip.vision_tower(eng.params.vision, CLIP_VCFG,
                                    _clip_pixels(imgs).permute(0, 2, 3, 1).reshape(2, 32, 96))
        ours_t = tclip.text_tower(eng.params.text, tcfg, ids)
    np.testing.assert_allclose(ours_i.numpy(), imf.numpy(), atol=2e-5, rtol=0)
    np.testing.assert_allclose(ours_t.numpy(), txf.numpy(), atol=2e-5, rtol=0)
    assert got.shape == (2, 3)
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)
    assert abs(s.model.engine.params.logit_scale.item() - hf.logit_scale.item()) == 0


ITM_WORDS = "a photo of cat two dogs on grass red cube [CLS] [SEP]"


@pytest.fixture(scope="module")
def itm_dirs(tmp_path_factory):
    from transformers import Blip2ForImageTextRetrieval
    from transformers.models.blip_2.configuration_blip_2 import Blip2Config

    from t2v_metrics_tpu_torch.models import blip2_itm as tbitm

    root = tmp_path_factory.mktemp("itm")
    tok = stage_tokenizer(str(root / "tok"), ITM_WORDS, t5=True)
    torch.manual_seed(4)
    hf = Blip2ForImageTextRetrieval(Blip2Config(
        vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                           num_attention_heads=4, image_size=28, patch_size=14,
                           hidden_act="gelu"),
        qformer_config=dict(vocab_size=256, hidden_size=32, intermediate_size=64,
                            num_hidden_layers=2, num_attention_heads=4,
                            cross_attention_frequency=2, max_position_embeddings=64,
                            hidden_act="gelu", use_qformer_text_input=True),
        num_query_tokens=4, image_token_index=None)).eval()
    cfg = tbitm.BLIP2_ITM_MODELS["blip2-itm-test"]["config"]
    path = stage_safetensors(hf.state_dict(), str(root / "ckpt"))
    return hf, path, tok, cfg


def test_itmscore_checkpoint_matches_hf(itm_dirs):
    from t2v_metrics_tpu_torch.models import blip2_itm as tbitm

    hf, path, tok, cfg = itm_dirs
    s = tt2v.ITMScore("blip2-itm", config=cfg, checkpoint=path, tokenizer=tok,
                      device="cpu", dtype=torch.float32)
    assert s.model.tokenizer.__class__.__name__ == "PreTrainedTokenizerFast"
    rng = np.random.default_rng(9)
    imgs = [rng.integers(0, 256, (28, 28, 3), dtype=np.uint8) for _ in range(2)]
    texts = ["a photo of cat", "two dogs on grass red cube"]
    got = s(images=imgs, texts=texts)
    px = _clip_pixels(imgs)
    ids, mask = s.model._tokenize(texts * 2)
    with torch.no_grad():
        ref_tower = hf.vision_model(px).last_hidden_state.numpy()
        ours_tower = tbitm.vision_tower(s.model.params.vision, cfg.vision,
                                        px.permute(0, 2, 3, 1).reshape(2, 28, 84)).numpy()
        out = hf(pixel_values=px.repeat_interleave(2, dim=0), input_ids=torch.from_numpy(ids),
                 attention_mask=torch.from_numpy(mask).long(),
                 use_image_text_matching_head=True)
        ref = torch.softmax(out.logits_per_image.float(), dim=1)[:, 1].numpy()
    np.testing.assert_allclose(ours_tower, ref_tower, atol=3e-5, rtol=0)
    assert got.shape == (2, 2)
    # pairs in score_matrix order: image 0 with both texts, then image 1;
    # the reference rows pair image i // 2 with text (i % 2) of texts * 2
    np.testing.assert_allclose(got.ravel(), ref, atol=SCORE_ATOL, rtol=0)
