"""The port's checkpoint layer (``models/checkpoint.py``, ``models/convert.py``,
``bridge.py``) on the CPU.

  * the safetensors reader against the ``safetensors`` writers, bitwise, on
    every dtype it takes; shards with and without the index; ``*.bin``
    shards; laziness (nothing mapped before a key is indexed, no page read
    before a view is used) and the page release;
  * ``save_params`` / ``load_params`` round trips, including trees the JAX
    ``save_params`` writes in f32 and in bf16 (``|V2`` records);
  * the shape checks and dim adoption, against the JAX package's functions
    on the same trees (``tests/test_dim_adoption.py``'s units);
  * local snapshot resolution and each error path;
  * ``chip_smoke.py``'s own HF key map and safetensors writer at a tiny
    config: the HF state dict's exact keys and shapes, loaded back bitwise;
  * the bridge: tensor leaves, bf16 kept bitwise; the shape check, the
    family's loader run onto the meta device, against JAX-made trees of
    every family, and a JAX-written clip-flant5 tree scored as in JAX;
  * CLIPScore and ITMScore: JAX-made trees through the shape check, native
    trees against the HF directories they came from, the pretrained
    default (weights and tokenizer) from a local snapshot, missing keys.
"""

import copy
import dataclasses
import gc
import json
import os
import sys
import warnings

import numpy as np
import pytest
import torch

import chip_smoke
import t2v_metrics_tpu_torch as tt2v
from t2v_metrics_tpu_torch import bridge
from t2v_metrics_tpu_torch.models import checkpoint as ckpt
from t2v_metrics_tpu_torch.models import clip_flant5 as tcft5
from t2v_metrics_tpu_torch.models import decoder as tdec
from t2v_metrics_tpu_torch.models import qwen3vl as tq3

from test_torch_hf_parity import (CLIP_T5_CFG, CLIP_VCFG, JAX_ATOL, JAX_RTOL,  # noqa: F401
                                  clip_dirs, clip_t5_hf, itm_dirs, stage_bin,
                                  stage_safetensors, stage_snapshot)

ST_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
             "I64": torch.int64, "I32": torch.int32, "U8": torch.uint8, "BOOL": torch.bool}


def _sample(dtype: torch.dtype, shape, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        return torch.rand(shape, generator=g) > 0.5
    if dtype.is_floating_point:
        return (torch.randn(shape, generator=g) * 3).to(dtype)
    return torch.randint(0, 250, shape, generator=g).to(dtype)


def _rss_file_kb() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("RssFile:"):
                return int(line.split()[1])
    return -1


# ---------------------------------------------------------------------------
# The safetensors reader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(ST_DTYPES))
def test_reader_matches_safetensors_torch_bitwise(tmp_path, name):
    from safetensors.torch import save_file

    dtype = ST_DTYPES[name]
    tensors = {f"t{i}": _sample(dtype, shape, i)
               for i, shape in enumerate([(3, 5), (7,), (2, 3, 4), (1,)])}
    save_file(tensors, str(tmp_path / "model.safetensors"))
    sd = ckpt.load_safetensors_dict(str(tmp_path))
    assert set(sd) == set(tensors)
    for k, t in tensors.items():
        got = sd[k]
        assert got.dtype == dtype and got.shape == t.shape
        assert torch.equal(got.view(torch.uint8) if dtype != torch.bool else got,
                           t.view(torch.uint8) if dtype != torch.bool else t)


def test_reader_matches_safetensors_numpy(tmp_path):
    from safetensors.numpy import save_file

    rng = np.random.default_rng(0)
    arrays = {"f32": rng.standard_normal((4, 6)).astype(np.float32),
              "f16": rng.standard_normal((5,)).astype(np.float16),
              "i64": rng.integers(-9, 9, (3, 2)).astype(np.int64),
              "i32": rng.integers(-9, 9, (8,)).astype(np.int32),
              "u8": rng.integers(0, 255, (2, 2, 2)).astype(np.uint8),
              "bool": rng.random((6,)) > 0.5}
    save_file(arrays, str(tmp_path / "a.safetensors"))
    sd = ckpt.load_safetensors_dict(str(tmp_path))
    for k, a in arrays.items():
        np.testing.assert_array_equal(sd[k].numpy(), a)
        assert sd[k].numpy().dtype == a.dtype


def test_reader_refuses_other_dtypes_by_name(tmp_path):
    from safetensors.torch import save_file

    save_file({"ok": torch.ones(2), "d": torch.ones(2, dtype=torch.float64)},
              str(tmp_path / "m.safetensors"))
    sd = ckpt.load_safetensors_dict(str(tmp_path))
    assert torch.equal(sd["ok"], torch.ones(2))
    with pytest.raises(ckpt.CheckpointError, match="F64"):
        sd["d"]


@pytest.mark.parametrize("index", [True, False], ids=["index", "sorted_files"])
def test_reader_shards(tmp_path, index):
    tensors = {f"layer.{i}.w": _sample(torch.bfloat16, (4, i + 1), i) for i in range(7)}
    stage_safetensors(tensors, str(tmp_path), shards=3, index=index)
    sd = ckpt.load_safetensors_dict(str(tmp_path))
    assert len(sd.files) == 3 and set(sd) == set(tensors)
    for k, t in tensors.items():
        assert torch.equal(sd[k], t)
    assert dict(ckpt.iter_safetensors(str(tmp_path))).keys() == tensors.keys()


def test_reader_index_errors(tmp_path):
    tensors = {"a": torch.ones(2), "b": torch.zeros(3)}
    stage_safetensors(tensors, str(tmp_path), shards=2)
    idx = tmp_path / "model.safetensors.index.json"
    wm = json.loads(idx.read_text())
    wm["weight_map"]["ghost"] = wm["weight_map"]["a"]
    idx.write_text(json.dumps(wm))
    with pytest.raises(ckpt.CheckpointError, match="ghost"):
        ckpt.load_safetensors_dict(str(tmp_path))
    wm["weight_map"] = {"a": "model-00009-of-00009.safetensors"}
    idx.write_text(json.dumps(wm))
    with pytest.raises(ckpt.CheckpointError, match="model-00009"):
        ckpt.load_safetensors_dict(str(tmp_path))


@pytest.mark.parametrize("index", [True, False], ids=["index", "sorted_files"])
def test_bin_shards(tmp_path, index):
    tensors = {f"w{i}": _sample(torch.float32, (3, 2), i) for i in range(5)}
    stage_bin(tensors, str(tmp_path), shards=2)
    if not index:
        os.remove(tmp_path / "pytorch_model.bin.index.json")
    sd = ckpt.load_hf_state_dict(str(tmp_path))
    assert isinstance(sd, ckpt.BinDict) and set(sd) == set(tensors)
    for k, t in tensors.items():
        assert torch.equal(sd[k], t)


def test_reader_is_lazy_and_zero_copy(tmp_path):
    """Only headers are read at construction; indexing maps the shard but
    reads no byte; the view is one of the mapping; pages become resident
    only when the view is read, and release_pages hands them back."""
    from safetensors.torch import save_file

    big = torch.arange(32 * 2 ** 20 // 4, dtype=torch.float32).reshape(-1, 1024)  # 32 MiB
    save_file({"big": big, "small": torch.ones(3)}, str(tmp_path / "m.safetensors"))
    before = set(ckpt._MAPPED)
    sd = ckpt.load_safetensors_dict(str(tmp_path))
    assert list(sd) and len(sd) == 2 and set(ckpt._MAPPED) == before   # nothing mapped
    rss0 = _rss_file_kb()
    view = sd["big"]
    owner, addr = ckpt._MAPPED[view.untyped_storage().data_ptr()]
    length = len(owner())
    assert addr <= view.data_ptr() < addr + length                    # its own map
    assert length < 32 * 2 ** 20 + 2 * 4096                           # that tensor only
    assert _rss_file_kb() - rss0 < 4 * 1024                           # no page read
    total = float(view.sum(dtype=torch.float64))
    assert total == float(big.sum(dtype=torch.float64))
    touched = _rss_file_kb() - rss0
    assert touched > 24 * 1024                                        # read on use
    ckpt.release_pages(view)
    assert _rss_file_kb() - rss0 < touched - 24 * 1024               # handed back
    assert torch.equal(view, big)                                     # re-read intact
    ckpt.release_pages(big)                                           # not mapped: no-op
    assert big[0, 1] == 1
    half = view[:8]
    del view, sd
    assert owner() is not None and half[0, 1] == 1                    # a view holds the map
    del half
    gc.collect()
    assert owner() is None                                            # unmapped with its views


def test_loading_hands_mapped_pages_back(tmp_path, monkeypatch):
    """Through the adapter: the lazy dict is gone by the time the bridge
    copies the converted views, and each leaf's mapped pages still go back
    right after its copy, so the file-backed RSS never holds more than about
    one leaf (the copies on the CPU are anonymous memory)."""
    from test_torch_hf_parity import CLIP_T5_CFG, clip_t5_hf

    cfg = dataclasses.replace(CLIP_T5_CFG, t5=dataclasses.replace(CLIP_T5_CFG.t5,
                                                                   vocab_size=65536))
    sd = dict(clip_t5_hf()[3])
    g = torch.Generator().manual_seed(0)
    for k in ("shared.weight", "encoder.embed_tokens.weight", "decoder.embed_tokens.weight",
              "lm_head.weight"):
        sd[k] = torch.randn(65536, 48, generator=g)   # 12 MiB each
    path = stage_safetensors(sd, str(tmp_path / "ckpt"))
    after_leaf = []

    def release(t):
        ckpt.release_pages(t)
        after_leaf.append(_rss_file_kb())

    monkeypatch.setattr(bridge, "release_pages", release)
    rss0 = _rss_file_kb()
    s = tt2v.VQAScore("clip-flant5-xl", config=cfg, checkpoint=path, device="cpu",
                      dtype=torch.float32)
    assert len(after_leaf) > 40 and max(after_leaf) - rss0 < 8 * 1024   # KiB
    assert torch.equal(s.model.engine.params.t5.shared_emb, sd["shared.weight"])


# ---------------------------------------------------------------------------
# The native format
# ---------------------------------------------------------------------------

def _tree(dtype):
    g = torch.Generator().manual_seed(3)
    return {"a": {"w": torch.randn(4, 3, generator=g).to(dtype), "b": None},
            "blocks": [{"s": torch.randn(5, generator=g).to(dtype)},
                       {"s": torch.randn(5, generator=g).to(dtype)}],
            "ids": torch.arange(6, dtype=torch.int32)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_native_round_trip(tmp_path, dtype):
    tree = _tree(dtype)
    ckpt.save_params(tree, str(tmp_path))
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert ("dtypes" in manifest) and (bool(manifest["dtypes"]) == (dtype == torch.bfloat16))
    back = ckpt.load_params(str(tmp_path))
    flat, flat_b = ckpt._flatten(tree), ckpt._flatten(back)
    assert flat.keys() == flat_b.keys() and back["a"]["b"] is None
    for k, v in flat.items():
        if v is not None:
            assert flat_b[k].dtype == v.dtype and torch.equal(flat_b[k], v), k
    cast = ckpt.load_params(str(tmp_path), dtype=torch.float32)
    assert cast["a"]["w"].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_params_reads_jax_written_trees(tmp_path, dtype):
    """The JAX save_params writes bf16 as |V2 records and loses the dtype;
    the port reads them as bf16 bits."""
    import jax
    import jax.numpy as jnp

    from t2v_metrics_tpu.models import checkpoint as jckpt

    key = jax.random.PRNGKey(0)
    tree = {"w": jax.random.normal(key, (6, 4)).astype(dtype),
            "layers": [{"s": jnp.arange(3, dtype=dtype)}], "none": None}
    jckpt.save_params(tree, str(tmp_path))
    if dtype == "bfloat16":
        npz = np.load(tmp_path / "arrays.npz")
        assert npz["w"].dtype.kind == "V" and npz["w"].dtype.itemsize == 2
    back = ckpt.load_params(str(tmp_path))
    want = np.asarray(tree["w"].astype(jnp.float32))
    assert back["w"].dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    np.testing.assert_array_equal(back["w"].float().numpy(), want)
    np.testing.assert_array_equal(back["layers"][0]["s"].float().numpy(), [0, 1, 2])
    assert back["none"] is None


def test_port_written_tree_reads_in_jax(tmp_path):
    """f32 leaves of a port-written tree read in the JAX loader, which ignores
    the manifest's dtypes."""
    from t2v_metrics_tpu.models import checkpoint as jckpt

    tree = _tree(torch.float32)
    ckpt.save_params(tree, str(tmp_path))
    back = jckpt.load_params(str(tmp_path))
    np.testing.assert_array_equal(np.asarray(back["a"]["w"]), tree["a"]["w"].numpy())


def test_load_params_errors(tmp_path):
    with pytest.raises(ckpt.CheckpointError, match="manifest.json"):
        ckpt.load_params(str(tmp_path))
    ckpt.save_params({"a": torch.ones(2)}, str(tmp_path))
    m = json.loads((tmp_path / "manifest.json").read_text())
    m["keys"].append("ghost")
    (tmp_path / "manifest.json").write_text(json.dumps(m))
    with pytest.raises(ckpt.CheckpointError, match="ghost"):
        ckpt.load_params(str(tmp_path))


# ---------------------------------------------------------------------------
# Shape checks and dim adoption (tests/test_dim_adoption.py's units)
# ---------------------------------------------------------------------------

def _gemma4_trees():
    import jax

    from t2v_metrics_tpu.models import gemma4 as g4

    base = g4.GEMMA4_MODELS["gemma-4-test"]["config"]
    big = dataclasses.replace(
        base,
        text=dataclasses.replace(base.text, layers=4, d_ff=128, vocab_size=600, heads=6,
                                 kv_heads=3, head_dim=8, layer_types=None,
                                 sliding_window=None),
        vision=dataclasses.replace(base.vision, layers=3, mlp_dim=80))
    params = jax.tree.map(np.asarray, g4.init_gemma4(jax.random.PRNGKey(0), big))
    return base, params


def test_adopt_dims_match_jax():
    from t2v_metrics_tpu.models import checkpoint as jckpt

    reg, params = _gemma4_trees()
    tparams = jax_tree_to_torch(params)
    for fn, sub, cfg in (("adopt_decoder_dims", "decoder", reg.text),
                         ("adopt_vision_dims", "vision", reg.vision)):
        want_cfg, want = getattr(jckpt, fn)(params[sub], cfg)
        got_cfg, got = getattr(ckpt, fn)(tparams[sub], cfg)
        assert got == want and got_cfg == want_cfg, fn
    new_text, changed = ckpt.adopt_decoder_dims(tparams["decoder"], reg.text)
    assert set(changed) == {"layers", "d_ff", "vocab_size", "heads", "kv_heads", "head_dim"}
    assert new_text.head_dim == 8
    same, ch = ckpt.adopt_decoder_dims(tparams["decoder"], new_text)
    assert ch == {} and same is new_text


def jax_tree_to_torch(tree):
    if isinstance(tree, dict):
        return {k: jax_tree_to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [jax_tree_to_torch(v) for v in tree]
    return None if tree is None else torch.from_numpy(np.array(tree, np.float32))


def _jax_family(family: str, cfg_fn=None):
    """(numpy tree made by the JAX package's init, the port's config, the
    port's loader onto the meta device) of a family's test config;
    ``cfg_fn`` changes the config of both packages first."""
    import jax

    from t2v_metrics_tpu.models import clip_flant5 as jcft5
    from t2v_metrics_tpu.models import gemma3 as jg3
    from t2v_metrics_tpu.models import qwen2vl as jq2
    from t2v_metrics_tpu.models import qwen3vl as jq3
    from t2v_metrics_tpu.models.adapters import CLIP_T5_MODELS as J_CLIP_T5
    from t2v_metrics_tpu_torch.models import gemma3 as tg3
    from t2v_metrics_tpu_torch.models import qwen2vl as tq2
    from t2v_metrics_tpu_torch.models.adapters import CLIP_T5_MODELS

    cfg_fn = cfg_fn or (lambda c: c)
    if family == "clip_t5":
        jcfg, cfg = J_CLIP_T5["clip-flant5-test"]["config"], \
            CLIP_T5_MODELS["clip-flant5-test"]["config"]
        init, load = jcft5.init_clip_t5, bridge.clip_t5_from_numpy
    elif family == "qwen2vl":
        jcfg = jq2.QWEN2_VL_MODELS["qwen2.5-vl-test"]["config"]
        cfg = tq2.QWEN2_VL_MODELS["qwen2.5-vl-test"]["config"]
        init, load = jq2.init_qwen2vl, bridge.qwen2vl_from_numpy
    elif family.startswith("qwen3vl"):
        name = "qwen3-vl-moe-test" if family.endswith("moe") else "qwen3-vl-test"
        jcfg, cfg = jq3.resolve_config(name), tq3.resolve_config(name)
        init, load = jq3.init_qwen3vl, bridge.qwen3vl_from_numpy
    else:
        jcfg = jg3.GEMMA3_MODELS["gemma-3-test"]["config"]
        cfg = tg3.GEMMA3_MODELS["gemma-3-test"]["config"]
        init, load = jg3.init_gemma3, bridge.gemma3_from_numpy
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), cfg_fn(jcfg)))
    cfg = cfg_fn(cfg)
    return tree, cfg, lambda t: load(t, cfg, "meta", torch.float32)


def test_adopt_decoder_dims_moe_and_layer_types():
    tree, cfg, _ = _jax_family("qwen3vl_moe")
    same, ch = ckpt.adopt_decoder_dims(tree["decoder"], cfg.text)
    assert ch == {} and same is cfg.text
    small = dataclasses.replace(cfg.text, num_experts=2, moe_d_ff=16, layers=5,
                                layer_types=("full_attention",) * 3)
    new, ch = ckpt.adopt_decoder_dims(tree["decoder"], small)
    assert ch == {"num_experts": (2, 4), "moe_d_ff": (16, 32), "layers": (5, 3)}
    assert new.layer_types == ("full_attention",) * 3


def test_adopt_config_json_matches_jax():
    from t2v_metrics_tpu.models import checkpoint as jckpt

    assert ckpt._HF_DECODER_KEYS == jckpt._HF_DECODER_KEYS
    assert ckpt._HF_VISION_KEYS == jckpt._HF_VISION_KEYS
    cfg = tdec.DecoderConfig(rms_eps=1e-6, rope_theta=1e6)
    cj = {"rms_norm_eps": 1e-5, "rope_theta": 10000.0,
          "layer_types": ["full_attention", "sliding_attention"], "unknown_key": 7,
          "head_dim": None}
    new, changed = ckpt.adopt_config_json(cj, cfg, ckpt._HF_DECODER_KEYS)
    assert new.rms_eps == 1e-5 and new.rope_theta == 10000.0
    assert new.layer_types == ("full_attention", "sliding_attention")
    assert set(changed) == {"rms_eps", "rope_theta", "layer_types"}
    same, ch = ckpt.adopt_config_json({}, cfg, ckpt._HF_DECODER_KEYS)
    assert same is cfg and ch == {}


def test_validate_params_dims_reports_every_leaf():
    """One pass of the loader onto the meta device names every leaf at fault:
    misshapen, missing (absent or None, also a whole sub-tree or block),
    packed parts that do not fill their leaf, and leaves never read."""
    tree, cfg, load = _jax_family("qwen3vl")
    ckpt.validate_params_dims(tree, load, "qwen3-vl-test")       # clean
    bad = copy.deepcopy(tree)
    gate = bad["decoder"]["blocks"][1]["mlp"]["gate"]
    gate["w"] = np.zeros((gate["w"].shape[0], gate["w"].shape[1] - 16), np.float32)
    bad["vision"]["pos_emb"] = None
    del bad["vision"]["blocks"][0]["attn"]["o"]
    q = bad["decoder"]["blocks"][0]["attn"]["q"]
    q["w"] = q["w"][:, :-8]
    last = bad["decoder"]["blocks"].pop()
    bad["decoder"]["extra"] = np.zeros(2, np.float32)
    with pytest.raises(ValueError) as ei:
        ckpt.validate_params_dims(bad, load, "qwen3-vl-test", provisional=True)
    msg = str(ei.value)
    assert "shape mismatch: decoder/blocks/1/mlp/gate/w" in msg
    assert "missing: vision/pos_emb" in msg and "unexpected: decoder/extra (2,)" in msg
    assert "missing: vision/blocks/0/attn/o/w" in msg
    assert "missing: vision/blocks/0/attn/o/b" in msg
    assert "shape mismatch: decoder/blocks/0/attn/q/w | decoder/blocks/0/attn/k/w" in msg
    n = len(bad["decoder"]["blocks"])
    assert f"missing: decoder/blocks/{n}/mlp/down/w" in msg
    n_last = sum(v is not None for v in ckpt._flatten(last).values())
    assert f"({n_last + 6} problem(s))" in msg
    assert "PROVISIONAL" in msg


def test_load_with_adopted_dims(tmp_path):
    """A native Qwen3-VL tree of other dims adopts them (with a warning naming
    each field) and config.json outranks the registry."""
    reg = tq3.resolve_config("qwen3-vl-test")
    tree, _, _ = _jax_family("qwen3vl", lambda c: dataclasses.replace(
        c, text=dataclasses.replace(c.text, layers=2, d_ff=64)))
    ckpt.save_params(tree, str(tmp_path))
    (tmp_path / "config.json").write_text(json.dumps({"text_config": {"rms_norm_eps": 3e-5}}))

    def load(t, cfg):
        return bridge.qwen3vl_from_numpy(t, cfg, "meta", torch.float32)

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        params, cfg = ckpt.load_with_adopted_dims(str(tmp_path), reg, load, "qwen3.5-test")
    msg = next(str(x.message) for x in w if "adopted checkpoint dims" in str(x.message))
    assert "text.layers 3 -> 2" in msg and "text.d_ff 96 -> 64" in msg
    assert cfg.text.layers == 2 and cfg.text.d_ff == 64 and cfg.text.rms_eps == 3e-5
    np.testing.assert_array_equal(params["decoder"]["embed"].numpy(), tree["decoder"]["embed"])


# ---------------------------------------------------------------------------
# Snapshots and error paths
# ---------------------------------------------------------------------------

@pytest.fixture
def caches(tmp_path, monkeypatch):
    dirs = {name: tmp_path / name for name in ("hub_cache", "hf_home", "home", "t2v")}
    monkeypatch.setenv("HF_HUB_CACHE", str(dirs["hub_cache"]))
    monkeypatch.setenv("HF_HOME", str(dirs["hf_home"]))
    monkeypatch.setenv("HOME", str(dirs["home"]))
    monkeypatch.setenv("T2V_TPU_CACHE", str(dirs["t2v"]))
    return dirs


def test_hub_cache_order(caches, tmp_path):
    got = ckpt.hub_cache_dirs(str(tmp_path / "explicit"))
    assert got == [str(tmp_path / "explicit"), str(caches["hub_cache"]),
                   os.path.join(str(caches["hf_home"]), "hub"),
                   os.path.join(str(caches["home"]), ".cache", "huggingface", "hub"),
                   str(caches["t2v"])]


def test_resolve_snapshot(caches, tmp_path):
    repo = "org/model-x"
    with pytest.raises(ckpt.CheckpointError) as ei:
        ckpt.resolve_snapshot(repo)
    for d in ckpt.hub_cache_dirs():
        assert os.path.join(d, "models--org--model-x") in str(ei.value)
    late = stage_snapshot(str(caches["t2v"]), repo, rev="late")
    assert ckpt.resolve_snapshot(repo) == late
    home = stage_snapshot(os.path.join(str(caches["home"]), ".cache", "huggingface", "hub"),
                          repo, rev="home")
    assert ckpt.resolve_snapshot(repo) == home                 # earlier in the order
    first = stage_snapshot(str(caches["hub_cache"]), repo, rev="first")
    assert ckpt.resolve_snapshot(repo) == first
    explicit = stage_snapshot(str(tmp_path / "explicit"), repo, rev="mine")
    assert ckpt.resolve_snapshot(repo, str(tmp_path / "explicit")) == explicit
    # no refs/main: a lone snapshot is taken
    os.remove(os.path.join(str(caches["hub_cache"]), "models--org--model-x", "refs", "main"))
    assert ckpt.resolve_snapshot(repo) == first
    assert ckpt.resolve_snapshot(str(tmp_path)) == str(tmp_path)    # a directory as is


def test_checkpoint_errors_name_path_and_keys(caches, tmp_path):
    kw = dict(config=CLIP_T5_CFG, device="cpu", dtype=torch.float32)
    missing = str(tmp_path / "nowhere")
    with pytest.raises(ckpt.CheckpointError, match="nowhere"):
        tt2v.VQAScore("clip-flant5-xl", checkpoint=missing, **kw)
    _, _, _, sd = clip_t5_hf()
    sd = {k: v for k, v in sd.items()
          if not k.startswith(("decoder.block.1.", "encoder.mm_projector.2"))}
    path = stage_safetensors(sd, str(tmp_path / "partial"))
    with pytest.raises(ckpt.CheckpointError) as ei:
        tt2v.VQAScore("clip-flant5-xl", checkpoint=path, **kw)
    msg = str(ei.value)
    assert path in msg and "encoder.mm_projector.2.weight" in msg
    assert "decoder.block.1.layer.0.SelfAttention.q.weight" in msg
    no_tower = {k: v for k, v in sd.items() if "vision_tower" not in k}
    path = stage_safetensors(no_tower, str(tmp_path / "no_tower"))
    with pytest.raises(ckpt.CheckpointError, match="no CLIP tower"):
        tt2v.VQAScore("clip-flant5-xl", checkpoint=path, **kw)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ckpt.CheckpointError, match="neither"):
        tt2v.VQAScore("clip-flant5-xl", checkpoint=str(empty), **kw)


def test_checkpoint_shape_mismatch_names_leaves(tmp_path):
    _, _, _, sd = clip_t5_hf()
    sd = dict(sd, **{"encoder.mm_projector.0.weight": torch.zeros(48, 30)})
    path = stage_safetensors(sd, str(tmp_path / "bad"))
    with pytest.raises(ckpt.CheckpointError) as ei:
        tt2v.VQAScore("clip-flant5-xl", config=CLIP_T5_CFG, checkpoint=path, device="cpu")
    assert "projector/fc1/w" in str(ei.value) and path in str(ei.value)


def test_tokenizer_dir_without_transformers_says_so(monkeypatch, tmp_path):
    from t2v_metrics_tpu_torch.tokenization import load_hf_tokenizer

    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers package"):
        load_hf_tokenizer(str(tmp_path))


# ---------------------------------------------------------------------------
# chip_smoke.py's key map and writer; the bridge
# ---------------------------------------------------------------------------

def test_chip_smoke_key_map_and_writer(tmp_path):
    from safetensors.torch import load_file

    _, _, _, sd = clip_t5_hf()
    model = bridge.clip_t5_from_numpy(tcft5.convert_clip_t5(sd, CLIP_T5_CFG), CLIP_T5_CFG,
                                      "cpu", torch.float32)
    got = chip_smoke.hf_clip_t5_tensors(model, CLIP_T5_CFG)
    assert set(got) == set(sd)
    for k, t in sd.items():
        assert tuple(got[k].shape) == tuple(t.shape) and torch.equal(got[k], t), k
    written = chip_smoke.write_checkpoint(got, str(tmp_path), shards=3)
    files = sorted(f for f in os.listdir(tmp_path) if f.endswith(".safetensors"))
    assert len(files) == 3 and written == sum(os.path.getsize(tmp_path / f) for f in files)
    back = {}
    for f in files:
        back.update(load_file(str(tmp_path / f)))
    lazy = ckpt.load_safetensors_dict(str(tmp_path))
    assert set(back) == set(lazy) == set(sd)
    for k, t in sd.items():
        assert torch.equal(back[k], t) and torch.equal(lazy[k], t), k


def test_bridge_keeps_bf16_bitwise_and_takes_views(tmp_path):
    _, _, _, sd = clip_t5_hf()
    sd16 = {k: v.to(torch.bfloat16) for k, v in sd.items()}
    path = stage_safetensors(sd16, str(tmp_path / "bf16"))
    tree = tcft5.convert_clip_t5(ckpt.load_safetensors_dict(path), CLIP_T5_CFG)
    w = tree["t5"]["encoder"]["blocks"][0]["mlp"]["wo"]["w"]
    assert not w.is_contiguous() and w.dtype == torch.bfloat16        # a transposed view
    model = bridge.clip_t5_from_numpy(tree, CLIP_T5_CFG, "cpu", torch.bfloat16)
    assert model.vision.proj is None                                   # a LLaVA tower
    again = chip_smoke.hf_clip_t5_tensors(model, CLIP_T5_CFG)
    for k, t in sd16.items():
        assert torch.equal(again[k].view(torch.int16), t.view(torch.int16)), k
    # numpy leaves in bf16 (ml_dtypes) and as raw |V2 records give the same bits
    import ml_dtypes

    np_tree = {"vision": tree["vision"], "t5": tree["t5"], "projector": {
        name: {"w": tree["projector"][name]["w"].float().numpy().astype(ml_dtypes.bfloat16),
               "b": tree["projector"][name]["b"].view(torch.int16).numpy().view("V2")}
        for name in ("fc1", "fc2")}}
    model2 = bridge.clip_t5_from_numpy(np_tree, CLIP_T5_CFG, "cpu", torch.bfloat16)
    for name in ("fc1", "fc2"):
        for leaf in ("w", "b"):
            a = getattr(getattr(model.projector, name), leaf)
            b = getattr(getattr(model2.projector, name), leaf)
            assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("family", ["clip_t5", "qwen2vl", "qwen3vl", "qwen3vl_moe", "gemma3"])
def test_validate_params_dims_takes_jax_trees(family):
    """A tree the JAX package's init makes passes the check of the port's
    loader onto the meta device (clip-flant5's with and without the tower's
    optional ``proj``); the same tree one decoder / T5 block short names each
    leaf of that block missing."""
    tree, cfg, load = _jax_family(family)
    ckpt.validate_params_dims(tree, load, family)
    if family == "clip_t5":
        assert tree["vision"]["proj"] is not None
        ckpt.validate_params_dims(dict(tree, vision=dict(tree["vision"], proj=None)), load,
                                  family)
        stack, path = tree["t5"]["decoder"], "t5/decoder/blocks"
    else:
        stack, path = tree["decoder"], "decoder/blocks"
    short = copy.deepcopy(tree)
    blocks = (short["t5"]["decoder"] if family == "clip_t5" else short["decoder"])["blocks"]
    gone = blocks.pop()
    with pytest.raises(ValueError) as ei:
        ckpt.validate_params_dims(short, load, family)
    n = len(stack["blocks"]) - 1
    want = sorted(f"  missing: {path}/{n}/{k}" for k, v in ckpt._flatten(gone).items()
                  if v is not None)
    got = sorted(line.split(" (expected")[0] for line in str(ei.value).splitlines()[1:])
    assert got == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_written_clip_flant5_tree_scores_as_jax(tmp_path, dtype):
    """A clip-flant5 tree the JAX package's init makes (the CLIP tower's
    ``proj`` included) and its ``save_params`` writes (bf16 as ``|V2``)
    loads through ``VQAScore(checkpoint=)`` and scores as the JAX package
    does with the same parameters."""
    import jax
    import jax.numpy as jnp

    import t2v_metrics_tpu as jt2v
    from t2v_metrics_tpu.models import checkpoint as jckpt
    from t2v_metrics_tpu.tokenization import SimpleT5Tokenizer as JTok

    tree, cfg, _ = _jax_family("clip_t5")
    # widen the score spread past the near-uniform random-init logits
    tree = jax.tree.map(lambda x: x * np.float32(4.0) if x.ndim == 2 else x, tree)
    jckpt.save_params(jax.tree.map(lambda x: jnp.asarray(x, dtype), tree), str(tmp_path))
    same = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, dtype), np.float32), tree)
    tok = JTok(cfg.t5.vocab_size)
    j = jt2v.VQAScore("clip-flant5-test", params=same, tokenizer=tok)
    t = tt2v.VQAScore("clip-flant5-test", checkpoint=str(tmp_path), tokenizer=tok,
                      device="cpu", dtype=torch.float32)
    assert t.model.engine.params.vision.proj is not None
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, (40, 52, 3), np.uint8) for _ in range(2)]
    texts = ["a red cube on a table", "two dogs"]
    np.testing.assert_allclose(t(images=imgs, texts=texts), np.asarray(j(images=imgs, texts=texts)),
                               rtol=JAX_RTOL, atol=JAX_ATOL)


# ---------------------------------------------------------------------------
# CLIPScore and ITMScore
# ---------------------------------------------------------------------------

def _jax_scorer_tree(family: str):
    """(numpy tree made by the JAX package's init, the port's config, the
    port's loader onto the meta device, the path of the stack to cut)."""
    import jax

    if family == "clipscore":
        from t2v_metrics_tpu.models import adapters as jad
        from t2v_metrics_tpu.models import clip as jclip
        from t2v_metrics_tpu_torch.models import adapters as tad

        tree = jclip.init_clip(jax.random.PRNGKey(0), jad._TEST_CLIP_V, jad._TEST_CLIP_T)
        cfg, load = (tad._TEST_CLIP_V, tad._TEST_CLIP_T), bridge.clip_from_numpy
        path = "text/blocks"
    else:
        from t2v_metrics_tpu.models import blip2_itm as jbitm
        from t2v_metrics_tpu_torch.models import blip2_itm as tbitm

        tree = jbitm.init_blip2_itm(jax.random.PRNGKey(0),
                                    jbitm.BLIP2_ITM_MODELS["blip2-itm-test"]["config"])
        cfg = tbitm.BLIP2_ITM_MODELS["blip2-itm-test"]["config"]
        load, path = bridge.blip2_itm_from_numpy, "vision/blocks"
    tree = jax.tree.map(np.asarray, tree)
    return tree, (lambda t: load(t, cfg, "meta", torch.float32)), path


@pytest.mark.parametrize("family", ["clipscore", "blip2_itm"])
def test_validate_params_dims_takes_jax_scorer_trees(family):
    """The JAX package's CLIPScore and BLIP-2 ITM trees (with the Q-Former's
    ``cross: None`` layers) pass the port's loaders onto the meta device;
    one block short, each of its leaves is named missing."""
    tree, load, path = _jax_scorer_tree(family)
    ckpt.validate_params_dims(tree, load, family)
    short = copy.deepcopy(tree)
    top, stack = path.split("/")
    gone = short[top][stack].pop()
    with pytest.raises(ValueError) as ei:
        ckpt.validate_params_dims(short, load, family)
    n = len(tree[top][stack]) - 1
    want = sorted(f"  missing: {path}/{n}/{k}" for k, v in ckpt._flatten(gone).items()
                  if v is not None)
    got = sorted(line.split(" (expected")[0] for line in str(ei.value).splitlines()[1:])
    assert got == want


def _scorer(family, fx, **kw):
    """(facade, its name, its config kwargs) of a staged HF family."""
    if family == "clipscore":
        hf, path, tok, tcfg = fx
        return tt2v.CLIPScore, "openai:ViT-B-32", dict(vision_config=CLIP_VCFG,
                                                      text_config=tcfg)
    hf, path, tok, cfg = fx
    return tt2v.ITMScore, "blip2-itm", dict(config=cfg)


@pytest.mark.parametrize("family", ["clipscore", "blip2_itm"])
def test_scorer_native_tree_equals_hf_directory(tmp_path, clip_dirs, itm_dirs, family):
    """A native tree written by the port's save_params (bf16 as ``|V2``)
    from the family's converter loads to the same parameters as the HF
    directory it came from, cast to bf16 there."""
    from t2v_metrics_tpu_torch.models import blip2_itm as tbitm
    from t2v_metrics_tpu_torch.models.convert import convert_clip

    fx = clip_dirs if family == "clipscore" else itm_dirs
    facade, name, cfg_kw = _scorer(family, fx)
    path = fx[1]
    kw = dict(device="cpu", dtype=torch.bfloat16, tokenizer=tt2v.SimpleT5Tokenizer(), **cfg_kw)
    from_hf = facade(name, checkpoint=path, **kw).model
    # (CLIP's 0-d logit_scale stays fp32, as the model keeps it)
    sd = {k: v.to(torch.bfloat16) if v.dim() else v
          for k, v in ckpt.load_hf_state_dict(path).items()}
    tree = (convert_clip(sd, 2, 2) if family == "clipscore"
            else tbitm.convert_blip2_itm(sd, fx[3]))
    ckpt.save_params(tree, str(tmp_path / "native"))
    from_native = facade(name, checkpoint=str(tmp_path / "native"), **kw).model
    params = (lambda m: m.engine.params) if family == "clipscore" else (lambda m: m.params)
    want, got = params(from_hf).state_dict(), params(from_native).state_dict()
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("family", ["clipscore", "blip2_itm"])
def test_scorer_pretrained_default_from_local_snapshot(caches, clip_dirs, itm_dirs, family):
    """Without ``init``, ``params`` or ``checkpoint`` the scorer reads the
    registry repo's snapshot from the local cache, weights and tokenizer;
    without a snapshot it names the places it searched."""
    import shutil

    fx = clip_dirs if family == "clipscore" else itm_dirs
    facade, name, cfg_kw = _scorer(family, fx)
    kw = dict(device="cpu", dtype=torch.float32, **cfg_kw)
    repo = "openai/clip-vit-base-patch32" if family == "clipscore" \
        else "Salesforce/blip2-itm-vit-g"
    with pytest.raises(ckpt.CheckpointError, match="never downloads"):
        facade(name, **kw)
    snap = stage_snapshot(str(caches["hub_cache"]), repo)
    for src in (fx[1], fx[2]):
        for f in os.listdir(src):
            shutil.copy(os.path.join(src, f), snap)
    s = facade(name, **kw)
    ref = facade(name, checkpoint=fx[1], tokenizer=fx[2], **kw)
    tok = s.model.engine.tokenizer if family == "clipscore" else s.model.tokenizer
    assert tok.__class__.__name__ == "PreTrainedTokenizerFast"
    rng = np.random.default_rng(10)
    side = 32 if family == "clipscore" else 28
    imgs = [rng.integers(0, 256, (side, side, 3), dtype=np.uint8)]
    texts = ["a photo of cat", "two dogs on grass"]
    np.testing.assert_array_equal(s(images=imgs, texts=texts), ref(images=imgs, texts=texts))


@pytest.mark.parametrize("family", ["clipscore", "blip2_itm"])
def test_scorer_missing_keys_are_named_with_the_path(tmp_path, clip_dirs, itm_dirs, family):
    fx = clip_dirs if family == "clipscore" else itm_dirs
    facade, name, cfg_kw = _scorer(family, fx)
    sd = ckpt.load_hf_state_dict(fx[1])
    cut = ".layers.1." if family == "clipscore" else ".layer.1."
    path = stage_safetensors({k: sd[k] for k in sd if cut not in k}, str(tmp_path / "part"))
    with pytest.raises(ckpt.CheckpointError) as ei:
        facade(name, checkpoint=path, device="cpu", **cfg_kw)
    msg = str(ei.value)
    want = ("text_model.encoder.layers.1.self_attn.q_proj.weight" if family == "clipscore"
            else "qformer.encoder.layer.1.attention.attention.query.weight")
    assert path in msg and want in msg


def test_zero_dim_bf16_leaf_round_trips(tmp_path):
    """A 0-d leaf (CLIP's logit_scale) keeps its shape through a native tree,
    in bf16 (``|V2`` bits) and in f32."""
    tree = {"logit_scale": torch.tensor(2.6592, dtype=torch.bfloat16),
            "f32": torch.tensor(-1.5)}
    ckpt.save_params(tree, str(tmp_path))
    back = ckpt.load_params(str(tmp_path))
    for k, v in tree.items():
        assert back[k].shape == () and back[k].dtype == v.dtype and torch.equal(back[k], v)
