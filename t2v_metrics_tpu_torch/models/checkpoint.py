"""Checkpoints of the port (port of t2v_metrics_tpu/models/checkpoint.py,
under the same names).

Three on-disk forms, all read without ``safetensors``, ``transformers`` or
``huggingface_hub`` (the GPU machine has none of them):

  * native: the JAX package's tree format, ``manifest.json`` (the tree's
    structure and leaf keys) plus ``arrays.npz``. The JAX ``save_params``
    writes bf16 leaves as raw 2-byte ``|V2`` records and loses their dtype;
    ``load_params`` reads those as bf16 bits. The port's ``save_params``
    writes bf16 the same way and adds a ``dtypes`` entry to the manifest,
    which the JAX loader ignores.
  * safetensors shards (HF layout): an 8-byte little-endian header length, a
    JSON header (dtype, shape and byte offsets of each tensor), then the
    raw bytes. ``load_safetensors_dict`` reads the headers and returns a
    lazy ``Mapping`` from key to a CPU tensor view: indexing a key maps that
    tensor's bytes (a private mapping of its own pages, never written), so
    nothing is read until the view is used, and nothing is copied on the
    host. ``release_pages`` hands the resident pages behind a view back to
    the kernel once the view has been copied to the device, so host memory
    stays bounded by the largest tensor in flight, not the checkpoint.
  * PyTorch ``*.bin`` shards (older hub repos): ``torch.load(...,
    weights_only=True, mmap=True)``.

``resolve_snapshot`` finds a repo's snapshot in the local Hugging Face
caches and never touches the network. ``convert_checked`` runs a
converter (``models/convert.py`` and the families' ``convert_*``) so that
one pass names every key the checkpoint lacks.

The shape checks (``validate_params_dims``, ``adopt_decoder_dims``,
``adopt_vision_dims``) work on trees in the JAX package's layout; the
config's shapes come from the port's models built on ``torch.device("meta")``,
which costs no memory: ``validate_params_dims`` runs the family's loader
(``bridge.*_from_numpy``) over the tree onto such a model.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import mmap
import os
import struct
import warnings
import weakref
from collections.abc import Mapping

import numpy as np
import torch

from ..constants import HF_CACHE_DIR


class CheckpointError(RuntimeError):
    """A checkpoint that cannot be read: the message names the path and what
    is missing or wrong."""


# ---------------------------------------------------------------------------
# Trees and the native format
# ---------------------------------------------------------------------------

def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_structure(v) for v in tree]
    if tree is None:
        return None
    return "leaf"


def _rebuild(structure, flat, prefix=""):
    if isinstance(structure, dict):
        return {k: _rebuild(v, flat, f"{prefix}{k}/")
                for k, v in structure.items()}
    if isinstance(structure, list):
        return [_rebuild(v, flat, f"{prefix}{i}/")
                for i, v in enumerate(structure)]
    if structure is None:
        return None
    return flat[prefix.rstrip("/")]


def _is_bf16_numpy(a: np.ndarray) -> bool:
    """ml_dtypes' bfloat16 (JAX leaves) or the 2-byte void records np.load
    gives for them."""
    return a.dtype.name == "bfloat16" or (a.dtype.kind == "V" and a.dtype.itemsize == 2)


def _leaf_array(v) -> tuple[np.ndarray, str | None]:
    """A leaf as the array np.savez writes, and its dtype name when the
    array holds bf16 bits."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        return t.numpy(), None
    a = np.asarray(v)
    if _is_bf16_numpy(a):
        return np.ascontiguousarray(a).view("V2"), "bfloat16"
    return a, None


def save_params(params, path: str):
    """Write a param tree (torch tensors or numpy arrays as leaves) to
    ``path/`` (manifest.json + arrays.npz). bf16 leaves are stored as their
    bits (``|V2``, as the JAX ``save_params`` writes them) and named in the
    manifest's ``dtypes``."""
    os.makedirs(path, exist_ok=True)
    flat = _flatten(params)
    arrays, dtypes = {}, {}
    for k, v in flat.items():
        if v is None:
            continue
        arrays[k.replace("/", "__")], name = _leaf_array(v)
        if name is not None:
            dtypes[k] = name
    manifest = {"structure": _structure(params),
                "keys": [k for k, v in flat.items() if v is not None],
                "dtypes": dtypes}
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def _numpy_leaf_tensor(a: np.ndarray, key: str) -> torch.Tensor:
    if _is_bf16_numpy(a):
        # (ascontiguousarray makes a 0-d leaf, CLIP's logit_scale, 1-d)
        bits = np.ascontiguousarray(a).view(np.int16).reshape(a.shape)
        return torch.from_numpy(bits).view(torch.bfloat16)
    if a.dtype.kind == "V":
        raise CheckpointError(f"leaf {key!r}: raw {a.dtype.itemsize}-byte records "
                              f"({a.dtype.str}) are not a dtype the port reads")
    return torch.from_numpy(a)


def load_params(path: str, dtype=None):
    """Load a native checkpoint dir -> param tree of CPU tensors (cast to
    ``dtype`` when given). Reads trees written by either package, bf16
    ``|V2`` leaves included."""
    mf = os.path.join(path, "manifest.json")
    if not os.path.exists(mf):
        raise CheckpointError(f"{path!r} holds no manifest.json (not a native tree)")
    with open(mf) as f:
        manifest = json.load(f)
    flat = {}
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        missing = [k for k in manifest["keys"] if k.replace("/", "__") not in npz.files]
        if missing:
            raise CheckpointError(f"{path!r}: arrays.npz lacks {len(missing)} leaf(s) "
                                  f"the manifest names: {missing[:20]}")
        for k in manifest["keys"]:
            t = _numpy_leaf_tensor(npz[k.replace("/", "__")], k)
            flat[k] = t if dtype is None else t.to(dtype)
    return _rebuild(manifest["structure"], flat)


# ---------------------------------------------------------------------------
# Shape checks
# ---------------------------------------------------------------------------

def validate_params_dims(params, load, model_name: str,
                         provisional: bool = False) -> None:
    """Raise with a readable per-leaf report when a loaded checkpoint's
    shapes disagree with the config.

    ``load(tree)`` is the family's loader onto the meta device (e.g.
    ``lambda t: bridge.qwen3vl_from_numpy(t, cfg, "meta", dtype)``); it runs
    once over ``params``, reading no data, and reports each leaf it looks
    for and the tree lacks (or holds as None), each that does not fit, and
    each it never reads (``bridge.shape_problems``). An optional leaf (the
    CLIP tower's ``proj``) is read when present. For the PROVISIONAL
    families a mismatch gets a pointer to ``config=``.
    """
    from ..bridge import shape_problems  # the bridge imports this module

    problems = shape_problems(load, params)
    if problems:
        hint = (
            "\nThe registry dims for this model are PROVISIONAL (no public "
            "HF config in the build environment — see the family module "
            "docstring). Pass config=<corrected config> with the dims from "
            "your checkpoint's config.json." if provisional else "")
        raise ValueError(
            f"checkpoint does not match the {model_name} config "
            f"({len(problems)} problem(s)):\n" + "\n".join(problems[:20])
            + ("\n  ..." if len(problems) > 20 else "") + hint)


def adopt_decoder_dims(dec_params, cfg):
    """Rebuild a DecoderConfig from a loaded decoder param tree's shapes:
    vocab / d_model from the embedding, the layer count, head_dim from the
    per-head qk-norm scale, heads / kv_heads from the q / k projections,
    d_ff or the expert count and width, embedding tying. Fields no shape
    determines keep the registry value. Returns ``(new_cfg, changed)``
    with ``changed`` mapping field -> (registry value, adopted value)."""
    blocks = dec_params["blocks"]
    b0 = blocks[0]
    emb = dec_params["embed"]
    upd = {
        "vocab_size": int(emb.shape[0]),
        "d_model": int(emb.shape[1]),
        "layers": len(blocks),
        "tie_embeddings": dec_params.get("lm_head") is None,
    }
    qn = b0["attn"].get("q_norm")
    head_dim = (int(qn["scale"].shape[-1]) if qn is not None
                else cfg.head_dim)
    upd["head_dim"] = head_dim
    upd["heads"] = int(b0["attn"]["q"]["w"].shape[1]) // head_dim
    upd["kv_heads"] = int(b0["attn"]["k"]["w"].shape[1]) // head_dim
    mlp = b0["mlp"]
    if "moe" in mlp:
        upd["num_experts"] = int(mlp["moe"]["gate_up"].shape[0])
        upd["moe_d_ff"] = int(mlp["moe"]["gate_up"].shape[-1]) // 2
    else:
        upd["d_ff"] = int(mlp["gate"]["w"].shape[1])
    changed = {k: (getattr(cfg, k), v) for k, v in upd.items()
               if getattr(cfg, k) != v}
    if not changed:
        return cfg, {}
    # the sliding/full pattern must track the adopted layer count: repeat
    # the registry pattern (the true one is a config.json fact)
    extra = {}
    lt = getattr(cfg, "layer_types", None)
    if lt is not None and "layers" in changed:
        n = changed["layers"][1]
        extra["layer_types"] = tuple((list(lt) * (n // len(lt) + 1))[:n])
    return (dataclasses.replace(
        cfg, **{k: v for k, (_, v) in changed.items()}, **extra), changed)


def adopt_vision_dims(vis_params, cfg):
    """ViT-side counterpart of :func:`adopt_decoder_dims` for CLIP/SigLIP
    style towers: width / layers / mlp_dim / patch_size; heads keep the
    registry value. Returns (new_cfg, changed)."""
    import math

    blocks = vis_params["blocks"]
    b0 = blocks[0]
    mlp = b0["mlp"]
    fc1 = mlp.get("fc1") or mlp.get("up") or mlp.get("gate")
    patch_dim = int(vis_params["patch_w"].shape[0])
    upd = {
        "width": int(vis_params["patch_w"].shape[1]),
        "layers": len(blocks),
        "mlp_dim": int(fc1["w"].shape[1]),
    }
    ps = math.isqrt(patch_dim // 3)
    if 3 * ps * ps == patch_dim:  # 2D conv patchify (not temporal-packed)
        upd["patch_size"] = ps
    upd = {k: v for k, v in upd.items() if hasattr(cfg, k)}
    changed = {k: (getattr(cfg, k), v) for k, v in upd.items()
               if getattr(cfg, k) != v}
    if not changed:
        return cfg, {}
    return (dataclasses.replace(
        cfg, **{k: v for k, (_, v) in changed.items()}), changed)


# ---------------------------------------------------------------------------
# config.json
# ---------------------------------------------------------------------------

# HF config.json key -> DecoderConfig field. A checkpoint's config.json pins
# fields no shape can recover (eps, rope theta, sliding windows), so it
# outranks both the registry and shape inference.
_HF_DECODER_KEYS = {
    "vocab_size": "vocab_size",
    "hidden_size": "d_model",
    "num_hidden_layers": "layers",
    "num_attention_heads": "heads",
    "num_key_value_heads": "kv_heads",
    "head_dim": "head_dim",
    "intermediate_size": "d_ff",
    "hidden_act": "act",
    "rms_norm_eps": "rms_eps",
    "rope_theta": "rope_theta",
    "sliding_window": "sliding_window",
    "layer_types": "layer_types",
    "tie_word_embeddings": "tie_embeddings",
    "num_experts": "num_experts",
    "num_experts_per_tok": "experts_per_tok",
    "moe_intermediate_size": "moe_d_ff",
}

# values may be a tuple of candidate fields (Qwen towers use depth/d_ff,
# CLIP-style towers layers/mlp_dim): the first the config has wins
_HF_VISION_KEYS = {
    "depth": ("depth", "layers"),
    "num_hidden_layers": ("layers",),
    "hidden_size": ("hidden", "width"),
    "num_heads": ("heads",),
    "num_attention_heads": ("heads",),
    "intermediate_size": ("d_ff", "mlp_dim"),
    "patch_size": ("patch_size",),
    "spatial_merge_size": ("merge_size",),
    "window_size": ("window_size",),
    "fullatt_block_indexes": ("fullatt_block_indexes",),
    "temporal_patch_size": ("temporal_patch_size",),
    "out_hidden_size": ("out_hidden",),
}


def read_hf_config(ckpt_dir: str) -> dict | None:
    """Parse ``<ckpt_dir>/config.json`` if present, else None."""
    path = os.path.join(ckpt_dir, "config.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def adopt_config_json(cj: dict, cfg, key_map: dict):
    """Apply the HF config dict onto a frozen config dataclass: only keys
    present in ``cj`` and fields existing on ``cfg`` apply; lists become
    tuples. Returns ``(new_cfg, changed)`` like the shape adopters."""
    upd = {}
    for hf_key, fields in key_map.items():
        if hf_key not in cj or cj[hf_key] is None:
            continue
        if isinstance(fields, str):
            fields = (fields,)
        field = next((f for f in fields if hasattr(cfg, f)), None)
        if field is None:
            continue
        v = cj[hf_key]
        if isinstance(v, list):
            v = tuple(v)
        upd[field] = v
    changed = {k: (getattr(cfg, k), v) for k, v in upd.items()
               if getattr(cfg, k) != v}
    if not changed:
        return cfg, {}
    return (dataclasses.replace(
        cfg, **{k: v for k, (_, v) in changed.items()}), changed)


def load_with_adopted_dims(ckpt: str, cfg, load_fn, model_name: str,
                           dtype=None):
    """Native-checkpoint load for the provisional-dims families: load the
    tree, adopt every shape-determined dim the checkpoint disagrees on, then
    config.json's fields, and run the dims guard against the adopted config.
    ``load_fn(tree, cfg)`` is the family's loader onto the meta device.
    Returns ``(params, cfg)``, warning with each adopted field."""
    params = load_params(ckpt, dtype=dtype)
    changed_all = {}
    new_text, new_vis = cfg.text, cfg.vision
    if "decoder" in params:
        new_text, ch = adopt_decoder_dims(params["decoder"], cfg.text)
        changed_all.update({f"text.{k}": v for k, v in ch.items()})
    if "vision" in params and isinstance(params["vision"], dict) \
            and "blocks" in params["vision"]:
        new_vis, ch = adopt_vision_dims(params["vision"], cfg.vision)
        changed_all.update({f"vision.{k}": v for k, v in ch.items()})
    cj = read_hf_config(ckpt)
    if cj is not None:
        tc = cj.get("text_config", cj)
        new_text, ch = adopt_config_json(tc, new_text, _HF_DECODER_KEYS)
        changed_all.update({f"text.{k}": v for k, v in ch.items()})
        if "vision_config" in cj:
            new_vis, ch = adopt_config_json(cj["vision_config"], new_vis,
                                            _HF_VISION_KEYS)
            changed_all.update({f"vision.{k}": v for k, v in ch.items()})
    if changed_all:
        cfg = dataclasses.replace(cfg, text=new_text, vision=new_vis)
        warnings.warn(
            f"{model_name}: adopted checkpoint dims over the provisional "
            f"registry values: "
            + ", ".join(f"{k} {o} -> {n}"
                        for k, (o, n) in sorted(changed_all.items())))
    validate_params_dims(params, lambda t: load_fn(t, cfg), model_name, provisional=True)
    return params, cfg


# ---------------------------------------------------------------------------
# safetensors and *.bin shards
# ---------------------------------------------------------------------------

SAFETENSORS_DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "U8": torch.uint8,
    "BOOL": torch.bool,
}

# storage address -> (weak reference to the mmap object, address of its first
# byte) of every tensor mapping this module made. An entry names its mapping
# only while the mmap (kept alive by the tensor's storage) is.
_MAPPED: dict = {}


def _map_range(path: str, offset: int, nbytes: int, dtype: torch.dtype,
               shape: tuple) -> torch.Tensor:
    """A CPU tensor over bytes [offset, offset + nbytes) of ``path``: a
    private (copy-on-write) mapping of just those pages, writable but never
    written (one mapping a tensor, so no mapping is larger than its tensor:
    some kernels make a whole mapping resident at its first touch),
    unmapped when the tensor's storage dies. Nothing is read until the
    tensor is."""
    start = offset // mmap.ALLOCATIONGRANULARITY * mmap.ALLOCATIONGRANULARITY
    with open(path, "rb") as f:
        m = mmap.mmap(f.fileno(), offset - start + nbytes, access=mmap.ACCESS_COPY,
                      offset=start)
    item = torch.empty((), dtype=dtype).element_size()
    if offset % item:  # unaligned in the file: the one case that copies
        raw = torch.frombuffer(m, dtype=torch.uint8, count=nbytes, offset=offset - start)
        return raw.clone().view(dtype).reshape(shape)
    t = torch.frombuffer(m, dtype=dtype, count=nbytes // item, offset=offset - start)
    addr = t.untyped_storage().data_ptr()
    _MAPPED[addr] = (weakref.ref(m), addr - (offset - start))
    return t.reshape(shape)


class SafetensorsShard:
    """One ``*.safetensors`` file: its header, read at construction; each
    tensor mapped on its own when ``tensor`` is called."""

    def __init__(self, path: str):
        self.path = path
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) != 8:
                raise CheckpointError(f"{path!r}: not a safetensors file (too short)")
            (n,) = struct.unpack("<Q", head)
            if n > size - 8:
                raise CheckpointError(f"{path!r}: header of {n} bytes overruns the file")
            header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        self.entries = header
        self.data_start = 8 + n
        self.size = size

    def tensor(self, key: str) -> torch.Tensor:
        e = self.entries[key]
        dtype = SAFETENSORS_DTYPES.get(e["dtype"])
        if dtype is None:
            raise CheckpointError(
                f"{self.path!r}: tensor {key!r} has dtype {e['dtype']}, which the "
                f"port does not read (it reads {', '.join(SAFETENSORS_DTYPES)})")
        shape = tuple(e["shape"])
        begin, end = e["data_offsets"]
        item = torch.empty((), dtype=dtype).element_size()
        numel = int(np.prod(shape, dtype=np.int64))
        if end - begin != numel * item or self.data_start + end > self.size:
            raise CheckpointError(f"{self.path!r}: tensor {key!r} has {end - begin} "
                                  f"bytes for shape {shape} {e['dtype']}")
        if numel == 0:
            return torch.empty(shape, dtype=dtype)
        for addr in [a for a, (ref, _) in _MAPPED.items() if ref() is None]:
            del _MAPPED[addr]
        return _map_range(self.path, self.data_start + begin, end - begin, dtype, shape)


class SafetensorsDict(Mapping):
    """Lazy ``Mapping`` key -> CPU tensor view over safetensors shards. Only
    the headers are read up front; a key's bytes are mapped, not read, when
    it is indexed, and read when the view is used."""

    def __init__(self, files: list[str]):
        self.files = list(files)
        self._shards = [SafetensorsShard(f) for f in self.files]
        self._where = {}
        for shard in self._shards:
            for key in shard.entries:
                self._where[key] = shard

    def __getitem__(self, key: str) -> torch.Tensor:
        return self._where[key].tensor(key)

    def __iter__(self):
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)

    def __contains__(self, key) -> bool:
        return key in self._where


class BinDict(Mapping):
    """Lazy ``Mapping`` over PyTorch ``*.bin`` shards: a shard is opened with
    ``torch.load(mmap=True, weights_only=True)`` when one of its keys is first
    indexed (the key index comes from ``pytorch_model.bin.index.json``, or
    from opening every shard)."""

    def __init__(self, files: list[str], weight_map: dict | None = None):
        self.files = list(files)
        self._loaded = {}
        if weight_map is None:
            weight_map = {k: os.path.basename(f) for f in self.files
                          for k in self._load(f)}
        base = {os.path.basename(f): f for f in self.files}
        self._where = {k: base[v] for k, v in weight_map.items()}

    def _load(self, path: str) -> dict:
        if path not in self._loaded:
            self._loaded[path] = torch.load(path, map_location="cpu",
                                            weights_only=True, mmap=True)
        return self._loaded[path]

    def __getitem__(self, key: str) -> torch.Tensor:
        path = self._where[key]
        sd = self._load(path)
        if key not in sd:
            raise CheckpointError(f"{path!r} lacks {key!r}, which its index names")
        return sd[key]

    def __iter__(self):
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)

    def __contains__(self, key) -> bool:
        return key in self._where


def _shards(model_dir: str, index_name: str, pattern: str):
    """(shard paths, the index's weight map or None): through the index json
    where it is there, else the sorted files matching ``pattern``."""
    index = os.path.join(model_dir, index_name)
    if os.path.exists(index):
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        files = [os.path.join(model_dir, n) for n in sorted(set(weight_map.values()))]
        absent = [f for f in files if not os.path.exists(f)]
        if absent:
            raise CheckpointError(f"{index!r} names shard(s) that are not there: {absent}")
        return files, weight_map
    return sorted(glob.glob(os.path.join(model_dir, pattern))), None


def iter_safetensors(model_dir: str):
    """Yield (name, CPU tensor view) from all safetensors shards in a dir,
    one tensor at a time."""
    sd = load_safetensors_dict(model_dir)
    for name in sd:
        yield name, sd[name]


def load_safetensors_dict(model_dir: str) -> SafetensorsDict:
    """The lazy mapping over a directory's safetensors shards (found through
    ``model.safetensors.index.json`` where it is there, else the sorted
    ``*.safetensors``)."""
    files, weight_map = _shards(model_dir, "model.safetensors.index.json",
                                "*.safetensors")
    if not files:
        raise CheckpointError(f"{model_dir!r} holds no *.safetensors shard")
    sd = SafetensorsDict(files)
    if weight_map is not None:
        absent = sorted(k for k in weight_map if k not in sd)
        if absent:
            raise CheckpointError(f"{model_dir!r}: the index names {len(absent)} key(s) "
                                  f"no shard holds: {absent[:20]}")
    return sd


def load_hf_state_dict(model_dir: str) -> Mapping:
    """The lazy state dict of an HF model directory: its safetensors shards,
    else its ``*.bin`` shards."""
    if not os.path.isdir(model_dir):
        raise CheckpointError(f"checkpoint {model_dir!r} is not a directory")
    if glob.glob(os.path.join(model_dir, "*.safetensors")):
        return load_safetensors_dict(model_dir)
    files, weight_map = _shards(model_dir, "pytorch_model.bin.index.json", "*.bin")
    if files:
        return BinDict(files, weight_map)
    raise CheckpointError(f"{model_dir!r} holds neither *.safetensors nor *.bin shards")


def is_native_tree(path: str) -> bool:
    return os.path.exists(os.path.join(path, "manifest.json"))


_PAGE = mmap.PAGESIZE


def release_pages(t: torch.Tensor) -> None:
    """Hand back the resident pages behind a view of a tensor mapping made
    here (a no-op for any other tensor). The mapping is private and never
    written, so a later read of the view re-reads the file: this only
    bounds host memory while a checkpoint streams to the device."""
    entry = _MAPPED.get(t.untyped_storage().data_ptr())
    m = None if entry is None else entry[0]()
    if m is None or not hasattr(mmap, "MADV_DONTNEED"):
        return
    base = entry[1]
    start = t.data_ptr()
    end = start + t.numel() * t.element_size()
    lo = max(start // _PAGE * _PAGE, base)
    hi = min(-(-end // _PAGE) * _PAGE, base + len(m))
    if hi > lo:
        m.madvise(mmap.MADV_DONTNEED, lo - base, hi - lo)


# ---------------------------------------------------------------------------
# Converting with every missing key named
# ---------------------------------------------------------------------------

class _Absent:
    """Stands in for a missing tensor while a converter runs, so that one
    pass names every key the checkpoint lacks."""

    shape = (0, 0, 0, 0, 0)

    def __getattr__(self, name):
        return lambda *a, **k: self

    def __getitem__(self, idx):
        return self

    def __iter__(self):
        return iter((self, self, self))


class _Recording(Mapping):
    def __init__(self, sd: Mapping):
        self.sd = sd
        self.missing: list[str] = []

    def __getitem__(self, key):
        if key in self.sd:
            return self.sd[key]
        self.missing.append(key)
        return _Absent()

    def __iter__(self):
        return iter(self.sd)

    def __len__(self):
        return len(self.sd)

    def __contains__(self, key):
        return key in self.sd


def convert_checked(convert, sd: Mapping, path: str, *args, **kwargs):
    """``convert(sd, *args, **kwargs)``, raising a ``CheckpointError`` that
    names ``path`` and every key the converter read and ``sd`` lacks."""
    rec = _Recording(sd)
    tree = convert(rec, *args, **kwargs)
    if rec.missing:
        raise CheckpointError(
            f"checkpoint {path!r} lacks {len(rec.missing)} key(s) that "
            f"{convert.__name__} reads: " + ", ".join(rec.missing[:20])
            + (" ..." if len(rec.missing) > 20 else ""))
    return tree


# ---------------------------------------------------------------------------
# Local snapshots (no hub)
# ---------------------------------------------------------------------------

def hub_cache_dirs(cache_dir: str | None = None) -> list[str]:
    """Where local snapshots are looked for, in order: ``cache_dir`` when
    given, ``$HF_HUB_CACHE``, ``$HF_HOME/hub``, ``~/.cache/huggingface/hub``,
    then ``$T2V_TPU_CACHE`` or ``./hf_cache/``."""
    dirs = [cache_dir] if cache_dir else []
    if os.environ.get("HF_HUB_CACHE"):
        dirs.append(os.environ["HF_HUB_CACHE"])
    if os.environ.get("HF_HOME"):
        dirs.append(os.path.join(os.environ["HF_HOME"], "hub"))
    dirs.append(os.path.join(os.path.expanduser("~"), ".cache", "huggingface", "hub"))
    dirs.append(os.environ.get("T2V_TPU_CACHE", HF_CACHE_DIR))
    return list(dict.fromkeys(dirs))


def resolve_snapshot(repo: str, cache_dir: str | None = None) -> str:
    """The local directory of ``repo``: itself when it is a directory, else
    ``models--{org}--{name}/snapshots/<refs/main>/`` in the first cache that
    has it (a cache without ``refs/main`` but with one snapshot gives that
    one). Never touches the network; raises naming every place searched."""
    if os.path.isdir(repo):
        return repo
    folder = "models--" + repo.replace("/", "--")
    searched = []
    for d in hub_cache_dirs(cache_dir):
        root = os.path.join(d, folder)
        searched.append(root)
        snaps = os.path.join(root, "snapshots")
        ref = os.path.join(root, "refs", "main")
        if os.path.exists(ref):
            with open(ref) as f:
                snap = os.path.join(snaps, f.read().strip())
            if os.path.isdir(snap):
                return snap
        elif os.path.isdir(snaps):
            found = sorted(os.listdir(snaps))
            if len(found) == 1:
                return os.path.join(snaps, found[0])
    raise CheckpointError(
        f"{repo!r} is not in a local Hugging Face cache and the port never "
        f"downloads; searched: {', '.join(searched)}. Pass checkpoint=<dir> "
        "or init='random'.")
