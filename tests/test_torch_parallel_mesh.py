"""The port's mesh layout and partition specs against the JAX package's, with
no process group: ``parallel/mesh.py``'s rank arithmetic, the spec of every
parameter against the JAX spec of its counterpart leaf, and the per-rank
shapes of ``abstract_sharded_params`` against JAX's ``shard_shape``. The
JAX trees are abstract (``jax.eval_shape``) and the port's modules live on
the meta device, so the full-width CLIPScore B/32 costs no memory.

Spec meshes use a tp that divides the configs' kv heads (the gemma-3 and
qwen3-vl test configs have 2); the port refuses tp 4 there (GSPMD would
split a head). Everything here is compared exactly.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from t2v_metrics_tpu.models import clip as jclip  # noqa: E402
from t2v_metrics_tpu.models import clip_flant5 as jcft5  # noqa: E402
from t2v_metrics_tpu.models import gemma3 as jg3  # noqa: E402
from t2v_metrics_tpu.models import qwen3vl as jq3  # noqa: E402
from t2v_metrics_tpu.models.adapters import CLIP_T5_MODELS as J_MODELS  # noqa: E402
from t2v_metrics_tpu.ops import quant as JQ  # noqa: E402
from t2v_metrics_tpu.parallel import mesh as jmesh  # noqa: E402
from t2v_metrics_tpu_torch.models import clip as tclip  # noqa: E402
from t2v_metrics_tpu_torch.models import clip_flant5 as tcft5  # noqa: E402
from t2v_metrics_tpu_torch.models import gemma3 as tg3  # noqa: E402
from t2v_metrics_tpu_torch.models import qwen3vl as tq3  # noqa: E402
from t2v_metrics_tpu_torch.models.adapters import CLIP_T5_MODELS as T_MODELS  # noqa: E402
from t2v_metrics_tpu_torch.ops import quant as TQ  # noqa: E402
from t2v_metrics_tpu_torch.parallel import mesh as tmesh  # noqa: E402

EIGHT = list(range(8))

LAYOUTS = [
    ("dp2_tp4", lambda m: m.make_mesh(dp=2, tp=4)),
    ("dp2_sp2_tp2", lambda m: m.make_mesh(dp=2, sp=2, tp=2)),
    ("dp1_sp4_ep1_tp2", lambda m: m.make_mesh(dp=1, sp=4, ep=1, tp=2)),
    ("dp1_ep2_tp4", lambda m: m.make_mesh(dp=1, ep=2, tp=4)),
    ("multihost_dcn2_dp2_tp2", lambda m: m.make_multihost_mesh(dcn=2, dp=2, tp=2)),
]


class _Port:
    """The port's mesh constructors over 8 rank ids, as JAX's over 8 devices."""

    @staticmethod
    def make_mesh(**kw):
        return tmesh.make_mesh(devices=EIGHT, **kw)

    @staticmethod
    def make_multihost_mesh(**kw):
        return tmesh.make_multihost_mesh(devices=EIGHT, **kw)


@pytest.mark.parametrize("build", [b for _, b in LAYOUTS], ids=[n for n, _ in LAYOUTS])
def test_layout_and_axis_names_equal_jax(build):
    want = build(jmesh)
    got = build(_Port)
    assert got.axis_names == want.axis_names
    np.testing.assert_array_equal(got.devices, np.vectorize(lambda d: d.id)(want.devices))
    assert got.shape == dict(want.shape)


def test_axis_slices_coordinates_and_data_rows():
    m = tmesh.make_multihost_mesh(dcn=2, dp=2, tp=2, devices=EIGHT)
    np.testing.assert_array_equal(tmesh.axis_slices(m.devices, m.axis_names, ("tp",)),
                                  [[0, 1], [2, 3], [4, 5], [6, 7]])
    np.testing.assert_array_equal(
        tmesh.axis_slices(m.devices, m.axis_names, ("dcn", "dp")),
        [[0, 2, 4, 6], [1, 3, 5, 7]])
    assert m.rank == 0 and m.axis_ranks("tp") == [0, 1]
    data = tmesh.data_sharding(m, 2)
    assert data.spec == (("dcn", "dp"), None) and data.count == 4
    assert data.rows(10) == slice(0, 3)
    assert tmesh.replicated(m).count == 1
    assert tmesh.data_sharding(tmesh.make_mesh(dp=2, tp=4, devices=EIGHT), 1).spec == (("dp",),)
    with pytest.raises(ValueError, match="no process group"):
        m.group("tp")                       # torch.distributed is not initialised here


def test_oversized_mesh_raises_as_jax_refuses_it():
    with pytest.raises(AssertionError):
        jmesh.make_mesh(dp=2, tp=8)
    with pytest.raises(ValueError, match="2x8 > 8 ranks"):
        tmesh.make_mesh(dp=2, tp=8, devices=EIGHT)
    with pytest.raises(ValueError, match="> 8 ranks"):
        tmesh.make_multihost_mesh(dcn=4, dp=2, tp=2, devices=EIGHT)


# ---------------------------------------------------------------------------
# Partition specs against the JAX rules
# ---------------------------------------------------------------------------

def _jax_leaves(port_name: str) -> list[str]:
    """The JAX tree paths of a port parameter's counterpart leaves."""
    parts = port_name.split(".")
    mod, leaf = parts[:-1], parts[-1]
    leaf = "w_q" if leaf == "w_qt" else leaf
    if "moe" in mod and "mlp" not in mod:
        mod.insert(mod.index("moe"), "mlp")
    block = len(mod) >= 3 and mod[-3] == "blocks" and mod[-2].isdigit()
    if mod and mod[-1] == "qkv":
        base = mod[:-1] if mod[-2] == "attn" else mod[:-1] + ["attn"]
        bases = [base + [c] for c in "qkv"]
    elif mod and mod[-1] == "wi_01":
        bases = [mod[:-1] + ["wi_0"], mod[:-1] + ["wi_1"]]
    elif block and mod[-1] == "o":
        bases = [mod[:-1] + ["attn", "o"]]
    elif block and mod[-1] in ("fc1", "fc2", "gate", "up", "down"):
        bases = [mod[:-1] + ["mlp", mod[-1]]]
    else:
        bases = [mod]
    return ["/".join(b + [leaf]) for b in bases]


def _spec(s, ndim):
    s = tuple(s)
    return s + (None,) * (ndim - len(s))


def _compare(port_model, jtree, jm, tm, ep_axis=None):
    """Each port parameter's spec equals its counterparts' JAX spec (the
    transpose for ``w_qt``), every leaf JAX shards has a counterpart, and
    the per-rank shapes equal JAX's shard shapes (summed over the parts of
    a packed leaf)."""
    jspecs = jmesh.partition_specs(jtree, ep_axis=ep_axis)
    none = lambda x: x is None  # noqa: E731
    specs_flat = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda x: x is None or isinstance(x, jax.sharding.PartitionSpec))[0]
    leaves_flat = jax.tree_util.tree_flatten_with_path(jtree, is_leaf=none)[0]
    assert len(specs_flat) == len(leaves_flat)
    flat = {jmesh._path_str(p): (s, leaf) for (p, s), (_, leaf) in zip(specs_flat, leaves_flat)
            if leaf is not None}
    specs = tmesh.partition_specs(port_model, ep_axis=ep_axis)
    local = tmesh.abstract_sharded_params(port_model, tm)
    seen = set()
    for name, p in port_model.named_parameters():
        got = specs[name]
        leaves = [x for x in _jax_leaves(name) if x in flat]
        if not leaves:
            assert all(a is None for a in got), (name, got)
            continue
        seen.update(leaves)
        transposed = name.endswith(".w_qt")
        want_shapes = []
        for path in leaves:
            jspec, jleaf = flat[path]
            want = _spec(jspec, p.dim())
            assert (got[::-1] if transposed else got) == want, (name, path, got, want)
            shape = NamedSharding(jm, jspec).shard_shape(jleaf.shape)
            want_shapes.append(shape[::-1] if transposed else shape)
        packed = 0 if transposed else p.dim() - 1
        want_local = list(want_shapes[0])
        if p.dim():                  # 0-d leaves (logit_scale) keep their shape
            want_local[packed] = sum(s[packed] for s in want_shapes)
        assert tuple(local[name].shape) == tuple(want_local), (name, local[name].shape,
                                                              want_local)
        assert local[name].device.type == "meta" and local[name].dtype == p.dtype
    sharded = {k for k, (s, _) in flat.items() if any(a is not None for a in s)}
    assert sharded <= seen, sorted(sharded - seen)[:5]


def _abstract(init, *args):
    return jax.eval_shape(lambda k: init(k, *args), jax.random.PRNGKey(0))


@pytest.mark.parametrize("quant", [None, "int8"])
def test_clip_flant5_specs_equal_jax(quant):
    jcfg = J_MODELS["clip-flant5-test"]["config"]
    jtree = _abstract(jcft5.init_clip_t5, jcfg)
    model = tcft5.CLIPT5Model(T_MODELS["clip-flant5-test"]["config"], "meta", torch.bfloat16)
    if quant:
        jtree = jax.eval_shape(lambda t: {**t, "t5": JQ.quantize_t5_params(t["t5"])}, jtree)
        TQ.quantize_t5_(model.t5)
        assert model.t5.encoder.blocks[0].mlp.wi_01.quantized
    _compare(model, jtree, jmesh.make_mesh(dp=4, tp=2), tmesh.make_mesh(dp=4, tp=2,
                                                                         devices=EIGHT))


@pytest.mark.parametrize("ep", [False, True], ids=["experts_over_tp", "ep_axis"])
def test_qwen3_moe_specs_equal_jax(ep):
    name = "qwen3-vl-moe-test"
    jtree = _abstract(jq3.init_qwen3vl, jq3.resolve_config(name))
    model = tq3.Qwen3VLModel(tq3.resolve_config(name), "meta", torch.bfloat16)
    kw = {"dp": 2, "ep": 2, "tp": 2} if ep else {"dp": 4, "tp": 2}
    _compare(model, jtree, jmesh.make_mesh(**kw), tmesh.make_mesh(devices=EIGHT, **kw),
             ep_axis="ep" if ep else None)
    spec = tmesh.partition_specs(model, ep_axis="ep" if ep else None)
    assert spec["decoder.blocks.0.moe.gate_up"] == ("ep" if ep else "tp", None, None)
    assert spec["decoder.blocks.0.qkv.w"] == (None, "tp")


def test_gemma3_specs_equal_jax():
    cfg = jg3.GEMMA3_MODELS["gemma-3-test"]["config"]
    jtree = _abstract(jg3.init_gemma3, cfg)
    model = tg3.Gemma3Model(tg3.GEMMA3_MODELS["gemma-3-test"]["config"], "meta",
                            torch.bfloat16)
    _compare(model, jtree, jmesh.make_mesh(dp=4, tp=2), tmesh.make_mesh(dp=4, tp=2,
                                                                         devices=EIGHT))


def test_clipscore_b32_specs_equal_jax():
    vcfg, tcfg = jclip.CLIP_ARCHS["ViT-B-32"]
    jtree = jax.eval_shape(lambda k: jclip.init_clip(k, vcfg, tcfg), jax.random.PRNGKey(0))
    model = tclip.CLIPModel(*tclip.CLIP_ARCHS["ViT-B-32"], "meta", torch.float32)
    _compare(model, jtree, jmesh.make_mesh(dp=2, tp=4), tmesh.make_mesh(dp=2, tp=4,
                                                                         devices=EIGHT))


def test_packed_qkv_is_cut_by_heads_not_thirds():
    """The packed q|k|v leaf's share is each of q, k and v's share side by
    side, not a contiguous third of the pack (the decoder's GQA parts have
    other widths)."""
    model = tq3.Qwen3VLModel(tq3.resolve_config("qwen3-vl-test"), "meta", torch.float32)
    cfg = tq3.resolve_config("qwen3-vl-test").text
    shards = tmesh._shards(model, tmesh.make_mesh(dp=1, tp=2, devices=[0, 1]), "tp")
    shard = shards["decoder.blocks.0.qkv.w"]
    full = torch.arange(np.prod(shard.full_shape), dtype=torch.float32).reshape(
        shard.full_shape)
    q, kv = cfg.heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim
    assert shard.widths == (q, kv, kv) and shard.index == 0 and shard.count == 2
    want = torch.cat([full[:, :q // 2], full[:, q:q + kv // 2],
                      full[:, q + kv:q + kv + kv // 2]], dim=1)
    torch.testing.assert_close(shard.take(full), want, rtol=0, atol=0)
    assert shards["decoder.blocks.0.o.w"].dim == 0            # row-parallel: its input
    assert "decoder.blocks.0.q_norm.scale" not in shards      # replicated


def test_tp_that_does_not_divide_kv_heads_raises():
    """gemma-3-test has 2 kv heads: tp 4 would split a head, which GSPMD
    does and the port refuses, naming both."""
    model = tg3.Gemma3Model(tg3.GEMMA3_MODELS["gemma-3-test"]["config"], "meta",
                            torch.bfloat16)
    tm = tmesh.make_mesh(dp=2, tp=4, devices=EIGHT)
    with pytest.raises(ValueError, match=r"tp 4 does not divide its 2 kv heads"):
        tmesh.abstract_sharded_params(model, tm)
    with pytest.raises(ValueError, match=r"tp 4 does not divide its 2 kv heads"):
        tmesh.shard_params(model, tm)


def test_sharded_bytes_of_xxl_at_tp2():
    """The per-rank parameter bytes of clip-flant5-xxl at tp 2 (meta device:
    nothing allocated): about half of the whole, the replicated embeddings,
    norms and biases on top."""
    cfg = tcft5.CLIP_T5_CONFIGS["clip-flant5-xxl"]
    model = tcft5.CLIPT5Model(cfg, "meta", torch.bfloat16)
    total = sum(p.numel() * p.element_size() for p in model.parameters())
    half = tmesh.sharded_bytes(model, tmesh.make_mesh(dp=1, tp=2, devices=[0, 1]))
    assert total > 20 * 2 ** 30
    assert total / 2 < half < total / 2 * 1.05


def test_shard_seq_is_a_no_op_without_an_sp_axis():
    from t2v_metrics_tpu_torch.parallel import sp as psp

    x = torch.arange(24.0).reshape(1, 6, 4)
    assert psp.shard_seq(x) is x and psp.current_mesh() is None
    with tmesh.make_mesh(dp=2, tp=4, devices=EIGHT) as m:
        assert psp.current_mesh() is m and psp.shard_seq(x) is x
    with tmesh.make_mesh(dp=1, sp=2, tp=4, devices=EIGHT):
        torch.testing.assert_close(psp.shard_seq(x), x[:, :3])     # rank 0's rows
        with pytest.raises(ValueError, match="5 rows are not divisible by sp 2"):
            psp.shard_seq(x[:, :5])
    assert psp.current_mesh() is None


@pytest.mark.parametrize("names", [("model.t5.lm_head", ["model/t5/lm_head"]),
                                   ("decoder.blocks.3.qkv.w_qt",
                                    ["decoder/blocks/3/attn/q/w_q", "decoder/blocks/3/attn/k/w_q",
                                     "decoder/blocks/3/attn/v/w_q"])],
                         ids=["raw", "packed_int8"])
def test_counterpart_paths(names):
    port, want = names
    assert _jax_leaves(port) == want
    assert re.fullmatch(r"[\w/]+", want[0])
