"""The benchmark's parts on the CPU: generators repeat per seed, the
operation and byte counts equal hand counts at the cells' shapes, the
end-to-end and per-layer readers take what they say, the reference's resize
is Pillow's, the no-JAX check compares whole top-level names, and
BENCHMARK.json keeps the contract's form."""

from __future__ import annotations

import importlib.util
import json
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from h100bench import peaks, run, traffic
from h100bench.families import clip_flant5 as fam
from h100bench.reference import clip_flant5 as ref
from h100bench.reference import pillow
from h100bench.tokenizer import WordTokenizer

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
BIG_SEED = 2**31 + 77


def _mix(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def _config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def _reader(name):
    spec = importlib.util.spec_from_file_location(name, BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# -- generators --------------------------------------------------------------

@pytest.mark.parametrize("mix", ["genai-image", "rerank8"])
def test_inputs_repeat_per_seed(mix):
    spec = dict(_mix(mix))
    spec["media"] = dict(spec["media"], height=24, width=20)
    a, b = traffic.make_inputs(spec, BIG_SEED), traffic.make_inputs(spec, BIG_SEED)
    assert all(np.array_equal(x, y) for x, y in zip(a.media, b.media))
    assert a.prompts == b.prompts
    for k in (0, 99):
        (ma, pa), (mb, pb) = a.stream(k), b.stream(k)
        assert [next(ma) for _ in range(300)] == [next(mb) for _ in range(300)]
        assert [next(pa) for _ in range(300)] == [next(pb) for _ in range(300)]
    c = traffic.make_inputs(spec, BIG_SEED + 1)
    assert c.prompts != a.prompts
    assert not np.array_equal(c.media[0], a.media[0])
    # every seed gets the same multiset of prompt lengths, in another order
    assert sorted(len(p.split()) for p in a.prompts) == \
        sorted(len(p.split()) for p in c.prompts)


def test_prompt_lengths_span_genai_bench():
    p = _mix("genai-image")["prompts"]
    lengths = traffic.prompt_lengths(p["pool"], p["min_words"], p["median_words"],
                                     p["max_words"])
    assert min(lengths) == 4 and max(lengths) == 48
    assert 11 <= float(np.median(lengths)) <= 13


def test_no_image_repeats_within_a_chunk():
    spec = dict(_mix("genai-image"))
    spec["media"] = dict(spec["media"], height=8, width=8)
    inputs = traffic.make_inputs(spec, BIG_SEED)
    driver = traffic.Driver(None, inputs, lambda m: m)
    units = driver._units(0)
    for _ in range(3):
        mi, pi = next(units)
        assert len(mi) == spec["batch_size"] * spec["round_chunks"]
        for k in range(0, len(mi), spec["batch_size"]):
            chunk = mi[k:k + spec["batch_size"]]
            assert len(set(chunk)) == len(chunk)


# -- counts ------------------------------------------------------------------

def test_counts_equal_hand_counts_at_the_xxl_shapes():
    cfg = _config("clip-flant5-xxl")
    tok = WordTokenizer(32128)
    prompt = " ".join(["dog"] * 10)
    # the system message and "USER:" (24 words) + </s> before the image, 576
    # features, then "Does this figure show "dog ... dog"? Please answer yes
    # or no. ASSISTANT:" (20 words) + </s>
    s = ref.encoder_length(cfg, tok, prompt)
    assert s == 25 + 576 + 21
    items = fam.chunk_work(cfg, 16, [prompt] * 16)
    gemm = [i for i in items if i[0] == "gemm"]
    attn = [i for i in items if i[0] == "attention"]
    # patch embed + 23 ViT blocks x 4 + projector 2 + 24 x 5 + 24 x 9 + lm_head
    assert len(gemm) == 1 + 23 * 4 + 2 + 24 * 5 + 24 * 9 + 1
    assert len(attn) == 23 + 24 + 24 * 2
    vit_qkv = gemm[1]
    assert vit_qkv[1] == 2 * (16 * 577) * 1024 * 3072
    assert vit_qkv[2] == 2 * (16 * 577 * 1024 + 1024 * 3072 + 16 * 577 * 3072)
    assert attn[0][1] == 4 * 16 * 577 * 577 * 1024
    assert attn[0][2] == 2 * 4 * 16 * 577 * 1024
    enc_qkv = gemm[1 + 23 * 4 + 2]
    assert enc_qkv[1] == 2 * (16 * s) * 4096 * 12288
    enc_attn = attn[23]
    assert enc_attn[1] == 4 * 16 * s * s * 4096
    dec_self, cross = attn[23 + 24], attn[23 + 25]
    assert dec_self[1] == 4 * 16 * 3 * 4096           # 2 answer tokens, causal
    assert cross[1] == 4 * 2 * 16 * s * 4096
    assert gemm[-1][1] == 2 * 32 * 4096 * 32128
    per_pair = sum(o for _, o, _ in items) / 16
    assert 7.0e12 < per_pair < 7.6e12


def test_bound_is_the_larger_of_operations_and_bytes():
    assert peaks.bound_s(989e12, 0.0) == pytest.approx(1.0)
    assert peaks.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(989e12, 6.7e12) == pytest.approx(2.0)


@pytest.mark.parametrize("name,family", [
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "gemm"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT", "gemm"),
    ("void flash::flash_fwd_kernel<Flash_fwd_kernel_traits<64>>", "attention"),
    ("fmha_cutlassF_bf16_aligned_64x64_rf_sm80", "attention"),
    ("cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16", "attention"),
    ("void flat_attention_kernel<64, true>", "attention"),
    ("grouped_gemm_kernel", "grouped_gemm"),
    ("void cutlass::device_kernel<at::cuda::detail::GroupedGemm>", "grouped_gemm"),
    ("void row_norm::row_norm_kernel<row_norm::RmsNorm, __nv_bfloat16>", "rms_norm"),
    ("void at::native::vectorized_elementwise_kernel<4, add>", "other"),
])
def test_kernel_families(name, family):
    assert peaks.kernel_family(name) == family


# -- readers -----------------------------------------------------------------

def _ctx(**kw):
    base = dict(pairs=0, seconds=1.0, setup_s=1.0, call_seconds=[], work=[],
                window_s=None, busy_s=None, family_s={}, spans_s={})
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_pairs_per_s_is_taken_over_the_whole_window():
    assert _reader("pairs_per_s")(_ctx(pairs=1000, seconds=30.5)) == pytest.approx(1000 / 30.5)


def test_p95_is_taken_over_all_calls():
    calls = [0.1] * 90 + [1.0] * 10
    # the 95th percentile of all 100 calls, not a median of chunks
    assert _reader("call_p95_ms")(_ctx(call_seconds=calls)) == pytest.approx(1000.0)
    assert _reader("call_p50_ms.rerank")(_ctx(call_seconds=calls)) == pytest.approx(100.0)
    rng = np.random.default_rng(0)
    many = rng.exponential(0.1, 997).tolist()
    assert _reader("call_p95_ms")(_ctx(call_seconds=many)) == \
        pytest.approx(np.percentile(many, 95) * 1e3)


def test_device_readers():
    work = [("gemm", 989e9, 1.0), ("attention", 0.0, 3.35e9), ("gemm", 989e9, 1.0)]
    ctx = _ctx(pairs=10, window_s=2.0, busy_s=1.5, work=work,
               family_s={"gemm": 0.004, "attention": 0.002, "other": 0.01},
               spans_s={"prep": 0.05})
    assert _reader("gemm_roofline")(ctx) == pytest.approx(50.0)
    assert _reader("attention_roofline")(ctx) == pytest.approx(50.0)
    assert _reader("grouped_gemm_roofline")(ctx) is None
    assert _reader("device_idle.pairs")(ctx) == pytest.approx(25.0)
    assert _reader("device_idle.rerank")(ctx) == pytest.approx(25.0)
    assert _reader("mfu.pairs")(ctx) == pytest.approx(100 * 2 * 989e9 / (2.0 * 989e12))
    assert _reader("glue_ms_per_pair")(ctx) == pytest.approx(1.0)
    assert _reader("adapter_host_ms_per_pair")(ctx) == pytest.approx(5.0)
    untraced = _ctx(pairs=10)
    assert _reader("mfu.pairs")(untraced) is None
    assert _reader("adapter_host_ms_per_pair")(untraced) is None


# -- the reference's resize ---------------------------------------------------

@pytest.mark.parametrize("shape,size", [((388, 400), 56), ((1024, 1024), 336),
                                        ((300, 380), 336), ((61, 47), 90)])
def test_resize_is_pillows(shape, size):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    fill = tuple(int(m * 255) for m in ref.CLIP_MEAN)
    square = pillow.expand_to_square(torch.from_numpy(img), fill).numpy()
    pil = Image.fromarray(img)
    side = max(pil.size)
    canvas = Image.new(pil.mode, (side, side), fill)
    canvas.paste(pil, ((side - pil.width) // 2, (side - pil.height) // 2))
    assert np.array_equal(np.asarray(canvas), square)
    want = np.asarray(canvas.resize((size, size), Image.BICUBIC))
    got = pillow.resize(torch.from_numpy(square), size, size).numpy()
    assert np.array_equal(got.astype(np.uint8), want)


# -- no JAX ------------------------------------------------------------------

def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    fake = {"t2v_metrics_tpu_torch": 1, "t2v_metrics_tpu_torch.ops": 1, "jaxtyping": 1,
            "flax_like": 1, "jax.numpy": 1, "t2v_metrics_tpu.models": 1, "flax": 1}
    monkeypatch.setattr(sys, "modules", fake)
    assert run.forbidden_modules() == ["flax", "jax.numpy", "t2v_metrics_tpu.models"]


def test_a_run_loads_no_jax():
    """Everything a run imports (the harness, the family, the port's facade
    and models, the reference, the profiler) in a fresh process."""
    code = ("import h100bench.run as r, h100bench.trace, h100bench.control\n"
            "import h100bench.families.clip_flant5, h100bench.reference.clip_flant5\n"
            "import t2v_metrics_tpu_torch.score, t2v_metrics_tpu_torch.models.adapters\n"
            "import torch.profiler\n"
            "r.environment(); print(r.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


# -- BENCHMARK.json ------------------------------------------------------------

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_keeps_the_contract():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["h100bench"] and 1 <= bench["run_seconds"] <= 51
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("h100bench/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and NAME.match(w["name"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
        mine = run.cell_metrics(bench, "end_to_end", w["name"])
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert run.cell_metrics(bench, "per_layer", w["name"])
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in e2e[m["moves"]].get("workloads", [w])
