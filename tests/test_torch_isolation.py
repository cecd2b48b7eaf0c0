"""The port stands alone: it imports nothing of the JAX package, needs none
of the host-only packages the GPU machine lacks (pandas, sklearn; matplotlib,
cv2, Pillow and the API clients only inside the functions that use them),
and its own copies of the host layers (tokenization, constants, video
frames) give the JAX package's results.

Tolerances: token ids, constants and frame layouts are compared exactly.
"""

import ast
import dataclasses
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from t2v_metrics_tpu import constants as JC  # noqa: E402
from t2v_metrics_tpu import tokenization as JT  # noqa: E402
from t2v_metrics_tpu.media import video as JV  # noqa: E402
from t2v_metrics_tpu_torch import constants as TC  # noqa: E402
from t2v_metrics_tpu_torch import tokenization as TT  # noqa: E402
from t2v_metrics_tpu_torch.media import video as TV  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "t2v_metrics_tpu_torch"


def test_port_and_chip_smoke_load_no_jax_package():
    """Importing the port, every module under it and chip_smoke (as a
    module) leaves no t2v_metrics_tpu module and no jax in sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import t2v_metrics_tpu_torch as t\n"
        "for m in pkgutil.walk_packages(t.__path__, 't2v_metrics_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 't2v_metrics_tpu')\n"
        "             or m.startswith(('jax.', 't2v_metrics_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("ok")


def test_parallel_modules_are_scanned_and_a_rank_loads_no_jax(tmp_path):
    """parallel/ (mesh, comm, sp, pipeline, launch) is in the source scans
    below, and a rank of a process group that builds a mesh and shards a
    model through it loads no jax and no t2v_metrics_tpu module."""
    modules = {p.stem for p in (PORT / "parallel").glob("*.py")}
    assert {"mesh", "comm", "sp", "pipeline", "launch"} <= modules
    scanned = {p for p in PORT.rglob("*.py")}
    assert all(PORT / "parallel" / f"{m}.py" in scanned for m in modules)
    init = f"file://{tmp_path / 'init'}"
    code = (
        "import sys, torch, torch.distributed as dist\n"
        f"dist.init_process_group('gloo', init_method={init!r}, world_size=1, rank=0)\n"
        "from t2v_metrics_tpu_torch.parallel import comm, launch, mesh, pipeline, sp\n"
        "from t2v_metrics_tpu_torch.models import clip_flant5 as c\n"
        "from t2v_metrics_tpu_torch.models.adapters import CLIP_T5_MODELS as R\n"
        "m = mesh.make_mesh(dp=1, tp=1)\n"
        "model = c.init_clip_t5(R['clip-flant5-test']['config'], 0, 'cpu', mesh=m)\n"
        "assert model.mesh is m\n"
        "dist.destroy_process_group()\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 't2v_metrics_tpu')\n"
        "             or k.startswith(('jax.', 't2v_metrics_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("ok")


_HUB_PACKAGES = ("safetensors", "transformers", "huggingface_hub")


@pytest.mark.parametrize("with_tokenizer", [False, True], ids=["no_tokenizer", "tokenizer_dir"])
def test_loading_a_checkpoint_pulls_no_hub_package(tmp_path, with_tokenizer):
    """Importing the port and loading a staged HF checkpoint (safetensors
    shards + index) leaves no safetensors, transformers or huggingface_hub
    in sys.modules: the GPU machine has none of them. A tokenizer directory
    is read through transformers, so with tokenizer=<dir> it appears."""
    from test_torch_hf_parity import clip_t5_hf, stage_safetensors, stage_tokenizer

    path = stage_safetensors(clip_t5_hf()[3], str(tmp_path / "ckpt"))
    tok = stage_tokenizer(str(tmp_path / "tok"), "a photo of cat Yes", t5=True)
    code = (
        "import sys, numpy as np, torch\n"
        "sys.path.insert(0, 'tests')\n"
        "import t2v_metrics_tpu_torch as t\n"
        "from test_torch_hf_parity import CLIP_T5_CFG\n"
        f"kw = dict(tokenizer={tok!r}) if {with_tokenizer} else {{}}\n"
        f"s = t.VQAScore('clip-flant5-xl', config=CLIP_T5_CFG, checkpoint={path!r},\n"
        "               device='cpu', dtype=torch.float32, **kw)\n"
        "img = np.zeros((28, 28, 3), np.uint8)\n"
        "assert np.isfinite(s(images=[img], texts=['a photo of cat'])).all()\n"
        f"hub = {_HUB_PACKAGES!r}\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in hub))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    loaded = res.stdout.strip().splitlines()[-1]
    if with_tokenizer:
        assert "'transformers'" in loaded
    else:
        assert loaded == "[]", loaded


def test_omni_audio_scoring_pulls_no_hub_package(tmp_path):
    """Qwen3-Omni scores an image with a .wav (the stdlib reader, the port's
    own mel filterbank) with no transformers, safetensors or
    huggingface_hub in sys.modules."""
    code = (
        "import sys, wave, numpy as np\n"
        "import t2v_metrics_tpu_torch as t\n"
        f"path = {str(tmp_path / 'a.wav')!r}\n"
        "with wave.open(path, 'wb') as w:\n"
        "    w.setnchannels(1); w.setsampwidth(2); w.setframerate(16000)\n"
        "    w.writeframes((np.sin(np.arange(8000) / 9.0) * 9000).astype(np.int16).tobytes())\n"
        "s = t.VQAScore('qwen3-omni-test', device='cpu')\n"
        "img = np.zeros((28, 28, 3), np.uint8)\n"
        "assert np.isfinite(s(images=[img], texts=['a tone'], audio_paths=[path])).all()\n"
        f"hub = {_HUB_PACKAGES!r}\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in hub))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]", res.stdout


def test_omni_speech_output_pulls_no_hub_package(tmp_path):
    """``generate(return_audio=True)`` on qwen3-omni-test (chip_smoke's
    chat-preserving tokenizer) with a tiny talker and Code2Wav drawn by
    ``init_talker`` / ``init_code2wav`` (seeded, in HF's layout, through the
    port's converters) writes a .wav with no transformers, safetensors or
    huggingface_hub in sys.modules."""
    code = (
        "import dataclasses, sys, wave, numpy as np\n"
        "import t2v_metrics_tpu_torch as t\n"
        "from t2v_metrics_tpu_torch.models import decoder as dec, qwen3omni_talker as tk\n"
        "text = dataclasses.replace(dec.DecoderConfig(vocab_size=64, d_model=32, layers=2,\n"
        "    heads=4, kv_heads=2, head_dim=8, d_ff=0, rope_theta=1e4, mrope_section=(2, 1, 1),\n"
        "    mrope_interleaved=True, qkv_bias=False, qk_norm=True), num_experts=4,\n"
        "    experts_per_tok=2, moe_d_ff=16, moe_norm_topk=False, moe_shared_ff=24,\n"
        "    moe_dispatch=True)\n"
        "pred = dec.DecoderConfig(vocab_size=48, d_model=32, layers=2, heads=4, kv_heads=2,\n"
        "    head_dim=8, d_ff=64, rope_theta=1e4, mrope_section=None, qkv_bias=False, qk_norm=True)\n"
        "c2w = tk.Code2WavConfig(codebook_size=64, num_quantizers=4, hidden_size=32,\n"
        "    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,\n"
        "    intermediate_size=64, sliding_window=8, upsampling_ratios=(2,),\n"
        "    upsample_rates=(2, 2), decoder_dim=16)\n"
        "import chip_smoke\n"
        "tok = chip_smoke.chat_tokenizer(512)\n"
        "s = t.VQAScore('qwen3-omni-test', device='cpu', tokenizer=tok)\n"
        "ids = lambda w: tok.encode(w, add_special_tokens=False)[0]\n"
        "cfg = tk.TalkerConfig(text=text, predictor=pred, code2wav=c2w, num_code_groups=4,\n"
        "    thinker_hidden_size=48, accept_hidden_layer=1, codec_eos_token_id=60,\n"
        "    codec_nothink_id=54, codec_think_bos_id=55, codec_think_eos_id=56, codec_pad_id=52,\n"
        "    codec_bos_id=53, speaker_id=(('ethan', 57),), suppress_band=12,\n"
        "    im_start_token_id=ids('<|im_start|>'), system_token_id=ids('system'),\n"
        "    user_token_id=ids('user'), assistant_token_id=ids('assistant'),\n"
        "    tts_bos_token_id=8, tts_eos_token_id=9, tts_pad_token_id=10)\n"
        "s.model.kwargs.update(talker_config=cfg, talker_params=tk.init_talker(cfg, 0, 'cpu',\n"
        "    proj_ff=64), code2wav_params=tk.init_code2wav(c2w, 1, 'cpu'))\n"
        f"path = {str(tmp_path / 'out.wav')!r}\n"
        "texts, wavs = s.model.generate([np.zeros((28, 28, 3), np.uint8)], ['Say it.'],\n"
        "    max_new_tokens=3, return_audio=True, save_audio_path=path,\n"
        "    talker_max_new_tokens=3)\n"
        "assert isinstance(texts[0], str) and np.isfinite(wavs[0]).all()\n"
        "assert wave.open(path, 'rb').getframerate() == 24000\n"
        f"hub = {_HUB_PACKAGES!r}\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in hub))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]", res.stdout


def _imports(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", sorted([*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_nothing_of_the_jax_package(path):
    """No import statement of the port or of chip_smoke names jax or
    t2v_metrics_tpu, at top level or inside a function."""
    bad = [n for n in _imports(path)
           if n.split(".")[0] in ("jax", "jaxlib", "t2v_metrics_tpu")]
    assert not bad, bad


_LAZY = ("matplotlib", "cv2", "PIL", "openai", "google", "diffusers")


def _module_level_imports(path: pathlib.Path) -> list[str]:
    """Imports that run when the module is imported: those outside every
    function body."""
    names = []

    def visit(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            if isinstance(child, ast.Import):
                names.extend(a.name for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0 and child.module:
                names.append(child.module)
            visit(child)
    visit(ast.parse(path.read_text(), str(path)))
    return names


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_need_no_host_only_package(path):
    """The GPU machine has no pandas, sklearn, matplotlib, cv2, Pillow,
    openai or google-genai: no module of the port imports pandas or sklearn
    at all, and the others only inside the functions that need them."""
    assert not [n for n in _imports(path) if n.split(".")[0] in ("pandas", "sklearn")]
    assert not [n for n in _module_level_imports(path) if n.split(".")[0] in _LAZY]


def test_genai_bench_scoring_loads_no_host_only_package(tmp_path):
    """GenAIBench_Image built with arrays (``return_image_paths=False``) and
    scored through ``cli.genai_image_eval.load_or_compute_scores`` on
    clip-flant5-test, then evaluated per skill: no pandas, sklearn, PIL, cv2
    or matplotlib in sys.modules (the way the GPU machine runs it)."""
    root = tmp_path / "GenAI-Image-1600"
    root.mkdir()
    prompts = {f"{i:05d}": {"prompt": f"prompt {i}", "models": {
        m: [1 + i, 3] for m in ("DALLE_3", "SDXL_Turbo", "DeepFloyd_I_XL_v1", "Midjourney_6",
                                "SDXL_2_1", "SDXL_Base")}} for i in range(2)}
    (root / "genai_image.json").write_text(json.dumps(prompts))
    (root / "genai_skills.json").write_text(json.dumps({"basic": [0], "advanced": [1]}))
    code = (
        "import argparse, sys, zlib, numpy as np\n"
        "from t2v_metrics_tpu_torch.benchmarks.datasets import GenAIBench_Image\n"
        "from t2v_metrics_tpu_torch.cli import genai_image_eval as cli\n"
        "pre = lambda p: np.random.default_rng(zlib.crc32(p.encode())).integers(\n"
        "    0, 256, (40, 40, 3), dtype=np.uint8)\n"
        f"ds = GenAIBench_Image(root_dir={str(tmp_path)!r}, return_image_paths=False,\n"
        "                      image_preprocess=pre)\n"
        "args = argparse.Namespace(model='clip-flant5-test', device='cpu', cache_dir=None,\n"
        "                          batch_size=4, question=None, answer=None)\n"
        f"s = cli.load_or_compute_scores(args, ds, {str(tmp_path / 's.npz')!r})\n"
        "assert s.shape == (12, 1, 1) and np.isfinite(s).all()\n"
        "ds.evaluate_scores(s); ds.evaluate_scores_per_skill(s)\n"
        "cli.show_performance_per_skill(s.mean(axis=1)[:, 0], ds, tag_groups={})\n"
        "bad = ('pandas', 'sklearn', 'PIL', 'cv2', 'matplotlib')\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in bad))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]", res.stdout[-2000:]


def test_simple_t5_tokenizer_gives_the_jax_ids():
    texts = ["a red cube on a table", "two dogs", "a red dog", "", "cube  cube",
             "USER: <image>\nDoes this show a cat? ASSISTANT:"]
    for vocab in (32128, 8):     # 8: the vocabulary fills and unknown words map to <unk>
        jt, tt = JT.SimpleT5Tokenizer(vocab), TT.SimpleT5Tokenizer(vocab)
        for text in texts:
            assert tt(text).input_ids == jt(text).input_ids
            assert tt.encode(text, add_special_tokens=False) == jt.encode(
                text, add_special_tokens=False)
        ids = jt("a red cube").input_ids
        assert tt.decode(ids) == jt.decode(ids)
        for attr in ("pad_token_id", "eos_token_id", "unk_token_id", "bos_token_id"):
            assert getattr(tt, attr) == getattr(jt, attr)


def test_splice_image_tokens_t5_gives_the_jax_ids():
    from t2v_metrics_tpu_torch.models.clip_flant5 import format_question

    prompts = [format_question("a red cube"), "<image>a dog", "no image here",
               "two <image> images <image> here"]
    jt, tt = JT.SimpleT5Tokenizer(), TT.SimpleT5Tokenizer()
    for prompt in prompts:
        # the port's splice with the port's tokenizer, the JAX splice with
        # the JAX tokenizer, each fed the same sequence of prompts
        assert (TT.splice_image_tokens_t5(prompt, tt)
                == JT.splice_image_tokens_t5(prompt, jt))


def test_constants_equal_the_jax_package():
    for name in ("SYSTEM_MSG", "IMAGE_TOKEN_INDEX", "DEFAULT_IMAGE_TOKEN",
                 "DEFAULT_QUESTION_TEMPLATE", "DEFAULT_ANSWER_TEMPLATE",
                 "CLIP_MEAN", "CLIP_STD", "VIDEO_EXTENSIONS"):
        assert getattr(TC, name) == getattr(JC, name), name


def test_video_helpers_equal_the_jax_package():
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in ((12, 20), (16, 8), (5, 5))]
    np.testing.assert_array_equal(TV.concatenate_horizontal(frames, dist=3),
                                  JV.concatenate_horizontal(frames, dist=3))
    for total, n, mode in ((100, 8, "step"), (7, 8, "step"), (100, 8, "linspace"),
                           (0, 4, "linspace")):
        np.testing.assert_array_equal(TV.frame_indices(total, n, mode),
                                      JV.frame_indices(total, n, mode))
    for path in ("a.mp4", "b.MOV", "c.png", 3, None, "d.webm"):
        assert TV.is_video_path(path) == JV.is_video_path(path)


def test_video_info_and_collages_equal_the_jax_package(tmp_path):
    """``video_info`` of a cv2-written clip, ``concatenate_vertical`` and
    ``concatenate_grid`` (cv2 Lanczos) give the JAX package's results."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in ((12, 20), (16, 8), (5, 5))]
    np.testing.assert_array_equal(TV.concatenate_vertical(frames, dist=3),
                                  JV.concatenate_vertical(frames, dist=3))
    np.testing.assert_array_equal(TV.concatenate_grid(frames, output_size=(64, 48)),
                                  JV.concatenate_grid(frames, output_size=(64, 48)))
    path = str(tmp_path / "c.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"FFV1"), 12.0, (20, 12))
    for _ in range(5):
        writer.write(frames[0])
    writer.release()
    assert TV.video_info(path) == JV.video_info(path) == {
        "total_frames": 5, "fps": 12.0, "width": 20, "height": 12}


def test_conversation_templates_equal_the_jax_package():
    """InternVL's templates: the port's copy of fastchat_utils gives the JAX
    package's prompt in every template and separator style."""
    from t2v_metrics_tpu.models import fastchat_utils as JF
    from t2v_metrics_tpu_torch.models import fastchat_utils as TF

    assert list(TF.conv_templates) == list(JF.conv_templates)
    assert [s.name for s in TF.SeparatorStyle] == [s.name for s in JF.SeparatorStyle]
    for name in JF.conv_templates:
        t, j = TF.get_conv_template(name), JF.get_conv_template(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name
        for conv in (t, j):
            conv.append_message(conv.roles[0], "<image>\nq")
            conv.append_message(conv.roles[1], "a")
            conv.append_message(conv.roles[0], "again")
            conv.append_message(conv.roles[1], None)
        assert t.get_prompt() == j.get_prompt(), name


def test_load_hf_tokenizer_stays_local(monkeypatch):
    """A path that is not a directory is read from the local cache only."""
    seen = {}

    class AutoTokenizer:
        @staticmethod
        def from_pretrained(path, **kwargs):
            seen.update(kwargs, path=path)
            return "tok"

    import types

    monkeypatch.setitem(sys.modules, "transformers",
                        types.SimpleNamespace(AutoTokenizer=AutoTokenizer))
    assert TT.load_hf_tokenizer("google/flan-t5-xxl") == "tok"
    assert seen["local_files_only"] is True and seen["use_fast"] is True
