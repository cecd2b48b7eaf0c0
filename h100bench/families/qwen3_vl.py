"""The qwen3_vl family on the port: how the benchmark builds the system under
test, and the work a chunk of pairs needs (operations and bytes, by kernel
family), counted from shapes.

The counts are a PyTorch-free rewrite of bench.py's ``qwen_video_flops_per_pair``
for Qwen3-VL images: the rows the inputs need (each image's own patch grid,
not the port's bucket; each prompt's own length, not its sequence bucket),
every matrix product once with its weight, input and output bytes, each
attention call with its q, k, v and output bytes (GQA: the kv heads' bytes),
and the routed experts as grouped products over the top-k rows, with the
weights of the experts those rows reach.
"""

from __future__ import annotations

from ..reference import qwen3_vl as ref
from ..tokenizer import WordTokenizer

# the async pipeline's one call does the host stage, the dispatch and a wait
# on the device, so no span of it is host time alone
HOST_STAGE = None
DISPATCH = "forward_device"


def _check_sizes(pcfg, cfg: dict) -> None:
    """The port's registry config must hold the sizes of the file."""
    for part, sub in (("vision", pcfg.vision), ("text", pcfg.text)):
        for key, value in cfg[part].items():
            got = getattr(sub, key)
            want = tuple(value) if isinstance(value, list) else value
            if got != want:
                raise ValueError(f"{cfg['model']}: the port's {part}.{key} is {got!r}, "
                                 f"the configuration's {want!r}")
    for key in ("image_token_id", "video_token_id", "vision_start_token_id",
                "vision_end_token_id"):
        if getattr(pcfg, key) != cfg[key]:
            raise ValueError(f"{cfg['model']}: the port's {key} differs")


def build(cfg: dict, seed: int, device):
    """The port's VQAScore with the benchmark's weights written in place
    into the model the port allocates, and the benchmark's tokenizer."""
    import torch

    from t2v_metrics_tpu_torch.models import qwen3vl
    from t2v_metrics_tpu_torch.models import qwen2vl_adapter as qa
    from t2v_metrics_tpu_torch.score import VQAScore

    from ..weights import fill_

    pcfg = qwen3vl.resolve_config(cfg["model"])
    _check_sizes(pcfg, cfg)
    limits = cfg["image_resize"]
    if (qa.IMAGE_MIN_PIXELS, qa.IMAGE_MAX_PIXELS) != (limits["min_pixels"],
                                                      limits["max_pixels"]):
        raise ValueError(f"{cfg['model']}: the port's image pixel limits differ")
    model = qwen3vl.Qwen3VLModel(pcfg, torch.device(device), getattr(torch, cfg["dtype"]))
    fill_(model, seed, ref.leaf_rule(cfg))
    return VQAScore(cfg["model"], device=str(device), params=model,
                    tokenizer=WordTokenizer(cfg["tokenizer_vocab"]))


def media_input(raw):
    """A raw uint8 (H, W, 3) image goes in as it is."""
    return raw


def log_scores(cfg: dict, seed: int, media: list, prompts: list[str], pairs, device,
               quant=None):
    return ref.log_scores(cfg, seed, media, prompts, pairs, device, quant)


def _gemm(m: float, k: int, n: int, weight: float | None = None, elt: int = 2):
    w = k * n if weight is None else weight
    return 2.0 * m * k * n, float(elt * (m * k + w + m * n))


def chunk_work(cfg: dict, media: int, prompts: list[str], image_hw=(1024, 1024)):
    """(kind, operations, bytes) of each call a chunk needs: ``media``
    distinct images (``image_hw`` each) encoded once, one pair per prompt. A
    matrix product of the chunk is one call; an attention layer one call
    over all its rows."""
    v, t = cfg["vision"], cfg["text"]
    tok = WordTokenizer(cfg["tokenizer_vocab"])
    gh, gw = ref.grid_of(cfg, *image_hw)
    s = gh * gw
    mu = v["merge_size"] ** 2
    hid, pd = v["hidden"], 3 * v["temporal_patch_size"] * v["patch_size"] ** 2
    items = []

    def gemm(m, k, n, weight=None):
        items.append(("gemm",) + _gemm(m, k, n, weight))

    rows = media * s
    gemm(rows, pd, hid)
    for _ in range(v["depth"]):
        gemm(rows, hid, 3 * hid)
        items.append(("attention", 4.0 * media * s * s * hid, 2.0 * 4 * rows * hid))
        gemm(rows, hid, hid)
        gemm(rows, hid, v["d_ff"])
        gemm(rows, v["d_ff"], hid)
    width = hid * mu
    for _ in range(1 + len(v["deepstack_indexes"])):
        gemm(rows / mu, width, width)
        gemm(rows / mu, width, v["out_hidden"])

    d, hd, heads, kvh = t["d_model"], t["head_dim"], t["heads"], t["kv_heads"]
    e, k, ff = t["num_experts"], t["experts_per_tok"], t["moe_d_ff"]
    ans = len(ref.answer_ids(tok))
    lens = [len(ref.prompt_ids(cfg, tok, p, s // mu)) + ans for p in prompts]
    n = sum(lens)
    used = min(e, n * k)
    for _ in range(t["layers"]):
        gemm(n, d, (heads + 2 * kvh) * hd)
        pairs_qk = sum(x * (x + 1) / 2 for x in lens)
        items.append(("attention", 4.0 * pairs_qk * heads * hd,
                      2.0 * n * (2 * heads * hd + 2 * kvh * hd)))
        gemm(n, heads * hd, d)
        gemm(n, d, e)
        items.append(("grouped_gemm",) + _gemm(n * k, d, 2 * ff, used * d * 2 * ff))
        items.append(("grouped_gemm",) + _gemm(n * k, ff, d, used * ff * d))
    gemm(ans * len(prompts), d, t["vocab_size"])
    return items
