"""The clip_flant5 family on the port: how the benchmark builds the system
under test, and the work a chunk of pairs needs (operations and bytes, by
kernel family), counted from shapes.

The counts are a PyTorch-free rewrite of bench.py's ``flops_per_pair`` for
these shapes: only the rows the inputs need (577 ViT tokens, not the port's
640; each prompt's own encoder length, not its bucket; the answer's two
decoder positions), every matrix product once with its weight, input and
output bytes, and each attention call with its q, k, v and output bytes.
"""

from __future__ import annotations

from ..reference import clip_flant5 as ref
from ..tokenizer import WordTokenizer

HOST_STAGE = "prepare_pairs"        # the staged pipeline's host stage
DISPATCH = "forward_device_prepared"


def _check_sizes(pcfg, cfg: dict) -> None:
    """The port's registry config must hold the sizes of the file."""
    want = {("t5", k): v for k, v in cfg["t5"].items()}
    want.update({("vision", k): v for k, v in cfg["vision"].items()})
    for (part, key), value in want.items():
        got = getattr(getattr(pcfg, part), key)
        if got != value:
            raise ValueError(f"{cfg['model']}: the port's {part}.{key} is {got!r}, "
                             f"the configuration's {value!r}")
    for key in ("num_image_tokens", "conversation", "image_aspect_ratio"):
        if getattr(pcfg, key) != cfg[key]:
            raise ValueError(f"{cfg['model']}: the port's {key} differs")


def build(cfg: dict, seed: int, device):
    """The port's VQAScore with the benchmark's weights written in place
    into the model the port allocates, and the benchmark's tokenizer."""
    import torch

    from t2v_metrics_tpu_torch.models import adapters, clip_flant5
    from t2v_metrics_tpu_torch.score import VQAScore

    from ..weights import fill_

    pcfg = adapters.CLIP_T5_MODELS[cfg["model"]]["config"]
    _check_sizes(pcfg, cfg)
    model = clip_flant5.CLIPT5Model(pcfg, torch.device(device), getattr(torch, cfg["dtype"]))
    fill_(model, seed, ref.leaf_rule(cfg))
    return VQAScore(cfg["model"], device=str(device), params=model,
                    tokenizer=WordTokenizer(cfg["t5"]["vocab_size"]))


def media_input(raw):
    """A raw uint8 (H, W, 3) image goes in as it is."""
    return raw


def log_scores(cfg: dict, seed: int, media: list, prompts: list[str], pairs, device,
               quant=None):
    return ref.log_scores(cfg, seed, media, prompts, pairs, device, quant)


def _gemm(m: int, k: int, n: int, elt: int = 2):
    return 2.0 * m * k * n, float(elt * (m * k + k * n + m * n))


def _attn(pairs_qk: float, sq: int, sk: int, hd: int, elt: int = 2):
    """Operations of the q.k and p.v products over ``pairs_qk`` (query, key)
    pairs, and the q, k, v and output bytes."""
    return 4.0 * pairs_qk * hd, float(elt * (2 * sq * hd + 2 * sk * hd))


def chunk_work(cfg: dict, media: int, prompts: list[str],
               image_hw=None) -> list[tuple[str, float, float]]:
    """(kind, operations, bytes) of each call a chunk needs: ``media``
    distinct images encoded once (every size is resized to the tower's),
    one pair per prompt (pair j with its image). A matrix product of the
    chunk is one call; an attention layer is one call over all its rows."""
    v, t5 = cfg["vision"], cfg["t5"]
    tok = WordTokenizer(t5["vocab_size"])
    w, d = v["width"], t5["d_model"]
    patch, size = v["patch_size"], v["image_size"]
    grid = (size // patch) ** 2
    tv = grid + 1
    items = []

    def gemm(m, k, n):
        items.append(("gemm",) + _gemm(m, k, n))

    def attn(pairs_qk, sq, sk, hd):
        items.append(("attention",) + _attn(pairs_qk, sq, sk, hd))

    rows = media * tv
    gemm(media * grid, 3 * patch * patch, w)
    for _ in range(v["layers"] + 1 + cfg["feature_layer"]):
        gemm(rows, w, 3 * w)
        attn(media * tv * tv, rows, rows, w)
        gemm(rows, w, w)
        gemm(rows, w, v["mlp_dim"])
        gemm(rows, v["mlp_dim"], w)
    gemm(media * grid, w, d)
    gemm(media * grid, d, d)

    inner = t5["num_heads"] * t5["d_kv"]
    lens = [ref.encoder_length(cfg, tok, p) for p in prompts]
    s_rows, a = sum(lens), ref.answer_length(tok)
    a_rows = a * len(prompts)
    for _ in range(t5["enc_layers"]):
        gemm(s_rows, d, 3 * inner)
        attn(sum(s * s for s in lens), s_rows, s_rows, inner)
        gemm(s_rows, inner, d)
        gemm(s_rows, d, t5["d_ff"])
        gemm(s_rows, d, t5["d_ff"])
        gemm(s_rows, t5["d_ff"], d)
    for _ in range(t5["dec_layers"]):
        gemm(a_rows, d, 3 * inner)
        attn(len(prompts) * a * (a + 1) / 2, a_rows, a_rows, inner)
        gemm(a_rows, inner, d)
        gemm(a_rows, d, inner)
        gemm(s_rows, d, inner)
        gemm(s_rows, d, inner)
        attn(a * s_rows, a_rows, s_rows, inner)
        gemm(a_rows, inner, d)
        gemm(a_rows, d, t5["d_ff"])
        gemm(a_rows, d, t5["d_ff"])
        gemm(a_rows, t5["d_ff"], d)
    gemm(a_rows, d, t5["vocab_size"])
    return items
