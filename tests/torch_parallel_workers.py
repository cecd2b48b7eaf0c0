"""Rank programs of tests/test_torch_parallel_tp.py and
tests/test_torch_parallel_pp_sp.py: each runs in a spawned process of a
gloo group (``parallel/launch.py:run_ranks``) and imports the port only
(no jax), so the ranks start fast. ``run_cases`` runs a file's cases in
order on every rank (each builds its mesh, so every rank creates the same
process groups in the same order) and returns {case name: result}.
"""

from __future__ import annotations

import numpy as np
import torch

from t2v_metrics_tpu_torch.parallel import mesh as M


def _mesh(spec):
    kind, kw = spec
    if kind == "mesh":
        return M.make_mesh(**kw)
    if kind == "multihost":
        return M.make_multihost_mesh(**kw)
    return M.Mesh(np.asarray(kw["devices"]), kw["names"])


def run_cases(rank: int, cases: list) -> dict:
    out = {}
    for case in cases:
        mesh = _mesh(case["mesh"])
        with torch.inference_mode():
            out[case["name"]] = globals()["case_" + case["kind"]](rank, mesh, **case["args"])
    return out


def _tokenizer(vocab_size: int, vocab: dict):
    """The port's SimpleT5Tokenizer holding the vocabulary the JAX side built."""
    from t2v_metrics_tpu_torch.tokenization import SimpleT5Tokenizer

    tok = SimpleT5Tokenizer(vocab_size)
    tok._vocab = dict(vocab)
    return tok


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# tensor / data / expert parallelism
# ---------------------------------------------------------------------------

def case_features(rank, mesh, tree, cfg, pixels):
    from t2v_metrics_tpu_torch.bridge import clip_t5_from_numpy
    from t2v_metrics_tpu_torch.models import clip_flant5 as tcft5

    model = M.shard_params(clip_t5_from_numpy(tree, cfg, "cpu", torch.float32), mesh)
    return tcft5.image_features(model, cfg, _t(pixels)).numpy()


def case_vqascore(rank, mesh, tree, vocab, images, texts, pair_images, pair_texts,
                  quant=None):
    """VQAScore through the adapter with ``mesh=``: the matrix, pairwise
    forward and batch_forward (the data split by image on every route)."""
    import t2v_metrics_tpu_torch as tt2v

    s = tt2v.VQAScore("clip-flant5-test", params=tree, tokenizer=_tokenizer(512, vocab),
                      device="cpu", mesh=mesh, quant=quant)
    data = [{"images": [images[i % 3]], "texts": texts} for i in range(5)]
    return {"matrix": s(images=images, texts=texts),
            "pairs": s.model.forward(pair_images, pair_texts),
            "batch": s.batch_forward(data, batch_size=2),
            "quantized": s.model.engine.params.t5.encoder.blocks[0].attn.qkv.quantized}


def case_clipscore(rank, mesh, tree, vocab, images, texts):
    import t2v_metrics_tpu_torch as tt2v

    s = tt2v.CLIPScore("clipscore-test", params=tree, tokenizer=_tokenizer(256, vocab),
                       device="cpu", mesh=mesh)
    return {"matrix": s(images=images, texts=texts),
            "pairs": s.model.forward(images, texts[:len(images)])}


def case_adapter_tp(rank, mesh, model, tree, vocab, vocab_size, images, texts, config=None):
    """A VQAScore family's adapter with its model sharded in place: the
    scoring path runs tensor-parallel through the leaves (``config``: the
    family's config, or None for the registry's)."""
    import t2v_metrics_tpu_torch as tt2v

    s = tt2v.VQAScore(model, params=tree, tokenizer=_tokenizer(vocab_size, vocab),
                      device="cpu", config=config)
    M.shard_params(s.model.params, mesh)
    return s(images=images, texts=texts)


def case_decoder(rank, mesh, tree, cfg, embeds, pos, mask):
    from t2v_metrics_tpu_torch.bridge import qwen3vl_from_numpy
    from t2v_metrics_tpu_torch.models import decoder as tdec

    model = M.shard_params(qwen3vl_from_numpy(tree, cfg, "cpu", torch.float32), mesh)
    experts = model.decoder.blocks[0].moe.gate_up.shape[0]
    return {"logits": tdec.forward(model.decoder, cfg.text, _t(embeds), _t(pos),
                                   _t(mask)).numpy(),
            "experts": experts}


def case_multihost(rank, mesh, tree, cfg, inputs):
    """image_features and score_pairs with the model sharded over tp and
    the pairs over the data axes ("dcn", "dp")."""
    from t2v_metrics_tpu_torch.bridge import clip_t5_from_numpy
    from t2v_metrics_tpu_torch.models import clip_flant5 as tcft5

    model = M.shard_params(clip_t5_from_numpy(tree, cfg, "cpu", torch.float32), mesh)
    pixels, *arrays, pair_image, pair_text = map(_t, inputs)
    feats = tcft5.image_features(model, cfg, pixels)
    data = M.data_sharding(mesh, 1)
    rows = data.rows(len(pair_image))
    local = tcft5.score_pairs(model, cfg, feats, *arrays, pair_image[rows].long(),
                              pair_text[rows].long())
    return {"scores": data.gather(local, len(pair_image)).numpy(), "spec": data.spec,
            "rows": (rows.start, rows.stop)}


# ---------------------------------------------------------------------------
# pipeline and sequence parallelism
# ---------------------------------------------------------------------------

def _t5(tree, cfg):
    from t2v_metrics_tpu_torch.bridge import t5_from_numpy

    return t5_from_numpy(tree, cfg, "cpu", torch.float32)


def case_pipeline(rank, mesh, tree, cfg, embeds, mask, n_micro):
    from t2v_metrics_tpu_torch.parallel import pipeline as P

    model = P.stage_encoder_(_t5(tree, cfg), cfg, mesh)
    out = P.pipeline_encode(model, cfg, _t(embeds), _t(mask), mesh, n_micro=n_micro)
    return {"out": out.numpy(), "layers": len(model.encoder.blocks)}


def case_bad_split(rank, mesh, tree, cfg, embeds, mask, n_micro):
    """The ValueError every rank raises before any collective."""
    from t2v_metrics_tpu_torch.parallel import pipeline as P

    try:
        P.pipeline_encode(_t5(tree, cfg), cfg, _t(embeds), _t(mask), mesh, n_micro=n_micro)
    except ValueError as e:
        return str(e)
    return None


def case_sp_encode(rank, mesh, tree, cfg, embeds, mask):
    from t2v_metrics_tpu_torch.models import t5 as tt5

    model = M.shard_params(_t5(tree, cfg), mesh)
    with mesh:
        return tt5.encode(model, cfg, _t(embeds), _t(mask)).numpy()


def case_sp_score(rank, mesh, tree, cfg, embeds, mask, ans, amask):
    from t2v_metrics_tpu_torch.models import t5 as tt5

    model = M.shard_params(_t5(tree, cfg), mesh)
    with mesh:
        return tt5.answer_log_probs(model, cfg, _t(embeds), _t(mask), _t(ans),
                                    _t(amask)).numpy()
