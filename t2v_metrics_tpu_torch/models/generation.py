"""KV-cached generation over the decoder stack (port of
t2v_metrics_tpu/models/generation.py).

``CachedLM`` runs one prefill that writes the prompt's k and v into a cache
of ``S + max_new_tokens`` slots (deepstack residuals and the image-block
overlay at the prefill), then single-token steps against absolute cache
slots: a prompt padded to S leaves its pad slots invalid between its last
token and its first generated one, while its rope position runs on from its
last prompt token, as in the JAX package.

``greedy_batch`` keeps the JAX contract of no host round-trip until the
final token matrix: the tokens, the finished flags and the validity mask
stay on the device, and the cache slot of a step is a host int. ``greedy``
(one sequence) reads each step's distribution back, as the JAX one does,
and samples with the caller's ``np.random.Generator``, so one seed gives the
same tokens in both packages.

``_nucleus_sample``, ``trace_from_rollout``, ``score_rollout`` and
``decode_text`` are the JAX package's, copied (pure Python and numpy).
"""

from __future__ import annotations

import numpy as np
import torch

from . import decoder as dec


class CachedLM:
    """Prefill and decode steps for one ``DecoderConfig``.

    embed_scale: the multiplier of token embeddings (Gemma's sqrt(d)), cast
    to the embedding dtype before the multiply as the JAX package does.
    Visual features are spliced into the prefill embeds by the caller.
    """

    def __init__(self, cfg: dec.DecoderConfig, embed_scale: float | None = None):
        self.cfg = cfg
        self.embed_scale = embed_scale

    def _embed(self, params_dec, ids: torch.Tensor) -> torch.Tensor:
        """(B, 1) token ids -> (B, 1, D) embeddings."""
        e = params_dec.embed[ids]
        if self.embed_scale is not None:
            e = e * torch.tensor(self.embed_scale, dtype=e.dtype, device=e.device)
        return e

    def _prefill(self, params_dec, embeds, pos, valid, max_len, n_prompts,
                 bidir_full, deepstack):
        """The prompt's k and v into a new cache; returns (logits of each
        row's last prompt token (B, V) fp32, cache)."""
        b, s, _ = embeds.shape
        dev = embeds.device
        bidir = None
        if bidir_full is not None:
            bidir = np.asarray(bidir_full, np.int32)
            if bidir.shape != (b, max_len):
                raise ValueError(f"bidir_full must be cache-aligned ({b}, {max_len})")
            # generated rows join no image block: the decode steps run without
            # the overlay, which would change nothing on them
            if (bidir[:, s:] >= 0).any():
                raise ValueError("bidir_full: generated slots must be -1")
            bidir = torch.from_numpy(bidir[:, :s]).to(dev)
        cache = dec.init_cache(self.cfg, b, max_len, dtype=embeds.dtype, device=dev)
        last = torch.as_tensor(np.asarray(n_prompts, np.int64) - 1, device=dev)[:, None]
        logits, cache = dec.forward(params_dec, self.cfg, embeds,
                                    torch.as_tensor(np.asarray(pos), device=dev), valid,
                                    logit_positions=last, cache=cache,
                                    deepstack=deepstack, bidir_ids=bidir, cache_pos=0)
        return logits[:, 0], cache

    @staticmethod
    def _last_pos(pos, n_prompts) -> np.ndarray:
        """(B,) rope position of each row's last prompt token (the largest of
        the three M-RoPE streams)."""
        pos = np.asarray(pos)
        rows = np.asarray(n_prompts, np.int64) - 1
        if pos.ndim == 2:
            return pos[np.arange(pos.shape[0]), rows]
        return pos[:, np.arange(pos.shape[1]), rows].max(axis=0)

    def _step_pos(self, last_pos: torch.Tensor, offset: int, ndim: int) -> torch.Tensor:
        p = (last_pos + offset)[:, None]
        return p if ndim == 2 else p[None].expand(3, -1, -1)

    @torch.inference_mode()
    def greedy_batch(self, params_dec, embeds, pos, n_prompts,
                     max_new_tokens: int, eos_id: int | None = None,
                     bidir_full=None, deepstack=None, gather_ids=None,
                     temperature: float = 1.0):
        """Batched greedy generation; nothing is read back from the device
        before the final token matrix.

        embeds: (B, S, D) on the device; pos: (B, S) or (3, B, S) host ints;
        n_prompts: (B,) prompt lengths; bidir_full: optional (B, S +
        max_new_tokens) cache-aligned groups (-1 on generated slots);
        deepstack: optional list of (B, S, D) residuals (prefill only);
        gather_ids: optional (B, G) ids whose fp32 probability (softmax of
        the logits over ``temperature``) is also returned at every step,
        (B, max_new_tokens, G). Returns (tokens (B, max_new_tokens) int32,
        lengths (B,) int32 counting tokens up to and including eos[,
        probs]); a row that met eos repeats it.
        """
        b, s, _ = embeds.shape
        dev = embeds.device
        max_len = s + max_new_tokens
        pos_np = np.asarray(pos)
        valid0 = np.zeros((b, max_len), bool)
        for j, n in enumerate(np.asarray(n_prompts)):
            valid0[j, :int(n)] = True
        valid = torch.from_numpy(valid0).to(dev)
        eos = -1 if eos_id is None else int(eos_id)
        gids = (None if gather_ids is None
                else torch.as_tensor(np.asarray(gather_ids, np.int64), device=dev))

        def gprobs(step_logits):
            d = torch.softmax(step_logits.float() / temperature, dim=-1)
            return torch.gather(d, -1, gids)

        first, cache = self._prefill(params_dec, embeds, pos_np, valid, max_len,
                                     n_prompts, bidir_full, deepstack)
        cur = first.argmax(-1)
        tokens = torch.zeros((b, max_new_tokens), dtype=torch.long, device=dev)
        tokens[:, 0] = cur
        probs = None
        if gids is not None:
            probs = torch.zeros((b, max_new_tokens, gids.shape[1]), dtype=torch.float32,
                                device=dev)
            probs[:, 0] = gprobs(first)
        done = cur == eos
        last_pos = torch.from_numpy(self._last_pos(pos_np, n_prompts)).to(dev)
        for step in range(1, max_new_tokens):
            cpos = s + step - 1   # the cache slot of the token generated at step - 1
            valid[:, cpos] = True
            logits, cache = dec.forward(
                params_dec, self.cfg, self._embed(params_dec, cur[:, None]),
                self._step_pos(last_pos, step, pos_np.ndim), valid, cache=cache,
                cache_pos=cpos)
            nxt = logits[:, 0].argmax(-1)
            nxt = torch.where(done, torch.full_like(nxt, eos), nxt)
            tokens[:, step] = nxt
            if probs is not None:
                probs[:, step] = gprobs(logits[:, 0])
            done = done | (nxt == eos)
            cur = nxt
        tokens = tokens.cpu().numpy().astype(np.int32)
        lengths = np.full((b,), max_new_tokens, np.int32)
        for j in range(b):
            hits = np.flatnonzero(tokens[j] == eos)
            if eos >= 0 and hits.size:
                lengths[j] = hits[0] + 1
        if probs is not None:
            return tokens, lengths, probs.cpu().numpy()
        return tokens, lengths

    @torch.inference_mode()
    def greedy(self, params_dec, embeds, pos, n_prompt: int,
               max_new_tokens: int, eos_ids=(), temperature: float = 1.0,
               bidir_full=None, deepstack=None, sample: bool = False,
               top_p: float = 0.9, rng=None):
        """Generate up to max_new_tokens for one sequence: greedy, or nucleus
        sampling when ``sample`` (with ``rng``, an np.random.Generator).

        embeds: (1, S, D) on the device (S >= n_prompt); pos: (1, S) or (3,
        1, S) host ints; bidir_full: optional (1, S + max_new_tokens)
        cache-aligned groups; deepstack: optional list of (1, S, D)
        residuals (prefill only). Returns (generated ids, the fp32 softmax
        distribution of each step as numpy).
        """
        s = embeds.shape[1]
        dev = embeds.device
        max_len = s + max_new_tokens
        valid = torch.zeros((1, max_len), dtype=torch.bool, device=dev)
        valid[0, :n_prompt] = True
        pos_np = np.asarray(pos)
        last_pos = torch.from_numpy(self._last_pos(pos_np, [n_prompt])).to(dev)
        logits, cache = self._prefill(params_dec, embeds, pos_np, valid, max_len,
                                      [n_prompt], bidir_full, deepstack)
        t = max(float(temperature), 1e-6)
        dist = torch.softmax(logits[0] / t, dim=-1)

        eos_ids = {e for e in eos_ids if e is not None}
        if sample and rng is None:
            rng = np.random.default_rng()
        gen, dists = [], []
        for step in range(max_new_tokens):
            dists.append(dist.float().cpu().numpy())
            if sample:
                nxt = int(_nucleus_sample(dists[-1], top_p, rng))
            else:
                nxt = int(np.argmax(dists[-1]))
            gen.append(nxt)
            if nxt in eos_ids or step == max_new_tokens - 1:
                break
            cpos = s + step
            valid[0, cpos] = True
            ids = torch.full((1, 1), nxt, dtype=torch.long, device=dev)
            logits, cache = dec.forward(
                params_dec, self.cfg, self._embed(params_dec, ids),
                self._step_pos(last_pos, 1 + step, pos_np.ndim), valid, cache=cache,
                cache_pos=cpos)
            dist = torch.softmax(logits[0, 0] / t, dim=-1)
        return gen, dists


def _nucleus_sample(dist: np.ndarray, top_p: float, rng) -> int:
    """Top-p (nucleus) sampling over an fp32 softmax distribution (HF
    semantics: keep the smallest prefix of descending-prob tokens whose
    cumulative mass reaches top_p, renormalize, sample)."""
    order = np.argsort(dist)[::-1]
    sorted_p = dist[order]
    cum = np.cumsum(sorted_p)
    cut = int(np.searchsorted(cum, top_p) + 1)
    keep = order[:cut]
    p = dist[keep] / dist[keep].sum()
    return int(rng.choice(keep, p=p))


def trace_from_rollout(gen, dists, answer_ids, special_ids, decode,
                       score_position: str = "end"):
    """Reference trace contract (qwen2vl_model.py:303-493): score the
    answer tokens at the start or end of a greedy rollout and return
    (geometric-mean prob, trace dict with per-token top-5 alternatives)."""
    assert score_position in ("start", "end")
    n_ans = len(answer_ids)
    ans = list(answer_ids)
    if score_position == "start":
        start, offset = 0, 0
    else:
        offset = 1 if (gen and gen[-1] in special_ids) else 0
        if offset:
            n_ans = min(n_ans, len(dists) - 1)
        start = max(len(gen) - n_ans - offset, 0)
    n_ans = min(n_ans, len(dists) - start)
    ans = ans[:n_ans]

    joint = 1.0
    details = []
    for i in range(n_ans):
        dist = dists[start + i]
        tid = ans[i]
        prob = float(dist[tid])
        joint *= prob
        top = np.argsort(dist)[::-1][:5]
        details.append({
            "position": start + i,
            "expected_token_id": tid,
            "expected_token_text": decode([tid]),
            "probability": prob,
            "top_alternatives": [
                {"token_id": int(t), "token_text": decode([int(t)]),
                 "probability": float(dist[t])} for t in top],
        })
    gm = joint ** (1.0 / max(n_ans, 1))
    trace = {
        "generated_text": decode(gen),
        "generated_length": len(gen),
        "score_position": score_position,
        "score_start_idx": start,
        "scored_indices": list(range(start, start + n_ans)),
        "scored_tokens_text": decode(gen[start:start + n_ans]),
        "probability": gm,
        "token_details": details,
    }
    return gm, trace


def score_rollout(dists, gen, answer_ids, special_ids,
                  warn=print) -> float:
    """End-aligned rollout scoring (reference gemma4_model.py:185-228 and
    molmo2_model.py:168-214 share this exact rule).

    The model generates a few tokens (possibly an empty thinking block
    before the answer); the answer tokens are scored from the END of the
    generated sequence, skipping one trailing special token. Returns the
    geometric-mean probability.
    """
    n_ans = len(answer_ids)
    offset = 0
    if gen and gen[-1] in special_ids:
        n_ans = min(n_ans, len(dists) - 1)
        offset = 1
        if n_ans <= 0:
            raise ValueError(
                "No content tokens to score after removing special tokens")
    if len(dists) < n_ans:
        warn(f"  Warning: Generated {len(dists)} tokens but need "
             f"{n_ans}, adjusting")
        n_ans = len(dists)
    ans = answer_ids[:n_ans]
    joint = 1.0
    for i in range(n_ans):
        pos = len(dists) - (n_ans - i + offset)
        joint *= float(dists[pos][ans[i]])
    return joint ** (1.0 / max(n_ans, 1))


def decode_text(tokenizer, ids, eos_ids=()) -> str:
    """Decode generated ids, stripping eos/special tokens like the
    reference's skip_special_tokens=True decode."""
    ids = [i for i in ids if i not in set(e for e in eos_ids if e is not None)]
    try:
        return tokenizer.decode(ids, skip_special_tokens=True).strip()
    except TypeError:
        return tokenizer.decode(ids).strip()
