"""CameraBench caption evaluation (reference camerabench/caption_evaluation.py;
the port's copy of t2v_metrics_tpu/camerabench/caption_evaluation.py):
self-implemented n-gram metrics — BLEU-2 (:130), ROUGE-L (:165), METEOR
(:193), CIDEr (:98), SPICE-like content-word F1 (:72) — plus the GPT-4o
"generative match" judge with retries (:276-343).

All metrics are implemented from their standard definitions in pure
numpy/python (no pycocoevalcap/nltk dependency); METEOR here is the
exact-match variant (unigram precision/recall harmonic mean with the
fragmentation penalty, no WordNet synonym expansion — noted for parity)."""

from __future__ import annotations

import argparse
import json
import math
import re
from collections import Counter
from pathlib import Path

import numpy as np


def _tokenize(text: str) -> list[str]:
    return re.findall(r"[a-z0-9]+", text.lower())


def _ngrams(tokens, n):
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


# ---------------------------------------------------------------------------
# BLEU-2
# ---------------------------------------------------------------------------

def bleu_2(candidate: str, references: list[str]) -> float:
    cand = _tokenize(candidate)
    refs = [_tokenize(r) for r in references]
    if not cand or not refs:
        return 0.0
    precisions = []
    for n in (1, 2):
        cand_ng = _ngrams(cand, n)
        if not cand_ng:
            precisions.append(0.0)
            continue
        max_ref = Counter()
        for ref in refs:
            for ng, c in _ngrams(ref, n).items():
                max_ref[ng] = max(max_ref[ng], c)
        clipped = sum(min(c, max_ref[ng]) for ng, c in cand_ng.items())
        precisions.append(clipped / sum(cand_ng.values()))
    if min(precisions) == 0.0:
        return 0.0
    log_p = sum(math.log(p) for p in precisions) / 2
    ref_len = min(refs, key=lambda r: (abs(len(r) - len(cand)), len(r)))
    bp = 1.0 if len(cand) > len(ref_len) else math.exp(1 - len(ref_len) / max(len(cand), 1))
    return bp * math.exp(log_p)


# ---------------------------------------------------------------------------
# ROUGE-L
# ---------------------------------------------------------------------------

def _lcs(a, b):
    dp = np.zeros((len(a) + 1, len(b) + 1), dtype=np.int32)
    for i in range(1, len(a) + 1):
        for j in range(1, len(b) + 1):
            dp[i, j] = (dp[i - 1, j - 1] + 1 if a[i - 1] == b[j - 1]
                        else max(dp[i - 1, j], dp[i, j - 1]))
    return int(dp[-1, -1])


def rouge_l(candidate: str, references: list[str], beta: float = 1.2) -> float:
    cand = _tokenize(candidate)
    if not cand:
        return 0.0
    best = 0.0
    for ref_text in references:
        ref = _tokenize(ref_text)
        if not ref:
            continue
        lcs = _lcs(cand, ref)
        if lcs == 0:
            continue
        prec, rec = lcs / len(cand), lcs / len(ref)
        score = ((1 + beta ** 2) * prec * rec) / (rec + beta ** 2 * prec)
        best = max(best, score)
    return best


# ---------------------------------------------------------------------------
# METEOR (exact-match variant)
# ---------------------------------------------------------------------------

def meteor(candidate: str, references: list[str], alpha=0.9, beta=3.0,
           gamma=0.5) -> float:
    cand = _tokenize(candidate)
    if not cand:
        return 0.0
    best = 0.0
    for ref_text in references:
        ref = _tokenize(ref_text)
        if not ref:
            continue
        # greedy unigram alignment (exact matches)
        ref_used = [False] * len(ref)
        matches = []  # (cand_idx, ref_idx)
        for ci, tok in enumerate(cand):
            for ri, rtok in enumerate(ref):
                if not ref_used[ri] and tok == rtok:
                    ref_used[ri] = True
                    matches.append((ci, ri))
                    break
        m = len(matches)
        if m == 0:
            continue
        prec, rec = m / len(cand), m / len(ref)
        f_mean = prec * rec / (alpha * prec + (1 - alpha) * rec)
        # chunk count: contiguous in both sequences
        chunks = 1
        for (c0, r0), (c1, r1) in zip(matches, matches[1:]):
            if not (c1 == c0 + 1 and r1 == r0 + 1):
                chunks += 1
        penalty = gamma * (chunks / m) ** beta
        best = max(best, f_mean * (1 - penalty))
    return best


# ---------------------------------------------------------------------------
# CIDEr
# ---------------------------------------------------------------------------

def cider(candidates: list[str], references: list[list[str]],
          n_max: int = 4, sigma: float = 6.0) -> list[float]:
    """Corpus-level CIDEr: tf-idf weighted n-gram cosine, averaged over n,
    with length gaussian penalty."""
    # document frequency per n over reference sets
    dfs = [Counter() for _ in range(n_max)]
    num_docs = len(references)
    ref_ng = []
    for refs in references:
        per_n = []
        for n in range(1, n_max + 1):
            union = set()
            counters = []
            for r in refs:
                c = _ngrams(_tokenize(r), n)
                counters.append(c)
                union |= set(c)
            for ng in union:
                dfs[n - 1][ng] += 1
            per_n.append(counters)
        ref_ng.append(per_n)

    def tfidf_vec(counter, n):
        vec = {}
        norm = 0.0
        total = sum(counter.values())
        for ng, c in counter.items():
            idf = math.log(max(num_docs, 1)) - math.log(max(dfs[n - 1][ng], 1))
            w = (c / max(total, 1)) * idf
            vec[ng] = w
            norm += w * w
        return vec, math.sqrt(norm)

    scores = []
    for cand_text, refs, per_n in zip(candidates, references, ref_ng):
        cand_toks = _tokenize(cand_text)
        score_n = []
        for n in range(1, n_max + 1):
            cvec, cnorm = tfidf_vec(_ngrams(cand_toks, n), n)
            sims = []
            for rc, ref_text in zip(per_n[n - 1], refs):
                rvec, rnorm = tfidf_vec(rc, n)
                dot = sum(min(cvec.get(ng, 0), rvec.get(ng, 0)) * rvec.get(ng, 0)
                          for ng in cvec)
                sim = dot / (cnorm * rnorm) if cnorm and rnorm else 0.0
                dl = len(cand_toks) - len(_tokenize(ref_text))
                sim *= math.exp(-(dl ** 2) / (2 * sigma ** 2))
                sims.append(sim)
            score_n.append(np.mean(sims) if sims else 0.0)
        scores.append(10.0 * float(np.mean(score_n)))
    return scores


# ---------------------------------------------------------------------------
# SPICE-like content-word F1
# ---------------------------------------------------------------------------

_STOP = set("a an the is are was were be been being to of in on at for with "
            "and or it its this that".split())


def spice_like(candidate: str, references: list[str]) -> float:
    """Content-word (stopword-filtered) F1 — the reference's lightweight
    stand-in for SPICE propositional matching (reference :72)."""
    cand = set(_tokenize(candidate)) - _STOP
    ref = set()
    for r in references:
        ref |= set(_tokenize(r)) - _STOP
    if not cand or not ref:
        return 0.0
    tp = len(cand & ref)
    if tp == 0:
        return 0.0
    prec, rec = tp / len(cand), tp / len(ref)
    return 2 * prec * rec / (prec + rec)


# ---------------------------------------------------------------------------
# GPT-4o generative match judge
# ---------------------------------------------------------------------------

JUDGE_PROMPT = (
    "You are evaluating a generated video caption against a reference.\n"
    "Reference: {reference}\nGenerated: {candidate}\n"
    "Does the generated caption describe the same camera motion as the "
    "reference? Answer with a score from 0 to 100 only.")


def gpt4o_judge(candidate: str, reference: str, client=None,
                model: str = "gpt-4o", retries: int = 3) -> float:
    """'Generative match' judge with retries (reference :276-343).
    Returns score in [0, 1] or 0.0 on failure."""
    if client is None:
        import os
        from openai import OpenAI

        client = OpenAI(api_key=os.environ["OPENAI_API_KEY"])
    prompt = JUDGE_PROMPT.format(reference=reference, candidate=candidate)
    for _ in range(retries):
        try:
            resp = client.chat.completions.create(
                model=model,
                messages=[{"role": "user", "content": prompt}],
                max_tokens=8)
            text = resp.choices[0].message.content.strip()
            m = re.search(r"\d+", text)
            if m:
                return min(max(int(m.group()) / 100.0, 0.0), 1.0)
        except Exception as e:
            print(f"judge attempt failed: {e}")
    return 0.0


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def evaluate_captions(caption_entries, use_judge=False, judge_client=None):
    cands, refs = [], []
    for e in caption_entries:
        if e.get("error") is None and e.get("generated_caption") is not None:
            cands.append(e["generated_caption"])
            r = e.get("reference_caption")
            refs.append(r if isinstance(r, list) else [r])
    if not cands:
        return {"num_samples": 0}
    out = {
        "num_samples": len(cands),
        "bleu_2": float(np.mean([bleu_2(c, r) for c, r in zip(cands, refs)])),
        "rouge_l": float(np.mean([rouge_l(c, r) for c, r in zip(cands, refs)])),
        "meteor": float(np.mean([meteor(c, r) for c, r in zip(cands, refs)])),
        "cider": float(np.mean(cider(cands, refs))),
        "spice_like": float(np.mean([spice_like(c, r)
                                     for c, r in zip(cands, refs)])),
    }
    if use_judge:
        out["generative_match"] = float(np.mean([
            gpt4o_judge(c, r[0], client=judge_client)
            for c, r in zip(cands, refs)]))
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--caption_files", type=str, nargs="+", required=True)
    parser.add_argument("--use_judge", action="store_true")
    parser.add_argument("--output_file", type=str, default="caption_eval.json")
    args = parser.parse_args()

    results = {}
    for path in args.caption_files:
        with open(path) as f:
            data = json.load(f)
        metrics = evaluate_captions(data["captions"], args.use_judge)
        results[Path(path).stem] = metrics
        print(f"{path}: {metrics}")
    with open(args.output_file, "w") as f:
        json.dump(results, f, indent=2)


if __name__ == "__main__":
    main()
