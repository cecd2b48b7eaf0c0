"""The one generator of every traffic mix, and the two closed-loop drivers.

A mix is a data file, ``traffic/<mix>.json``; its keys:

  driver         "batch_forward": ``scorer.batch_forward`` over rounds of
                 ``batch_size * round_chunks`` samples of one medium and one
                 text each (GenAI-Bench's offline scoring); "call":
                 ``scorer(images=[media_per_call media], texts=[one prompt])``,
                 one client in a closed loop (reranking in a generation loop)
  media          {"kind": "image", "height", "width", "pool"} seeded uint8
                 RGB arrays; {"kind": "video", "frames", "fps", "height",
                 "width", "pool"} seeded decoded clips; each medium a random
                 FIELD x FIELD colour field spread bilinearly over the frame,
                 with uniform noise of +-NOISE on every pixel
  prompts        {"pool", "min_words", "median_words", "max_words"}: the
                 lengths are the log-normal quantiles of the pool with that
                 median, the longest at max_words, cut below at min_words;
                 the same multiset for every seed, which draws the words and
                 the order
  batch_size, round_chunks   (batch_forward)
  media_per_call            (call)
  warmup         chunks (or calls) run before the window, their longest
                 prompts spread evenly over the pool's lengths, so every
                 shape bucket the window can meet is built first
  check          {"pairs": n} or {"calls": n}: the sample the reference
                 recomputes (the longest prompt among them)

Every stream is drawn from ``np.random.default_rng([seed, k])``, so the
same seed gives the same inputs and schedule.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import time

import numpy as np

# words of GenAI-Bench-like prompts: objects, attributes, counts, actions,
# relations, scenes
WORDS = tuple("""
a an the two three four five several many one single pair of group
red blue green yellow black white golden silver purple orange pink brown
wooden glass metal plastic paper stone furry shiny transparent tiny small
large huge tall short old young ancient modern broken empty full
dog cat horse bird fish rabbit fox bear elephant giraffe owl butterfly
man woman child girl boy chef astronaut robot knight dancer painter
car bicycle train boat airplane bus truck motorcycle umbrella lamp chair
table cup bottle book phone clock vase guitar piano candle mirror window
tree flower mountain river lake beach forest desert city street bridge
house castle tower garden field sky cloud moon sun star rain snow
on under above behind beside near inside between next to in front
holding riding chasing reading eating jumping sitting standing flying
swimming playing painting looking wearing carrying pushing watching
while at night during sunset morning winter summer with without and
left right top bottom center corner background foreground reflection
""".split())


def prompt_lengths(pool: int, min_words: int, median_words: int,
                   max_words: int) -> list[int]:
    """The pool's word counts: log-normal quantiles (i + 0.5) / pool with
    median ``median_words``, the largest equal to ``max_words``."""
    nd = statistics.NormalDist()
    sigma = math.log(max_words / median_words) / nd.inv_cdf(1 - 0.5 / pool)
    out = []
    for i in range(pool):
        z = nd.inv_cdf((i + 0.5) / pool)
        out.append(int(min(max_words, max(min_words,
                                          round(median_words * math.exp(sigma * z))))))
    return out


FIELD = 4      # a medium's colour field: FIELD x FIELD random colours
NOISE = 24     # plus uniform noise in [-NOISE, NOISE] on every pixel


def _spread(n: int, g: int) -> np.ndarray:
    """(n, g) weights that spread g values bilinearly over n pixels."""
    pos = np.clip((np.arange(n) + 0.5) * g / n - 0.5, 0, g - 1)
    i0 = np.floor(pos).astype(int)
    i1 = np.minimum(i0 + 1, g - 1)
    w = np.zeros((n, g), np.float32)
    np.add.at(w, (np.arange(n), i0), 1 - (pos - i0))
    np.add.at(w, (np.arange(n), i1), pos - i0)
    return w


def _media_pool(spec: dict, rng) -> list:
    """Seeded uint8 media: each a random colour field spread over the frame
    (the same in every frame of a clip) with noise on every pixel, so that
    media differ as a whole, as photographs do, and not only in detail that
    the resize averages away."""
    kind = spec["kind"]
    if kind not in ("image", "video"):
        raise ValueError(f"unknown media kind {kind!r}")
    h, w = spec["height"], spec["width"]
    frames = (spec["frames"],) if kind == "video" else ()
    wy, wx = _spread(h, FIELD), _spread(w, FIELD)
    fields = rng.integers(0, 256, (spec["pool"], FIELD, FIELD, 3)).astype(np.float32)
    out = []
    for f in fields:
        img = np.empty((h, w, 3), np.float32)
        for c in range(3):
            img[..., c] = wy @ f[..., c] @ wx.T
        noise = rng.integers(-NOISE, NOISE + 1, frames + (h, w, 3), dtype=np.int16)
        out.append(np.clip(img.astype(np.int16) + noise, 0, 255).astype(np.uint8))
    return out


def _permutations(rng, n: int):
    """An endless stream of indices: one permutation of range(n) after
    another."""
    while True:
        yield from rng.permutation(n).tolist()


@dataclasses.dataclass
class Inputs:
    """One seed's inputs: the raw media pool, the prompts, and the streams
    the drivers draw from."""

    spec: dict
    seed: int
    media: list            # raw uint8 arrays
    prompts: list[str]

    def stream(self, k: int):
        """(media stream, prompt stream) of stream ``k``."""
        rng = np.random.default_rng([self.seed, 100 + k])
        return (_permutations(rng, len(self.media)),
                _permutations(rng, len(self.prompts)))

    def by_length(self) -> list[int]:
        """Prompt indices, shortest first (ties by index)."""
        return sorted(range(len(self.prompts)),
                      key=lambda i: (len(self.prompts[i].split()), i))


def make_inputs(spec: dict, seed: int) -> Inputs:
    media = _media_pool(spec["media"], np.random.default_rng([seed, 0]))
    p = spec["prompts"]
    lengths = prompt_lengths(p["pool"], p["min_words"], p["median_words"],
                             p["max_words"])
    rng = np.random.default_rng([seed, 1])
    lengths = [lengths[i] for i in rng.permutation(len(lengths))]
    prompts = [" ".join(rng.choice(WORDS, size=n)) for n in lengths]
    if spec["driver"] == "batch_forward" and len(media) % spec["batch_size"]:
        raise ValueError("the media pool must be a multiple of batch_size, so no "
                         "medium repeats within a chunk")
    if spec["driver"] == "call" and len(media) % spec["media_per_call"]:
        raise ValueError("the media pool must be a multiple of media_per_call")
    return Inputs(spec, seed, media, prompts)


@dataclasses.dataclass
class Window:
    """What a window completed: its units (media indices, prompt indices,
    scores, seconds), one a round or a call, and its seconds."""

    units: list
    seconds: float

    @property
    def pairs(self) -> list:
        """(media index, prompt index, score) of every pair completed."""
        out = []
        for mi, pi, scores, _ in self.units:
            texts = pi if len(pi) == len(mi) else pi * len(mi)
            out += list(zip(mi, texts, scores))
        return out

    def chunks(self, batch_size: int | None):
        """(media indices, prompt of each pair) of each device chunk: a
        round cut into ``batch_size`` samples, or a whole call."""
        for mi, pi, _, _ in self.units:
            if batch_size is None:
                yield mi, pi * len(mi)
            else:
                for k in range(0, len(mi), batch_size):
                    yield mi[k:k + batch_size], pi[k:k + batch_size]


class Driver:
    """A closed loop over ``scorer`` (the port's facade); ``wrap`` turns a
    raw medium into what the scorer takes (the family's ``media_input``)."""

    def __init__(self, scorer, inputs: Inputs, wrap, span=None):
        self.scorer = scorer
        self.inputs = inputs
        self.spec = inputs.spec
        self.media = [wrap(m) for m in inputs.media]
        self.span = span

    # units of work: a round (batch_forward) or a call ----------------------

    def _units(self, k: int):
        """Endless (media indices, prompt indices) units of stream ``k``."""
        ms, ps = self.inputs.stream(k)
        if self.spec["driver"] == "batch_forward":
            n = self.spec["batch_size"] * self.spec["round_chunks"]
            while True:
                yield ([next(ms) for _ in range(n)], [next(ps) for _ in range(n)])
        else:
            per = self.spec["media_per_call"]
            while True:
                yield ([next(ms) for _ in range(per)], [next(ps)])

    def _warmup_units(self):
        """The warm-up: chunks (calls) whose longest prompt walks the
        pool's lengths from the shortest to the longest."""
        order = self.inputs.by_length()
        count = max(2, int(self.spec.get("warmup", 4)))
        ms, _ = self.inputs.stream(99)
        if self.spec["driver"] == "batch_forward":
            b = self.spec["batch_size"]
            mi, pi = [], []
            for k in range(count):
                end = round(k * (len(order) - 1) / (count - 1))
                block = order[max(0, end - b + 1):end + 1]
                block = block + [order[end]] * (b - len(block))
                mi += [next(ms) for _ in range(b)]
                pi += block
            return [(mi, pi)]
        per = self.spec["media_per_call"]
        return [([next(ms) for _ in range(per)],
                 [order[round(k * (len(order) - 1) / (count - 1))]])
                for k in range(count)]

    def _run(self, unit):
        mi, pi = unit
        media_key = "videos" if self.spec["media"]["kind"] == "video" else "images"
        if self.spec["driver"] == "batch_forward":
            ds = [{media_key: [self.media[m]], "texts": [self.inputs.prompts[p]]}
                  for m, p in zip(mi, pi)]
            out = self.scorer.batch_forward(ds, batch_size=self.spec["batch_size"])
            return np.asarray(out, np.float64).reshape(len(ds))
        out = self.scorer(**{"images": [self.media[m] for m in mi],
                             "texts": [self.inputs.prompts[pi[0]]]})
        return np.asarray(out, np.float64).reshape(len(mi))

    def warmup(self) -> None:
        for unit in self._warmup_units():
            self._run(unit)

    def window(self, seconds: float, stream: int = 0, min_units: int = 1) -> Window:
        """Whole units from stream ``stream`` until ``seconds`` have
        passed (and at least ``min_units`` ran); the window closes when the
        unit in flight then ends."""
        units_done = []
        units = self._units(stream)
        name = "call" if self.spec["driver"] == "call" else "round"
        t0 = time.perf_counter()
        while True:
            mi, pi = next(units)
            t = time.perf_counter()
            if self.span is not None:
                with self.span(name):
                    scores = self._run((mi, pi))
            else:
                scores = self._run((mi, pi))
            units_done.append((mi, pi, scores.tolist(), time.perf_counter() - t))
            if time.perf_counter() - t0 >= seconds and len(units_done) >= min_units:
                break
        return Window(units_done, time.perf_counter() - t0)


def check_sample(inputs: Inputs, window: Window, seed: int) -> list:
    """The pairs (media index, prompt index, score) the reference
    recomputes, drawn from the seed among the window's: ``check.pairs``
    pairs, or every pair of ``check.calls`` units; the longest prompt among
    them."""
    rng = np.random.default_rng([seed, 3])
    check = inputs.spec["check"]

    def words(p):
        return len(inputs.prompts[p].split())

    if "calls" in check:
        groups = [list(zip(mi, pi * len(mi), sc)) for mi, pi, sc, _ in window.units]
        count = check["calls"]
    else:
        groups = [[p] for p in window.pairs]
        count = check["pairs"]
    longest = max(range(len(groups)), key=lambda j: (max(words(p) for _, p, _ in groups[j]), -j))
    rest = [j for j in rng.permutation(len(groups)).tolist() if j != longest]
    return [pair for j in [longest] + rest[:count - 1] for pair in groups[j]]

