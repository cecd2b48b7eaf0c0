"""Faults planted under the timed path, for the tests and for the readings
at a cell's own size (``control.py --faults``): each breaks the scores
where they are produced, and ``correct`` has to come out false.

- ``answer``: one answer altered, the first score of each device stage
  (a chunk of the staged or async pipeline, one call's score matrix)
  multiplied by 1.5 (0.405 nats);
- ``half``: half of the batch left out, each of its scores replaced by the
  mean taken over the rest.
"""

from __future__ import annotations

import numpy as np


class _Altered:
    """Scores still on the device, changed when read: ``how`` gets the host
    array and returns the one the caller sees."""

    def __init__(self, inner, how):
        self.inner, self.how = inner, how

    def __array__(self, dtype=None, copy=None):
        out = self.how(np.array(self.inner, np.float32))
        return out if dtype is None else out.astype(dtype)


def answer_altered(scores):
    scores[0] *= 1.5
    return scores


def half_left_out(scores):
    half = len(scores) // 2
    scores[half:] = scores[:half].mean()
    return scores


FAULTS = {"answer": answer_altered, "half": half_left_out}


def breaker(how):
    """A fault for ``run.run_cell``: breaks the built scorer where its scores
    are produced, in the device stage of the staged pipeline (CLIP-FlanT5) or
    of the async one (Qwen), and in the synchronous score matrix."""
    how = FAULTS.get(how, how)

    def fault(scorer):
        adapter = scorer.model
        name = ("forward_device_prepared" if hasattr(adapter, "forward_device_prepared")
                else "forward_device")
        stage = getattr(adapter, name)
        matrix = adapter.score_matrix

        def device_stage(*args, **kw):
            dev, n = stage(*args, **kw)
            return _Altered(dev, lambda s: how(s[:n]) if n > 1 else s), n

        def score_matrix(images, texts, **kw):
            m = matrix(images, texts, **kw)
            return how(m.reshape(-1).copy()).reshape(m.shape)

        setattr(adapter, name, device_stage)
        adapter.score_matrix = score_matrix

    return fault
