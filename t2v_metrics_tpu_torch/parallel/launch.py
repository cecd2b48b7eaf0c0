"""Run a function as the ranks of a process group, one spawned process a
rank, with a time limit.

    results = run_ranks(fn, 4, args, init_method="file:///tmp/x/init")

Each rank joins ``torch.distributed`` (``backend``, ``init_method``),
runs on one host thread, calls ``fn(rank, *args)`` and returns its result
to the caller through a file; ``run_ranks`` returns the results in rank
order. A rank that raises,
exits or outlives ``timeout_s`` ends the run: the other ranks are killed at
once (a rank left waiting in a collective would otherwise wait for its
peer until the collective's own timeout), and ``RankFailure`` carries each
failed rank's traceback. ``fn`` and ``args`` are pickled (the ``spawn``
start method, which CUDA needs): ``fn`` must be importable by name.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist


class RankFailure(RuntimeError):
    pass


def _rank_main(rank: int, world: int, init_method: str, backend: str, fn, args,
               out_path: str, timeout_s: float) -> None:
    torch.set_num_threads(1)     # the ranks share the host's cores
    try:
        dist.init_process_group(backend, init_method=init_method, world_size=world,
                                rank=rank,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = ("ok", fn(rank, *args))
        finally:
            dist.destroy_process_group()
    except BaseException:  # recorded for the parent, then the rank exits non-zero
        result = ("error", traceback.format_exc())
    with open(out_path, "wb") as f:
        pickle.dump(result, f)
    sys.stdout.flush()
    if result[0] != "ok":
        sys.exit(1)


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(10)


def run_ranks(fn, world_size: int, args=(), *, init_method: str | None = None,
              backend: str = "gloo", timeout_s: float = 300.0) -> list:
    """``[fn(rank, *args) for rank in range(world_size)]``, each call in its
    own process in one process group. ``init_method`` defaults to a file
    in a temporary directory (no TCP port to race for)."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="t2v_ranks_") as tmp:
        init_method = init_method or f"file://{os.path.join(tmp, 'init')}"
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world_size)]
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world_size, init_method, backend, fn, args,
                                   outs[r], timeout_s))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    raise RankFailure(f"ranks still running after {timeout_s:.0f} s: "
                                      f"{[r for r, p in enumerate(procs) if p.is_alive()]}")
                time.sleep(0.05)
        finally:
            _stop(procs)
        results, failures = [], []
        for r, (p, path) in enumerate(zip(procs, outs)):
            if not os.path.exists(path):
                failures.append(f"rank {r}: exit code {p.exitcode}, no result")
                continue
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status != "ok":
                failures.append(f"rank {r}:\n{value}")
            results.append(value)
        if failures:
            raise RankFailure("\n".join(failures))
        return results
