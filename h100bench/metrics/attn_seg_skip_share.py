"""attn_seg_skip_share: the share of the (block, key tile) pairs of the
attention calls with segment ids over the traced window that the kernel
skips, in %: 100 x (1 - ``attn_seg_tiles_run`` / ``attn_seg_tiles``), the
program's counters (every pair a call's blocks would visit without skipping,
against those whose key ids meet their rows' ids). A program without these
counters reports nothing."""

from h100bench.program_trace import session


def read(ctx):
    got = session()
    counts = got[2] if got is not None else {}
    tiles, run = counts.get("attn_seg_tiles"), counts.get("attn_seg_tiles_run")
    if not tiles or run is None:
        return None
    return 100.0 * (1.0 - run / tiles)
