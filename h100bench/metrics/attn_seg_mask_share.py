"""attn_seg_mask_share: the share of the (consumer warpgroup, visited key
tile) pairs of the attention calls with segment ids over the traced window
that run the per-element segment compare, in %: 100 x
``attn_seg_tiles_mixed`` / ``attn_seg_wg_tiles``, the program's counters (a
pair whose rows and keys all hold one id, or whose id ranges do not meet,
takes no compare). A program without these counters reports nothing."""

from h100bench.program_trace import session


def read(ctx):
    got = session()
    counts = got[2] if got is not None else {}
    mixed, pairs = counts.get("attn_seg_tiles_mixed"), counts.get("attn_seg_wg_tiles")
    if not pairs or mixed is None:
        return None
    return 100.0 * mixed / pairs
