"""moe_pad_share: the share of the rows the grouped GEMM computes over the
traced window that are padding, in %: 100 x (1 - ``moe_rows`` /
``moe_block_rows``), the program's counters (each MoE dispatch's T x k
expert assignments, against its expert groups each rounded up to the
kernel's 128-row block). A program without these counters reports
nothing."""

from h100bench.program_trace import session


def read(ctx):
    got = session()
    counts = got[2] if got is not None else {}
    rows, block_rows = counts.get("moe_rows"), counts.get("moe_block_rows")
    if not rows or not block_rows:
        return None
    return 100.0 * (1.0 - rows / block_rows)
