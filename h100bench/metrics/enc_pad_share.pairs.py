"""enc_pad_share: the share of the T5 encoder's rows over the traced window
that are padding, in %: 100 x (1 - ``t5_enc_rows_valid`` / ``t5_enc_rows``),
the program's counters (pair rows padded to the batch bucket times each
chunk's bucketed length, against the real pairs' lengths). A program without
its own tracing reports nothing."""

from h100bench.program_trace import session


def read(ctx):
    got = session()
    rows = got[2].get("t5_enc_rows") if got is not None else None
    if not rows:
        return None
    return 100.0 * (1.0 - got[2].get("t5_enc_rows_valid", 0) / rows)
