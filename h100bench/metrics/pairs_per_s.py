"""pairs_per_s: every pair the window completed over the window's seconds
(host clock; the window closes when the unit in flight at its end ends)."""


def read(ctx):
    return ctx.pairs / ctx.seconds
