"""attention_roofline: the least time the attention work of the traced window
needs on one H100 (each call's larger of operations over the bf16 peak and
bytes over HBM bandwidth, counted from the inputs' shapes), over the device
time of the kernels in the attention family, in %."""

from h100bench.peaks import bound_s


def read(ctx):
    device = ctx.family_s.get("attention", 0.0)
    need = sum(bound_s(ops, nbytes) for kind, ops, nbytes in ctx.work if kind == "attention")
    if device <= 0.0 or need <= 0.0:
        return None
    return 100.0 * need / device
