"""setup_s: process start to the first timed call (imports, the kernel
build where it has not been made, the weights on the card, the inputs, the
warm-up), host clock."""


def read(ctx):
    return ctx.setup_s
