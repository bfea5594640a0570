"""``setup_s``: from the start of the process to the first timed job --
imports, the card's start, the inputs made from the seed, the kernels'
build or load, ``Session.compile`` and one warm job."""


def read(ctx):
    return ctx["setup_s"]
