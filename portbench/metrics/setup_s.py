"""setup_s: process start → the first measured window: imports, the card,
the kernel library, the scenes made and written, the warm-up windows."""


def read(run):
    return run.setup_s
