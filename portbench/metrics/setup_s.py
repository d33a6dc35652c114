"""Set-up: process start to the window's first call, with the kernels'
load (and their build on a checkout's first run), the engine, the pool,
its cuts and every stream's warm-up."""

UNIT = "s"


def read(run):
    return run.setup_s
