"""setup_s: seconds from the process's start to the window's (imports, the image pool
and weights, the program's build, the kernels' build on a checkout's first run, the
warm-up)."""


def read(run):
    return run.setup_s
