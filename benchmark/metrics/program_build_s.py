"""program_build_s: seconds of set-up in the program's builds, the `build.*` spans
(`build.dissector`, `build.target`, `build.model`, `build.kernels`) that end before
the window, each counted once (`benchmark/spans.py`). None where the program keeps
no spans."""
from benchmark.spans import build_seconds


def read(run):
    return build_seconds(run)
