"""trace.idle_share: see bench_port/lib/readers.py `idle_share`."""

from lib import readers


def read(run):
    return readers.idle_share(run, "trace")
