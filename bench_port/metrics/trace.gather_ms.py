"""trace.gather_ms: see bench_port/lib/readers.py `gather_ms`."""

from lib import readers


def read(run):
    return readers.gather_ms(run, "trace")
