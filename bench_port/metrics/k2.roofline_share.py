"""k2.roofline_share: the kernel's share of its roofline over the
captured launches of the traced frames (bench_port/lib/roofline.py has
the counting rule, bench_port/lib/probes.py which launches are kept)."""

from lib import readers


def read(run):
    return readers.roofline_share(run, "k2")
