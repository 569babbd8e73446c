"""small_raster.launches_per_frame: see bench_port/lib/readers.py `launches_per_frame`."""

from lib import readers


def read(run):
    return readers.launches_per_frame(run, "raster")
