"""spheres.launches_per_frame: device kernels a traced frame launched
under the program's `hala.query.spheres` spans (the stage table of
bench_port/lib/stages.py; copies and fills not counted); None where the
program recorded no such span."""

SPAN = "hala.query.spheres"


def read(run):
    row = run.stages["stages"].get(SPAN)
    return row["launches"] if row else None
