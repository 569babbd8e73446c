"""spheres.query_ms: device ms a traced frame charged to the program's
`hala.query.spheres` spans, the procedural spheres' pass inside each
query (the merge after a closest-hit query, the shadow rays' sphere
test); None where the program recorded no such span."""

from lib import readers


def read(run):
    return readers.span_busy_ms(run, "hala.query.spheres")
