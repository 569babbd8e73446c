"""traverse.walk_ms: device ms a traced frame of K5,
`traverse_candidates_kernel` (hala_tpu_torch/csrc/traverse_candidates.cu), by name in the
device trace; None where the traced frames launched none."""

KERNEL = "traverse_candidates_kernel"


def read(run):
    ms = run.trace.time_s((KERNEL,)) * 1e3 / run.frames
    return ms if ms > 0 else None
