"""traverse.fallback_ms: device ms a traced frame of K6,
`cluster_stream_kernel` (hala_tpu_torch/csrc/cluster_stream.cu), by name in the
device trace; None where the traced frames launched none."""

KERNEL = "cluster_stream_kernel"


def read(run):
    ms = run.trace.time_s((KERNEL,)) * 1e3 / run.frames
    return ms if ms > 0 else None
