"""traverse.cull_ms: device ms a traced frame of K4,
`cull_topk_kernel` (hala_tpu_torch/csrc/cull_topk.cu), by name in the
device trace; None where the traced frames launched none."""

KERNEL = "cull_topk_kernel"


def read(run):
    ms = run.trace.time_s((KERNEL,)) * 1e3 / run.frames
    return ms if ms > 0 else None
