"""Row gathers of the shading tables.

The JAX package's ops/gathers.py picks between a one-hot matmul (the
TPU's matrix unit as a gather unit, for tables of at most 2048 rows) and
`jnp.take`. A GPU gathers rows natively, so `take_rows` is one index.
"""

from __future__ import annotations

import torch


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table: (T, ...) ; idx: (N,) int in [0, T) -> (N, ...) row gather."""
    return table[idx.long()]
