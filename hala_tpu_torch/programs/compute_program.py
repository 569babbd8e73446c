"""Compute program: JSON desc -> kernel dispatch.

Parity: reference src/compute_program.rs (HalaComputeProgram{Desc},
SURVEY.md section 2.10): desc {shader_file_path, push_constant_size,
bindings} wrapping a compute pipeline with bind/push_constants/
dispatch[_indirect]. Here the desc names a kernel in the KernelCache
and `dispatch` calls it on tensors: push constants become keyword
scalars, descriptor bindings the positional tensor arguments. There is
nothing to compile; `static_argnames` is kept for desc parity.
"""

from __future__ import annotations

import dataclasses
import json

import torch

from .shader_cache import KernelCache


@dataclasses.dataclass
class ComputeProgramDesc:
    """compute_program.rs:24-30 JSON shape."""

    shader_file_path: str                     # "module:function" kernel key
    push_constant_size: int = 0               # informational (desc parity)
    bindings: list[str] = dataclasses.field(default_factory=list)
    static_argnames: tuple[str, ...] = ()

    @staticmethod
    def from_json(text: str) -> "ComputeProgramDesc":
        d = json.loads(text)
        return ComputeProgramDesc(
            shader_file_path=d["shader_file_path"],
            push_constant_size=d.get("push_constant_size", 0),
            bindings=d.get("bindings", []),
            static_argnames=tuple(d.get("static_argnames", ())),
        )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


class ComputeProgram:
    def __init__(self, desc: ComputeProgramDesc):
        self.desc = desc
        cache = KernelCache.get_instance()
        # from_memory-registered names resolve first (shader_cache.rs
        # from_memory shaders feed programs the same as file loads).
        kernel = cache.get(desc.shader_file_path)
        if kernel is None:
            kernel = cache.load(desc.shader_file_path)
        self._fn = kernel

    def dispatch(self, *buffers, **push_constants):
        """compute_program.rs:144-168 dispatch: run the kernel."""
        return self._fn(*buffers, **push_constants)

    def dispatch_indirect(self, count, *buffers, **push_constants):
        """compute_program.rs:144-168 dispatch_indirect: the work count
        comes from a device buffer and is never read on the host: it is
        passed to the kernel as its first argument, an i32 tensor on the
        device of the first buffer, and the kernel masks its work by it."""
        dev = buffers[0].device if buffers else None
        return self._fn(torch.as_tensor(count, dtype=torch.int32, device=dev),
                        *buffers, **push_constants)
