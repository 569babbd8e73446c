"""Kernel cache: the shader-cache analog.

Parity: reference src/shader_cache.rs (HalaShaderCache, SURVEY.md
section 2.10): a process-wide singleton keyed cache with
`set_shader_dir`, `load` (path-like keys joined to the dir),
`from_memory` (keyed by name), `get`/`remove`/`clear`. Here a "shader"
is a Python callable on tensors; `load` resolves
`"module.sub:function"` import paths, with relative names joined to the
configured kernel package (shader_cache.rs:68-73 dir-join parity). This
cache is the name -> function registry the program descs resolve
against; nothing is compiled.
"""

from __future__ import annotations

import importlib
import threading
from typing import Callable

from ..error import HalaRendererError


class KernelCache:
    """Process-wide singleton (shader_cache.rs:35-46 get_instance)."""

    _instance: "KernelCache | None" = None
    _lock = threading.Lock()

    def __init__(self):
        self._kernels: dict[str, Callable] = {}
        self._kernel_dir: str = ""

    @classmethod
    def get_instance(cls) -> "KernelCache":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def set_kernel_dir(self, module_prefix: str) -> None:
        """set_shader_dir parity: relative kernel names resolve under
        this module prefix (e.g. "hala_tpu_torch.ops")."""
        self._kernel_dir = module_prefix

    def load(self, path: str) -> Callable:
        """Resolve "pkg.module:function" (absolute) or "module:function"
        (joined to the kernel dir). Cached by the resolved key."""
        key = path
        if ":" not in path:
            raise HalaRendererError(
                f"Kernel path {path!r} must look like 'module:function'."
            )
        if self._kernel_dir and not path.split(":")[0].startswith(
            self._kernel_dir
        ):
            key = f"{self._kernel_dir}.{path}"
        if key in self._kernels:
            return self._kernels[key]
        mod_name, fn_name = key.split(":")
        try:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, fn_name)
        except (ImportError, AttributeError) as e:
            raise HalaRendererError(f"Failed to load kernel {key!r}.", e)
        self._kernels[key] = fn
        return fn

    def from_memory(self, name: str, fn: Callable) -> Callable:
        """Register a kernel object directly, keyed by name
        (shader_cache.rs:107-123)."""
        self._kernels[name] = fn
        return fn

    def get(self, name: str) -> Callable | None:
        return self._kernels.get(name)

    def remove(self, name: str) -> None:
        self._kernels.pop(name, None)

    def clear(self) -> None:
        self._kernels.clear()
