"""The PyTorch port imports torch and never jax.

Runs in a subprocess: this test process has jax loaded already
(tests/conftest.py configures it).
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
sys.path.insert(0, {repo!r})
import hala_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    hala_tpu_torch.__path__, "hala_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert "jax" not in sys.modules, "jax was imported"
assert not any(m == "hala_tpu" or m.startswith("hala_tpu.") for m in sys.modules)
import torch
assert torch.backends.cuda.matmul.allow_tf32 is False
assert torch.backends.cudnn.allow_tf32 is False
print(len(names))
"""


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, timeout=300,
    )


def test_port_never_imports_jax():
    proc = _run(_PROBE.format(repo=REPO))
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20  # every module of the port loaded


def test_chip_smoke_refuses_without_cuda():
    """chip_smoke.py exits non-zero and prints no result without CUDA."""
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, timeout=300,
    )
    import torch

    if torch.cuda.is_available():
        return  # exercised for real on the card
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_native_source_is_the_ports_own():
    """The C++ routines compile from the port's own copy of meshopt.cpp,
    never from a file of the JAX package."""
    from hala_tpu_torch import native

    pkg = os.path.join(REPO, "hala_tpu_torch") + os.sep
    assert os.path.abspath(native._SRC).startswith(pkg), native._SRC
    assert os.path.exists(native._SRC)


def _public_symbols(path: str) -> list:
    """Module-level public names of a source file (functions, classes,
    assignments), read with ast: no import of the JAX package."""
    import ast

    out = []
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.append(node.name)
        elif isinstance(node, ast.Assign):
            out += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.append(node.target.id)
    return [n for n in out if not n.startswith("_") and n != "logger"]


def test_port_map_names_every_public_symbol():
    """docs/PORT_MAP.md names every public module-level symbol of the JAX
    package, in the row of its module or in the table of the symbols not
    ported under their own name."""
    with open(os.path.join(REPO, "docs", "PORT_MAP.md")) as f:
        rows = f.read().splitlines()
    ref = os.path.join(REPO, "hala_tpu")
    missing = []
    for root, _, files in os.walk(ref):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            rel = os.path.relpath(path, ref).replace(os.sep, "/")
            mine = [r for r in rows if r.startswith(f"| `{rel}`")]
            for sym in _public_symbols(path):
                if not any(f"`{sym}`" in r for r in mine):
                    missing.append(f"{rel}:{sym}")
    assert not missing, missing
