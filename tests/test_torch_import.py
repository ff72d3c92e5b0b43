"""The port loads no jax, and chip_smoke.py refuses to run without a GPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_MODULES = (
    "ntrace_tpu_torch",
    "ntrace_tpu_torch.device",
    "ntrace_tpu_torch.host",
    "ntrace_tpu_torch.host.core",
    "ntrace_tpu_torch.host.scenes",
    "ntrace_tpu_torch.host.scenes.procedural",
    "ntrace_tpu_torch.host.bvh",
    "ntrace_tpu_torch.host.bvh.host_bvh",
    "ntrace_tpu_torch.host.bvh.flatten",
    "ntrace_tpu_torch.host.bvh.median",
    "ntrace_tpu_torch.host.bvh.sbvh",
    "ntrace_tpu_torch.host.bvh.packed",
    "ntrace_tpu_torch.host.bvh.golden",
    "ntrace_tpu_torch.host.ops",
    "ntrace_tpu_torch.host.ops.aabb",
    "ntrace_tpu_torch.host.ops.woop",
    "ntrace_tpu_torch.host.ops.intersect",
    "ntrace_tpu_torch.host.ops.morton",
    "ntrace_tpu_torch.host.trace",
    "ntrace_tpu_torch.host.trace.common",
    "ntrace_tpu_torch.host.trace.cpu",
    "ntrace_tpu_torch.host.native",
    "ntrace_tpu_torch.host.native.sbvh_lib",
    "ntrace_tpu_torch.bvh.lbvh",
    "ntrace_tpu_torch.ops.pscan",
    "ntrace_tpu_torch.tables",
    "ntrace_tpu_torch.kernels.build",
    "ntrace_tpu_torch.ops.aabb",
    "ntrace_tpu_torch.ops.morton",
    "ntrace_tpu_torch.ray.pixeltable",
    "ntrace_tpu_torch.ray.raybatch",
    "ntrace_tpu_torch.ray.raygen",
    "ntrace_tpu_torch.ray.rng",
    "ntrace_tpu_torch.trace.packet_common",
    "ntrace_tpu_torch.trace.packet",
    "ntrace_tpu_torch.trace.packet_ww",
    "ntrace_tpu_torch.trace.packet_ifif",
    "ntrace_tpu_torch.trace.registry",
    "ntrace_tpu_torch.trace.binraster",
    "ntrace_tpu_torch.trace.binraster_dense",
    "ntrace_tpu_torch.utils.timing",
    "ntrace_tpu_torch.render.renderer",
)
NO_JAX = ("bad = sorted(m for m in sys.modules if m == 'jax' "
          "or m.startswith('jax.'))\n"
          "assert not bad, bad\n"
          "print('ok')\n")
NO_REFERENCE = ("bad = sorted(m for m in sys.modules if m == 'ntrace_tpu' "
                "or m.startswith('ntrace_tpu.'))\n"
                "assert not bad, bad\n"
                "print('ok')\n")


def _run(code: str, **kw):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120, **kw)


def _package_modules() -> set:
    """Every module of the port, by file, package __init__s left out."""
    out = set()
    for f in Path(ROOT, "ntrace_tpu_torch").rglob("*.py"):
        parts = f.relative_to(ROOT).with_suffix("").parts
        if parts[-1] != "__init__":
            out.add(".".join(parts))
    return out


def _imported_modules(path: Path):
    """Every module an import statement of `path` names."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in PORT_MODULES) + NO_JAX)
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py imports everything it uses at module level."""
    proc = _run("import sys\nimport chip_smoke\n" + NO_JAX)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_port_imports_nothing_of_the_reference():
    """No file of the port and not chip_smoke.py names ntrace_tpu in an
    import (the ast walk), and after importing every port module and
    chip_smoke no ntrace_tpu module is loaded."""
    root = Path(ROOT)
    files = [root / "chip_smoke.py"] + sorted(
        (root / "ntrace_tpu_torch").rglob("*.py"))
    direct = {str(f.relative_to(root)) for f in files
              for m in _imported_modules(f)
              if m == "ntrace_tpu" or m.startswith("ntrace_tpu.")}
    assert direct == set()
    assert _package_modules() <= set(PORT_MODULES)
    code = ("import sys\n" + "".join(f"import {m}\n" for m in PORT_MODULES)
            + "import chip_smoke\n" + NO_REFERENCE)
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the script would run")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "cuda" in proc.stderr.lower()
