"""Import hygiene of the PyTorch port: no module of
``mcp_context_forge_tpu_torch`` (nor ``chip_smoke.py`` or
``profile_torch_engine.py``, which run on the card) imports JAX or
anything of the JAX package, and the kernel modules import without
``nvcc`` or ``triton`` (kernels build at first launch, on the card)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "mcp_context_forge_tpu"}
SOURCES = sorted((ROOT / "mcp_context_forge_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "profile_torch_engine.py"]


def _imported_roots(source: str) -> set[str]:
    """First components of every absolute import in ``source``."""
    roots = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    assert not _imported_roots(path.read_text()) & FORBIDDEN


@pytest.mark.parametrize("source,forbidden", [
    ("import mcp_context_forge_tpu_torch.tpu_local.engine", False),
    ("from mcp_context_forge_tpu_torch.utils import new_id", False),
    ("from mcp_context_forge_tpu.tpu_local import engine", True),
    ("import jax.numpy as jnp", True),
    ("from jaxlib import xla_client", True),
])
def test_root_comparison_is_exact(source, forbidden):
    assert bool(_imported_roots(source) & FORBIDDEN) is forbidden


def test_kernel_modules_import_without_toolchain():
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env["PATH"] = os.path.dirname(sys.executable)  # no nvcc on it
    code = (
        "import sys\n"
        "import mcp_context_forge_tpu_torch.tpu_local.ops.paged_attention\n"
        "import mcp_context_forge_tpu_torch.tpu_local.ops.attention\n"
        "import mcp_context_forge_tpu_torch.tpu_local.ops.grouped_moe\n"
        "import mcp_context_forge_tpu_torch.tpu_local.ops.kv_write\n"
        "import mcp_context_forge_tpu_torch.tpu_local.decode_graphs\n"
        "import mcp_context_forge_tpu_torch.tpu_local.parallel.moe\n"
        "import mcp_context_forge_tpu_torch.tpu_local.quantize\n"
        "import mcp_context_forge_tpu_torch.tpu_local.kv.paged_cache\n"
        "import mcp_context_forge_tpu_torch.tpu_local.kv.prefix_index\n"
        "import mcp_context_forge_tpu_torch.tpu_local.kv.tiers\n"
        "import mcp_context_forge_tpu_torch.tpu_local.kv.fabric.index\n"
        "import mcp_context_forge_tpu_torch.tpu_local.kv.fabric.object_store\n"
        "import mcp_context_forge_tpu_torch.tpu_local.models.llama\n"
        "import mcp_context_forge_tpu_torch.tpu_local.engine\n"
        "import mcp_context_forge_tpu_torch.tpu_local.roofline\n"
        "import mcp_context_forge_tpu_torch.tpu_local.compile_events\n"
        "import mcp_context_forge_tpu_torch.tpu_local.models.encoder\n"
        "import mcp_context_forge_tpu_torch.tpu_local.tpu_provider\n"
        "import mcp_context_forge_tpu_torch.observability\n"
        "import mcp_context_forge_tpu_torch.observability.phases\n"
        "import mcp_context_forge_tpu_torch.observability.tracing\n"
        "import mcp_context_forge_tpu_torch.observability.degradation\n"
        "import mcp_context_forge_tpu_torch.observability.signals\n"
        "import mcp_context_forge_tpu_torch.observability.faults\n"
        "import mcp_context_forge_tpu_torch.utils.jwt\n"
        "import mcp_context_forge_tpu_torch.gateway.auth\n"
        "import mcp_context_forge_tpu_torch.gateway.middleware\n"
        "import mcp_context_forge_tpu_torch.tpu_local.controller\n"
        "import mcp_context_forge_tpu_torch.tpu_local.server\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('triton', 'jax', 'jaxlib', 'mcp_context_forge_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)
