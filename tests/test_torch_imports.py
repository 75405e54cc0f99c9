"""Import hygiene of the PyTorch port: no module of
``mcp_context_forge_tpu_torch`` (nor ``chip_smoke.py``,
``profile_torch_engine.py``, ``profile_torch_train.py`` or
``multi_gpu_smoke.py``, which run on the card) imports JAX, anything of
the JAX package or ``prometheus_client`` (the card has none; the port's
metrics registry is its own), and the kernel modules import without
``nvcc`` or ``triton`` (kernels build at first launch, on the card); the
plugin kinds, the external plugin host and the plugin servers import
neither torch nor httpx; the modules of the database-backed auth import
neither JAX, pydantic, argon2-cffi nor httpx."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "mcp_context_forge_tpu", "prometheus_client"}
SOURCES = sorted((ROOT / "mcp_context_forge_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "profile_torch_engine.py", ROOT / "profile_torch_train.py",
    ROOT / "multi_gpu_smoke.py"]


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
    ("from prometheus_client import Counter", True),
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
        "import mcp_context_forge_tpu_torch.tpu_local.parallel.mesh\n"
        "import mcp_context_forge_tpu_torch.tpu_local.parallel.sharding\n"
        "import mcp_context_forge_tpu_torch.tpu_local.parallel.ring_attention\n"
        "import mcp_context_forge_tpu_torch.tpu_local.parallel.pipeline\n"
        "import mcp_context_forge_tpu_torch.tpu_local.train\n"
        "import mcp_context_forge_tpu_torch.tools.tiny_checkpoint\n"
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


def test_chip_smoke_plane_worker_entry_imports_no_jax():
    """``chip_smoke.py --plane-worker`` (a worker process of the plane
    phase) imports nothing of JAX, and on a box without built kernel
    libraries it refuses to start: it never builds one beside the script
    that spawned it."""
    code = (
        "import sys, runpy\n"
        "sys.argv = ['chip_smoke.py', '--plane-worker', 'W0', '1', 'llama3-tiny', 'float32']\n"
        "try:\n"
        "    runpy.run_path('chip_smoke.py', run_name='__main__')\n"
        "except SystemExit as exc:\n"
        "    print('exit', exc.code)\n"
        "except Exception as exc:\n"
        "    print('raised', type(exc).__name__, exc)\n"
        "import mcp_context_forge_tpu_torch.coordination.heartbeat\n"
        "import mcp_context_forge_tpu_torch.coordination.hub\n"
        "import mcp_context_forge_tpu_torch.coordination.rpc\n"
        "import mcp_context_forge_tpu_torch.tpu_local.pool_rpc\n"
        "import mcp_context_forge_tpu_torch.tpu_local.kv.fabric.publisher\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'mcp_context_forge_tpu')]\n"
        "assert not bad, bad\n")
    env = {**os.environ, "MCPFORGE_BUS_TCP_SECRET": "s"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    assert "kernel libraries not built" in out or "CUDA is not available" in out, out


MCP_PATH_MODULES = [
    "jsonrpc", "schemas", "utils.retry", "utils.ssrf", "utils.outbound", "clients.mcp_client",
    "services.upstream_sessions", "services.tool_service", "services.gateway_service",
    "services.server_service", "services.cancellation_service", "gateway.rpc",
    "gateway.routers", "gateway.transports.streamable_http", "translate"]


@pytest.mark.parametrize("module", MCP_PATH_MODULES)
def test_mcp_path_module_imports_no_jax_pydantic_or_httpx(module):
    """Each module of the MCP tools/call path imports alone, with nothing of
    JAX, pydantic or the JAX package, and without httpx, which the outbound
    clients load when they are built."""
    code = (f"import sys\nimport mcp_context_forge_tpu_torch.{module}\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mcp_context_forge_tpu', 'pydantic', 'httpx')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


PLUGIN_MODULES = [
    "utils.paths", "plugins.builtin.filters", "plugins.builtin.transformers",
    "plugins.builtin.resilience", "plugins.builtin.content_plugins",
    "plugins.builtin.security_plugins", "plugins.builtin.validation_plugins",
    "plugins.external", "plugins.servers.sdk", "plugins.servers.opa_policy",
    "plugins.servers.prompt_guard", "plugins.servers.content_scanner"]


@pytest.mark.parametrize("module", PLUGIN_MODULES)
def test_plugin_module_imports_no_torch_jax_or_httpx(module):
    """Each module of the builtin kinds, the external plugin host and the
    plugin servers (each of which runs as ``python -m`` in a process of its
    own) imports alone, with nothing of torch, JAX, the JAX package, numpy
    or httpx."""
    code = (f"import sys\nimport mcp_context_forge_tpu_torch.{module}\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'jaxlib', 'mcp_context_forge_tpu', 'numpy', 'httpx')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


AUTH_MODULES = [
    "config", "utils.passwords", "utils.redact", "services.auth_service",
    "services.role_service", "services.team_service", "services.csrf_service",
    "services.email_service", "services.audit_service", "services.compliance_service",
    "services.oauth_service", "gateway.auth", "gateway.middleware", "gateway.routers",
    "gateway.routers_chat", "gateway.routers_rbac"]


@pytest.mark.parametrize("module", AUTH_MODULES)
def test_auth_module_imports_no_jax_pydantic_argon2_or_httpx(module):
    """Each module of the auth backed by the database imports alone, with
    nothing of JAX, the JAX package or pydantic, without argon2-cffi (the
    KDF is ``cryptography``'s) and without httpx (the OAuth and SSO calls go
    through the app's client, built at startup)."""
    code = (f"import sys\nimport mcp_context_forge_tpu_torch.{module}\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mcp_context_forge_tpu', 'pydantic', 'argon2', 'httpx')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
