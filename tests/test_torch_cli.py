"""The port's command line (``python -m mcp_context_forge_tpu_torch.cli``) on
the CPU: ``version`` prints the port's version; ``token`` mints a JWT that
the JAX package's ``utils.jwt`` verifies under the same secret, audience
and issuer; ``serve`` in a subprocess (``MCPFORGE_TORCH_DEVICE=cpu``,
llama3-test) answers ``/health``, ``/ready`` and a greedy chat completion
whose text equals an in-process ``build_llm_app`` over the same settings,
imports nothing of JAX or the JAX package (read from its ``sys.modules`` at
exit) and ends with exit 0 on SIGTERM; without the CPU device on a machine
with no card, ``serve`` exits non-zero naming CUDA, with no fallback. ``run``'s
``install_event_loop`` and ``serving_ssl`` agree with the JAX gateway's."""

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import aiohttp
import pytest
from aiohttp.test_utils import TestClient, TestServer
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

from mcp_context_forge_tpu.utils import jwt as jax_jwt
from mcp_context_forge_tpu_torch import __version__, cli
from mcp_context_forge_tpu_torch.config import load_settings, reset_settings_cache
from mcp_context_forge_tpu_torch.tpu_local.server import build_llm_app

ROOT = Path(__file__).resolve().parents[1]
SERVE_ENV = {
    "MCPFORGE_DATABASE_URL": "sqlite:///:memory:",
    "MCPFORGE_TPU_LOCAL_MODEL": "llama3-test",
    "MCPFORGE_TPU_LOCAL_MAX_BATCH": "2",
    "MCPFORGE_TPU_LOCAL_MAX_SEQ_LEN": "128",
    "MCPFORGE_TPU_LOCAL_PAGE_SIZE": "16",
    "MCPFORGE_TPU_LOCAL_NUM_PAGES": "32",
    "MCPFORGE_TPU_LOCAL_PREFILL_BUCKETS": "64",
    "MCPFORGE_TPU_LOCAL_DTYPE": "float32",
    "MCPFORGE_HOST": "127.0.0.1",
    "MCPFORGE_JWT_SECRET_KEY": "cli-test-secret-0123456789abcdef",
}
CHAT = {"model": "llama3-test", "max_tokens": 8, "temperature": 0,
        "messages": [{"role": "user", "content": "Name one MCP server."}]}
# runs the CLI as ``python -m`` would, then reports the JAX modules it holds
SERVE = ("import atexit, runpy, sys\n"
         "def report():\n"
         "    bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
         "                 ('jax', 'jaxlib', 'mcp_context_forge_tpu', 'pydantic'))\n"
         "    print('JAX_MODULES=' + ','.join(bad), flush=True)\n"
         "atexit.register(report)\n"
         "sys.argv = ['mcp_context_forge_tpu_torch.cli'] + sys.argv[1:]\n"
         "runpy.run_module('mcp_context_forge_tpu_torch.cli', run_name='__main__')\n")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("MCPFORGE_") and k != "JAX_PLATFORMS"}
    return {**env, **SERVE_ENV, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1", **extra}


def test_version(capsys):
    assert cli.main(["version"]) == 0
    assert capsys.readouterr().out.strip() == __version__
    out = subprocess.run([sys.executable, "-m", "mcp_context_forge_tpu_torch.cli", "version"],
                         cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=60)
    assert out.returncode == 0 and out.stdout.strip() == __version__


@pytest.mark.parametrize("minutes", [60, 5])
def test_token_verifies_under_the_jax_jwt(capsys, monkeypatch, minutes):
    for key, value in SERVE_ENV.items():
        monkeypatch.setenv(key, value)
    reset_settings_cache()
    try:
        assert cli.main(["token", "ops@example.com", "--expires-minutes", str(minutes)]) == 0
    finally:
        reset_settings_cache()
    token = capsys.readouterr().out.strip()
    claims = jax_jwt.decode(token, SERVE_ENV["MCPFORGE_JWT_SECRET_KEY"],
                            audience="mcpforge-api", issuer="mcpforge")
    assert claims["sub"] == "ops@example.com"
    assert claims["exp"] - claims["iat"] == minutes * 60
    with pytest.raises(Exception):
        jax_jwt.decode(token, "another-secret-0123456789abcdef", audience="mcpforge-api",
                       issuer="mcpforge")


def test_device_choice(monkeypatch):
    monkeypatch.delenv(cli.DEVICE_ENV, raising=False)
    assert cli.torch_device() == "cuda"
    monkeypatch.setenv(cli.DEVICE_ENV, "cpu")
    assert cli.torch_device() == "cpu"
    monkeypatch.setenv(cli.DEVICE_ENV, "tpu")
    with pytest.raises(SystemExit, match="cuda or cpu"):
        cli.torch_device()


def _get(port: int, path: str, body: dict | None = None) -> tuple[int, dict]:
    request = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode() if body else None,
        headers={"content-type": "application/json",
                 "authorization": aiohttp.BasicAuth("admin", "changeme").encode()})
    with urllib.request.urlopen(request, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def _in_process_text() -> str:
    """The chat's greedy text from ``build_llm_app`` in this process, over
    the settings the subprocess loads."""
    settings = load_settings(env=SERVE_ENV, env_file=None)

    async def run():
        client = TestClient(TestServer(build_llm_app(settings, device="cpu")))
        await client.start_server()
        try:
            resp = await client.post("/v1/chat/completions", json=CHAT,
                                     auth=aiohttp.BasicAuth("admin", "changeme"))
            return (await resp.json())["choices"][0]["message"]["content"]
        finally:
            await client.close()

    return asyncio.run(run())


def test_serve_on_the_cpu_answers_and_stops_on_sigterm(tmp_path):
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-c", SERVE, "serve", "--port", str(port)], cwd=tmp_path,
        env=_env(MCPFORGE_TORCH_DEVICE="cpu"), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, proc.communicate()
            try:
                status, body = _get(port, "/health")
                break
            except OSError:
                assert time.monotonic() < deadline, "serve never answered /health"
                time.sleep(0.2)
        assert (status, body) == (200, {"status": "healthy"})
        status, ready = _get(port, "/ready")
        assert status == 200 and ready["status"] == "ready"
        status, reply = _get(port, "/v1/chat/completions", CHAT)
        assert status == 200 and reply["usage"]["completion_tokens"] > 0
        status, stats = _get(port, "/admin/engine/stats")
        assert status == 200 and stats["model"] == "llama3-test" and stats["requests"] == 1
    finally:
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err[-2000:]
    assert "JAX_MODULES=\n" in out, out[-2000:]
    assert reply["choices"][0]["message"]["content"] == _in_process_text()


def test_serve_without_a_card_fails_naming_cuda(tmp_path):
    out = subprocess.run([sys.executable, "-c", SERVE, "serve", "--port", str(_free_port())],
                         cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "CUDA" in out.stderr and "JAX_MODULES=\n" in out.stdout


@pytest.mark.parametrize("policy", ["", "asyncio", "uvloop"])
def test_event_loop_policy_agrees(policy):
    """``install_event_loop`` installs what the JAX gateway's does: asyncio,
    or uvloop when asked for and importable (else asyncio, with a warning)."""
    from mcp_context_forge_tpu.gateway.app import install_event_loop as jax_install
    from mcp_context_forge_tpu_torch.tpu_local.server import install_event_loop

    saved = asyncio.get_event_loop_policy()
    try:
        ours = install_event_loop(policy)
        asyncio.set_event_loop_policy(saved)
        assert ours == jax_install(policy)
    finally:
        asyncio.set_event_loop_policy(saved)


@pytest.mark.parametrize("enabled", [False, True])
def test_serving_ssl_agrees(enabled, tmp_path):
    from mcp_context_forge_tpu.config import load_settings as jax_load_settings
    from mcp_context_forge_tpu.utils.sslctx import serving_ssl as jax_serving_ssl
    from mcp_context_forge_tpu_torch.utils.sslctx import serving_ssl

    env = {"SSL_ENABLED": str(enabled), "SSL_CERT_FILE": str(tmp_path / "absent.pem")}
    port, ref = load_settings(env, env_file=None), jax_load_settings(env, env_file=None)
    if not enabled:
        assert serving_ssl(port) is None and jax_serving_ssl(ref) is None
        return
    for fn, settings in ((serving_ssl, port), (jax_serving_ssl, ref)):
        with pytest.raises(FileNotFoundError):
            fn(settings)
