"""The port's command line (a copy of the JAX package's ``cli.py`` over the
port's settings): ``serve [--host] [--port]`` (the default) runs the /v1
app and its operator routes (``tpu_local/server.py`` ``run``),
``token EMAIL [--expires-minutes]`` mints a JWT under the settings' secret,
audience and issuer, ``version`` prints the port's version.

The device: ``MCPFORGE_TORCH_DEVICE`` (``cuda`` by default, or ``cpu``)
goes to the engine's config. Without a card, ``serve`` on ``cuda`` fails
with the engine's own error and a non-zero exit: nothing falls back to the
CPU. ``supervise`` (several workers and a hub) is not ported yet.

    python -m mcp_context_forge_tpu_torch.cli serve --port 4444
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

DEVICE_ENV = "MCPFORGE_TORCH_DEVICE"


def torch_device() -> str:
    """The engine's device from ``MCPFORGE_TORCH_DEVICE``: ``cuda`` (the
    default, a card or an error) or ``cpu``."""
    device = os.environ.get(DEVICE_ENV, "").strip() or "cuda"
    if device not in ("cuda", "cpu"):
        raise SystemExit(f"{DEVICE_ENV} must be cuda or cpu, not {device!r}")
    return device


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="mcpforge-torch",
                                     description="MCP gateway /v1 on the PyTorch engine")
    sub = parser.add_subparsers(dest="command")
    serve = sub.add_parser("serve", help="run the /v1 app and its operator routes")
    serve.add_argument("--host", default=None)
    serve.add_argument("--port", type=int, default=None)
    token = sub.add_parser("token", help="mint a JWT for an email")
    token.add_argument("email")
    token.add_argument("--expires-minutes", type=int, default=60)
    sub.add_parser("version", help="print version")

    args = parser.parse_args(argv)
    command = args.command or "serve"

    if command == "version":
        from . import __version__
        print(__version__)
        return 0

    from .config import get_settings
    settings = get_settings()

    if command == "token":
        from .utils import jwt
        print(jwt.create_token({"sub": args.email}, settings.jwt_secret_key,
                               settings.jwt_algorithm,
                               expires_minutes=args.expires_minutes,
                               audience=settings.jwt_audience,
                               issuer=settings.jwt_issuer))
        return 0

    device = torch_device()
    if getattr(args, "host", None):
        settings = dataclasses.replace(settings, host=args.host)
    if getattr(args, "port", None):
        settings = dataclasses.replace(settings, port=args.port)
    from .tpu_local.server import run
    run(settings, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
