"""PyTorch/CUDA port of the in-process LLM engine of ``mcp_context_forge_tpu``.

It runs on an NVIDIA Hopper card through hand-written CUDA kernels, and
imports nothing of the JAX package (``tests/test_torch_imports.py``).
"""

__version__ = "0.1.0"   # the JAX package's version: app_info renders the same

PROTOCOL_VERSION = "2025-06-18"
"""Latest MCP protocol revision the gateway speaks."""

SUPPORTED_PROTOCOL_VERSIONS = ("2024-11-05", "2025-03-26", "2025-06-18")
