"""PyTorch/CUDA port of the in-process LLM engine of ``mcp_context_forge_tpu``.

It runs on an NVIDIA Hopper card through hand-written CUDA kernels, and
imports nothing of the JAX package (``tests/test_torch_imports.py``).
"""
