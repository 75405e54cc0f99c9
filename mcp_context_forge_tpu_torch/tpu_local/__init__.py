"""The ``tpu_local`` engine, ported to PyTorch: model, paged KV cache,
attention kernels, sampling, engine and chat provider."""
