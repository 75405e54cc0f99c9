#!/usr/bin/env python3
"""Where one llama3-1b training step's device time goes on one NVIDIA GPU.

    python3 profile_torch_train.py

Run from the root of a checkout, on a card. Builds ``chip_smoke.py``'s
``train_llama3_1b`` step (the whole llama3-1b, tied, f32 params and AdamW,
one seeded batch of 2 x 1024 tokens, attention through its plain version,
TF32 off), takes two steps to warm up, then:

- times three steps, unprofiled: the host wall per step, and the device
  span per step from CUDA events recorded around it on the stream;
- profiles one more step under ``torch.profiler`` (CPU and CUDA
  activity), and sums the device time of the kernels each ATen op
  launched itself: ``aten::mm`` (the projections and the head, forward
  and backward), ``aten::bmm`` (the attention's scores and weighted sum),
  softmax, the optimizer's ``_foreach`` ops and the rest. The GEMMs' rate is the
  step's matmul FLOPs (6 x tokens x projection and head parameters for
  ``mm``; 3 x 4 x B x S^2 x heads x head_dim x layers for ``bmm``) over
  that op's device time.

Prints one JSON line with the card. Exits 1 without CUDA.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

WARMUP, TIMED = 2, 3


def device_us(event) -> float:
    """An op's own device time in microseconds (the attribute's name
    differs across PyTorch versions)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_train: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import chip_smoke
    from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS
    from mcp_context_forge_tpu_torch.tpu_local.models.llama import init_params
    from mcp_context_forge_tpu_torch.tpu_local.train import (init_train_state,
                                                             make_optimizer, train_step)
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = MODEL_CONFIGS["llama3-1b"]
    B, S = chip_smoke.TRAIN_1B_BATCH
    gen = torch.Generator(device=dev).manual_seed(7)
    params = init_params(cfg, gen, dtype=torch.float32, device=dev)
    data = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen, device=dev)
    batch = (data[:, :-1], data[:, 1:], torch.ones((B, S), device=dev))
    state = init_train_state(params, make_optimizer(chip_smoke.TRAIN_1B_LR,
                                                    chip_smoke.TRAIN_1B_WD))
    for _ in range(WARMUP):
        state, _ = train_step(state, cfg, *batch)
    walls, spans = [], []
    for _ in range(TIMED):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.monotonic()
        start.record()
        state, _ = train_step(state, cfg, *batch)
        end.record()
        torch.cuda.synchronize()
        walls.append((time.monotonic() - t0) * 1e3)
        spans.append(start.elapsed_time(end))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = train_step(state, cfg, *batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    names = {e.name for e in kernels}
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    # ATen ops only: runtime ranges such as "Command Buffer Full" (launches
    # the host made while the device's queue was full) span kernels that
    # their ops already hold
    ops = {e.key: device_us(e) / 1e3 for e in prof.key_averages()
           if "::" in e.key and e.key not in names}
    ops = {k: ms for k, ms in ops.items() if ms > 0}
    hd, L = cfg.head_dim, cfg.n_layers
    projections = L * (cfg.dim * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
                       + cfg.n_heads * hd * cfg.dim + 3 * cfg.dim * cfg.ffn_hidden)
    head = cfg.vocab_size * cfg.dim
    flops = {"aten::mm": 6 * B * S * (projections + head),
             "aten::bmm": 3 * 4 * B * S * S * cfg.n_heads * hd * L}
    print(json.dumps({
        "card": chip_smoke.card_line(), "model": cfg.name, "batch": [B, S],
        "tf32": torch.backends.cuda.matmul.allow_tf32,
        "wall_ms": walls, "device_span_ms": spans,
        "wall_ms_median": statistics.median(walls),
        "device_span_ms_median": statistics.median(spans),
        "profiled_busy_ms": busy, "ops_busy_ms": sum(ops.values()),
        "gemm": {op: {"ms": ops.get(op, 0.0), "tflop": f / 1e12,
                      "tflop_per_s": f / 1e9 / ops[op] if ops.get(op) else None}
                 for op, f in flops.items()},
        "top_ops_ms": sorted(([k, ms] for k, ms in ops.items()),
                             key=lambda kv: -kv[1])[:16]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
