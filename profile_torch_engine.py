#!/usr/bin/env python3
"""Where the port's decode step spends its time on one NVIDIA GPU.

    python3 profile_torch_engine.py [--phase engine|long]

Run from the root of a checkout, on a card. Builds the engine of one of
``chip_smoke.py``'s llama3-8b phases (random weights from seed 0): ``engine``
(bf16 pages, max_seq_len 2048) or ``long`` (int8 KV pages, max_seq_len 8192,
a ~6000- and a ~3000-token prompt chunked), serves that phase's six
requests through ``TorchLocalProvider.chat``, and profiles decode steps 8 to
15 with ``torch.profiler`` (CUDA activity only, one step per profile, so
the profiler's start and stop stay outside the step). Each step's wall time
is the engine's own (host clock around the step, which ends in a
device-to-host copy of the sampled tokens), its device time the sum of the
kernel durations in the step. Prints one JSON line: the card, the medians
per step (wall, device busy, kernels launched, the idle share
1 - busy / wall) and the kernels that take the most device time.
Exits 1 without CUDA.
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import json
import statistics
import sys
import time
from pathlib import Path

FIRST_STEP, STEPS = 8, 8


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_engine: CUDA is not available", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser()
    parser.add_argument("--phase", choices=("engine", "long"), default="long")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import chip_smoke
    from mcp_context_forge_tpu_torch.tpu_local.engine import EngineConfig, TorchEngine
    from mcp_context_forge_tpu_torch.tpu_local.tpu_provider import TorchLocalProvider
    from torch.profiler import ProfilerActivity, profile

    config = dict(model="llama3-8b", dtype="bfloat16", device="cuda", max_batch=8,
                  max_seq_len=2048, page_size=128, num_pages=512,
                  prefill_buckets=(128, 512, 2048), prefill_max_batch=4, seed=0)
    requests = chip_smoke.chat_requests("llama3-8b")
    if args.phase == "long":
        config.update(kv_quant="int8", max_seq_len=8192)
        requests = chip_smoke.long_context_requests("llama3-8b")
    engine = TorchEngine(EngineConfig(**config))
    provider = TorchLocalProvider("tpu_local", engine)
    step = engine._decode_step
    seen, steps = [0], []

    def profiled_step():
        seen[0] += 1
        if not FIRST_STEP <= seen[0] < FIRST_STEP + STEPS:
            return step()
        before = (engine.stats.decode_steps, engine.stats.decode_ms_total)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step()
        if engine.stats.decode_steps == before[0]:
            return None   # no running row
        by_name = collections.Counter()
        kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
        for e in kernels:   # a kernel's own interval on the card
            by_name[e.name] += e.time_range.elapsed_us() / 1e3
        steps.append({"wall_ms": engine.stats.decode_ms_total - before[1],
                      "busy_ms": sum(by_name.values()), "kernels": len(kernels),
                      "by_name": by_name})
        return None

    engine._decode_step = profiled_step

    async def run():
        await engine.start()
        try:
            await asyncio.wait_for(asyncio.gather(
                *(provider.chat(r) for r in requests)), 600)
        finally:
            await engine.stop()

    t0 = time.monotonic()
    asyncio.run(run())
    if not steps:
        print("profile_torch_engine: no decode step was profiled", file=sys.stderr)
        return 1
    by_name = collections.Counter()
    for s in steps:
        for name, ms in s["by_name"].items():
            by_name[name] += ms / len(steps)
    wall = statistics.median(s["wall_ms"] for s in steps)
    busy = statistics.median(s["busy_ms"] for s in steps)
    print(json.dumps({
        "card": chip_smoke.card_line(), "phase": args.phase,
        "profiled_steps": [FIRST_STEP, FIRST_STEP + len(steps) - 1],
        "wall_ms_per_step": wall, "busy_ms_per_step": busy,
        "idle_share": 1 - busy / wall,
        "kernels_per_step": statistics.median(s["kernels"] for s in steps),
        "top_kernels_ms_per_step": [[name[:90], ms] for name, ms in by_name.most_common(12)],
        "seconds": time.monotonic() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
