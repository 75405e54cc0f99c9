#!/usr/bin/env python3
"""Where the port's decode time goes on one NVIDIA GPU.

    python3 profile_torch_engine.py [--phase engine|long|spec]

Run from the root of a checkout, on a card. Builds the engine of one of
``chip_smoke.py``'s llama3-8b phases (random weights from seed 0): ``engine``
(bf16 pages, max_seq_len 2048), ``long`` (int8 KV pages, max_seq_len 8192,
a ~6000- and a ~3000-token prompt chunked) or ``spec`` (``engine`` with
speculative decoding, plus the extraction-style request), serves that
phase's requests through ``TorchLocalProvider.chat``, and reads two
windows of the engine's loop, each step of which dispatches one
CUDA-graph replay (``spec``: one verify replay, read back before the step
ends; the windows count verify steps and time only verify replays) and,
under the overlapped pipeline, retires the one before it:

- steps 8 to 15 (``spec``: verify steps 4 to 11), unprofiled: the wall
  per step, ``EngineStats.decode_wall_ms_total`` over the window's
  retires (retire to retire); the device time per replay, CUDA events
  recorded around each replay on its stream (a graph's kernels run back
  to back, so this is its busy time); the idle share, 1 - device time /
  wall;
- steps 16 to 23 (``spec``: 12 to 19), under ``torch.profiler`` (CUDA
  activity only): the kernels (and copies) per replay, their summed time
  per replay, and the kernels that take the most device time. CUPTI's tracing of graph
  kernels slows each replay's host side by about a second, so no wall is
  read from this window.

Prints one JSON line with the card. Exits 1 without CUDA.
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import json
import sys
import time
from pathlib import Path

FIRST_STEP, STEPS = 8, 8
SPEC_FIRST_STEP = 4   # a spec phase runs ~30 verify steps in all


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_engine: CUDA is not available", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser()
    parser.add_argument("--phase", choices=("engine", "long", "spec"), default="long")
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
    spec = args.phase == "spec"
    first = SPEC_FIRST_STEP if spec else FIRST_STEP
    if spec:
        config.update(spec_decode=True)
        requests = requests + [chip_smoke.extraction_request("llama3-8b")]
    engine = TorchEngine(EngineConfig(**config))
    provider = TorchLocalProvider("tpu_local", engine)
    if spec:
        name = "_spec_step_all"
    else:
        name = "_decode_step_overlapped" if engine.config.decode_overlap else "_decode_step_all"
    step, retire = getattr(engine, name), engine._decode_retire
    seen, retires, window, marks = [0], [0], {}, []

    class TimedGraph:
        """A graph whose replays in the first window are bracketed by
        CUDA events."""

        def __init__(self, graph):
            self.graph = graph

        def replay(self):
            if not first <= seen[0] < first + STEPS:
                return self.graph.replay()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            self.graph.replay()
            end.record()
            marks.append((start, end))
            return None

    for key, bufs in engine._graphs.buffers.items():
        if (key.kind == "verify") == spec:
            bufs.graph = TimedGraph(bufs.graph)

    def counted_retire(inflight):
        retires[0] += 1
        return retire(inflight)

    def profiled_step():
        seen[0] += 1
        stats = engine.stats
        if seen[0] == first:
            window.update(wall=stats.decode_wall_ms_total, retires=retires[0],
                          t0=time.monotonic())
        if seen[0] == first + STEPS:
            window["prof"] = profile(activities=[ProfilerActivity.CUDA])
            window["replays"] = stats.graph_replays
            window["prof"].start()
        step()
        if spec:
            retires[0] += 1   # a verify step reads its own dispatch back
        if seen[0] == first + STEPS - 1:
            torch.cuda.synchronize()
            window.update(host_s=time.monotonic() - window["t0"],
                          wall=stats.decode_wall_ms_total - window["wall"],
                          retires=retires[0] - window["retires"],
                          busy=[s.elapsed_time(e) for s, e in marks])
        if seen[0] == first + 2 * STEPS - 1:
            torch.cuda.synchronize()
            window["prof"].stop()
            window["replays"] = stats.graph_replays - window["replays"]

    setattr(engine, name, profiled_step)
    engine._decode_retire = counted_retire

    async def run():
        await engine.start()
        try:
            await asyncio.wait_for(asyncio.gather(
                *(provider.chat(r) for r in requests)), 600)
        finally:
            await engine.stop()

    t0 = time.monotonic()
    asyncio.run(run())
    if "replays" not in window or not window["replays"] or not window["busy"]:
        print("profile_torch_engine: the decode windows were not reached", file=sys.stderr)
        return 1
    by_name = collections.Counter()
    kernels = [e for e in window["prof"].events() if e.device_type.name == "CUDA"]
    for e in kernels:   # a kernel's own interval on the card
        by_name[e.name] += e.time_range.elapsed_us() / 1e3
    replays, busy = window["replays"], window["busy"]
    wall = window["wall"] / window["retires"]
    device = sum(busy) / len(busy)
    print(json.dumps({
        "card": chip_smoke.card_line(), "phase": args.phase,
        "superstep": engine.config.superstep,
        "decode_overlap": engine.config.decode_overlap and not spec,
        "spec_decode": spec, "spec_steps": engine.stats.spec_steps,
        "timed_steps": [first, first + STEPS - 1],
        "profiled_steps": [first + STEPS, first + 2 * STEPS - 1],
        "timed_replays": len(busy), "retires": window["retires"],
        "wall_ms_per_step": wall, "device_ms_per_replay": device,
        "idle_share": 1 - device / wall,
        "host_window_ms_per_replay": window["host_s"] * 1e3 / len(busy),
        "profiled_replays": replays,
        "kernels_per_replay": len(kernels) / replays,
        "profiled_busy_ms_per_replay": sum(by_name.values()) / replays,
        "top_kernels_ms_per_replay": [[k[:90], ms / replays]
                                      for k, ms in by_name.most_common(12)],
        "seconds": time.monotonic() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
