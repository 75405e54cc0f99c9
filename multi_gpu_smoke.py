#!/usr/bin/env python3
"""Multi-rank serving of the PyTorch/CUDA port across the GPUs of one host.

    python3 multi_gpu_smoke.py [PHASE ...]

Runs every phase below, or the named ones and the references they need.
Needs two or more CUDA devices (four for the 1x4 and 2x2 phases) and
exits 1 without them. Run from the root of a checkout, after
``chip_smoke.py`` or on its own (it builds the kernels first). Each phase
runs in a child process of its own (``--phase NAME``) under a time limit,
so that a hung collective ends that phase alone; each prints one JSON line
and writes its full record under ``chiprun_out/multi_gpu/``; the parent
prints the card line and a summary line last, and exits non-zero when a
phase failed.

Every engine serves ``chip_smoke.chat_requests(model)`` with seeded
random weights (every rank draws the whole tree leaf by leaf and keeps
its block), all six queued before the dispatch thread starts, so that the
admission groups, and with them every prefill's shape, are the same in
every phase; then the request sharing the system prompt twice more, each
a prefix hit, whose tokens must repeat:

- ``ref_f32``, ``ref_bf16``: llama3-8b at full width on card 0 alone;
- ``tp_1x2_f32``: llama3-8b in f32 at mesh 1x2 (cards 0-1): its greedy
  streams must equal ``ref_f32``'s token for token;
- ``tp_1x2``, ``tp_1x4``, ``tp_2x2`` (bf16): streams against ``ref_bf16``'s
  (reported: a row-parallel sum in another order may part a bf16 near
  tie), TTFT p50, decode tokens/s, the build's seconds and each card's
  memory in use while serving. Every multi-rank engine must stop within
  15 s, with every rank's digest of the tokens it wrote equal;
- ``sp_1x2_ring``: bf16 at 1x2 with ``sp_impl="ring"`` and ``sp_threshold``
  512: the 2048 bucket's prefill rotates K/V blocks between the two cards;
- ``mixtral_bf16_1x2``: mixtral-8x7b in bf16 at full depth (about 93 GB of
  weights: more than one card holds) at 1x2, the grouped expert kernel
  on each rank's half of every expert;
- ``dead_follower``: llama3-tiny (f32) at 1x2, a follower killed mid-decode:
  the stream must end with the error terminal within the group timeout,
  the engine must read dead, and no process may be left.
"""

from __future__ import annotations

import asyncio
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "multi_gpu"
PHASE_TIMEOUT_S = 300
LLAMA = dict(model="llama3-8b", max_batch=8, max_seq_len=2048, page_size=128, num_pages=512,
             prefill_buckets=(128, 512, 2048), prefill_max_batch=4, seed=0)
# (phase, cards it needs, engine overrides, reference phase whose streams it
# must equal (True) or is reported against (False))
PHASES = [
    ("ref_f32", 1, dict(dtype="float32", device="cuda:0"), None),
    ("ref_bf16", 1, dict(dtype="bfloat16", device="cuda:0"), None),
    ("tp_1x2_f32", 2, dict(dtype="float32", mesh_shape="1x2"), ("ref_f32", True)),
    ("tp_1x2", 2, dict(dtype="bfloat16", mesh_shape="1x2"), ("ref_bf16", False)),
    ("tp_1x4", 4, dict(dtype="bfloat16", mesh_shape="1x4"), ("ref_bf16", False)),
    ("tp_2x2", 4, dict(dtype="bfloat16", mesh_shape="2x2"), ("ref_bf16", False)),
    ("sp_1x2_ring", 2, dict(dtype="bfloat16", mesh_shape="1x2", sp_impl="ring",
                            sp_threshold=512), ("ref_bf16", False)),
    ("mixtral_bf16_1x2", 2, dict(model="mixtral-8x7b", dtype="bfloat16", mesh_shape="1x2",
                                 moe_impl="grouped_pallas"), None),
    ("dead_follower", 2, None, None),
]


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str) -> list[str]:
    """One line per card of ``nvidia-smi --query-gpu=<query>``."""
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()


def rank_devices(torch, config: dict) -> list | None:
    """One device per rank of the config's mesh: the first cards (CPU
    ranks for a CPU config), or None without a mesh shape."""
    mesh = config.get("mesh_shape", "")
    if not mesh:
        return None
    data, model = (int(n) for n in mesh.split("x"))
    kind = torch.device(config.get("device", "cuda")).type
    return [torch.device(kind, i) if kind == "cuda" else torch.device(kind)
            for i in range(data * model)]


def serve(torch, overrides: dict) -> dict:
    """One engine of ``LLAMA`` + ``overrides`` serving the chat requests
    (queued before it starts), then the prefix-sharing one again."""
    import chip_smoke as cs
    from mcp_context_forge_tpu_torch.tpu_local.engine import EngineConfig, TorchEngine
    from mcp_context_forge_tpu_torch.tpu_local.tpu_provider import TorchLocalProvider

    config = {**LLAMA, **overrides}
    mesh = config.get("mesh_shape", "")
    on_card = torch.device(config.get("device", "cuda")).type == "cuda"
    t0 = time.monotonic()
    engine = TorchEngine(EngineConfig(**config), devices=rank_devices(torch, config))
    build_s = time.monotonic() - t0
    provider = TorchLocalProvider("tpu_local", engine)
    requests = cs.chat_requests(config["model"])
    gens = [provider._prepare(r) for r in requests]
    engine._pending.extend(gens)
    memory = {}

    async def run():
        await engine.start()
        try:
            t_start = time.monotonic()
            for gen in gens:
                while await asyncio.wait_for(gen.stream.get(), 600) is not None:
                    pass
                if not memory and on_card:
                    memory["cards_memory_used"] = nvidia_smi("memory.used")
            wall = time.monotonic() - t_start
            again = []
            for _ in range(2):
                again.append(provider._prepare(requests[1]))
                await engine.submit(again[-1])
                while await asyncio.wait_for(again[-1].stream.get(), 600) is not None:
                    pass
            return wall, again
        finally:
            t_stop = time.monotonic()
            await engine.stop()
            memory["stop_s"] = time.monotonic() - t_stop

    stats0 = dict(engine.stats.__dict__)
    wall, again = asyncio.run(run())
    delta = {k: v - stats0[k] for k, v in engine.stats.__dict__.items()}
    cs.check(all(g.finish_reason in ("stop", "length") for g in gens),
             f"finish reasons {[g.finish_reason for g in gens]}")
    cs.check(all(a.hist > 0 for a in again), "a repeat missed the prefix cache")
    cs.check(again[0].generated == again[1].generated, "a repeated request changed its tokens")
    ttft = [(g.first_token_ts - g.created) * 1e3 for g in gens]
    decode_tokens = sum(len(g.generated) - 1 for g in gens)
    out = {"model": config["model"], "dtype": config["dtype"], "mesh_shape": mesh,
           "world": engine.world, "build_s": build_s, "serve_s": wall,
           "prompt_tokens": [len(g.prompt_ids) for g in gens],
           "buckets": [g.bucket for g in gens], "prefix_hit_tokens": again[0].hist,
           "hit_equals_cold_prefill": again[0].generated == gens[1].generated,
           "ttft_ms": ttft, "ttft_p50_ms": statistics.median(ttft),
           "decode_tokens_per_s": decode_tokens / (delta["decode_wall_ms_total"] / 1e3),
           "graph_captures": engine.stats.graph_captures, "graph_replays": delta["graph_replays"],
           "graph_collectives_per_replay": sorted({b.collectives
                                                   for b in engine._graphs.buffers.values()}),
           "rank_digests_equal": (None if engine.rank_digests is None
                                  else len(set(engine.rank_digests)) == 1),
           **memory, "generated": [g.generated for g in gens]}
    if engine.world > 1:
        cs.check(out["stop_s"] < 15.0, f"stop() took {out['stop_s']:.1f} s")
        cs.check(bool(out["rank_digests_equal"]),
                 f"ranks wrote other tokens: {engine.rank_digests}")
    return out


def dead_follower(torch, device: str = "cuda") -> dict:
    """A 1x2 llama3-tiny engine whose follower is killed mid-decode."""
    import chip_smoke as cs
    from mcp_context_forge_tpu_torch.tpu_local.engine import EngineConfig, GenRequest, TorchEngine

    timeout_s = 20.0
    config = dict(model="llama3-tiny", dtype="float32", mesh_shape="1x2", max_seq_len=2048,
                  init_timeout_s=timeout_s, auto_restart=True, device=device)
    engine = TorchEngine(EngineConfig(**config), devices=rank_devices(torch, config))

    async def run():
        await engine.start()
        request = GenRequest(request_id="long", prompt_ids=list(range(1, 41)), max_tokens=1500)
        await engine.submit(request)
        for _ in range(8):
            cs.check(await asyncio.wait_for(request.stream.get(), 120) is not None,
                     "the stream ended before the kill")
        engine._ranks.procs[0].kill()
        killed = time.monotonic()
        while await asyncio.wait_for(request.stream.get(), 3 * timeout_s) is not None:
            pass
        ended = time.monotonic() - killed
        alive = engine.dispatch_alive()
        t_stop = time.monotonic()
        await asyncio.wait_for(engine.stop(), 3 * timeout_s)
        return request, ended, alive, time.monotonic() - t_stop

    request, ended, alive, stop_s = asyncio.run(run())
    left = [p.poll() for p in engine._ranks.procs]
    cs.check(request.finish_reason == "error", f"finish reason {request.finish_reason!r}")
    cs.check(ended < timeout_s, f"the stream ended {ended:.1f} s after the kill")
    cs.check(not alive and engine.stats.engine_restarts == 0, "the engine reads alive")
    cs.check(all(code is not None for code in left), f"followers left: {left}")
    return {"finish_reason": request.finish_reason, "tokens_before_end": len(request.generated),
            "ended_s_after_kill": ended, "stop_s": stop_s, "group_timeout_s": timeout_s,
            "follower_exit_codes": left}


def child(name: str) -> int:
    import torch

    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = {p[0]: p for p in PHASES}[name]
    t0 = time.monotonic()
    if name == "dead_follower":
        out = dead_follower(torch)
    else:
        out = serve(torch, spec[2])
        ref = spec[3]
        if ref is not None:
            want = json.loads((OUT / f"{ref[0]}.json").read_text())["generated"]
            equal = [a == b for a, b in zip(out["generated"], want)]
            parted = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
                      for a, b in zip(out["generated"], want)]
            out.update({f"streams_equal_{ref[0]}": equal,
                        f"first_differing_token_vs_{ref[0]}": parted})
            if ref[1] and not all(equal):
                raise SystemExit(f"{name}: streams differ from {ref[0]}'s: {parted}")
    out["seconds"] = time.monotonic() - t0
    (OUT / f"{name}.json").write_text(json.dumps(out))
    emit({"phase": name, **{k: v for k, v in out.items() if k != "generated"}})
    return 0


def main(wanted: list[str]) -> int:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("multi_gpu_smoke: needs two or more CUDA devices", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from mcp_context_forge_tpu_torch.tpu_local.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    cards = torch.cuda.device_count()
    t0 = time.monotonic()
    _build.build()
    emit({"phase": "build", "seconds": time.monotonic() - t0, "cards": cards,
          "names": [torch.cuda.get_device_name(i) for i in range(cards)]})
    if wanted:
        refs = {p[3][0] for p in PHASES if p[0] in wanted and p[3] is not None}
        wanted = set(wanted) | refs
    results = {}
    for name, needs, _, ref in PHASES:
        if wanted and name not in wanted:
            continue
        if needs > cards or (ref is not None and results.get(ref[0]) != "ok"):
            results[name] = "skipped"
            continue
        start = time.monotonic()
        try:
            proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--phase", name],
                                  timeout=PHASE_TIMEOUT_S)
            results[name] = "ok" if proc.returncode == 0 else f"exit {proc.returncode}"
        except subprocess.TimeoutExpired:
            results[name] = f"timed out after {PHASE_TIMEOUT_S} s"
        if results[name] != "ok":
            emit({"phase": name, "failed": results[name], "seconds": time.monotonic() - start})
    for line in nvidia_smi("name,power.limit"):
        print(line, flush=True)
    emit({"multi_gpu": results, "seconds": time.monotonic() - t0})
    return 0 if all(r in ("ok", "skipped") for r in results.values()) else 1


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--phase":
        sys.exit(child(sys.argv[2]))
    sys.exit(main(sys.argv[1:]))
