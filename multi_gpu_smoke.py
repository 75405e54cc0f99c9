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
  the engine must read dead, and no process may be left;
- ``tiers_1x2``: ``chip_smoke.tier_run``'s 16-page eviction scenario on
  llama3-8b in f32 at 1x2 (cards 0-1), the lossless spill from host RAM:
  each spill gathers the page's KV-head halves from both cards, each
  restore sends each card its heads. The restored hit's stream must equal
  ``ref_f32``'s resident hit of the same request, token for token. Then,
  on a spare page of the stopped engine (its group still open): a payload
  uploaded and read back is the same bytes; planted faults, each rejected
  by that check: the halves joined in reverse rank order, and a restore
  whose broadcast page carries rank 0's heads for every rank;
- ``pool_2x_1x2``: an ``EnginePool`` of two bf16 llama3-8b replicas at
  1x2 over the four cards (``chip_smoke.pool_config``), roles
  ``prefill,decode``, both rank 0s in this process on groups of their own:
  the six chats queued at once, the three long ones migrating from one
  replica to the other (migrations ok, pages conserved); streams against
  ``ref_bf16``'s (reported), TTFT p50, decode tokens/s, migration ms;
- ``plane_owner_1x2``: the shared plane over a coordination hub, two
  worker processes (``chip_smoke.py --plane-worker ... 1x2``); the owner
  serves a 1x2 engine on cards 0-1 and is SIGKILLed with its followers
  after a chat; the survivor builds its own on the same cards once they
  have gone, and serves the same chat with the same tokens. The gap from
  the kill to its first token is split into the lease's lapse, the
  election, the build and the first token.
"""

from __future__ import annotations

import asyncio
import json
import os
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
    ("tiers_1x2", 2, None, ("ref_f32", True)),
    ("pool_2x_1x2", 4, None, ("ref_bf16", False)),
    ("plane_owner_1x2", 2, None, None),
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
           **memory, "generated": [g.generated for g in gens],
           "again": again[0].generated}
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


def tiers(torch) -> dict:
    """``tiers_1x2``: the eviction scenario through the rank path across
    two cards, then the payload round trip and its planted faults."""
    import chip_smoke as cs
    from mcp_context_forge_tpu_torch.tpu_local import engine as engine_module
    from mcp_context_forge_tpu_torch.tpu_local.engine import EngineConfig, TorchEngine

    config = {**LLAMA, "dtype": "float32", "mesh_shape": "1x2", "prefix_tiers": True,
              "tier_spill_quant": "", "num_pages": cs.TIER_POOL_PAGES,
              "tier_host_bytes": 2**31}
    t0 = time.monotonic()
    engine = TorchEngine(EngineConfig(**config), devices=rank_devices(torch, config))
    build_s = time.monotonic() - t0
    cs.check(engine.world == 2 and engine._kv_sharded, "the engine does not split its pool")

    def faults(engine) -> dict:
        alloc = engine.allocator
        page = next(iter(alloc._page_key))
        spare = alloc._free[0]
        good = engine._read_page_payload(page)
        engine._upload_page(spare, good)
        cs.check(not cs.payload_diff(engine._read_page_payload(spare), good),
                 "a payload uploaded across the two cards and read back differs")
        join = engine_module._join_heads
        engine_module._join_heads = lambda pieces: join(list(reversed(pieces)))
        try:
            swapped = cs.payload_diff(engine._read_page_payload(page), good)
        finally:
            engine_module._join_heads = join
        cs.check(bool(swapped), "halves joined in reverse rank order passed the check")
        upload = engine._op_upload_page

        def rank0_heads_everywhere(page, parts=None):
            n = parts[0].shape[2] // engine._ranks.shape[1]
            m = engine._ranks.shape[1]
            parts = tuple(t[:, :, :n].repeat(1, 1, m, 1) if i < 2 else t[:, :n].repeat(1, m)
                          for i, t in enumerate(parts))
            return upload(page, parts)

        engine._op_upload_page = rank0_heads_everywhere
        try:
            engine._upload_page(spare, good)
        finally:
            del engine._op_upload_page
        wrong = cs.payload_diff(engine._read_page_payload(spare), good)
        cs.check(bool(wrong), "a restore of rank 0's heads on every rank passed the check")
        return {"round_trip_equal": True, "reverse_rank_order_rejected": swapped,
                "rank0_heads_everywhere_rejected": wrong}

    run = cs.tier_run(torch, engine, "host", after=faults)
    layers = engine.model_config.n_layers
    cs.check_tier_hit(run, "host", 3, layers)
    want = json.loads((OUT / "ref_f32.json").read_text())
    cs.check(run["streams"][1] == want["again"],
             "the hit restored across two cards differs from ref_f32's resident hit")
    collision = run["collision"]
    cs.check(collision["collisions"] == 1 and collision["hist"] == 0
             and run["streams"][2] == run["streams"][0],
             f"the planted collision was not a miss giving the cold stream: {collision}")
    cs.check(engine.rank_digests is not None and len(set(engine.rank_digests)) == 1,
             f"ranks wrote other tokens: {engine.rank_digests}")
    return {"model": config["model"], "dtype": "float32", "mesh_shape": "1x2",
            "pool_pages": cs.TIER_POOL_PAGES, "build_s": build_s,
            "restored_stream_equal_ref_f32_hit": True,
            "cold_stream_equal_ref_f32": run["streams"][0] == want["generated"][1],
            "ttft_ms": run["ttft_ms"], "hist": run["hist"], "hit_tokens": run["hit_tokens"],
            "rates": cs.tier_rates(run, cs.payload_bytes(config["model"], False)),
            "restored_max_abs_diff": run["restored_max_abs_diff"], "faults": run["after"],
            "collision": collision, "tier_stats": run["tier_stats"]}


def pool_1x2(torch) -> dict:
    """``pool_2x_1x2``: two 1x2 replicas over four cards, prefill and
    decode, the six chats at once."""
    import torch.distributed as dist

    import chip_smoke as cs
    from mcp_context_forge_tpu_torch.tpu_local.pool import EnginePool
    from mcp_context_forge_tpu_torch.tpu_local.tpu_provider import TorchLocalProvider

    t0 = time.monotonic()
    pool = EnginePool(cs.pool_config("llama3-8b", "bfloat16"), replicas=2,
                      roles="prefill,decode", health_interval_s=0.1,
                      heartbeat_timeout_s=cs.POOL_HEARTBEAT_S,
                      devices=[torch.device("cuda", i) for i in range(4)])
    build_s = time.monotonic() - t0
    engines = [r.engine for r in pool.replicas]
    cs.check([(e.world, str(e.device)) for e in engines] == [(2, "cuda:0"), (2, "cuda:2")],
             f"replicas {[(e.world, str(e.device)) for e in engines]}")
    cs.check(engines[0]._mesh.get_group("world") is not engines[1]._mesh.get_group("world"),
             "the replicas share a process group")
    cs.check(all(b.collectives > 0 for e in engines for b in e._graphs.buffers.values()),
             "a replica's decode graph holds no collective")
    provider = TorchLocalProvider("tpu_local", pool)
    requests = cs.chat_requests("llama3-8b")
    migrate_ms: list[float] = []
    migrate = pool._migrate

    async def timed_migrate(record):
        start = time.monotonic()
        await migrate(record)
        migrate_ms.append((time.monotonic() - start) * 1e3)

    pool._migrate = timed_migrate
    memory = {}

    async def run():
        await pool.start()
        try:
            gens = [provider._prepare(r) for r in requests]
            sent = time.monotonic()
            for gen in gens:
                await pool.submit(gen)
            first, ends = {}, {}

            async def drain(k, gen):
                while (token := await asyncio.wait_for(gen.stream.get(), 600)) is not None:
                    first.setdefault(k, time.monotonic())
                ends[k] = time.monotonic()

            await asyncio.gather(*(drain(k, g) for k, g in enumerate(gens)))
            memory["cards_memory_used"] = nvidia_smi("memory.used")
            return gens, sent, first, ends
        finally:
            await pool.stop()

    gens, sent, first, ends = asyncio.run(run())
    cs.check(all(g.finish_reason in ("stop", "length") for g in gens),
             f"finish reasons {[g.finish_reason for g in gens]}")
    pages = pool.migration_pages
    cs.check(pool.migrations["ok"] >= 1 and pool.migrations["degraded"] == 0,
             f"migrations {pool.migrations}")
    cs.check(pages["spilled"] == pages["restored"] + pages["degraded"],
             f"migration pages not conserved: {pages}")
    cs.check(not dist.is_initialized(), "the default process group was initialized")
    cs.check(all(p.poll() is not None for e in engines for p in e._ranks.procs),
             "a follower outlived the pool")
    cs.check(all(e.rank_digests is not None and len(set(e.rank_digests)) == 1
                 for e in engines), "a replica's ranks wrote other tokens")
    ttft = [(first[k] - sent) * 1e3 for k in range(len(gens))]
    decode = engines[1].stats
    decode_tokens = sum(len(g.generated) - 1 for g in gens)
    return {"model": "llama3-8b", "dtype": "bfloat16", "replicas": 2, "mesh_shape": "1x2",
            "roles": [r.role for r in pool.replicas], "build_s": build_s,
            "prompt_tokens": [len(g.prompt_ids) for g in gens],
            "ttft_ms": ttft, "ttft_p50_ms": statistics.median(ttft),
            "serve_s": max(ends.values()) - sent,
            "decode_tokens_per_s_decode_replica": (
                decode.completion_tokens / (decode.decode_wall_ms_total / 1e3)
                if decode.decode_wall_ms_total else None),
            "tokens_per_s_wall": decode_tokens / (max(ends.values()) - sent),
            "migrations": dict(pool.migrations), "migration_pages": dict(pages),
            "migration_bytes": pool.migration_bytes, "migration_ms": migrate_ms,
            "migration_ms_p50": statistics.median(migrate_ms) if migrate_ms else None,
            "router": pool.router.counters(), **memory,
            "generated": [g.generated for g in gens]}


def plane_owner(torch) -> dict:
    """``plane_owner_1x2``: a SIGKILLed 1x2 owner and its survivor."""
    import chip_smoke as cs

    hub = cs.HubThread(secret=f"multi-gpu-{os.getpid()}-{time.time_ns()}")
    conductor = cs.PlaneConductor(hub, "llama3-8b", "bfloat16", processes=True,
                                  mesh_shape="1x2")
    body = cs.plane_chats("llama3-8b")["failover"]
    out: dict = {"model": "llama3-8b", "dtype": "bfloat16", "mesh_shape": "1x2",
                 "lease_ttl_s": cs.PLANE_TTL_S}

    def gone(pid: int) -> bool:
        """The process exited (an orphan may linger as a zombie until
        init reaps it)."""
        try:
            return Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0] == "Z"
        except FileNotFoundError:
            return True

    async def run():
        await conductor.start()
        try:
            conductor.spawn("W0")
            await conductor.alive("W0", 120)
            cs.check(await conductor.built_owner(["W0"], 300) == "W0", "W0 did not build")
            conductor.spawn("W1")
            await conductor.alive("W1", 120)
            forwarded = await conductor.call("W1", "chat", body=body)
            cs.check(forwarded["error"] is None, f"the forwarded chat failed: {forwarded}")
            report = await conductor.call("W0", "report")
            cs.check(report["world"] == 2 and len(report["follower_pids"]) == 1,
                     f"W0 serves world {report['world']}, followers {report['follower_pids']}")
            stream = report["served"][-1]["generated"]
            cs.check(cs.spelled_ids(forwarded["content"]) == stream,
                     "the forwarded chunks are not the owner's tokens")
            lease: dict = {}
            t_kill = time.time()
            await conductor.kill("W0")
            followers_gone = None
            while "elected" not in lease or followers_gone is None:
                now = time.time()
                owner = await conductor.owner()
                if owner != "W0" and "lapsed" not in lease:
                    lease["lapsed"] = now
                if owner == "W1" and "elected" not in lease:
                    lease["elected"] = now
                if followers_gone is None and all(gone(p) for p in report["follower_pids"]):
                    followers_gone = now
                cs.check(now - t_kill < 60, f"60 s after the kill: lease {lease}, the dead "
                                            f"owner's followers gone at {followers_gone}")
                await asyncio.sleep(cs.LEASE_POLL_S)
            cs.check(await conductor.built_owner(["W1"], 300) == "W1", "W1 did not build")
            retried = await conductor.call("W1", "chat", body=body)
            cs.check(retried["error"] is None, f"the survivor's chat failed: {retried}")
            survivor = await conductor.call("W1", "report")
            build = survivor["builds"][-1]
            cs.check(survivor["world"] == 2, f"the survivor serves world {survivor['world']}")
            cs.check(survivor["served"][-1]["generated"] == stream,
                     "the survivor's stream differs from the dead owner's")
            cs.check(followers_gone <= build["t_start"],
                     "the survivor built before the dead owner's followers had gone")
            first_token = retried["arrivals"][0]
            out.update(
                forwarded_ttft_ms=(forwarded["arrivals"][0] - forwarded["t_send"]) * 1e3,
                stream_tokens=len(stream), survivor_stream_equal=True,
                followers_gone_after_kill_s=followers_gone - t_kill,
                gap_s=first_token - t_kill,
                split_s={"lease_lapse": lease["lapsed"] - t_kill,
                         "election": lease["elected"] - lease["lapsed"],
                         "build": build["t_end"] - lease["elected"],
                         "first_token": first_token - build["t_end"]},
                build_s={"W0": report["builds"][0]["seconds"], "W1": build["seconds"]})
        finally:
            await conductor.stop()

    try:
        asyncio.run(run())
    finally:
        hub.close()
        for log in conductor.logs.glob("W*.log"):   # the workers' own logs
            (OUT / f"plane_owner_{log.name}").write_text(log.read_text())
    return out


def child(name: str) -> int:
    import torch

    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = {p[0]: p for p in PHASES}[name]
    t0 = time.monotonic()
    special = {"dead_follower": dead_follower, "tiers_1x2": tiers, "pool_2x_1x2": pool_1x2,
               "plane_owner_1x2": plane_owner}
    if name in special:
        out = special[name](torch)
        if name == "pool_2x_1x2":
            want = json.loads((OUT / "ref_bf16.json").read_text())["generated"]
            out["streams_equal_ref_bf16"] = [a == b for a, b in zip(out["generated"], want)]
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
