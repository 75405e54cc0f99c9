#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each printing one JSON line:

1. device: the card (nvidia-smi name and power limit); TF32 off.
2. build: nvcc builds every kernel from ``csrc/`` for sm_90a, one process
   per source, all started together, into ``build/kernels/``.
3. kernels: each kernel against its plain PyTorch version in bf16 (atol =
   rtol = 2e-2 on the rows anyone reads: both sides accumulate in f32; the
   order of the sums and the bf16 rounding of the output differ), with
   CUDA-event times (median of 25 runs, L2 flushed before each; see
   ``Timer`` for the card's time against the call's) and each kernel's
   bound on this card, and one PyTorch call computing the same function
   (``library_ms``: SDPA over K/V gathered, expanded and dequantized in
   advance). Flash runs both of its kernels: the wgmma one (bf16 at hd 128
   and 64, G = 4 and the qwen2 G = 7) and the mma.sync one (f32 at the
   llama3-tiny geometry, held per row to 1e-4; bf16 at gemma-2b's; every
   head-dim template in both dtypes at small shapes). The paged chunk
   kernel runs its wgmma route (bf16 pages; int8 below) and its mma.sync
   route (f32 pages and int8 pages at the llama3-tiny geometry, held per
   row to 1e-4), each at a spread of geometries (page sizes 16 to 256,
   qwen2-7b's G = 7, gemma-2b's KV 1 / G 8 / hd 256); decode is held at
   those geometries too. Planted faults show that the checks see a kernel
   that misreads part of a walk.
4. model: a tiny f32 model on the card (kernels) against the same model on
   the CPU (plain versions): prefill, prefix-hit suffix prefill, decode.
   Then ``engine_llama3_tiny_f32``: the engine phase below on llama3-tiny in
   f32, the path of the mma.sync flash and chunk kernels.
5. engine: ``TorchLocalProvider.chat`` with seeded random weights in bf16
   (decode on CUDA graphs, below):
   six concurrent greedy requests (two share a 300+ token system prompt,
   so the second hits the prefix cache; one is ~1450 tokens), then one
   request sent twice must give the same tokens. Every kernel's launch
   count is reset just before the six requests, and each kernel the phase
   runs must show > 0 launches after them; the chunk kernels must launch
   once per layer per call of the history prefill (a whole chunk round or
   prefix-hit suffix in one call). Each engine is freed before the next is
   built. The kernel table's ``launches`` sum every engine phase and
   model check.

Decode in every engine phase is CUDA-graph replays of K-step super-steps
(the overlapped pipeline on, as by default): each phase checks that
``decode_step`` ran only while the engine was built (warm-up and capture,
2 K calls per graph; one graph per width and greedy-only or sampling) and
never while it served, that every decode dispatch was a replay, and that
each decode kernel's launches equal replays x the graph's launches of it;
its line adds ``graph_replays``, ``graph_captures``, ``decode_dispatches``,
``overlap_steps``, ``pipeline_drains`` and ``decode_wall_ms_total``
(retire-to-retire wall, which decode tokens/s divides by). The llama3-8b
phase also gives one replay's inputs to the eager super-step on the same
pool (``graph_against_eager``: equal greedy tokens, logits within the row
bound), and ``engine_llama3_tiny_f32_k8`` repeats the llama3-tiny phase at
K = 8, whose greedy streams must equal the K = 1 phase's. ``kv_write``
holds the fused int8 decode writer bit for bit against the plain writer
(pages >= 1 and their scales) at Llama-3-8B shapes, with three planted
faults.

Speculative decoding (prompt-lookup drafts, a [B, spec_k] verify replayed
from its own CUDA graphs through the paged chunk kernel): in
``engine_llama3_tiny_f32_spec`` and ``engine_llama3_tiny_f32_int8_kv_spec``
greedy streams must equal the plain phases' of the same config in the
same run (``engine_llama3_tiny_f32`` and ``engine_llama3_tiny_f32_int8_kv``).
``engine_llama3_8b_spec`` serves the ``engine`` phase's requests plus an
extraction-style one at full width and depth in bf16; one verify replay
must give bit-identical logits to the eager verify, and at llama3-8b's
width in f32 (4 layers) each verify position's logits are held to an
eager decode step's over the same prefix (``verify_against_eager``); its
streams' agreement with the ``engine`` phase is reported. Every engine
phase accounts for each launch: decode kernels = replays x per-graph
launches, and flash, the chunk kernels and the int8 span writer add one
launch per layer per eager prefill or history prefill; the plain int8
writer (``_quant_store``) never runs on the card. ``kv_span_write`` holds
the int8 span writer (prefill, chunk rounds, hit suffixes, verify) bit
for bit against the plain writer at the verify's block and a 2048-token
prefill block, with three planted faults, and ``kernels_verify_shape``
times the chunk kernel (rows 2 and 2b) at the verify's shape.

The attention path runs first, on a card the MoE phases have not loaded:
kernels (Llama-3-8B serving shapes), model (llama3-tiny), engine (llama3-8b
at full width, 32 layers: the three attention kernels; every flash and
chunk launch must take the wgmma kernels). Then the long-
context path on int8 KV pages: the int8-page chunk and decode kernels at
Llama-3-8B shapes over a 1024-page int8 pool (seq_lens up to ~8000; 512-
query chunks over up to 48 history pages, and the 6040-token prompt's last
chunk round: 2048 queries, 1944 of them real, over 32 history pages), the
fused int8 decode writer (``kv_write``), the llama3-tiny model check on
int8 pages, and
``engine_llama3_8b_int8_kv_long``: llama3-8b at full width
and depth with ``kv_quant="int8"``, max_seq_len 8192 and a 512-page byte
budget (1023 int8 pages), serving a ~6000-token and a ~3000-token prompt
by chunked prefill beside a prefix hit and two short chats (tensor-core
flash and the two int8-page kernels, the chunk kernel on its wgmma route;
the bf16 paged kernels, the mma.sync chunk kernels and the mma.sync
flash kernel must not launch). Then gemma-2b, whose 256-wide heads the
wgmma kernels do not take: the mma.sync chunk kernel at its geometry (the
2048-query chunk round over 32 history pages, bf16 and int8 pages; 4 x
512 queries), and ``engine_gemma_2b``: gemma-2b at full width and depth
(18 layers, bf16 weights, bf16 pages of 128, max_seq_len 8192, 512
pages) serving the same long-context requests (the mma.sync flash, chunk
and decode kernels at KV 1, G 8, hd 256; no wgmma attention kernel may
launch). Then the MoE path:
kernels (both routes of the grouped-expert kernels, the wgmma one and the
WMMA one, at Mixtral-8x7B widths on a 2048-token batch routed by a
seeded random router, NB = 40 blocks of 128 rows, each row also held in
norm to MOE_ROW_RMS, with planted faults, plus the cost of one expert-scan
``qmm`` over an int8 expert matrix), model (mixtral-test through the
grouped path at moe_block 8, the WMMA route, full-precision and int8
weights), and two engine phases: mixtral-8x7b at full width and depth
with int8 weights (``moe_impl="grouped_pallas"``: attention and
``expert_blocks_tc_q8``), and mixtral-8x7b in bf16 cut to 8 layers (32 do
not fit the card in bf16: attention and ``expert_blocks_tc``); neither may
launch the WMMA route.

Operability and observability (every engine phase, and three phases of
their own): each engine phase checks ``compile_stats()``: the
construction's graph captures are warmup-stage events equal to
``graph_captures``, and no kernel is built and no graph captured while it
serves. ``engine_llama3_8b_ops`` (after ``engine``) serves the ``engine``
phase's requests on llama3-8b with decode graphs for K = 1 and 4
(``k_ladder``), phase attribution every 4th decode dispatch and the
telemetry handles (the port's own tracer and signal bus, recording
stand-ins of the metrics registry and the ledger); once every request has
streamed its first token, ``request_knobs(superstep=4)`` must be accepted
and land at a drain barrier. Its greedy streams must equal the ``engine`` phase's, its phase
rows be complete and sum to their totals within 5 %, the median sampled
K = 1 device compute be within 25 % of one K = 1 replay's CUDA-event time,
the roofline over the decode window lie in (0, 1.05] for both mfu and
hbm_roofline_frac, and the span names and metric families equal what the
CPU tests pin. ``engine_restart`` (llama3-tiny, f32, ``auto_restart``,
one slot) plants a one-shot fault in ``DecodeGraphs.launch``: the victim
ends "error", the queued request completes, one restart, no capture, the
pool reset in place, the same tokens after it, no page in use.
``encoder_mini`` runs ``embed`` and ``classify`` (both coverages) through
the provider's batcher on the encoder-mini geometry over 64 concurrent
texts (two past 1024 tokens), each row held to the same weights on the
CPU within 1e-4 of its largest value, with the ms of each coalesced
forward.

The serving plane (two phases on one llama3-8b build: full width and
depth, bf16, K rungs 1 and 4, ``auto_restart``, the port's own signal
bus and tracer): ``engine_llama3_8b_admission`` sends the ``engine``
phase's requests through the port's stdlib admission (``gateway/auth.py``
resolves a minted JWT or the Basic admin credentials, ``require("llm.chat")``,
the overload shedder's ``decide_admission``, the registry's chat under the
tenant contextvar); at the first tokens four bad credentials (none, a wrong
password, a JWT for another audience, a JWT scoped without ``llm.chat``)
are refused before the engine sees them, and a shedder with ``shed_at`` 0
and the class order ["batch"] sheds a ``batch`` tenant (429) and admits a
``default`` one; the streams equal ``engine``'s. ``engine_llama3_8b_controller``
(the same run): a ``safe_mode`` and an actuating ``ServingController`` tick
over the engine's live signals and both decide K 1 -> 4; the actuating
one's move lands at a drain barrier and its ring row settles an effect;
with the fault plane disabled arming is refused and one overlapped decode
dispatch runs ``DECODE_REPLAY_EVENTS`` device events (``torch.profiler``);
then an ``engine.dispatch`` error fault armed once under ``auto_restart``
(the victim ends "error", the queued request completes, one restart, no
capture, the same tokens after, no page in use). A second build with
``spec_decode``: a controller turns drafting off from the live acceptance
and ``spec_steps`` stops rising once it lands; the streams' agreement with
``engine``'s is reported (in bf16 the verify's logits, and the KV it
writes, drift from a decode step's, so a near-tie may flip even after
drafting stops). The same toggle on llama3-tiny in f32 must leave every
stream equal to ``engine_llama3_tiny_f32``'s.

Checkpoints (two phases; the files live under ``build/checkpoints/`` for
the phase only, after ``shutil.disk_usage`` is printed): this script draws
a seeded tree on the card and writes it in HF layout with its own
safetensors writer (8-byte header length, JSON header, raw little-endian
bf16; transposed ``*.weight``, ``model.layers.N.*`` names; two shard
files), streamed a tensor at a time. ``checkpoint_llama3_8b`` (full width
and depth, 16.06 GB) boots ``TorchEngine(EngineConfig(checkpoint=...))``
in bf16, every leaf bit for bit the drawn one (norms widened to f32; each
drawn leaf made again from its own generator to compare), and serves a
chat, an SSE stream (``sse_event`` frames ending in ``SSE_DONE``) and a
chat sharing the first's full-page prefix through an
``LLMProviderRegistry`` (flash, the paged chunk kernel and decode
launch); then with ``quant="int8"``: every leaf bit for bit
``quantize_tree`` of the drawn leaf on the card, the load's peak device
memory under the bf16 tree's bytes, one request. ``checkpoint_mixtral_int8``
(full width, one layer, per-expert tensors with one expert split across
the two files) loads as int8: each expert stack's q and s bit for bit
``quantize_tree``'s (s [8, 14336] / [8, 4096]), the peak under the bf16
tree's bytes, a ~1450-token request on the int8 grouped-expert kernel;
the int8 tree through ``save_params``/``load_params`` bit for bit; the bf16
tree saved the same way refused under ``quant="int8"``. Planted faults it
must reject: a flipped byte in a shard's data, an expert tensor dropped
from a header (the incomplete-stack error), and a loader that quantizes
expert stacks over axis 0, the expert axis. Each load prints its seconds,
GB/s and peak; each engine its ``compile_stats()``.

The spill tiers (``prefix_tiers``; three phases): a request whose
system prompt fills three pages is sent cold, then two ~1440-token
summaries evict (spill) those pages from a 16-page pool, then the request
again, whose history is restored from the tiers into the pool
(fetch-on-miss) and prefilled as a hit through the paged chunk kernel.
``engine_llama3_8b_tiers`` (llama3-8b, full width and depth, bf16): a pool
that never evicts gives the resident hit's stream, one fed decode
dispatch's device events (``DECODE_REPLAY_EVENTS``) and what a spill read
costs a decode step it overlaps; the lossless spill (``tier_spill_quant=""``)
restored from host RAM and, with a host budget of one page, from disk must
give that stream with every restored page equal on the card to the page
spilled; a payload with one flipped byte of its chunk identity is a miss
and the request then gives its cold stream; an armed ``tier.disk.write``
error is counted; the default int8 spill reports how many tokens match.
Each run prints spill and restore ms per page (median, max) and their GB/s,
the TTFTs (cold, resident, host, disk), the chunk kernel's launches on the
restored hit (one per layer, no flash), the peak device memory and
``tier_stats()``. ``engine_llama3_8b_int8_kv_tiers``: the same on an int8
pool (15 pages), whose bytes and scales round-trip bit for bit and whose
restored hit (row 2b) gives the resident hit's stream.
``engine_llama3_tiny_f32_tiers``: llama3-tiny in f32, the lossless spill:
the restored hit's stream equals ``engine_llama3_tiny_f32``'s.

The replica pool (two phases, ``pool_phase``): an ``EnginePool`` of two
replicas on the one card, each with its own weights (seed 0), 256-page
pool and decode graphs, one shared host store (1 GiB, the lossless spill),
the health monitor at 0.1 s with a 3 s heartbeat bar. In order: parity
(``engine``'s six requests through ``TorchLocalProvider.chat`` over the
pool, then ``EnginePool.generate``: streams equal the engine phase's
wherever a request hit as many cached tokens, in bf16 only where its
prefill call also had the same bucket and rows, both replicas routed, the
system-prompt repeat an affinity hit of 384 tokens); failover
(``fail_replica`` after four tokens of a 32-token request: 32 tokens, the
delivered prefix the engine phase's, one requeue, a ``pool.requeue``
span; the gap printed); the dead replica reloaded while the survivor
serves six 160-token requests (the survivor retires decode steps during
the capture, every stream whole), then its decode dispatch blocked
host-side until the health monitor fails it over (detection seconds);
spill on drain (the survivor's reload spills >= 3 pages; rebuilt, it
serves the system-prompt repeat from ``host``, 384 tokens, with the
resident hit's stream); aggregate decode tokens/s (eight 128-token
requests on one replica, sixteen on both); disaggregation (replica 0
``prefill``, 1 ``decode``: a 454-token request whose system prompt no
cache holds migrates 3 lossless pages, its first token the cold run's and
the rest the resident hit's of its continuation on one engine
(``standalone_reference``), the chunk kernel once per layer and no flash
on the decode leg; then ``pool.migrate`` armed ``corrupt`` degrades in
place); capacity loss (``requeue_max`` 0: the provider raises
``LLMUnavailable``). Every engine the pool built shows no serving-stage
build or capture. ``engine_llama3_tiny_f32_pool`` (f32: the failover
stream equal in full) adds one migration on int8 pages whose restored
chain pages equal the exported ones bit for bit (rows 2b, 3b, w, ws);
``engine_llama3_8b_pool`` (llama3-8b, bf16) also holds one fed decode
dispatch of each replica to ``DECODE_REPLAY_EVENTS``.

The shared engine plane and the object tier (four phases on one
``CoordinationHub`` on 127.0.0.1, with a secret, on an event loop of its
own, which outlives every worker): ``engine_llama3_8b_shared_plane``
(``plane_phase``): three workers of ``SharedEnginePlane``, each a process
of this script (``--plane-worker``: a ``TcpEventBus``, ``TcpLeaseManager``
and ``BusRpc`` on the hub, the worker heartbeat, a 3 s owner lease and
heartbeat TTL, a 2 s stream idle bar; it loads the kernel libraries this
script built and raises if one is missing). W0 owns the lease and builds
llama3-8b at full width and depth (``engine``'s configuration) before W1
and W2 start. ``engine``'s six chats through W1 (as ``team:alpha``) and W2
give the owner's streams, held to ``engine``'s by the pool phase's rule,
and the tenant's bill; the hop's TTFT cost and the ms of each forwarded
chunk; the owner's queue depth read by W2 under sixteen chats; a
``coordination.hub.rpc`` partition that ends in ``LLMUnavailable``; then
W0 is SIGKILLed four tokens into a 64-token chat through W1: that stream
ends with ``LLMUnavailable`` within the idle bar and one lease TTL, a
survivor wins the lease and builds on the card once W0's memory is back,
and the chat sent again equals the direct run's stream. The failover gap is
split into the lease's lapse, the election, the build and the first token.
No owner builds or captures while serving; each owner's kernel launches
count in the table. ``engine_llama3_8b_fabric`` (``fabric_phase``): host A's
chain reaches a ``file://`` object tier through the spill and write-behind
path, A's publisher advertises it over ``BusRpc`` to host B's
``fabric.advert``, and B serves the request from the object tier (384
tokens, A's resident-hit stream; restore ms per page and GB/s). Planted
faults: a forwarded stream with one token changed, an advert merged under
another tenant (B misses), the partition. The llama3-tiny f32 arms run
the plane's three workers as tasks of this process (failover: the owner's
RPC, heartbeat and plane stopped) and add an engine that knew the chain
only under another tenant and serves it cold.

Training and the parallel layer (last, on a card the earlier phases have
freed; no kernel of their own: the kernels have no backward, and training
runs the plain attention and expert scan). ``train_llama3_test_tiny_ckpt``
trains the tiny checkpoint (llama3-test, f32, the corpus as bytes) for 400
steps, saves it with ``save_params`` and serves it on the card: the four
memorized answers, every stream equal to the CPU port engine's on the same
directory, a prefix hit through the mma.sync chunk kernel; the step-0
checkpoint must fail the answer check. ``train_llama3_1b`` trains the
whole llama3-1b for 5 steps on one 2 x 1024 batch (the loss falls; step ms,
tokens/s, peak memory), holds the first AdamW step to its rule (a planted
optimizer that decays twice must fail) and replays one step on the CPU at
2 layers. ``parallel_nccl_world1`` runs every sharded entry point on a
one-rank NCCL group against its single-device function; a ring without the
causal mask must fail its check.

Multi-rank serving (``mesh_shape``; ``ranks.py``). After the ``engine``
phase's operability run, ``engine_llama3_8b_rank1`` serves its requests at
``mesh_shape="1x1"``: the rank path on a one-rank NCCL group, the
forward's collectives and the sampled tokens' broadcast inside the decode
graphs; its greedy streams must equal the ``engine`` phase's token for
token, and it reports each graph's launches and collectives and one fed
decode dispatch's device events. ``engine_llama3_tiny_sp1`` serves the
llama3-tiny requests at "1x1" with ``sp_impl`` ring, then Ulysses, and
``sp_threshold`` 128: the 512 and 2048 buckets prefill sequence-parallel,
and every stream must equal the f32 engine phase's. After the MoE
kernels, ``tp_rank_geometries`` holds rows 1, 2, 2b, 3 and 3b at the
per-rank head counts of llama3-8b at TP 2, 4, 8 and 16 (a replicated pool
read at a KV-head offset) and gemma-2b at TP 2, and rows 4 and 5 at
Mixtral's per-rank F at TP 2; a rank reading the wrong KV head of a
replicated pool must fail its check. Each engine's groups are its own
(``parallel/mesh.py`` ``ServingMesh``, no default group) and end with it.
After the tier phases, ``engine_llama3_8b_rank1_tiers`` runs their 16-page
eviction scenario (lossless and the int8 spill) at "1x1": spills gather
the page's KV-head shards on the data plane, restores broadcast it and
each rank keeps its heads; the restored hits' streams must equal
``engine_llama3_8b_tiers``'s and each lossless chain payload the rank-less
engine's, byte for byte; planted faults: a payload gathered in reversed
head order, and, over the real page at a model axis of 2, 4 and 8, every
rank given rank 0's heads. After the llama3-8b pool phase,
``engine_llama3_8b_rank1_pool`` builds two replicas at "1x1", each on its
own one-rank NCCL group in this process, roles ``prefill,decode``: a
three-page prompt migrates from one to the other with the standalone
engine's stream, 3 pages spilled and 3 restored; every graph of each holds
collectives, and a fed dispatch of each runs the device events the 1x1
rank path ran in ``engine_llama3_8b_rank1``.

Then the card line, the kernel table (JSON), and last the contract line.
Any failure raises: the exit code is non-zero and the last line is absent.
Exits 1 at once when CUDA is not available.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import weakref
from pathlib import Path

TOL = 2e-2
ROW_REL = 1e-2   # attention kernels: max|out - ref| within a row over max|ref| of that row
F32_ROW_REL = 1e-4   # the f32 mma.sync route (3xTF32): one TF32 product alone reads ~1e-3
# grouped experts, each row's ||out - ref||_2 over ||ref||_2: a right row
# differs from the plain version where the tensor cores' f32 accumulation and
# the plain f32 sums round to another bf16 value (up to 8.0e-4 on an H100 at
# Mixtral widths, K = 14336); an h rounded once to bf16 (its lo half dropped)
# reads 2.8e-3 there, which the max-based ROW_REL cannot see (0.0078 against
# 0.0078 for a right row)
MOE_ROW_RMS = 1.5e-3
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet, dense peak
BF16_FLOPS_PER_S = 989e12     # H100 SXM data sheet, dense bf16 tensor cores
F32_FLOPS_PER_S = 67e12       # H100 SXM data sheet, f32 outside the tensor cores
RUNS = 25
SPIN_CYCLES = 5_000_000       # ~2.5 ms of a spinning kernel ahead of a timed call


class SmokeFailure(RuntimeError):
    pass


def check(condition, message: str) -> None:
    """A failed check ends the run (unlike ``assert``, also under -O)."""
    if not condition:
        raise SmokeFailure(message)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float,
          flops_per_s: float = BF16_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


REPLACES = {
    "flash_attention_tc": "mcp_context_forge_tpu/tpu_local/ops/attention.py:88",
    "flash_attention_mma": "mcp_context_forge_tpu/tpu_local/ops/attention.py:88",
    "paged_chunk_attention_tc": "mcp_context_forge_tpu/tpu_local/ops/paged_attention.py:148",
    "paged_chunk_attention_tc_q8": "mcp_context_forge_tpu/tpu_local/ops/paged_attention.py:111",
    "paged_chunk_attention_mma": "mcp_context_forge_tpu/tpu_local/ops/paged_attention.py:148",
    "paged_chunk_attention_mma_q8": "mcp_context_forge_tpu/tpu_local/ops/paged_attention.py:111",
    "paged_decode_attention": "mcp_context_forge_tpu/tpu_local/ops/paged_attention.py:199",
    "paged_decode_attention_q8": "mcp_context_forge_tpu/tpu_local/ops/paged_attention.py:59",
    "expert_blocks_tc": "mcp_context_forge_tpu/tpu_local/ops/grouped_moe.py:164",
    "expert_blocks_tc_q8": "mcp_context_forge_tpu/tpu_local/ops/grouped_moe.py:225",
    "expert_blocks_wmma": "mcp_context_forge_tpu/tpu_local/ops/grouped_moe.py:164",
    "expert_blocks_wmma_q8": "mcp_context_forge_tpu/tpu_local/ops/grouped_moe.py:225",
    # not a pallas_call: the XLA-fused int8 decode write (_quant_store)
    "kv_quant_store_decode": "mcp_context_forge_tpu/tpu_local/kv/paged_cache.py:121",
    # not a pallas_call: the XLA-fused int8 prefill write (_quant_store as
    # write_prefill_kv calls it)
    "kv_quant_store_span": "mcp_context_forge_tpu/tpu_local/kv/paged_cache.py:165",
}
SOURCES = {
    "flash_attention_tc": "flash_attention_tc.cu",
    "flash_attention_mma": "flash_attention_mma.cu",
    "paged_chunk_attention_tc": "paged_chunk_attention_tc.cu",
    "paged_chunk_attention_tc_q8": "paged_chunk_attention_tc.cu",
    "paged_chunk_attention_mma": "paged_chunk_attention_mma.cu",
    "paged_chunk_attention_mma_q8": "paged_chunk_attention_mma.cu",
    "paged_decode_attention": "paged_decode_attention.cu",
    "paged_decode_attention_q8": "paged_decode_attention.cu",
    "expert_blocks_tc": "grouped_moe_tc.cu",
    "expert_blocks_tc_q8": "grouped_moe_tc.cu",
    "expert_blocks_wmma": "grouped_moe.cu",
    "expert_blocks_wmma_q8": "grouped_moe.cu",
    "kv_quant_store_decode": "kv_quant_store.cu",
    "kv_quant_store_span": "kv_quant_store.cu",
}
ATTENTION = ("flash_attention_tc", "paged_chunk_attention_tc", "paged_decode_attention")
ATTENTION_Q8 = ("flash_attention_tc", "paged_chunk_attention_tc_q8",
                "paged_decode_attention_q8")
ATTENTION_MMA = ("flash_attention_mma", "paged_chunk_attention_mma", "paged_decode_attention")
CHUNK = ("paged_chunk_attention_tc", "paged_chunk_attention_tc_q8",
         "paged_chunk_attention_mma", "paged_chunk_attention_mma_q8")
TC_ATTENTION = ("flash_attention_tc", "paged_chunk_attention_tc", "paged_chunk_attention_tc_q8")
MOE_WMMA = ("expert_blocks_wmma", "expert_blocks_wmma_q8")
FLASH = ("flash_attention_tc", "flash_attention_mma")
# kernels that run only inside the decode graphs
DECODE_ONLY = ("paged_decode_attention", "paged_decode_attention_q8", "kv_quant_store_decode")
INT8_WRITERS = ("kv_quant_store_decode", "kv_quant_store_span")
# kernels the bf16 llama3-8b and Mixtral paths must not launch
NOT_BF16 = ("flash_attention_mma", "paged_chunk_attention_mma",
            "paged_chunk_attention_mma_q8")


def kernel_wrappers() -> dict:
    """Each kernel's wrapper, which carries its ``launches`` count."""
    from mcp_context_forge_tpu_torch.tpu_local.ops import kernel_wrappers as wrappers
    return wrappers()


def free_device(torch) -> None:
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# ------------------------------------------------------------- telemetry

# what one served run reports through the telemetry handles (pinned on the
# CPU by tests/test_torch_telemetry.py with these same handles): span
# names, and each metric family with the label names it is given
SERVED_SPANS = {"llm.request", "llm.queue", "llm.prefill", "llm.decode"}
SERVED_FAMILIES = {
    "llm_queue_depth": {("replica",)}, "llm_dispatch_gap": {("replica",)},
    "llm_step_phase": {("phase", "replica")}, "llm_mfu": {("replica",)},
    "llm_hbm_roofline": {("replica",)}, "llm_device_idle_frac": {("replica",)},
    "llm_batch_occupancy": {("replica",)}, "llm_kv_pages_in_use": {("replica",)},
    "llm_kv_page_utilization": {("replica",)}, "llm_kv_bytes_in_use": {("replica",)},
    "llm_step_tokens_per_sec": {("replica",)}, "llm_tokens_per_dispatch": {("replica",)},
    "llm_tokens_per_dispatch_ewma": {("replica",)},
    "llm_ttft": {("model", "replica", "tenant")}, "llm_tpot": {("model", "replica", "tenant")},
    "llm_queue_wait": {("tenant",)}, "llm_tokens": {("kind", "model")},
    "llm_requests": {("model", "status")}}
# the construction's graph captures, on the card only (warmup-stage events)
CAPTURE_FAMILIES = {"llm_xla_compiles": {("replica", "stage")},
                    "llm_xla_compile_time": {("replica",)}}
PHASE_KEYS = {"host_dispatch_ms", "table_sync_ms", "device_compute_ms", "readback_ms",
              "emit_ms", "total_ms"}


class RecordingMetrics:
    """Stands in for the metrics registry: each ``llm_*`` family records the
    label names it is given and its values; tenants are not clamped."""

    class Family:
        def __init__(self):
            self.label_names: set[tuple] = set()
            self.values: list[float] = []

        def labels(self, **labels):
            self.label_names.add(tuple(sorted(labels)))
            return self

        def inc(self, value=1.0):
            self.values.append(value)

        def set(self, value):
            self.values.append(value)

        def observe(self, value, exemplar=None):
            self.values.append(value)

    class Clamp:
        @staticmethod
        def label(tenant):
            return tenant or "unattributed"

    def __init__(self):
        self.families: dict[str, RecordingMetrics.Family] = {}
        self.tenant_clamp = self.Clamp()

    def __getattr__(self, name):
        if not name.startswith("llm_"):
            raise AttributeError(name)
        return self.families.setdefault(name, self.Family())

    def exemplar(self, metric, value, trace_id, labels=()):
        return None

    def label_names(self) -> dict:
        return {name: family.label_names for name, family in self.families.items()}


class RecordingLedger:
    def __init__(self):
        self.totals: dict[str, dict[str, float]] = {}

    def add(self, tenant, **counts):
        row = self.totals.setdefault(tenant, {})
        for key, value in counts.items():
            row[key] = row.get(key, 0) + value


def telemetry_handles() -> dict:
    """The port's own tracer (memory exporter) and signal bus, with the
    recording stand-ins of the metrics registry and the tenant ledger
    (whose modules the port has not taken over yet)."""
    from mcp_context_forge_tpu_torch.observability.signals import SignalBus
    from mcp_context_forge_tpu_torch.observability.tracing import Tracer

    return dict(tracer=Tracer(exporter="memory"), metrics=RecordingMetrics(),
                signals=SignalBus(), ledger=RecordingLedger())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from mcp_context_forge_tpu_torch.tpu_local.ops import _build

    # ---------------------------------------------------------------- device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    emit({"phase": "device", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # ----------------------------------------------------------------- build
    t0 = time.monotonic()
    logs = _build.build()
    usage = {name: [line.strip() for line in log.splitlines()
                    if "registers" in line or "spill" in line]
             for name, log in logs.items()}
    emit({"phase": "build", "seconds": round(time.monotonic() - t0, 3),
          "ptxas": usage})

    # ------------------------------------------- attention: kernels, model, engine
    launches = dict.fromkeys(REPLACES, 0)   # summed over the engine phases and model checks

    def count(counts: dict) -> None:
        for name in launches:
            launches[name] += counts[name]

    timer = Timer(torch, dev)
    results = kernel_phase(torch, dev, timer)
    free_device(torch)
    count(model_check(torch, dev, "llama3-tiny"))
    counts, stats = engine_phase(torch, dev, "llama3-tiny", ATTENTION_MMA,
                                 chat_requests("llama3-tiny"), hit=1,
                                 absent=TC_ATTENTION, dtype="float32")
    emit({"phase": "engine_llama3_tiny_f32", **stats})
    count(counts)
    free_device(torch)
    k1_tokens = stats["generated"]
    tiny_reference = stats
    counts, stats = engine_phase(torch, dev, "llama3-tiny", ATTENTION_MMA,
                                 chat_requests("llama3-tiny"), hit=1,
                                 absent=TC_ATTENTION, dtype="float32", superstep=8)
    check(stats["generated"] == k1_tokens,
          "K = 8 super-steps changed a greedy stream of the K = 1 phase")
    emit({"phase": "engine_llama3_tiny_f32_k8", "tokens_equal_k1": True, **stats})
    count(counts)
    free_device(torch)
    # speculative decoding is lossless: greedy streams equal the plain phases'
    counts, stats = engine_phase(torch, dev, "llama3-tiny", ATTENTION_MMA[:2],
                                 chat_requests("llama3-tiny"), hit=1,
                                 absent=TC_ATTENTION, dtype="float32", spec_decode=True)
    check(stats["generated"] == k1_tokens,
          "speculative decoding changed a greedy stream of the plain phase")
    emit({"phase": "engine_llama3_tiny_f32_spec", "tokens_equal_plain": True, **stats})
    count(counts)
    free_device(torch)
    tiny_q8 = ("flash_attention_mma", "paged_chunk_attention_mma_q8")
    tiny_q8_absent = TC_ATTENTION + ("paged_chunk_attention_mma", "paged_decode_attention")
    counts, stats = engine_phase(torch, dev, "llama3-tiny",
                                 tiny_q8 + ("paged_decode_attention_q8",) + INT8_WRITERS,
                                 chat_requests("llama3-tiny"), hit=1, absent=tiny_q8_absent,
                                 dtype="float32", kv_quant="int8")
    emit({"phase": "engine_llama3_tiny_f32_int8_kv", **stats})
    count(counts)
    free_device(torch)
    q8_tokens = stats["generated"]
    counts, stats = engine_phase(torch, dev, "llama3-tiny", tiny_q8 + ("kv_quant_store_span",),
                                 chat_requests("llama3-tiny"), hit=1, absent=tiny_q8_absent,
                                 dtype="float32", kv_quant="int8", spec_decode=True)
    check(stats["generated"] == q8_tokens,
          "speculative decoding changed a greedy stream of the plain int8-page phase")
    emit({"phase": "engine_llama3_tiny_f32_int8_kv_spec", "tokens_equal_plain": True, **stats})
    count(counts)
    free_device(torch)
    counts, stats = tiny_tiers_phase(torch, dev, k1_tokens)
    emit({"phase": "engine_llama3_tiny_f32_tiers", **stats})
    count(counts)
    free_device(torch)
    counts, stats = pool_phase(torch, dev, "llama3-tiny", "float32", tiny_reference,
                               ATTENTION_MMA, TC_ATTENTION + INT8_WRITERS)
    count(counts)
    stats.pop("migrate_reference")
    counts, stats["int8_migration"] = int8_pool_migration(torch, dev)
    emit({"phase": "engine_llama3_tiny_f32_pool", **stats})
    count(counts)
    free_device(torch)
    counts, stats = restart_phase(torch, dev)
    emit({"phase": "engine_restart", **stats})
    count(counts)
    free_device(torch)
    emit({"phase": "encoder_mini", **encoder_phase(torch, dev)})
    free_device(torch)
    counts, stats = engine_phase(torch, dev, "llama3-8b", ATTENTION,
                                 chat_requests("llama3-8b"), hit=1, absent=NOT_BF16,
                                 graph_check=True)
    check(stats["buckets"][2] == 2048,
          f"the ~1450-token prompt took bucket {stats['buckets'][2]}")
    emit({"phase": "engine", **stats})
    count(counts)
    free_device(torch)
    engine_reference = stats
    engine_tokens = stats["generated"]
    counts, stats = ops_phase(torch, dev, engine_tokens, stats["prompt_tokens"])
    emit({"phase": "engine_llama3_8b_ops", **stats})
    count(counts)
    free_device(torch)
    counts, stats = rank1_phase(torch, dev, engine_reference)
    emit({"phase": "engine_llama3_8b_rank1", **stats})
    count(counts)
    free_device(torch)
    rank1_events = stats["replay_device_events"]["device_events"]
    counts, stats = sp1_phase(torch, dev, k1_tokens)
    emit({"phase": "engine_llama3_tiny_sp1", **stats})
    count(counts)
    free_device(torch)
    counts, admission, controller = serving_plane_phase(torch, dev, engine_tokens, k1_tokens)
    emit({"phase": "engine_llama3_8b_admission", **admission})
    emit({"phase": "engine_llama3_8b_controller", **controller})
    count(counts)
    free_device(torch)
    counts, stats = engine_phase(torch, dev, "llama3-8b", ATTENTION[:2],
                                 chat_requests("llama3-8b") + [extraction_request("llama3-8b")],
                                 hit=1, absent=NOT_BF16, spec_decode=True)
    # reported, not required: in bf16 a near-tie may flip between the
    # verify's and the decode step's sums
    stats["streams_equal_engine"] = [a == b for a, b in zip(stats["generated"], engine_tokens)]
    free_device(torch)
    stats["verify_against_decode_f32"] = verify_against_decode_f32(torch, dev)
    emit({"phase": "engine_llama3_8b_spec", **stats})
    count(counts)
    free_device(torch)
    counts, bf16_tiers, int8_tiers, tier_reference = tiers_phase(torch, dev)
    emit({"phase": "engine_llama3_8b_tiers", **bf16_tiers})
    emit({"phase": "engine_llama3_8b_int8_kv_tiers", **int8_tiers})
    count(counts)
    free_device(torch)
    counts, stats = rank1_tiers_phase(torch, dev, tier_reference)
    emit({"phase": "engine_llama3_8b_rank1_tiers", **stats})
    count(counts)
    del tier_reference
    free_device(torch)
    counts, stats = pool_phase(torch, dev, "llama3-8b", "bfloat16", engine_reference, ATTENTION,
                               NOT_BF16 + INT8_WRITERS + ("paged_chunk_attention_tc_q8",
                                                          "paged_decode_attention_q8"))
    for events in stats["replay_device_events"]:
        check(events["device_events"] == DECODE_REPLAY_EVENTS,
              f"one fed decode dispatch of a replica ran {events['device_events']} device "
              f"events, not {DECODE_REPLAY_EVENTS}")
    migrate_reference = stats.pop("migrate_reference")
    emit({"phase": "engine_llama3_8b_pool", **stats})
    count(counts)
    free_device(torch)
    counts, stats = rank1_pool_phase(torch, dev, migrate_reference, rank1_events)
    emit({"phase": "engine_llama3_8b_rank1_pool", **stats})
    count(counts)
    free_device(torch)
    # the shared engine plane and the object tier, on one coordination hub
    hub = HubThread(secret=f"chip-smoke-{os.getpid()}-{time.time_ns()}")
    try:
        counts, stats = plane_phase(torch, dev, "llama3-tiny", "float32", tiny_reference, hub,
                                    ATTENTION_MMA, processes=False)
        emit({"phase": "engine_llama3_tiny_f32_shared_plane", **stats})
        count(counts)
        free_device(torch)
        counts, stats = fabric_phase(torch, dev, "llama3-tiny", "float32", hub,
                                     ATTENTION_MMA[1:])
        emit({"phase": "engine_llama3_tiny_f32_fabric", **stats})
        count(counts)
        free_device(torch)
        counts, stats = plane_phase(torch, dev, "llama3-8b", "bfloat16", engine_reference, hub,
                                    ATTENTION, processes=True)
        emit({"phase": "engine_llama3_8b_shared_plane", **stats})
        count(counts)
        free_device(torch)
        counts, stats = fabric_phase(torch, dev, "llama3-8b", "bfloat16", hub, ATTENTION[1:])
        emit({"phase": "engine_llama3_8b_fabric", **stats})
        count(counts)
        free_device(torch)
    finally:
        hub.close()
    # checkpoints written here in HF layout, served from disk
    ckpt_root = Path(__file__).resolve().parent / "build" / "checkpoints"
    counts, stats = checkpoint_llama3_phase(torch, dev, ckpt_root)
    emit({"phase": "checkpoint_llama3_8b", **stats})
    count(counts)
    free_device(torch)

    # ------------------------- long context on int8 KV: kernels, model, engine
    results.update(q8_kernel_phase(torch, dev, timer))
    free_device(torch)
    results.update(kv_write_phase(torch, dev, timer))
    free_device(torch)
    results.update(span_write_phase(torch, dev, timer))
    free_device(torch)
    verify_shape_phase(torch, dev, timer)
    free_device(torch)
    count(model_check(torch, dev, "llama3-tiny", kv_quant="int8"))
    counts, stats = engine_phase(torch, dev, "llama3-8b", ATTENTION_Q8 + INT8_WRITERS,
                                 long_context_requests("llama3-8b"), hit=3,
                                 absent=ATTENTION[1:] + NOT_BF16,
                                 kv_quant="int8", max_seq_len=8192)
    check_long_context(stats, pool_pages=1023, page_dtype="torch.int8")
    emit({"phase": "engine_llama3_8b_int8_kv_long", **stats})
    count(counts)
    free_device(torch)

    # --------------------- gemma-2b: hd 256 on the mma.sync kernels, engine
    gemma_kernel_phase(torch, dev, timer)
    free_device(torch)
    counts, stats = engine_phase(torch, dev, "gemma-2b", ATTENTION_MMA,
                                 long_context_requests("gemma-2b"), hit=3,
                                 absent=TC_ATTENTION + ("paged_chunk_attention_mma_q8",
                                                        "paged_decode_attention_q8"),
                                 max_seq_len=8192)
    check_long_context(stats, pool_pages=512, page_dtype="torch.bfloat16")
    emit({"phase": "engine_gemma_2b", **stats})
    count(counts)
    free_device(torch)

    # ------------------------------------------------- MoE: kernels, model, engine
    results.update(moe_kernel_phase(torch, dev, timer))
    del timer
    free_device(torch)
    emit({"phase": "tp_rank_geometries", **tp_rank_geometries(torch, dev)})
    free_device(torch)
    for quant in ("", "int8"):
        count(model_check(torch, dev, "mixtral-test", quant=quant,
                          moe=dict(moe_impl="grouped_pallas", moe_block=8)))
    counts, stats = engine_phase(
        torch, dev, "mixtral-8x7b", ATTENTION + ("expert_blocks_tc_q8",),
        chat_requests("mixtral-8x7b"), hit=1, absent=NOT_BF16 + MOE_WMMA,
        quant="int8", moe_impl="grouped_pallas")
    emit({"phase": "engine_mixtral_int8", **stats})
    count(counts)
    free_device(torch)
    counts, stats = engine_phase(
        torch, dev, "mixtral-8x7b", ATTENTION + ("expert_blocks_tc",),
        chat_requests("mixtral-8x7b"), hit=1, absent=NOT_BF16 + MOE_WMMA,
        moe_impl="grouped_pallas", n_layers=8)
    emit({"phase": "engine_mixtral_bf16_8_layers", **stats})
    count(counts)
    free_device(torch)
    counts, stats = checkpoint_mixtral_phase(torch, dev, ckpt_root)
    emit({"phase": "checkpoint_mixtral_int8", **stats})
    count(counts)
    free_device(torch)

    # ------------------------------------- training and the parallel layer
    counts, stats = train_tiny_ckpt_phase(torch, dev, ckpt_root / "tiny")
    emit({"phase": "train_llama3_test_tiny_ckpt", **stats})
    count(counts)
    free_device(torch)
    emit({"phase": "train_llama3_1b", **train_1b_phase(torch, dev)})
    free_device(torch)
    emit({"phase": "parallel_nccl_world1", **parallel_world1_phase(torch, dev)})
    free_device(torch)

    table = []
    for name, tpu_kernel in REPLACES.items():
        r = results[name]
        table.append({
            "name": name, "route": "cuda",
            "source": f"mcp_context_forge_tpu_torch/tpu_local/csrc/{SOURCES[name]}",
            "replaces": tpu_kernel, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(card_line(), flush=True)
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


class Timer:
    """CUDA-event times of a call: medians of RUNS runs after 3 warm-ups,
    with a 64 MB buffer written before each run so the inputs are cold in
    L2, as the real caller finds them. Two times per call:

    - the card's (``ms``): a kernel that spins ~2.5 ms is queued ahead of
      the start event, so the host has enqueued the whole call before the
      card reaches it and the events bracket the call's kernels back to
      back, without the host's launch overhead;
    - the call's (``call_ms``): no spin, so a call shorter than its host
      overhead reads that overhead too (how kernel times were taken
      before ``ms`` existed).
    """

    def __init__(self, torch, dev):
        self.torch = torch
        self.flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)

    def _median(self, fn, spin: bool) -> float:
        times = []
        for _ in range(RUNS):
            self.flush.zero_()
            if spin:
                self.torch.cuda._sleep(SPIN_CYCLES)
            start = self.torch.cuda.Event(enable_timing=True)
            end = self.torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def __call__(self, fn) -> float:
        """The card's time of ``fn``."""
        for _ in range(3):
            fn()
        return self._median(fn, spin=True)

    def both(self, prefix: str, fn) -> dict:
        """``{prefix}_ms`` (the card's time) and ``{prefix}_call_ms``."""
        for _ in range(3):
            fn()
        return {f"{prefix}_ms": self._median(fn, spin=True),
                f"{prefix}_call_ms": self._median(fn, spin=False)}


def compare(torch, out, ref, rows) -> float:
    out, ref = out[rows].float(), ref[rows].float()
    check(torch.isfinite(out).all(), "non-finite kernel output")
    torch.testing.assert_close(out, ref, atol=TOL, rtol=TOL)
    return float((out - ref).abs().max())


def row_error(torch, out, ref, rows) -> float:
    """The largest over ``rows`` of max|out - ref| / max|ref| within the
    row. An attention output over n keys is ~1/sqrt(n) in size, below the
    absolute tolerance at thousands of keys, so each row of a paged kernel
    is held to its own size as well. Both sides round one f32 result to
    bf16, so a right row reads at most one bf16 step: 2**-7 of its largest
    value."""
    out, ref = out[rows].float().flatten(1), ref[rows].float().flatten(1)
    err = (out - ref).abs().amax(1) / ref.abs().amax(1).clamp_min(1e-30)
    return float(err.max())


def compare_paged(torch, name: str, out, ref, rows,
                  limit: float = ROW_REL) -> tuple[float, float]:
    """``compare`` plus each row within ``limit`` of its own size."""
    err = compare(torch, out, ref, rows)
    rel = row_error(torch, out, ref, rows)
    check(rel <= limit, f"{name}: a row is off by {rel:.3g} of its largest value")
    return err, rel


def planted_faults(torch, name: str, faults: dict, ref, rows,
                   limit: float = ROW_REL) -> dict:
    """Each fault's output (the kernel on corrupted inputs) against the
    right plain output: the row check (each row within ``limit``) must
    reject every one. Returns each fault's row error and whether
    atol = rtol = TOL alone would pass it."""
    readings = {}
    for fault, out in faults.items():
        rel = row_error(torch, out, ref, rows)
        check(rel > limit, f"{name}: the row check passes the planted fault {fault}")
        readings[fault] = {"row_error": rel, "passes_atol_rtol": bool(torch.allclose(
            out[rows].float(), ref[rows].float(), atol=TOL, rtol=TOL))}
    return readings


def split_grid(torch, dev, name: str, ws, B: int, KV: int) -> dict:
    """The decode kernel's grid from its workspace; it must hold at least
    two CTAs per SM (the plan asks for DECODE_CTAS_PER_SM where the table
    has the slots)."""
    splits = ws.ml.shape[2]
    ctas = splits * KV * B
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    check(ctas >= 2 * sms, f"{name}: {ctas} CTAs for {sms} SMs")
    return {"pages_per_split": ws.pps, "splits": splits, "ctas": ctas, "sms": sms}


def drop_split(torch, paged, ws, seq_lens, q, row: int, split: int) -> dict:
    """The combine over the kernel's own partials with one split of ``row``
    dropped (m = -1e30, l = 0, o = 0): a planted fault, by its name."""
    pages = -(-int(seq_lens[row]) // ws.page_size)
    check(split * ws.pps < pages, f"split {split} of row {row} holds no key")
    name = (f"row {row}: split {split} of {ws.ml.shape[2]} (pages {split * ws.pps}-"
            f"{min(pages, (split + 1) * ws.pps) - 1} of {pages}) dropped")
    ws.ml[row, :, split, :, 0] = paged.NEG_INF
    ws.ml[row, :, split, :, 1] = 0.0
    ws.o[row, :, split] = 0.0
    return {name: paged.paged_decode_combine(ws, seq_lens, torch.empty_like(q))}


def flash_faults(torch, kernel, q, k, v, valid, out) -> dict:
    """A flash kernel on inputs that plant two faults: row 0's last 64-key
    tile dropped (its keys marked invalid), and a causal off-by-one (each
    query moved one position later, so query s sees key s + 1; the last
    position keeps its right output)."""
    S = q.shape[1]
    short = valid.clone()
    short[0, (S - 1) // 64 * 64:] = False
    later = torch.zeros_like(q)
    later[:, 1:] = q[:, :-1]
    shifted = kernel(later, k, v, valid).roll(-1, dims=1)
    shifted[:, -1] = out[:, -1]
    return {f"row 0: last 64-key tile of {S} dropped": kernel(q, k, v, short),
            "causal off by one: query s sees key s + 1": shifted}


def tf32(torch, x):
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero),
    as cvt.rna.tf32.f32 rounds: what a kernel that drops the lo terms of
    3xTF32 multiplies."""
    bits = x.view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, ~0x1FFF).view(torch.float32)


def chunk_faults(torch, kernel, args, spare: int, row: int, slot: int,
                 n_slots: int) -> dict:
    """A chunk kernel on inputs that plant two faults: one history page of
    ``row`` (table slot ``slot`` of ``n_slots``) read from the ``spare``
    page, and a causal off-by-one (every real query one position later, so
    a query at position p also sees key p + 1)."""
    q, k_pages, v_pages, tables, pos, *scales = args
    wrong = tables.clone()
    wrong[row, slot] = spare
    later = torch.where(pos >= 0, pos + 1, pos)
    return {f"row {row}: history page {slot} of {n_slots} read from a wrong page":
            kernel(q, k_pages, v_pages, wrong, pos, *scales),
            "causal off by one: a query at position p sees key p + 1":
            kernel(q, k_pages, v_pages, tables, later, *scales)}


def sdpa_paged(torch, paged, q, k_pages, v_pages, tables, keep, scales=()):
    """``library_ms``'s inputs for a paged kernel: K/V gathered from the
    row's pages into contiguous [B, H, C, hd] in the query's dtype
    (dequantized for int8 pages, expanded to the H query heads), q as
    [B, H, S, hd] and the
    boolean mask [B, 1, S, C] from ``keep(c)`` (key c of row b for query s);
    C is the longest walk, rounded up to whole pages. Built outside the
    timed call."""
    B, KV, G, hd = q.shape[0], q.shape[-3], q.shape[-2], q.shape[-1]
    page = k_pages.shape[1]
    mask = keep(torch.arange(tables.shape[1] * page, device=q.device))
    C = -(-(int(mask.any(1).any(0).nonzero().max()) + 1) // page) * page
    used = tables[:, :C // page]
    ks, vs = scales if scales else (None, None)
    kg = paged._gather_pages(k_pages, used, ks).to(q.dtype)
    vg = paged._gather_pages(v_pages, used, vs).to(q.dtype)
    kt = kg.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    vt = vg.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    qt = q.reshape(B, -1, KV * G, hd).transpose(1, 2).contiguous()
    return qt, kt, vt, mask[..., :C][:, None].contiguous()


def chunk_geometries(torch, dev, gen, paged, cases) -> list:
    """Each (kernel, dtype, hd, page, int8 pages, KV, G) of ``cases`` at a
    small shape against the plain version: three rows at different offsets
    (one starting past a page boundary, one half padding) in a pool of
    their own; f32 held per row to F32_ROW_REL, bf16 to ROW_REL."""
    out_rows = []
    for name, dtype, hd, page, q8, KV, G in cases:
        starts, n_real, S = (3 * page + 5, 0, 2 * page - 9), (200, 200, 90), 200
        P = -(-(max(st + n for st, n in zip(starts, n_real))) // page)
        n_pages = 3 * P + 2   # distinct pages for every row, page 0 unused
        tables = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(page))[
            :3 * P].add(1).reshape(3, P).to(torch.int32).to(dev)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)

        if q8:
            kp, vp = (torch.randint(-127, 128, (n_pages, page, KV, hd), generator=gen,
                                    device=dev, dtype=torch.int8) for _ in range(2))
            scales = tuple((torch.rand((n_pages, KV), generator=gen, device=dev) + 0.5)
                           .div(127).to(dtype) for _ in range(2))
        else:
            kp, vp, scales = randn(n_pages, page, KV, hd), randn(n_pages, page, KV, hd), ()
        pos = torch.full((3, S), -1, dtype=torch.int32)
        for b, (st, n) in enumerate(zip(starts, n_real)):
            pos[b, :n] = torch.arange(st, st + n)
        pos = pos.to(dev)
        args = (randn(3, S, KV, G, hd), kp, vp, tables, pos, *scales)
        out = getattr(paged, name)(*args)
        ref = paged.paged_chunk_attention_ref(*args)
        torch.cuda.synchronize()
        check(torch.isfinite(out).all(), f"{name}: a padding row is not finite")
        limit = F32_ROW_REL if dtype == torch.float32 else ROW_REL
        err, rel = compare_paged(torch, f"{name} {dtype} hd {hd} page {page} KV {KV} G {G}",
                                 out, ref, pos >= 0, limit)
        out_rows.append({"kernel": name, "dtype": str(dtype), "hd": hd, "page": page,
                         "KV": KV, "G": G, "max_abs_err": err, "max_row_error": rel})
    return out_rows


def kernel_phase(torch, dev, time_ms) -> dict:
    """Each attention kernel against its plain version at Llama-3-8B
    serving shapes in bf16; times, bounds, SDPA yardsticks. Flash also at
    the qwen2-7b (G = 7) and qwen2-0.5b (G = 7, hd 64) geometries, its
    mma.sync kernel in f32 at the llama3-tiny geometry and in bf16 at
    gemma-2b's (and every head-dim template at small shapes); the chunk
    kernel's wgmma route at every head dim and page size it takes (small
    shapes, G 3 and G 7) and its mma.sync route on f32 pages at the
    llama3-tiny geometry and at a spread of page sizes and geometries;
    decode at qwen2-7b's and gemma-2b's geometries. Returns the per-kernel
    results."""
    from mcp_context_forge_tpu_torch.tpu_local.ops import attention as attn
    from mcp_context_forge_tpu_torch.tpu_local.ops import paged_attention as paged

    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    KV, G, hd, PAGE, NUM_PAGES, P = 8, 4, 128, 128, 512, 16
    H = KV * G

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    k_pages = randn(NUM_PAGES, PAGE, KV, hd)
    v_pages = randn(NUM_PAGES, PAGE, KV, hd)
    spare = NUM_PAGES - 1    # a page no row's table holds

    def tables_for(n_tokens: list[int]) -> torch.Tensor:
        tables = torch.zeros((len(n_tokens), P), dtype=torch.int32)
        nxt = 1
        for b, n in enumerate(n_tokens):
            pages = -(-n // PAGE)
            tables[b, :pages] = torch.arange(nxt, nxt + pages)
            nxt += pages
        check(nxt <= spare, "the test tables overflow the page pool")
        return tables.to(dev)

    results = {}

    # decode: one query token per row over its pages
    seq_lens_list = [2000, 1, 0, 129, 300, 777, 128, 1500]
    q = randn(8, KV, G, hd)
    tables = tables_for(seq_lens_list)
    seq_lens = torch.tensor(seq_lens_list, dtype=torch.int32, device=dev)
    out = paged.paged_decode_attention(q, k_pages, v_pages, tables, seq_lens)
    ref = paged.paged_decode_attention_ref(q, k_pages, v_pages, tables, seq_lens)
    torch.cuda.synchronize()
    active = seq_lens > 0
    err, rel = compare_paged(torch, "paged_decode_attention", out, ref, active)
    check(torch.count_nonzero(out[~active]) == 0, "seq_len 0 row is not zero")
    again, ws = paged._decode_launch("paged_decode_attention", "mcf_paged_decode_attention",
                                     q, k_pages, v_pages, tables, seq_lens, None, None)
    check(torch.equal(again, out), "paged_decode_attention is not deterministic")
    grid = split_grid(torch, dev, "paged_decode_attention", ws, 8, KV)
    faults = planted_faults(torch, "paged_decode_attention",
                            drop_split(torch, paged, ws, seq_lens, q, 0, 1), ref, active)
    tokens = sum(seq_lens_list)
    nbytes = 2 * tokens * KV * hd * 2 + 2 * q.numel() * 2 + tables.numel() * 4 + 8 * 4
    lib = sdpa_paged(torch, paged, q, k_pages, v_pages, tables,
                     lambda c: (c[None, :] < seq_lens[:, None])[:, None])
    results["paged_decode_attention"] = dict(
        shape={"q": list(q.shape), "pages": list(k_pages.shape),
               "seq_lens": seq_lens_list},
        grid=grid, max_abs_err=err, max_row_error=rel, planted_faults=faults,
        **time_ms.both("kernel", lambda: paged.paged_decode_attention(
            q, k_pages, v_pages, tables, seq_lens)),
        plain_ms=time_ms(lambda: paged.paged_decode_attention_ref(q, k_pages, v_pages, tables, seq_lens)),
        library_ms=time_ms(lambda: sdpa(lib[0], lib[1], lib[2], attn_mask=lib[3])),
        bytes=nbytes, flops=4 * hd * G * KV * tokens)
    del lib

    # chunk, the wgmma route: a 128-query suffix over 2-6 history pages;
    # row 3 is half padding
    hist_pages, S = [2, 3, 4, 6], 128
    n_valid = [128, 128, 128, 60]
    qc = randn(4, S, KV, G, hd)
    pos = torch.full((4, S), -1, dtype=torch.int32)
    for b, (hp, n) in enumerate(zip(hist_pages, n_valid)):
        pos[b, :n] = torch.arange(hp * PAGE, hp * PAGE + n)
    pos = pos.to(dev)
    ctables = tables_for([hp * PAGE + S for hp in hist_pages])
    cargs = (qc, k_pages, v_pages, ctables, pos)
    check(paged.chunk_route(bf16, hd, PAGE) == "tc", "bf16 chunk does not route to tc")
    out = paged.paged_chunk_attention_tc(*cargs)
    ref = paged.paged_chunk_attention_ref(*cargs)
    torch.cuda.synchronize()
    check(torch.equal(paged.paged_chunk_attention(*cargs), out),
          "paged_chunk_attention does not dispatch to paged_chunk_attention_tc")
    valid = pos >= 0
    err, rel = compare_paged(torch, "paged_chunk_attention_tc", out, ref, valid)
    faults = planted_faults(torch, "paged_chunk_attention_tc", chunk_faults(
        torch, paged.paged_chunk_attention_tc, cargs, spare, 3, 5, 7), ref, valid)
    keys = sum(int(p.max()) + 1 for p in pos)
    pairs = int((pos[valid].long() + 1).sum())
    nbytes = 2 * keys * KV * hd * 2 + 2 * qc.numel() * 2 + ctables.numel() * 4 + pos.numel() * 4
    lib = sdpa_paged(torch, paged, qc, k_pages, v_pages, ctables,
                     lambda c: c[None, None, :] <= pos[:, :, None])
    results["paged_chunk_attention_tc"] = dict(
        shape={"q": list(qc.shape), "pages": list(k_pages.shape),
               "history_pages": hist_pages, "valid_queries": n_valid},
        max_abs_err=err, max_row_error=rel, planted_faults=faults,
        **time_ms.both("kernel", lambda: paged.paged_chunk_attention_tc(*cargs)),
        plain_ms=time_ms(lambda: paged.paged_chunk_attention_ref(*cargs)),
        mma_route_ms=time_ms(lambda: paged.paged_chunk_attention_mma(*cargs)),
        library_ms=time_ms(lambda: sdpa(lib[0], lib[1], lib[2], attn_mask=lib[3])),
        bytes=nbytes, flops=4 * hd * G * KV * pairs)
    del lib

    # every geometry the wgmma route takes (hd 64/128, pages of 64, 128 and
    # 256 tokens, bf16 and int8 pages; G 3 and qwen2-7b's G 7 over 4 KV
    # heads) and a spread of the mma route's (f32, bf16 and int8 pages of 16,
    # 96 and 128 tokens at gemma-2b's KV 1 / G 8 / hd 256, qwen2's G 7 and
    # the tiny configs' hd 32)
    tc_cases = [("paged_chunk_attention_tc" + ("_q8" if q8 else ""), bf16, hdg, page, q8, KVg, Gg)
                for hdg in (64, 128) for page in (64, 128, 256) for q8 in (False, True)
                for KVg, Gg in ((2, 3),) + (((4, 7),) if hdg == 128 else ())]
    mma_cases = [("paged_chunk_attention_mma" + ("_q8" if q8 else ""), dtype, hdg, page, q8, KVg, Gg)
                 for dtype in (torch.float32, bf16) for page in (16, 96, 128)
                 for q8 in (False, True) for KVg, Gg, hdg in ((1, 8, 256), (4, 7, 128), (4, 2, 32))]
    geometries = chunk_geometries(torch, dev, gen, paged, tc_cases)
    mma_geometries = chunk_geometries(torch, dev, gen, paged, mma_cases)

    # decode at qwen2-7b's geometry (KV 4, G 7, hd 128) and gemma-2b's (KV 1,
    # G 8, hd 256), bf16 and int8 pages
    decode_geometries = []
    for KVd, Gd, hdd in ((4, 7, 128), (1, 8, 256)):
        for q8 in (False, True):
            lens_d = [1000, 1, 0, 129, 384]
            pool = 5 * 8 + 1    # eight table slots of 128 per row, distinct pages
            td = torch.randperm(pool - 1, generator=torch.Generator().manual_seed(hdd)).add(1).reshape(
                5, 8).to(torch.int32).to(dev)
            if q8:
                kd, vd = (torch.randint(-127, 128, (pool, PAGE, KVd, hdd), generator=gen, device=dev,
                                        dtype=torch.int8) for _ in range(2))
                sd = tuple((torch.rand((pool, KVd), generator=gen, device=dev) + 0.5).div(127).to(bf16)
                           for _ in range(2))
            else:
                kd, vd, sd = randn(pool, PAGE, KVd, hdd), randn(pool, PAGE, KVd, hdd), ()
            lens_t = torch.tensor(lens_d, dtype=torch.int32, device=dev)
            dargs = (randn(5, KVd, Gd, hdd), kd, vd, td, lens_t, *sd)
            name = "paged_decode_attention_q8" if q8 else "paged_decode_attention"
            out = getattr(paged, name)(*dargs)
            ref = paged.paged_decode_attention_ref(*dargs)
            torch.cuda.synchronize()
            err, rel = compare_paged(torch, f"{name} KV {KVd} G {Gd} hd {hdd}", out, ref, lens_t > 0)
            check(torch.count_nonzero(out[lens_t == 0]) == 0, "seq_len 0 row is not zero")
            decode_geometries.append({"kernel": name, "KV": KVd, "G": Gd, "hd": hdd,
                                      "seq_lens": lens_d, "max_abs_err": err, "max_row_error": rel})

    # chunk, the mma route: f32 pages at the llama3-tiny geometry (KV 4, G 2,
    # hd 32), the same rows, each held to F32_ROW_REL
    KVt, Gt, hdt = 4, 2, 32
    kt_pages = randn(NUM_PAGES, PAGE, KVt, hdt, dtype=torch.float32)
    vt_pages = randn(NUM_PAGES, PAGE, KVt, hdt, dtype=torch.float32)
    qt = randn(4, S, KVt, Gt, hdt, dtype=torch.float32)
    targs = (qt, kt_pages, vt_pages, ctables, pos)
    check(paged.chunk_route(torch.float32, hdt, PAGE) == "mma", "f32 chunk does not route to mma")
    out = paged.paged_chunk_attention_mma(*targs)
    ref = paged.paged_chunk_attention_ref(*targs)
    torch.cuda.synchronize()
    check(torch.equal(paged.paged_chunk_attention(*targs), out),
          "paged_chunk_attention does not dispatch to paged_chunk_attention_mma")
    err, rel = compare_paged(torch, "paged_chunk_attention_mma", out, ref, valid, F32_ROW_REL)
    faults = planted_faults(torch, "paged_chunk_attention_mma", chunk_faults(
        torch, paged.paged_chunk_attention_mma, targs, spare, 3, 5, 7), ref, valid, F32_ROW_REL)
    lib = sdpa_paged(torch, paged, qt, kt_pages, vt_pages, ctables,
                     lambda c: c[None, None, :] <= pos[:, :, None])
    results["paged_chunk_attention_mma"] = dict(
        shape={"q": list(qt.shape), "pages": list(kt_pages.shape), "dtype": "float32",
               "history_pages": hist_pages, "valid_queries": n_valid},
        max_abs_err=err, max_row_error=rel, row_limit=F32_ROW_REL, planted_faults=faults,
        **time_ms.both("kernel", lambda: paged.paged_chunk_attention_mma(*targs)),
        plain_ms=time_ms(lambda: paged.paged_chunk_attention_ref(*targs)),
        library_ms=time_ms(lambda: sdpa(lib[0], lib[1], lib[2], attn_mask=lib[3])),
        bytes=2 * keys * KVt * hdt * 4 + 2 * qt.numel() * 4 + ctables.numel() * 4 + pos.numel() * 4,
        flops=4 * hdt * Gt * KVt * pairs, flops_per_s=F32_FLOPS_PER_S)
    del kt_pages, vt_pages, lib

    # flash: the wgmma kernel at B=4, S=512 and S=2048 (llama3-8b), at the
    # qwen2-7b and qwen2-0.5b geometries; the mma.sync kernel in f32 at the
    # llama3-tiny geometry and in bf16 at gemma-2b's; rows padded to the
    # lengths given
    flash_runs = []
    for name, B, S, KVf, Gf, hdf, dtype, lens in (
            ("flash_attention_tc", 4, 512, KV, G, hd, bf16, [512, 475, 261, 1]),
            ("flash_attention_tc", 4, 2048, KV, G, hd, bf16, [2048, 2011, 1029, 1]),
            ("flash_attention_tc", 2, 1024, 4, 7, 128, bf16, [1024, 700]),
            ("flash_attention_tc", 2, 1024, 2, 7, 64, bf16, [1024, 333]),
            ("flash_attention_mma", 1, 2048, 1, 8, 256, bf16, [2048]),
            ("flash_attention_mma", 2, 256, 4, 2, 32, torch.float32, [256, 100])):
        kernel = getattr(attn, name)
        check(attn.flash_route(dtype, hdf) == name.rsplit("_", 1)[1],
              f"{dtype} at hd {hdf} does not route to {name}")
        Hf, size = KVf * Gf, torch.finfo(dtype).bits // 8
        limit = F32_ROW_REL if dtype == torch.float32 else ROW_REL
        qf, kf, vf = (randn(B, S, Hf, hdf, dtype=dtype), randn(B, S, KVf, hdf, dtype=dtype),
                      randn(B, S, KVf, hdf, dtype=dtype))
        validf = torch.arange(S, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]
        out = kernel(qf, kf, vf, validf)
        ref = attn.attention_reference(qf, kf, vf, validf)
        torch.cuda.synchronize()
        check(torch.equal(attn.flash_attention(qf, kf, vf, validf), out),
              f"flash_attention does not dispatch to {name}")
        err, rel = compare_paged(torch, name, out, ref, validf, limit)
        run = dict(kernel=name, shape={"q": list(qf.shape), "kv": list(kf.shape),
                                       "dtype": str(dtype), "valid_lens": lens},
                   max_abs_err=err, max_row_error=rel, row_limit=limit)
        if KVf == KV or name == "flash_attention_mma":
            faults = flash_faults(torch, kernel, qf, kf, vf, validf, out)
            if dtype == torch.float32:
                faults["inputs rounded to TF32 (the lo terms of 3xTF32 dropped)"] = kernel(
                    tf32(torch, qf), tf32(torch, kf), tf32(torch, vf), validf)
            run["planted_faults"] = planted_faults(torch, name, faults, ref, validf, limit)
        del ref
        qt = qf.transpose(1, 2).contiguous()
        kt = kf.repeat_interleave(Gf, dim=2).transpose(1, 2).contiguous()
        vt = vf.repeat_interleave(Gf, dim=2).transpose(1, 2).contiguous()
        pairs = sum(n * (n + 1) // 2 for n in lens)
        run.update(
            **time_ms.both("kernel", lambda: kernel(qf, kf, vf, validf)),
            plain_ms=time_ms(lambda: attn.attention_reference(qf, kf, vf, validf)),
            library_ms=time_ms(lambda: sdpa(qt, kt, vt, is_causal=True)),
            bytes=(qf.numel() * 2 + kf.numel() * 2) * size + validf.numel(),
            flops=4 * hdf * Hf * pairs)
        run["bound_ms"], run["bound_by"] = bound(
            run["bytes"], run["flops"],
            BF16_FLOPS_PER_S if dtype == bf16 else F32_FLOPS_PER_S)
        flash_runs.append(run)
        del qt, kt, vt
    results["flash_attention_tc"] = flash_runs[1]
    results["flash_attention_mma"] = flash_runs[-1]

    # every head-dim template of the mma.sync kernel (hd up to 16, 32, 64,
    # 128, 256; hd % 8 == 0) in both dtypes, at a small shape
    templates = []
    for dtype in (torch.float32, bf16):
        for hdm in (8, 16, 24, 32, 48, 64, 96, 128, 192, 256):
            qf, kf, vf = (randn(2, 200, 6, hdm, dtype=dtype), randn(2, 200, 2, hdm, dtype=dtype),
                          randn(2, 200, 2, hdm, dtype=dtype))
            validf = torch.arange(200, device=dev)[None, :] < torch.tensor([200, 77], device=dev)[:, None]
            out = attn.flash_attention_mma(qf, kf, vf, validf)
            ref = attn.attention_reference(qf, kf, vf, validf)
            torch.cuda.synchronize()
            limit = F32_ROW_REL if dtype == torch.float32 else ROW_REL
            err, rel = compare_paged(torch, f"flash_attention_mma {dtype} hd {hdm}", out, ref,
                                     validf, limit)
            templates.append({"dtype": str(dtype), "hd": hdm, "max_abs_err": err,
                              "max_row_error": rel})
    for name in ("paged_decode_attention", "paged_chunk_attention_tc", "paged_chunk_attention_mma"):
        run = results[name]
        run["bound_ms"], run["bound_by"] = bound(
            run["bytes"], run["flops"], run.pop("flops_per_s", BF16_FLOPS_PER_S))
    emit({"phase": "kernels",
          "tolerance": {"atol": TOL, "rtol": TOL, "row_relative": ROW_REL,
                        "row_relative_f32_mma": F32_ROW_REL},
          "decode": results["paged_decode_attention"],
          "chunk": results["paged_chunk_attention_tc"],
          "chunk_tc_geometries": geometries,
          "chunk_mma_f32": results["paged_chunk_attention_mma"],
          "chunk_mma_geometries": mma_geometries, "decode_geometries": decode_geometries,
          "flash": flash_runs, "flash_mma_templates": templates})
    return results


def q8_kernel_phase(torch, dev, time_ms) -> dict:
    """Both int8-page kernels against their plain versions at Llama-3-8B
    serving shapes over a pool of 1024 int8 pages of 128 with bf16 scales
    [1024, 8]; times, bounds (1 byte per K/V element plus the scales of the
    pages walked), SDPA yardsticks over K/V gathered and dequantized to
    bf16 in advance. Each is also timed beside its bf16-page kernel on the
    same pages dequantized to bf16 (the same shape, twice the bytes), and
    the wgmma chunk kernel beside the mma.sync route on the same int8 pages.
    Planted faults in row 0 (decode: a wrong page, wrong K scales, a dropped
    tail tile, a dropped split; chunk: a wrong history page, a causal
    off-by-one, wrong V scales) show that the row check sees a kernel that
    misreads part of a long walk. Then the mma.sync route on int8 pages
    with f32 queries at the llama3-tiny geometry."""
    from mcp_context_forge_tpu_torch.tpu_local.ops import paged_attention as paged
    from mcp_context_forge_tpu_torch.tpu_local.quantize import kv_dequantize

    gen = torch.Generator(device=dev).manual_seed(2)
    bf16 = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    KV, G, hd, PAGE, NUM_PAGES, P = 8, 4, 128, 128, 1024, 64

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(bf16)

    def int8_pages():
        return torch.randint(-127, 128, (NUM_PAGES, PAGE, KV, hd), generator=gen,
                             device=dev, dtype=torch.int8)

    def scales():
        return (torch.rand((NUM_PAGES, KV), generator=gen, device=dev) * 1.5 + 0.5).div(127).to(bf16)

    k8, v8, ks, vs = int8_pages(), int8_pages(), scales(), scales()
    k16 = kv_dequantize(k8, ks[:, None, :, None], bf16)
    v16 = kv_dequantize(v8, vs[:, None, :, None], bf16)

    def tables_for(n_tokens: list[int]) -> torch.Tensor:
        tables = torch.zeros((len(n_tokens), P), dtype=torch.int32)
        nxt = 1
        for b, n in enumerate(n_tokens):
            pages = -(-n // PAGE)
            tables[b, :pages] = torch.arange(nxt, nxt + pages)
            nxt += pages
        check(nxt <= NUM_PAGES, "the test tables overflow the page pool")
        return tables.to(dev)

    def page_bytes(n_tokens: list[int]) -> int:
        """K and V at 1 byte per element, plus both scales of each page walked."""
        pages = sum(-(-n // PAGE) for n in n_tokens)
        return 2 * sum(n_tokens) * KV * hd + 2 * pages * KV * 2

    results = {}

    # decode: one query token per row, seq_lens up to ~8000, one row at 0
    seq_lens_list = [8000, 1, 0, 6032, 3000, 129, 4100, 7777]
    q = randn(8, KV, G, hd)
    tables = tables_for(seq_lens_list)
    seq_lens = torch.tensor(seq_lens_list, dtype=torch.int32, device=dev)
    args = (q, k8, v8, tables, seq_lens, ks, vs)
    out = paged.paged_decode_attention_q8(*args)
    ref = paged.paged_decode_attention_ref(*args)
    torch.cuda.synchronize()
    active = seq_lens > 0
    err, rel = compare_paged(torch, "paged_decode_attention_q8", out, ref, active)
    check(torch.count_nonzero(out[~active]) == 0, "seq_len 0 row is not zero")
    spare = NUM_PAGES - 1    # a page no row's table holds
    check(not bool((tables == spare).any()), "the spare page is in use")
    wrong_page, wrong_scales = tables.clone(), ks.clone()
    wrong_page[0, 40] = spare
    wrong_scales[tables[0, 33:63].long()] *= 1.25
    short = seq_lens.clone()
    short[0] -= 64
    again, ws = paged._decode_launch("paged_decode_attention_q8",
                                     "mcf_paged_decode_attention_q8", *args)
    check(torch.equal(again, out), "paged_decode_attention_q8 is not deterministic")
    grid = split_grid(torch, dev, "paged_decode_attention_q8", ws, 8, KV)
    faults = planted_faults(torch, "paged_decode_attention_q8", {
        "row 0: page 40 of 63 read from a wrong page": paged.paged_decode_attention_q8(
            q, k8, v8, wrong_page, seq_lens, ks, vs),
        "row 0: K scales of pages 33-62 read 1.25x": paged.paged_decode_attention_q8(
            q, k8, v8, tables, seq_lens, wrong_scales, vs),
        "row 0: last 64 keys of 8000 dropped": paged.paged_decode_attention_q8(
            q, k8, v8, tables, short, ks, vs),
        **drop_split(torch, paged, ws, seq_lens, q, 0, 2)}, ref, active)
    tokens = sum(seq_lens_list)
    results["paged_decode_attention_q8"] = dict(
        shape={"q": list(q.shape), "pages": list(k8.shape), "page_dtype": "int8",
               "scales": list(ks.shape), "seq_lens": seq_lens_list},
        grid=grid, max_abs_err=err, max_row_error=rel, planted_faults=faults,
        **time_ms.both("kernel", lambda: paged.paged_decode_attention_q8(*args)),
        plain_ms=time_ms(lambda: paged.paged_decode_attention_ref(*args)),
        bf16_pages_kernel_ms=time_ms(lambda: paged.paged_decode_attention(
            q, k16, v16, tables, seq_lens)),
        library_ms=None,
        bytes=page_bytes(seq_lens_list) + 2 * q.numel() * 2 + tables.numel() * 4 + 8 * 4,
        flops=4 * hd * G * KV * tokens)
    del ref

    lib = sdpa_paged(torch, paged, q, k8, v8, tables,
                     lambda c: (c[None, :] < seq_lens[:, None])[:, None], (ks, vs))
    results["paged_decode_attention_q8"]["library_ms"] = time_ms(
        lambda: sdpa(lib[0], lib[1], lib[2], attn_mask=lib[3]))
    del lib

    # chunk, the wgmma route: 4 rows x 512 queries over 48, 24, 8 and 0
    # history pages (row 3 half padding); then one row of 2048 queries, the
    # first 1944 real, over 32 history pages (the 6040-token prompt's last
    # chunk round)
    chunk_runs = []
    for hist_pages, S, n_valid in (([48, 24, 8, 0], 512, [512, 512, 512, 256]),
                                   ([32], 2048, [1944])):
        B = len(hist_pages)
        qc = randn(B, S, KV, G, hd)
        pos = torch.full((B, S), -1, dtype=torch.int32)
        for b, (hp, n) in enumerate(zip(hist_pages, n_valid)):
            pos[b, :n] = torch.arange(hp * PAGE, hp * PAGE + n)
        pos = pos.to(dev)
        ctables = tables_for([hp * PAGE + n for hp, n in zip(hist_pages, n_valid)])
        check(not bool((ctables == spare).any()), "the spare page is in use")
        cargs = (qc, k8, v8, ctables, pos, ks, vs)
        out = paged.paged_chunk_attention_tc_q8(*cargs)
        ref = paged.paged_chunk_attention_ref(*cargs)
        torch.cuda.synchronize()
        check(torch.equal(paged.paged_chunk_attention_q8(*cargs), out),
              "paged_chunk_attention_q8 does not dispatch to paged_chunk_attention_tc_q8")
        valid = pos >= 0
        err, rel = compare_paged(torch, "paged_chunk_attention_tc_q8", out, ref, valid)
        n_slots = -(-(hist_pages[0] * PAGE + n_valid[0]) // PAGE)
        wrong_scales = vs.clone()
        wrong_scales[ctables[0, 1:hist_pages[0] - 1].long()] *= 1.25
        planted = chunk_faults(torch, paged.paged_chunk_attention_tc_q8, cargs, spare, 0,
                               hist_pages[0] - 8, n_slots)
        if hist_pages[0] * PAGE > S:   # every query sees thousands of keys: one more moves
            planted = {k: v for k, v in planted.items() if not k.startswith("causal")}
        faults = planted_faults(torch, "paged_chunk_attention_tc_q8", {
            **planted,
            f"row 0: V scales of history pages 1-{hist_pages[0] - 2} read 1.25x":
            paged.paged_chunk_attention_tc_q8(qc, k8, v8, ctables, pos, ks, wrong_scales)},
            ref, valid)
        del ref, out
        keys = [int(p.max()) + 1 for p in pos]
        pairs = int((pos[valid].long() + 1).sum())
        lib = sdpa_paged(torch, paged, qc, k8, v8, ctables,
                         lambda c: c[None, None, :] <= pos[:, :, None], (ks, vs))
        run = dict(
            shape={"q": list(qc.shape), "pages": list(k8.shape), "page_dtype": "int8",
                   "scales": list(ks.shape), "history_pages": hist_pages,
                   "valid_queries": n_valid},
            max_abs_err=err, max_row_error=rel, planted_faults=faults,
            **time_ms.both("kernel", lambda: paged.paged_chunk_attention_tc_q8(*cargs)),
            plain_ms=time_ms(lambda: paged.paged_chunk_attention_ref(*cargs)),
            mma_route_ms=time_ms(lambda: paged.paged_chunk_attention_mma_q8(*cargs)),
            bf16_pages_kernel_ms=time_ms(lambda: paged.paged_chunk_attention(
                qc, k16, v16, ctables, pos)),
            library_ms=time_ms(lambda: sdpa(lib[0], lib[1], lib[2], attn_mask=lib[3])),
            bytes=page_bytes(keys) + 2 * qc.numel() * 2 + ctables.numel() * 4 + pos.numel() * 4,
            flops=4 * hd * G * KV * pairs)
        del lib
        run["bound_ms"], run["bound_by"] = bound(run["bytes"], run["flops"])
        chunk_runs.append(run)
    results["paged_chunk_attention_tc_q8"] = chunk_runs[0]

    # chunk, the mma route on int8 pages: f32 queries and scales at the
    # llama3-tiny geometry (KV 4, G 2, hd 32), 4 x 128 queries over 2-6
    # history pages, each row held to F32_ROW_REL
    KVt, Gt, hdt = 4, 2, 32
    hist_pages, S, n_valid = [2, 3, 4, 6], 128, [128, 128, 128, 60]
    kt8 = k8[:, :, :KVt, :hdt].contiguous()
    vt8 = v8[:, :, :KVt, :hdt].contiguous()
    kst, vst = ks[:, :KVt].float().contiguous(), vs[:, :KVt].float().contiguous()
    qt = torch.randn((4, S, KVt, Gt, hdt), generator=gen, device=dev)
    pos = torch.full((4, S), -1, dtype=torch.int32)
    for b, (hp, n) in enumerate(zip(hist_pages, n_valid)):
        pos[b, :n] = torch.arange(hp * PAGE, hp * PAGE + n)
    pos = pos.to(dev)
    ctables = tables_for([hp * PAGE + S for hp in hist_pages])
    targs = (qt, kt8, vt8, ctables, pos, kst, vst)
    out = paged.paged_chunk_attention_mma_q8(*targs)
    ref = paged.paged_chunk_attention_ref(*targs)
    torch.cuda.synchronize()
    check(torch.equal(paged.paged_chunk_attention_q8(*targs), out),
          "paged_chunk_attention_q8 does not dispatch to paged_chunk_attention_mma_q8")
    valid = pos >= 0
    err, rel = compare_paged(torch, "paged_chunk_attention_mma_q8", out, ref, valid, F32_ROW_REL)
    wrong_scales = vst.clone()
    wrong_scales[ctables[3, 1:5].long()] *= 1.25
    faults = planted_faults(torch, "paged_chunk_attention_mma_q8", {
        **chunk_faults(torch, paged.paged_chunk_attention_mma_q8, targs, spare, 3, 5, 7),
        "row 3: V scales of history pages 1-4 read 1.25x": paged.paged_chunk_attention_mma_q8(
            qt, kt8, vt8, ctables, pos, kst, wrong_scales)}, ref, valid, F32_ROW_REL)
    keys = [int(p.max()) + 1 for p in pos]
    pairs = int((pos[valid].long() + 1).sum())
    lib = sdpa_paged(torch, paged, qt, kt8, vt8, ctables,
                     lambda c: c[None, None, :] <= pos[:, :, None], (kst, vst))
    mma_run = dict(
        shape={"q": list(qt.shape), "pages": list(kt8.shape), "page_dtype": "int8",
               "dtype": "float32", "history_pages": hist_pages, "valid_queries": n_valid},
        max_abs_err=err, max_row_error=rel, row_limit=F32_ROW_REL, planted_faults=faults,
        **time_ms.both("kernel", lambda: paged.paged_chunk_attention_mma_q8(*targs)),
        plain_ms=time_ms(lambda: paged.paged_chunk_attention_ref(*targs)),
        library_ms=time_ms(lambda: sdpa(lib[0], lib[1], lib[2], attn_mask=lib[3])),
        bytes=(2 * sum(keys) * KVt * hdt + 2 * sum(-(-n // PAGE) for n in keys) * KVt * 4
               + 2 * qt.numel() * 4 + ctables.numel() * 4 + pos.numel() * 4),
        flops=4 * hdt * Gt * KVt * pairs)
    mma_run["bound_ms"], mma_run["bound_by"] = bound(mma_run["bytes"], mma_run["flops"],
                                                     F32_FLOPS_PER_S)
    results["paged_chunk_attention_mma_q8"] = mma_run
    run = results["paged_decode_attention_q8"]
    run["bound_ms"], run["bound_by"] = bound(run["bytes"], run["flops"])
    emit({"phase": "kernels_int8_pages",
          "tolerance": {"atol": TOL, "rtol": TOL, "row_relative": ROW_REL},
          "decode": results["paged_decode_attention_q8"],
          "chunk": chunk_runs, "chunk_mma_f32": mma_run})
    return results


def writer_diff(torch, got: dict, want: dict) -> int:
    """Elements of pages >= 1 and their scales (K and V) where two pools
    differ; the trash page 0 is don't-care."""
    return sum(int((got[key][1:] != want[key][1:]).sum()) for key in want)


def kv_write_phase(torch, dev, time_ms) -> dict:
    """The fused int8 decode writer against its plain version (the plain
    writer, ``_quant_store``, on the card) at Llama-3-8B shapes: one layer
    of the long-context pool (1024 int8 pages of 128, KV 8, hd 128, bf16
    scales), B = 8 rows: offset 0 on a page left with a large scale (the
    reset shows), mid-page rows whose scale grows and does not, the last
    offset of a page, offset 1, and two invalid rows. Pages >= 1 and their
    scales must agree bit for bit. Planted faults, each a kernel given
    corrupted inputs or an output edited as a faulty kernel would leave it,
    must be rejected: the requantize skipped (the growing row's page given
    its final scale, so the ratio is 1), the offset-0 reset skipped (its
    page keeps max(old, token) and the token is quantized under it), and a
    scale read from the wrong page (the non-growing row's page given
    another page's scale). Timed on repeated writes of the same tokens,
    the decode steady state (no scale grows)."""
    from mcp_context_forge_tpu_torch.tpu_local.kv import PagedKVState
    from mcp_context_forge_tpu_torch.tpu_local.kv.paged_cache import write_decode_kv_plain
    from mcp_context_forge_tpu_torch.tpu_local.ops.kv_write import kv_quant_store_decode
    from mcp_context_forge_tpu_torch.tpu_local.quantize import kv_int8_scale, kv_quantize

    gen = torch.Generator(device=dev).manual_seed(7)
    bf16 = torch.bfloat16
    KV, hd, PAGE, NUM_PAGES, P, B = 8, 128, 128, 1024, 64, 8
    pool = {key: torch.randint(-127, 128, (NUM_PAGES, PAGE, KV, hd), generator=gen,
                               device=dev, dtype=torch.int8) for key in ("k_pages", "v_pages")}
    for key in ("k_scales", "v_scales"):
        pool[key] = ((torch.rand((NUM_PAGES, KV), generator=gen, device=dev) + 0.5) / 127).to(bf16)
    tables = torch.arange(1, 1 + B * P, dtype=torch.int32, device=dev).reshape(B, P)
    #        reset  grows    no growth  last   invalid  mid      invalid  offset 1
    positions = [3 * PAGE, 5 * PAGE + 37, 2 * PAGE + 90, 2 * PAGE + 127, 40, 7 * PAGE + 64,
                 9 * PAGE, 11 * PAGE + 1]
    valid = torch.tensor([True, True, True, True, False, True, False, True], device=dev)
    magnitude = torch.tensor([0.5, 60.0, 1e-3, 1.0, 5.0, 1.0, 5.0, 1.0], device=dev)
    k, v = (torch.randn((B, KV, hd), generator=gen, device=dev) * magnitude[:, None, None]
            for _ in range(2))
    k, v = k.to(bf16), v.to(bf16)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    slots = torch.arange(B, dtype=torch.int32, device=dev)
    page_of = [int(tables[b, p // PAGE]) for b, p in enumerate(positions)]
    for key in ("k_scales", "v_scales"):
        pool[key][page_of[0]] = 1.0            # a large scale left by an earlier tenancy

    def kernel(state: dict) -> dict:
        kv_quant_store_decode(state["k_pages"], state["v_pages"], state["k_scales"],
                              state["v_scales"], k, v, tables, slots, pos, valid)
        return state

    def plain(state: dict) -> dict:
        kv = PagedKVState(*(state[key][None] for key in ("k_pages", "v_pages")), tables,
                          state["k_scales"][None], state["v_scales"][None])
        write_decode_kv_plain(kv, 0, k, v, slots, pos, valid)
        return state

    def copy(state: dict) -> dict:
        return {key: t.clone() for key, t in state.items()}

    ref = plain(copy(pool))
    out = kernel(copy(pool))
    torch.cuda.synchronize()
    diff = writer_diff(torch, out, ref)
    check(diff == 0, f"kv_quant_store_decode: {diff} elements of pages >= 1 or their "
                     f"scales differ from the plain writer")
    grew = {key: [b for b in range(B) if bool(valid[b]) and positions[b] % PAGE
                  and not torch.equal(ref[key][page_of[b]], pool[key][page_of[b]])]
            for key in ("k_scales", "v_scales")}
    check(1 in grew["k_scales"] and 2 not in grew["k_scales"],
          f"the rows whose scale grows are {grew}, not row 1 alone")

    faults = {}
    skip_requant = copy(pool)                  # the ratio is 1: nothing is requantized
    for key in ("k_scales", "v_scales"):
        skip_requant[key][page_of[1]] = ref[key][page_of[1]]
    faults["row 1: the requantize skipped"] = kernel(skip_requant)
    no_reset = copy(out)
    for name, x in (("k", k), ("v", v)):
        scales, pages = no_reset[f"{name}_scales"], no_reset[f"{name}_pages"]
        kept = torch.maximum(pool[f"{name}_scales"][page_of[0]],
                             kv_int8_scale(x[0].float().abs().amax(-1)).to(bf16))
        scales[page_of[0]] = kept
        pages[page_of[0], 0] = kv_quantize(x[0], kept[:, None])
    faults["row 0: the offset-0 reset skipped"] = no_reset
    wrong_scale = copy(pool)
    for key in ("k_scales", "v_scales"):
        wrong_scale[key][page_of[2]] = pool[key][NUM_PAGES - 1] / 8
    faults["row 2: its page's scale read from another page"] = kernel(wrong_scale)
    torch.cuda.synchronize()
    planted = {}
    for fault, state in faults.items():
        n = writer_diff(torch, state, ref)
        check(n > 0, f"kv_quant_store_decode: the bit check passes the planted fault {fault}")
        planted[fault] = {"differing_elements": n}

    # requantized (row, head) slices of the checked call, and the timed state
    requant = sum(int((ref[key][page_of[b]] != pool[key][page_of[b]]).sum())
                  for key in ("k_scales", "v_scales") for b in grew[key])
    steady = copy(ref)
    kernel_ms = time_ms.both("kernel", lambda: kernel(steady))
    plain_state = copy(ref)
    plain_ms = time_ms(lambda: plain(plain_state))
    check(writer_diff(torch, steady, plain_state) == 0,
          "kv_quant_store_decode: repeated writes differ from the plain writer's")
    values = 2 * B * KV * hd
    nbytes = values * 2 + values + 2 * 2 * B * KV * 2 + B * (4 * 3 + 1)
    result = dict(
        shape={"pages": list(pool["k_pages"].shape), "scales": list(pool["k_scales"].shape),
               "k": list(k.shape), "positions": positions, "valid": valid.tolist()},
        rows_whose_scale_grew=grew, requantized_head_slices=requant,
        first_call_bytes=nbytes + requant * 2 * PAGE * hd,
        max_abs_err=max(float((out[key][1:].float() - ref[key][1:].float()).abs().max())
                        for key in ref),
        differing_elements=diff, planted_faults=planted,
        **kernel_ms, plain_ms=plain_ms, library_ms=None, bytes=nbytes, flops=0)
    result["bound_ms"], result["bound_by"] = bound(nbytes, 0)
    emit({"phase": "kv_write", "tolerance": "bit for bit on pages >= 1 and their scales",
          **result})
    return {"kv_quant_store_decode": result}


def span_write_phase(torch, dev, time_ms) -> dict:
    """The int8 span writer against its plain versions at Llama-3-8B
    shapes: one layer of the long-context pool (1024 int8 pages of 128, KV
    8, hd 128, bf16 scales), the verify's block (B = 8, S = 4: spans at
    offset 0 of a page left with a large scale, so the reset shows;
    mid-page with values that grow the page's scale and with values that
    do not; crossing a page from its offset 126; 2 and 3 tokens, then
    padding; one token at offset 1; a padding row) and a prefill block
    (B = 4, S = 2048, rows of 2048, 2011, 1029 and 1 valid tokens from
    offset 0, mid-page with growth, a page's last offset, and mid-page).
    The kernel must equal the plain writer (``write_prefill_kv_plain``,
    ``_quant_store`` on the card) and the plain model of the kernel
    (``kv_quant_store_span_ref``) bit for bit on pages >= 1 and their
    scales. Planted faults on the verify block, each a kernel given
    corrupted inputs or an output edited as a faulty kernel would leave it,
    must be rejected: the requantize skipped (the growing row's first page
    given its final scale, so the ratio is 1), the offset-0 reset skipped
    (the page keeps max(old, new) and its tokens are quantized under it),
    and a wrong page column (one row's table column pointing at a spare
    page). Timed on repeated writes of the same block (the steady state: no
    scale grows); the bound counts the valid tokens' bytes."""
    from mcp_context_forge_tpu_torch.tpu_local.kv import PagedKVState
    from mcp_context_forge_tpu_torch.tpu_local.kv.paged_cache import write_prefill_kv_plain
    from mcp_context_forge_tpu_torch.tpu_local.ops.kv_write import (kv_quant_store_span,
                                                                    kv_quant_store_span_ref)
    from mcp_context_forge_tpu_torch.tpu_local.quantize import kv_quantize

    gen = torch.Generator(device=dev).manual_seed(8)
    bf16 = torch.bfloat16
    KV, hd, PAGE, NUM_PAGES, P = 8, 128, 128, 1024, 64
    spare = NUM_PAGES - 1    # a page no row's table holds
    pool = {key: torch.randint(-127, 128, (NUM_PAGES, PAGE, KV, hd), generator=gen,
                               device=dev, dtype=torch.int8) for key in ("k_pages", "v_pages")}
    for key in ("k_scales", "v_scales"):
        pool[key] = ((torch.rand((NUM_PAGES, KV), generator=gen, device=dev) + 0.5) / 127).to(bf16)

    def copy(state: dict) -> dict:
        return {key: t.clone() for key, t in state.items()}

    cases = {   # (first positions, valid tokens, magnitudes, S) of each row
        # rows: reset, grows, no growth, crosses a page, padding, 2 tokens,
        # 3 tokens, offset 1
        "verify": ([3 * PAGE, 5 * PAGE + 37, 2 * PAGE + 90, 2 * PAGE + 126, 40,
                    7 * PAGE + 64, 9 * PAGE, 11 * PAGE + 1],
                   [4, 4, 4, 4, 0, 2, 3, 1], [0.5, 60.0, 1e-3, 1.0, 5.0, 1.0, 1.0, 1.0], 4),
        "prefill": ([0, 2 * PAGE + 37, 5 * PAGE + 127, 20 * PAGE + 64], [2048, 2011, 1029, 1],
                    [0.5, 60.0, 1e-3, 1.0], 2048),
    }
    runs = {}
    for case, (starts, n_valid, magnitude, S) in cases.items():
        B = len(starts)
        tables = torch.arange(1, 1 + B * P, dtype=torch.int32, device=dev).reshape(B, P)
        check(not bool((tables == spare).any()), "the spare page is in use")
        positions = torch.zeros((B, S), dtype=torch.int32)
        valid = torch.zeros((B, S), dtype=torch.bool)
        for b, (st, n) in enumerate(zip(starts, n_valid)):
            positions[b, :n] = torch.arange(st, st + n)
            valid[b, :n] = True
        positions, valid = positions.to(dev), valid.to(dev)
        scale = torch.tensor(magnitude, device=dev)[:, None, None, None]
        k, v = ((torch.randn((B, S, KV, hd), generator=gen, device=dev) * scale).to(bf16)
                for _ in range(2))
        slots = torch.arange(B, dtype=torch.int32, device=dev)
        first_page = [int(tables[b, st // PAGE]) for b, st in enumerate(starts)]
        start = copy(pool)
        for key in ("k_scales", "v_scales"):
            start[key][first_page[0]] = 1.0    # a large scale left by an earlier tenancy

        def kernel(state: dict, tables=tables) -> dict:
            kv_quant_store_span(state["k_pages"], state["v_pages"], state["k_scales"],
                                state["v_scales"], k, v, tables, slots, positions, valid)
            return state

        def plain(state: dict) -> dict:
            kv = PagedKVState(*(state[key][None] for key in ("k_pages", "v_pages")), tables,
                              state["k_scales"][None], state["v_scales"][None])
            write_prefill_kv_plain(kv, 0, k, v, slots, positions, valid)
            return state

        def model(state: dict) -> dict:
            kv_quant_store_span_ref(state["k_pages"], state["v_pages"], state["k_scales"],
                                    state["v_scales"], k, v, tables, slots, positions, valid)
            return state

        ref = plain(copy(start))
        out = kernel(copy(start))
        modelled = model(copy(start))
        torch.cuda.synchronize()
        diff = writer_diff(torch, out, ref)
        check(diff == 0, f"kv_quant_store_span ({case}): {diff} elements of pages >= 1 or "
                         f"their scales differ from the plain writer")
        check(writer_diff(torch, modelled, ref) == 0,
              f"kv_quant_store_span_ref ({case}) differs from the plain writer")
        grew = [b for b in range(B) if n_valid[b] and starts[b] % PAGE
                and not torch.equal(ref["k_scales"][first_page[b]], start["k_scales"][first_page[b]])]
        reset = bool((ref["k_scales"][first_page[0]] < 1.0).all())
        check(1 in grew and reset, f"kv_quant_store_span ({case}): the rows whose scale grew "
                                   f"are {grew}, the reset showed: {reset}")
        run = {"shape": {"pages": list(pool["k_pages"].shape), "scales": list(pool["k_scales"].shape),
                         "k": list(k.shape), "starts": starts, "valid_tokens": n_valid},
               "rows_whose_scale_grew": grew, "differing_elements": diff,
               "max_abs_err": max(float((out[key][1:].float() - ref[key][1:].float()).abs().max())
                                  for key in ref)}
        if case == "verify":
            faults = {}
            skip_requant = copy(start)
            for key in ("k_scales", "v_scales"):
                skip_requant[key][first_page[1]] = ref[key][first_page[1]]
            faults["row 1: the requantize skipped"] = kernel(skip_requant)
            no_reset = copy(out)
            n0 = n_valid[0]
            for name, x in (("k", k), ("v", v)):
                scales, pages = no_reset[f"{name}_scales"], no_reset[f"{name}_pages"]
                kept = torch.maximum(start[f"{name}_scales"][first_page[0]],
                                     ref[f"{name}_scales"][first_page[0]])
                scales[first_page[0]] = kept
                pages[first_page[0], :n0] = kv_quantize(x[0, :n0], kept[None, :, None])
            faults["row 0: the offset-0 reset skipped"] = no_reset
            wrong = tables.clone()
            wrong[2, starts[2] // PAGE] = spare
            faults["row 2: its page column read as a spare page"] = kernel(copy(start), wrong)
            torch.cuda.synchronize()
            planted = {}
            for fault, state in faults.items():
                n = writer_diff(torch, state, ref)
                check(n > 0, f"kv_quant_store_span: the bit check passes the planted fault {fault}")
                planted[fault] = {"differing_elements": n}
            run["planted_faults"] = planted
        steady = copy(ref)
        run.update(time_ms.both("kernel", lambda: kernel(steady)))
        plain_state = copy(ref)
        run["plain_ms"] = time_ms(lambda: plain(plain_state))
        check(writer_diff(torch, steady, plain_state) == 0,
              f"kv_quant_store_span ({case}): repeated writes differ from the plain writer's")
        tokens = sum(n_valid)
        pages_touched = sum(-(-(st % PAGE + n) // PAGE) for st, n in zip(starts, n_valid) if n)
        run["bytes"] = (2 * tokens * KV * hd * (2 + 1)           # K and V read in bf16, written in int8
                        + 2 * pages_touched * KV * 2 * 2         # each touched scale read and written
                        + B * S * (4 + 1) + B * (4 + 4))         # positions, valid, slot ids, table entries
        run["flops"] = 0
        run["bound_ms"], run["bound_by"] = bound(run["bytes"], 0)
        run["library_ms"] = None
        runs[case] = run
        del ref, out, modelled, steady, plain_state, start
    emit({"phase": "kv_span_write", "tolerance": "bit for bit on pages >= 1 and their scales",
          **runs})
    return {"kv_quant_store_span": runs["prefill"]}


def verify_shape_phase(torch, dev, time_ms) -> dict:
    """The paged chunk kernel (rows 2 and 2b) at the speculative verify's
    shape at Llama-3-8B width: q [8, 4, 8, 4, 128] bf16, each row's 4
    queries at the last positions of the decode phases' seq_lens (bf16
    pages: [512, 128, 8, 128], seq_lens 2000/1/0/129/300/777/128/1500;
    int8 pages: [1024, 128, 8, 128] with bf16 scales, seq_lens
    8000/1/0/6032/3000/129/4100/7777; a row of 1 has one real query, a
    row of 0 none). Each row within ROW_REL of the plain version; times,
    bounds and SDPA yardsticks."""
    from mcp_context_forge_tpu_torch.tpu_local.ops import paged_attention as paged

    gen = torch.Generator(device=dev).manual_seed(13)
    bf16 = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    KV, G, hd, PAGE, S = 8, 4, 128, 128, 4
    runs = {}
    for name, num_pages, seq_lens_list in (
            ("paged_chunk_attention_tc", 512, [2000, 1, 0, 129, 300, 777, 128, 1500]),
            ("paged_chunk_attention_tc_q8", 1024, [8000, 1, 0, 6032, 3000, 129, 4100, 7777])):
        B, P = len(seq_lens_list), -(-max(seq_lens_list) // PAGE)
        q8 = name.endswith("q8")
        if q8:
            k_pages, v_pages = (torch.randint(-127, 128, (num_pages, PAGE, KV, hd), generator=gen,
                                              device=dev, dtype=torch.int8) for _ in range(2))
            scales = tuple((torch.rand((num_pages, KV), generator=gen, device=dev) * 1.5 + 0.5)
                           .div(127).to(bf16) for _ in range(2))
        else:
            k_pages, v_pages = (torch.randn((num_pages, PAGE, KV, hd), generator=gen, device=dev)
                                .to(bf16) for _ in range(2))
            scales = ()
        tables = torch.zeros((B, P), dtype=torch.int32)
        nxt = 1
        for b, n in enumerate(seq_lens_list):
            tables[b, :-(-n // PAGE)] = torch.arange(nxt, nxt + -(-n // PAGE))
            nxt += -(-n // PAGE)
        check(nxt <= num_pages, "the test tables overflow the page pool")
        tables = tables.to(dev)
        pos = torch.tensor([[n - S + j if n - S + j >= 0 else -1 for j in range(S)]
                            for n in seq_lens_list], dtype=torch.int32, device=dev)
        q = torch.randn((B, S, KV, G, hd), generator=gen, device=dev).to(bf16)
        args = (q, k_pages, v_pages, tables, pos, *scales)
        kernel = getattr(paged, name)
        out = kernel(*args)
        ref = paged.paged_chunk_attention_ref(*args)
        torch.cuda.synchronize()
        valid = pos >= 0
        err, rel = compare_paged(torch, f"{name} at the verify shape", out, ref, valid)
        keys = [int(p.max()) + 1 for p in pos if int(p.max()) >= 0]
        pairs = int((pos[valid].long() + 1).sum())
        per_elem = 1 if q8 else 2
        nbytes = (2 * sum(keys) * KV * hd * per_elem
                  + (2 * sum(-(-n // PAGE) for n in keys) * KV * 2 if q8 else 0)
                  + 2 * q.numel() * 2 + tables.numel() * 4 + pos.numel() * 4)
        lib = sdpa_paged(torch, paged, q, k_pages, v_pages, tables,
                         lambda c: c[None, None, :] <= pos[:, :, None], scales)
        run = dict(shape={"q": list(q.shape), "pages": list(k_pages.shape),
                          "page_dtype": str(k_pages.dtype), "seq_lens": seq_lens_list},
                   max_abs_err=err, max_row_error=rel,
                   **time_ms.both("kernel", lambda: kernel(*args)),
                   plain_ms=time_ms(lambda: paged.paged_chunk_attention_ref(*args)),
                   library_ms=time_ms(lambda: sdpa(lib[0], lib[1], lib[2], attn_mask=lib[3])),
                   bytes=nbytes, flops=4 * hd * G * KV * pairs)
        run["bound_ms"], run["bound_by"] = bound(run["bytes"], run["flops"])
        runs[name] = run
        del lib, ref, out, k_pages, v_pages
    emit({"phase": "kernels_verify_shape", "tolerance": {"row_relative": ROW_REL}, **runs})
    return runs


def gemma_kernel_phase(torch, dev, time_ms) -> None:
    """The mma.sync chunk route at gemma-2b's geometry (KV 1, G 8, hd 256,
    page 128), where the wgmma kernel does not go: one row of 2048 queries,
    1944 real, over 32 history pages (the 6040-token prompt's last chunk
    round) on bf16 and on int8 pages, and 4 x 512 queries over 48, 24, 8
    and 0 history pages on bf16 pages. Each row is held to ROW_REL, with
    planted faults (a wrong history page; int8: V scales read 1.25x), timed
    beside its bound, its plain version and SDPA over K/V gathered (and
    dequantized) in advance."""
    from mcp_context_forge_tpu_torch.tpu_local.ops import paged_attention as paged

    gen = torch.Generator(device=dev).manual_seed(3)
    bf16 = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    KV, G, hd, PAGE, NUM_PAGES, P = 1, 8, 256, 128, 256, 64
    spare = NUM_PAGES - 1
    check(paged.chunk_route(bf16, hd, PAGE) == "mma", "hd 256 does not route to mma")
    pools = {
        "bf16": (torch.randn((NUM_PAGES, PAGE, KV, hd), generator=gen, device=dev).to(bf16),
                 torch.randn((NUM_PAGES, PAGE, KV, hd), generator=gen, device=dev).to(bf16), ()),
        "int8": tuple(torch.randint(-127, 128, (NUM_PAGES, PAGE, KV, hd), generator=gen,
                                    device=dev, dtype=torch.int8) for _ in range(2))
        + (tuple((torch.rand((NUM_PAGES, KV), generator=gen, device=dev) * 1.5 + 0.5)
                 .div(127).to(bf16) for _ in range(2)),)}
    runs = []
    for pages, hist_pages, S, n_valid in (("bf16", [32], 2048, [1944]),
                                          ("int8", [32], 2048, [1944]),
                                          ("bf16", [48, 24, 8, 0], 512, [512, 512, 512, 256])):
        kp, vp, scales = pools[pages]
        B = len(hist_pages)
        tables = torch.zeros((B, P), dtype=torch.int32)
        nxt = 1
        for b, (hp, n) in enumerate(zip(hist_pages, n_valid)):
            used = -(-(hp * PAGE + n) // PAGE)
            tables[b, :used] = torch.arange(nxt, nxt + used)
            nxt += used
        check(nxt <= spare, "the test tables overflow the page pool")
        tables = tables.to(dev)
        pos = torch.full((B, S), -1, dtype=torch.int32)
        for b, (hp, n) in enumerate(zip(hist_pages, n_valid)):
            pos[b, :n] = torch.arange(hp * PAGE, hp * PAGE + n)
        pos = pos.to(dev)
        q = torch.randn((B, S, KV, G, hd), generator=gen, device=dev).to(bf16)
        args = (q, kp, vp, tables, pos, *scales)
        name = "paged_chunk_attention_mma" + ("_q8" if scales else "")
        kernel = getattr(paged, name)
        out = kernel(*args)
        ref = paged.paged_chunk_attention_ref(*args)
        torch.cuda.synchronize()
        dispatch = paged.paged_chunk_attention_q8 if scales else paged.paged_chunk_attention
        check(torch.equal(dispatch(*args), out), f"the chunk dispatch does not take {name}")
        valid = pos >= 0
        err, rel = compare_paged(torch, f"{name} at gemma-2b's geometry", out, ref, valid)
        n_slots = -(-(hist_pages[0] * PAGE + n_valid[0]) // PAGE)
        planted = chunk_faults(torch, kernel, args, spare, 0, hist_pages[0] - 8, n_slots)
        if hist_pages[0] * PAGE > S:   # every query sees thousands of keys: one more moves
            planted = {k: v for k, v in planted.items() if not k.startswith("causal")}
        if scales:
            loud = scales[1].clone()
            loud[tables[0, 1:hist_pages[0] - 1].long()] *= 1.25
            planted[f"row 0: V scales of history pages 1-{hist_pages[0] - 2} read 1.25x"] = \
                kernel(q, kp, vp, tables, pos, scales[0], loud)
        faults = planted_faults(torch, name, planted, ref, valid)
        del ref, out, planted
        keys = [int(p.max()) + 1 for p in pos]
        pairs = int((pos[valid].long() + 1).sum())
        kv_bytes = 2 * sum(keys) * KV * hd * (1 if scales else 2)
        if scales:
            kv_bytes += 2 * sum(-(-n // PAGE) for n in keys) * KV * 2
        lib = sdpa_paged(torch, paged, q, kp, vp, tables,
                         lambda c: c[None, None, :] <= pos[:, :, None], scales)
        run = dict(
            kernel=name, shape={"q": list(q.shape), "pages": list(kp.shape),
                                "page_dtype": pages, "history_pages": hist_pages,
                                "valid_queries": n_valid},
            max_abs_err=err, max_row_error=rel, planted_faults=faults,
            **time_ms.both("kernel", lambda: kernel(*args)),
            plain_ms=time_ms(lambda: paged.paged_chunk_attention_ref(*args)),
            library_ms=time_ms(lambda: sdpa(lib[0], lib[1], lib[2], attn_mask=lib[3])),
            bytes=kv_bytes + 2 * q.numel() * 2 + tables.numel() * 4 + pos.numel() * 4,
            flops=4 * hd * G * KV * pairs)
        del lib
        run["bound_ms"], run["bound_by"] = bound(run["bytes"], run["flops"])
        runs.append(run)
    emit({"phase": "kernels_gemma_2b", "tolerance": {"atol": TOL, "rtol": TOL,
                                                     "row_relative": ROW_REL},
          "chunk_mma": runs})


def row_rms(torch, out, ref, rows) -> float:
    """The largest over ``rows`` of ||out - ref||_2 / ||ref||_2 within the
    row (see MOE_ROW_RMS)."""
    out, ref = out[rows].float().flatten(1), ref[rows].float().flatten(1)
    return float(((out - ref).norm(dim=1) / ref.norm(dim=1).clamp_min(1e-30)).max())


def moe_checks(torch, name: str, out, ref, rows) -> dict:
    """A grouped-expert output against its plain version: atol = rtol = TOL,
    each row within ROW_REL of its largest value and within MOE_ROW_RMS in
    norm."""
    err = compare(torch, out, ref, rows)
    rel, rms = row_error(torch, out, ref, rows), row_rms(torch, out, ref, rows)
    check(rel <= ROW_REL, f"{name}: a row is off by {rel:.3g} of its largest value")
    check(rms <= MOE_ROW_RMS, f"{name}: a row is off by {rms:.3g} in norm")
    return {"max_abs_err": err, "max_row_error": rel, "max_row_rms": rms}


def moe_faults(torch, name: str, faults: dict, ref, rows) -> dict:
    """Each planted fault's output against the right plain output: the
    checks of ``moe_checks`` must reject every one."""
    readings = {}
    for fault, out in faults.items():
        rel, rms = row_error(torch, out, ref, rows), row_rms(torch, out, ref, rows)
        check(rel > ROW_REL or rms > MOE_ROW_RMS,
              f"{name}: the row checks pass the planted fault {fault}")
        readings[fault] = {"row_error": rel, "row_rms": rms}
    return readings


def moe_kernel_phase(torch, dev, time_ms) -> dict:
    """Both routes of the grouped-expert kernels against their plain
    versions at Mixtral-8x7B widths (D 4096, F 14336, E 8, top-2, Bt 128) on
    T = 2048 bf16 tokens routed by a seeded random router: NB = 40 blocks.
    bf16 stacks [8, 4096, 14336] (2.8 GB), then the same stacks in int8 with
    bf16 scales. The tensor-core route (rows 4, 5) and the WMMA route on the
    same inputs, each held by ``moe_checks``; the tensor-core route must be
    deterministic and reject three planted faults (a wrong expert for one
    block, h's lo half dropped, int8: s2 read 1.25x). ``library_ms``: the
    same function by cuBLAS per expert (``torch.matmul`` over each expert's
    padded rows, x3, plus silu(a) * b; int8 stacks converted to bf16 and
    scaled after each product, as ``qmm`` does), not one call. Also times
    one expert-scan ``qmm`` (an [8, D] decode batch through one int8 [D, F]
    expert matrix) beside the bf16 matmul."""
    from mcp_context_forge_tpu_torch.tpu_local.ops import grouped_moe as gm
    from mcp_context_forge_tpu_torch.tpu_local.parallel.moe import router_probs
    from mcp_context_forge_tpu_torch.tpu_local.quantize import qmm, quantize_leaf

    D, F, E, K, T, Bt = 4096, 14336, 8, 2, 2048, 128
    bf16 = torch.bfloat16
    silu = torch.nn.functional.silu
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, fan_in=1):
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (w / math.sqrt(fan_in)).to(bf16)

    def stack(shape, fan_in):
        out = torch.empty((E, *shape), dtype=bf16, device=dev)
        for e in range(E):
            out[e] = randn(*shape, fan_in=fan_in)
        return out

    w1, w3, w2 = stack((D, F), D), stack((D, F), D), stack((F, D), F)
    router = randn(D, E, fan_in=D)
    x = randn(T, D)
    plan = gm.route_sorted_blocks(router_probs(router, x), K, Bt)
    be = plan["block_expert"]
    NB = be.numel()
    check(NB == -(-T * K // Bt) + E, f"NB is {NB}")
    check(gm.moe_route(bf16, Bt, D, F) == "tc", "Mixtral widths do not route to tc")
    x_pad = (x[plan["sorted_token"].long()]
             * plan["row_valid"][:, None].to(bf16)).reshape(NB, Bt, D)
    rows = plan["row_valid"].reshape(NB, Bt) > 0
    NP = NB * Bt
    flops = 6 * NP * D * F
    act_bytes = 2 * NP * D * 2 + NB * 4          # x_pad in, out out, owners
    per_expert = torch.bincount(be.long(), minlength=E).mul(Bt).tolist()
    shape = {"x_pad": [NB, Bt, D], "w1": [E, D, F], "w2": [E, F, D],
             "tokens": T, "top_k": K, "padded_rows_per_expert": per_expert}
    # blocks are sorted by expert: each expert's padded rows are one slice
    spans = [(sum(per_expert[:e]), sum(per_expert[:e + 1])) for e in range(E)]
    xf = x_pad.reshape(NP, D)
    wrong = be.clone()
    wrong[NB // 2] = (wrong[NB // 2] + 1) % E

    def library(up1, up3, down):
        out = torch.empty_like(xf)
        for e, (r0, r1) in enumerate(spans):
            if r1 > r0:
                xs = xf[r0:r1]
                out[r0:r1] = down(silu(up1(xs, e)) * up3(xs, e), e)
        return out

    def routes(name, args, ref, extra_faults):
        """Both routes on ``args``; the tensor-core one's faults."""
        tc, wmma = getattr(gm, f"expert_blocks_tc{name}"), getattr(gm, f"expert_blocks_wmma{name}")
        out = tc(*args)
        torch.cuda.synchronize()
        runs = {"tc": moe_checks(torch, f"expert_blocks_tc{name}", out, ref, rows)}
        check(torch.equal(out, tc(*args)), f"expert_blocks_tc{name} is not deterministic")
        dispatch = gm.expert_blocks_q8 if name else gm.expert_blocks
        check(torch.equal(dispatch(*args), out),
              f"expert_blocks{name} does not dispatch to expert_blocks_tc{name}")
        h = torch.empty((2, NP, F), dtype=bf16, device=dev)
        tc(*args, phases=1, h=h)
        h[1].zero_()
        runs["tc"]["planted_faults"] = moe_faults(torch, f"expert_blocks_tc{name}", {
            f"block {NB // 2} read with expert {int(wrong[NB // 2])} for {int(be[NB // 2])}":
            tc(args[0], *args[1:4], wrong),
            "h's lo half dropped: the down-projection over hi alone": tc(*args, phases=2, h=h),
            **{k: fn() for k, fn in extra_faults.items()}}, ref, rows)
        del h, out
        out = wmma(*args)
        torch.cuda.synchronize()
        runs["wmma"] = moe_checks(torch, f"expert_blocks_wmma{name}", out, ref, rows)
        check(torch.equal(out, wmma(*args)), f"expert_blocks_wmma{name} is not deterministic")
        del out
        for route, fn in (("tc", tc), ("wmma", wmma)):
            runs[route].update(time_ms.both("kernel", lambda: fn(*args)))
        return runs

    # the tensor-core route's other instantiations at a small shape: blocks
    # of 64 rows (one warpgroup per CTA) and 128, SiLU and GeLU, bf16 and
    # int8 stacks, three experts owning 1, 2 and 3 of six blocks
    tc_geometries = []
    for Bt_g in (64, 128):
        for q8 in (False, True):
            for act in ("silu", "gelu"):
                Dg, Fg, Eg = 512, 384, 3
                xg = randn(6, Bt_g, Dg)
                beg = torch.tensor([0, 1, 1, 2, 2, 2], dtype=torch.int32, device=dev)
                wg = [randn(Eg, Dg, Fg, fan_in=Dg), randn(Eg, Dg, Fg, fan_in=Dg),
                      randn(Eg, Fg, Dg, fan_in=Fg)]
                if q8:
                    leaves = [[quantize_leaf(w[e], 0, bf16) for e in range(Eg)] for w in wg]
                    wg = [{k: torch.stack([leaf[k] for leaf in ls]) for k in ("q", "s")}
                          for ls in leaves]
                    out = gm.expert_blocks_tc_q8(xg, *wg, beg, act)
                    ref_g = gm.expert_blocks_q8_ref(xg, *wg, beg, act)
                else:
                    out = gm.expert_blocks_tc(xg, *wg, beg, act)
                    ref_g = gm.expert_blocks_ref(xg, *wg, beg, act)
                torch.cuda.synchronize()
                tc_geometries.append({"Bt": Bt_g, "int8": q8, "act": act, **moe_checks(
                    torch, f"expert_blocks_tc Bt {Bt_g} int8 {q8} {act}", out, ref_g,
                    torch.ones((6, Bt_g), dtype=torch.bool, device=dev))})

    results = {}
    args = (x_pad, w1, w3, w2, be)
    ref = gm.expert_blocks_ref(*args)
    runs = routes("", args, ref, {})
    del ref
    plain_ms = time_ms(lambda: gm.expert_blocks_ref(*args))
    library_ms = time_ms(lambda: library(lambda xs, e: xs @ w1[e], lambda xs, e: xs @ w3[e],
                                         lambda h, e: h @ w2[e]))
    for route, run in runs.items():
        results[f"expert_blocks_{route}"] = dict(
            shape=shape, dtype="bfloat16", **run, plain_ms=plain_ms,
            library_ms=library_ms, library="cuBLAS per expert (3 matmuls + silu(a)*b), not one call",
            flops=flops, bytes=act_bytes + 3 * E * D * F * 2)

    def quantize(w):   # per expert, as the engine's int8 init does
        q = torch.empty(w.shape, dtype=torch.int8, device=dev)
        s = torch.empty((E, w.shape[2]), dtype=bf16, device=dev)
        for e in range(E):
            leaf = quantize_leaf(w[e], 0, bf16)
            q[e], s[e] = leaf["q"], leaf["s"]
        return {"q": q, "s": s}

    q1, q3, q2 = quantize(w1), quantize(w3), quantize(w2)
    x8 = x[:8].contiguous()
    w_one, q_one = w1[0].contiguous(), {"q": q1["q"][0], "s": q1["s"][0]}
    qmm_cost = {"x": [8, D], "w": [D, F],
                "int8_qmm_ms": time_ms(lambda: qmm(x8, q_one)),
                "bf16_matmul_ms": time_ms(lambda: x8 @ w_one),
                "int8_bound_ms": bound(D * F + F * 2 + 2 * 8 * (D + F) * 2,
                                       2 * 8 * D * F)[0]}
    del w1, w3, w2, w_one, args
    free_device(torch)

    args = (x_pad, q1, q3, q2, be)
    ref = gm.expert_blocks_q8_ref(*args)
    loud = dict(q2, s=q2["s"] * 1.25)
    runs = routes("_q8", args, ref, {"s2 read 1.25x": lambda: gm.expert_blocks_tc_q8(
        x_pad, q1, q3, loud, be)})
    del ref, loud
    plain_ms = time_ms(lambda: gm.expert_blocks_q8_ref(*args))
    library_ms = time_ms(lambda: library(
        lambda xs, e: (xs @ q1["q"][e].to(bf16)) * q1["s"][e],
        lambda xs, e: (xs @ q3["q"][e].to(bf16)) * q3["s"][e],
        lambda h, e: (h @ q2["q"][e].to(bf16)) * q2["s"][e]))
    for route, run in runs.items():
        results[f"expert_blocks_{route}_q8"] = dict(
            shape=shape, dtype="bfloat16 activations, int8 stacks, bf16 scales", **run,
            plain_ms=plain_ms, library_ms=library_ms,
            library="cuBLAS per expert on int8 stacks converted to bf16, not one call",
            flops=flops, bytes=act_bytes + 3 * E * D * F + (2 * E * F + E * D) * 2)
    for run in results.values():
        run["bound_ms"], run["bound_by"] = bound(run["bytes"], run["flops"])
    emit({"phase": "moe_kernels",
          "tolerance": {"atol": TOL, "rtol": TOL, "row_relative": ROW_REL,
                        "row_rms": MOE_ROW_RMS},
          **results, "tc_geometries": tc_geometries, "dense_scan_qmm": qmm_cost})
    return results


def model_check(torch, dev, name: str, quant: str = "",
                moe: dict | None = None, kv_quant: str = "") -> dict:
    """A tiny f32 model, the same weights on the card (kernels) and on the
    CPU (plain versions): cold prefill, prefix-hit suffix prefill and decode
    logits agree within 1e-3 (f32 both sides; summation order differs).
    ``moe`` overrides the MoE formulation; the grouped kernels must then
    launch on the card (f32 activations: the WMMA route). The mma.sync flash
    and chunk kernels (f32) and the decode kernel must launch on the card.
    ``kv_quant="int8"`` stores the KV pool as int8 pages (the CPU side reads
    them through ``gather_kv``); both int8-page kernels and the int8 decode
    writer must then launch on the card. Returns every kernel's launches over the card's run (the
    counts are set to 0 just before it). Quantization is not continuous:
    the two sides' int8 pools may differ by isolated one-step rounding
    flips (checked: never more), and a stage's logits read the pages that
    stage writes, so the logits are compared against the plain path
    replayed on the pages the card stored: before each stage the CPU pool
    is loaded with the card's pool after it, and the model's KV writers
    are replaced for the stage by ones that write nothing (checked: the
    pool is unchanged after it)."""
    from unittest import mock

    from mcp_context_forge_tpu_torch.tpu_local.kv import init_kv_state
    from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS
    from mcp_context_forge_tpu_torch.tpu_local.models import llama

    cfg = dataclasses.replace(MODEL_CONFIGS[name], **(moe or {}))
    params_cpu = llama.init_params(cfg, torch.Generator().manual_seed(0),
                                   torch.float32, "cpu", quant=quant)
    wrappers = kernel_wrappers()
    expert_kernel = "expert_blocks_wmma_q8" if quant else "expert_blocks_wmma"
    attention = (("flash_attention_mma", "paged_chunk_attention_mma_q8",
                  "paged_decode_attention_q8") + INT8_WRITERS
                 if kv_quant else ATTENTION_MMA)

    def to(tree, device):
        if isinstance(tree, dict):
            return {k: to(v, device) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, device) for v in tree]
        return tree.to(device)

    ids = torch.arange(2 * 96, dtype=torch.int64).reshape(2, 96) % cfg.vocab_size
    pos = torch.arange(64, dtype=torch.int32).repeat(2, 1)
    pos[1, 50:] = -1
    hpos = torch.arange(64, 96, dtype=torch.int32).repeat(2, 1)
    hpos[1] = torch.arange(50, 82)
    slots = torch.tensor([0, 1])
    stages = (   # (part, fn(params, kv, device) -> logits)
        ("prefill", lambda w, kv, d: llama.prefill(
            w, cfg, ids[:, :64].to(d), pos.to(d), kv, slots.to(d))[0][(pos >= 0).to(d)]),
        ("history", lambda w, kv, d: llama.prefill_with_history(
            w, cfg, ids[:, 64:].to(d), hpos.to(d), kv, slots.to(d))[0].flatten(0, 1)),
        ("decode", lambda w, kv, d: llama.decode_step(
            w, cfg, ids[:, 0].to(d), torch.tensor([96, 82], dtype=torch.int32).to(d),
            kv, slots.to(d), torch.tensor([97, 83], dtype=torch.int32).to(d))[0]))
    pool_names = ("k_pages", "v_pages", "k_scales", "v_scales") if kv_quant else ()

    def run(device, replay=None):
        """The three stages on ``device``; the logits and the pool after
        each stage. ``replay``: load the card's pool after each stage and
        do not write, so the plain path reads the pages the card stored."""
        params = params_cpu if device == "cpu" else to(params_cpu, device)
        kv = init_kv_state(cfg, 16, 16, 2, 8, dtype=torch.float32, device=device,
                           quant=kv_quant)
        kv.block_tables.copy_(torch.tensor([[1, 2, 3, 4, 5, 6, 7, 8],
                                            [9, 10, 11, 12, 13, 14, 15, 0]],
                                           dtype=torch.int32))
        outs, pools = {}, []
        for i, (part, fn) in enumerate(stages):
            if replay is None:
                outs[part] = fn(params, kv, device).cpu()
            else:
                for key in pool_names:
                    getattr(kv, key).copy_(replay[i][key])
                # mock.patch raises if llama no longer holds these names
                with mock.patch.object(llama, "write_prefill_kv", lambda kv, *a: kv), \
                        mock.patch.object(llama, "write_decode_kv", lambda kv, *a, **k: kv):
                    outs[part] = fn(params, kv, device).cpu()
                check(all(torch.equal(getattr(kv, key), replay[i][key]) for key in pool_names),
                      f"{name}: the {part} replay wrote to the pool")
            pools.append({key: getattr(kv, key).to("cpu", copy=True) for key in pool_names})
        return outs, pools

    for fn in wrappers.values():
        fn.launches = 0
    card, card_pools = run(dev)
    counts = {k: fn.launches for k, fn in wrappers.items()}
    if moe:
        check(counts[expert_kernel] > 0, f"{name}: the grouped expert kernel never launched")
    for kernel in attention:
        check(counts[kernel] > 0, f"{name}: {kernel} never launched")
    cpu, cpu_pools = run("cpu")
    stored = {}
    if kv_quant:
        # the writers: the card's and the CPU's f32 GEMMs differ in the last
        # bits, so a key within that of a rounding boundary is stored one
        # int8 step apart; nothing may differ by more, and the scales (page
        # maxima) agree. The trash page 0 is not compared.
        for key in pool_names:
            x, y = card_pools[-1][key][:, 1:], cpu_pools[-1][key][:, 1:]
            if key.endswith("pages"):
                diff = (x.int() - y.int()).abs()
                check(int(diff.max()) <= 1, f"{key} differ by more than one step")
                stored[key + "_one_step_flips"] = int(diff.count_nonzero())
                stored[key + "_elements"] = diff.numel()
            else:
                torch.testing.assert_close(x, y, atol=1e-6, rtol=1e-3)
        # the kernels: the plain path on the pages the card stored
        cpu, _ = run("cpu", replay=card_pools)
    errs = {}
    for part in card:
        x, y = card[part], cpu[part]
        check(torch.isfinite(x).all(), f"non-finite {part} logits on the card")
        torch.testing.assert_close(x, y, atol=1e-3, rtol=1e-3)
        errs[part] = float((x - y).abs().max())
    emit({"phase": "model", "config": name, "dtype": "float32",
          "quant": quant or "none", "kv_quant": kv_quant or "none", "moe": moe,
          "max_abs_err": errs, **({"int8_storage": stored} if kv_quant else {}),
          "launches": counts})
    return counts


SYSTEM = ("You are the assistant of an MCP gateway. Use only the tools "
          "listed for this conversation and follow their JSON schemas exactly. "
          "Name the server that answered each tool call. Keep answers "
          "short and plain. Never invent a tool, a server or a result. "
          "When a tool fails, say which one failed and why, then stop. "
          "Ask before any call that writes, deletes or sends data. "
          "Prefer read-only tools when two tools can answer.")


def chat(model: str, user: str, system_prompt: str | None = None) -> dict:
    messages = [{"role": "user", "content": user}]
    if system_prompt:
        messages.insert(0, {"role": "system", "content": system_prompt})
    return {"model": model, "max_tokens": 32, "temperature": 0,
            "messages": messages}


def chat_requests(model: str) -> list[dict]:
    """Two share SYSTEM (the second, index 1, hits the prefix cache), a
    ~1450-token log summary (the 2048 bucket), three short chats."""
    long_doc = " ".join(f"line {i}: the tool returned status ok." for i in range(37))
    return [chat(model, "Which tools can read files?", SYSTEM),
            chat(model, "Summarize the last failure.", SYSTEM),
            chat(model, "Summarize this log:\n" + long_doc),
            chat(model, "Hello!"), chat(model, "List three MCP servers."),
            chat(model, "What is 2 + 2?")]


def extraction_request(model: str) -> dict:
    """An extraction-style request, whose reply should echo its prompt:
    the lines of a tool log that name one server, copied as they are."""
    log = "\n".join(f"tool call {i % 7} on server s{i % 3} returned status ok."
                    for i in range(24))
    return chat(model, "Copy every line below that names server s1, exactly as "
                       "written, one per line:\n" + log)


def long_context_requests(model: str) -> list[dict]:
    """Summaries of a ~6000- and a ~3000-token log at indices 1 and 2, led
    only by the first SYSTEM request so that one admission takes both into
    the chunk rounds; the SYSTEM prefix hit at index 3; two short chats."""
    def log(lines: int) -> str:
        return "\n".join(f"line {i}: tool call {i % 17} on server s{i % 5} "
                         f"returned status ok in {i % 97} ms." for i in range(lines))

    return [chat(model, "Which tools can read files?", SYSTEM),
            chat(model, "Summarize this log:\n" + log(95)),
            chat(model, "Summarize this log:\n" + log(48)),
            chat(model, "Summarize the last failure.", SYSTEM),
            chat(model, "Hello!"), chat(model, "What is 2 + 2?")]


def check_long_context(stats: dict, pool_pages: int, page_dtype: str) -> None:
    """A long-context phase: both summaries chunked, and the pool holds
    ``pool_pages`` pages of ``page_dtype`` (1023 int8 pages in the bytes of
    512 bf16 ones, or 512 bf16 pages)."""
    lengths = stats["prompt_tokens"][1:3]
    check(lengths[0] >= 6000 and 3000 <= lengths[1] < 4096,
          f"the long prompts have {lengths} tokens")
    check(all(stats["chunked"][1:3]), "a long prompt was not chunked")
    check(stats["kv_pages"] == stats["kv_pool_pages"] == pool_pages
          and stats["kv_page_dtype"] == page_dtype,
          f"the pool holds {stats['kv_pool_pages']} {stats['kv_page_dtype']} pages, "
          f"not {pool_pages} {page_dtype}")


def graph_against_eager(torch, engine) -> dict:
    """One greedy replay's inputs given to the eager ``_decode_and_sample``
    on the same pool (restored to its state before the replay): eight
    columns over real pages of the engine's pool, one of them empty. The
    greedy tokens and valid masks must be equal, and each active row's
    last logits within ROW_REL of its largest value. The engine is
    stopped; this is the one eager decode on the card, on purpose."""
    from mcp_context_forge_tpu_torch.tpu_local.decode_graphs import (BUDGETS, POSITIONS,
                                                                     SEQ_LENS, TOKENS,
                                                                     GraphKey)

    K, B = engine._k, engine.config.max_batch
    key = GraphKey("decode", K, B, False)
    bufs = engine._graphs.get(key)
    lens = ([1500, 37, 800, 128, 0, 300, 1990, 64] * B)[:B]
    gen = torch.Generator().manual_seed(11)
    pack = engine._graphs.stage(key)
    for slot, n in enumerate(lens):
        if n:
            check(engine.allocator.allocate_slot(slot, n + K), "no pages for the check")
            pack[TOKENS, slot] = int(torch.randint(0, engine.model_config.vocab_size, (1,),
                                                   generator=gen))
            pack[POSITIONS, slot], pack[SEQ_LENS, slot], pack[BUDGETS, slot] = n - 1, n, K
    kv = engine.kv
    pool = [t for t in (kv.k_pages, kv.v_pages, kv.k_scales, kv.v_scales) if t is not None]
    with torch.inference_mode():
        engine._sync_tables()
        saved = [t.clone() for t in pool]
        tokens_g, valid_g, _ = engine._graphs.fetch(engine._graphs.launch(key))
        logits_g = bufs.logits.clone()
        for t, copy in zip(pool, saved):
            t.copy_(copy)
        del saved
        tokens_e, valid_e, _, logits_e = engine._decode_and_sample(*bufs.views(), k=K,
                                                                   any_sampled=False)
        torch.cuda.synchronize()
    for slot in range(B):
        engine.allocator.free_slot(slot)
    active = torch.tensor(lens) > 0
    check(bool((torch.from_numpy(valid_g) == valid_e.cpu()).all()),
          "graph and eager decode differ in their valid masks")
    check(bool((torch.from_numpy(tokens_g)[:, active]
                == tokens_e.cpu().to(torch.int32)[:, active]).all()),
          "graph and eager decode sampled different greedy tokens")
    rel = row_error(torch, logits_g, logits_e, active.to(logits_g.device))
    check(rel <= ROW_REL, f"graph and eager logits differ by {rel:.3g} of a row's largest value")
    return {"key": list(key), "seq_lens": lens, "tokens_equal": True,
            "logits_max_row_error": rel,
            "logits_max_abs_err": float((logits_g - logits_e)[active.to(logits_g.device)]
                                        .abs().max())}


def verify_against_eager(torch, engine) -> dict:
    """One greedy verify replay's inputs given to the eager
    ``_verify_and_sample`` on the same pool (restored to its state before
    the replay): eight rows over real pages of the engine's pool, chunks of
    4, 4, 3, 4, 0 (an empty row), 1, 4 and 2 tokens after histories of
    1500 down to 37 tokens. The logits must be bit-identical and the
    tokens equal. Then, on bf16 or f32 pages, each chunk position's logits
    against an eager ``decode_step`` over the same prefix (the pool
    restored once more; the chunk's tokens decoded one at a time): an f32
    engine holds each active row within F32_ROW_REL of its largest value
    (the chunk's and the step's projections and attention sum in other
    orders); a bf16 engine's distance is reported, not held: bf16 rounds
    those two orders apart by about 1 % of a row's largest value per layer
    of random weights (0.0100 at one layer, 0.0191 at four, 0.0544 at 32
    of llama3-8b on an H100, where f32 reads 1.3e-5 and 2.1e-5). Not on
    int8 pages, where the two store other values: the verify quantizes its
    chunk under the page's final scale, decode one token at a time with
    requantization (0.025 of a row's largest value apart in f32 on the
    CPU at llama3-test). The engine is stopped; these are the
    eager verify and decode on the card, on purpose. Also times the replay
    alone (CUDA events around it, and the host's wall from upload to read
    back)."""
    from mcp_context_forge_tpu_torch.tpu_local.decode_graphs import (V_TOKENS, GraphKey)
    from mcp_context_forge_tpu_torch.tpu_local.models.llama import decode_step

    K, B = engine.config.spec_k, engine.config.max_batch
    key = GraphKey("verify", K, B, False)
    bufs = engine._graphs.get(key)
    hist = ([1500, 37, 800, 128, 0, 300, 1990, 64] * B)[:B]
    widths = ([4, 4, 3, 4, 0, 1, 4, 2] * B)[:B]
    gen = torch.Generator().manual_seed(12)
    pack = engine._graphs.stage(key)
    tokens = torch.randint(0, engine.model_config.vocab_size, (B, K), generator=gen)
    positions = torch.full((B, K), -1, dtype=torch.int32)
    for slot, (n, w) in enumerate(zip(hist, widths)):
        if w:
            check(engine.allocator.allocate_slot(slot, n + w), "no pages for the check")
            positions[slot, :w] = torch.arange(n, n + w)
            pack[V_TOKENS:V_TOKENS + w, slot] = tokens[slot, :w].numpy()
            pack[V_TOKENS + K:V_TOKENS + K + w, slot] = positions[slot, :w].numpy()
    kv = engine.kv
    pool = [t for t in (kv.k_pages, kv.v_pages, kv.k_scales, kv.v_scales) if t is not None]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with torch.inference_mode():
        engine._sync_tables()
        saved = [t.clone() for t in pool]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        start.record()
        handle = engine._graphs.launch(key)
        end.record()
        tokens_g = engine._graphs.fetch_verify(handle)
        wall_ms = (time.monotonic() - t0) * 1e3
        logits_g = bufs.logits.clone()
        for t, copy in zip(pool, saved):
            t.copy_(copy)
        tokens_e, logits_e = engine._verify_and_sample(*bufs.verify_views(), any_sampled=False)
        for t, copy in zip(pool, saved):
            t.copy_(copy)
        del saved
        dev = logits_e.device
        valid = (positions >= 0).to(dev)
        steps = []
        for j in range(0 if kv.quantized else K):
            pos = positions[:, j].to(dev)
            live = valid[:, j]
            logits_d, _ = decode_step(
                engine.params, engine.model_config, tokens[:, j].to(dev),
                torch.where(live, pos, 0), kv, bufs.slot_ids,
                torch.where(live, pos + 1, 0), write_mask=live)
            steps.append(logits_d)
        torch.cuda.synchronize()
    for slot in range(B):
        engine.allocator.free_slot(slot)
    check(torch.equal(logits_g, logits_e), "graph and eager verify logits differ")
    check(bool((torch.from_numpy(tokens_g)[valid.cpu()]
                == tokens_e.cpu().to(torch.int32)[valid.cpu()]).all()),
          "graph and eager verify sampled different greedy tokens")
    result = {"key": list(key), "history": hist, "chunk_widths": widths,
              "logits_bit_identical": True, "tokens_equal": True,
              "replay_device_ms": start.elapsed_time(end), "replay_wall_ms": wall_ms}
    if steps:
        logits_d = torch.stack(steps, dim=1)     # [B, K, V]
        rel = row_error(torch, logits_e, logits_d, valid)
        if engine.dtype == torch.float32:
            check(rel <= F32_ROW_REL,
                  f"verify and decode logits differ by {rel:.3g} of a row's largest value")
        result.update(against_decode_max_row_error=rel,
                      against_decode_max_abs_err=float((logits_e - logits_d)[valid].abs().max()))
    return result


def verify_against_decode_f32(torch, dev, layers: int = 4) -> dict:
    """``verify_against_eager`` on a spec engine of llama3-8b's width in f32
    (``layers`` deep, its pool filled with random values so the histories
    matter): the verify's logits held to the decode step's within
    F32_ROW_REL per row, the check that a bf16 engine cannot take."""
    from mcp_context_forge_tpu_torch.tpu_local.engine import EngineConfig, TorchEngine
    from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS

    name = f"llama3-8b-{layers}-layers"
    MODEL_CONFIGS[name] = dataclasses.replace(MODEL_CONFIGS["llama3-8b"], name=name,
                                              n_layers=layers)
    engine = TorchEngine(EngineConfig(model=name, dtype="float32", device="cuda",
                                      max_batch=8, max_seq_len=2048, page_size=128,
                                      num_pages=256, spec_decode=True))
    gen = torch.Generator(device=dev).manual_seed(3)
    for pages in (engine.kv.k_pages, engine.kv.v_pages):
        pages.copy_(torch.randn(pages.shape, generator=gen, device=dev))
    result = verify_against_eager(torch, engine)
    check("against_decode_max_row_error" in result, "the f32 verify was not held to decode")
    del engine
    return {"model": name, "dtype": "float32", **result}


def engine_phase(torch, dev, model: str, kernels: tuple[str, ...],
                 requests: list[dict], hit: int, absent: tuple[str, ...] = (),
                 n_layers: int = 0, graph_check: bool = False, handles: dict | None = None,
                 on_first_tokens=None, after=None, send=None, **engine_kwargs):
    """``requests`` sent concurrently as greedy chats through
    ``TorchLocalProvider.chat`` on ``model`` (random weights, bf16), then
    ``requests[hit]`` twice more, which must give the same tokens. The
    first request runs alone until its prefix is registered, so that
    ``requests[hit]``, which shares its system prompt, hits the cache.
    ``n_layers`` cuts the depth; ``engine_kwargs`` override the engine
    config. Every kernel's count is reset just before the concurrent
    requests and read just after; each of ``kernels`` must have launched,
    and none of ``absent`` (nor the int8 KV writers on a pool that is not
    int8), and the plain int8 writer (``_quant_store``) never ran.

    Decode and verify run only as CUDA-graph replays: ``decode_step`` is
    called only while the engine is built (warm-up and capture: 2 K calls
    per decode graph), one decode graph per (K, width, greedy-only or
    sampling) and, with ``spec_decode``, one verify graph per greedy-only
    or sampling, and never while it serves. Every launch is accounted for:
    the decode kernels' launches equal the sum over the graphs of replays
    x the graph's launches of them; the chunk kernels', flash's and the
    int8 span writer's equal that plus their eager launches, one per
    layer per call: flash per cold prefill, the chunk kernel per history
    prefill (a chunk round or a prefix-hit suffix), the span writer (int8
    pools) per either. ``graph_check`` runs ``graph_against_eager`` after
    the requests, and ``verify_against_eager`` on a spec engine.

    Kernel builds and graph captures (``compile_stats``): the construction's
    captures are warmup-stage events, one per graph, and the phase builds
    no kernel and captures no graph while it serves. ``handles`` (telemetry
    handles) go to the engine and the provider; ``on_first_tokens(engine)``
    (a function or a coroutine function) runs once every request has
    streamed its first token, and ``after(engine)`` once the requests are
    served and the engine stopped; their results are the stats'
    ``on_first_tokens`` and ``after``. ``send(provider, request)`` sends
    each request in place of ``provider.chat(request)``."""
    from unittest import mock

    from mcp_context_forge_tpu_torch.tpu_local import engine as engine_module
    from mcp_context_forge_tpu_torch.tpu_local.engine import EngineConfig, TorchEngine
    from mcp_context_forge_tpu_torch.tpu_local.kv import paged_cache
    from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS
    from mcp_context_forge_tpu_torch.tpu_local.tpu_provider import TorchLocalProvider

    name = model
    if n_layers:
        name = f"{model}-{n_layers}-layers"
        MODEL_CONFIGS[name] = dataclasses.replace(MODEL_CONFIGS[model],
                                                  name=name, n_layers=n_layers)
    wrappers = kernel_wrappers()
    calls = dict.fromkeys(("decode", "prefill", "history", "quant_store", "sp_prefill"), 0)

    def counted(kind, fn):
        def wrapped(*args, **kwargs):
            # a sequence-parallel prefill's attention is the ring or
            # Ulysses, not the flash kernel
            sp = kind == "prefill" and kwargs.get("attn_impl") in ("ring", "ulysses")
            calls["sp_prefill" if sp else kind] += 1
            return fn(*args, **kwargs)
        return wrapped

    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    config = dict(model=name, dtype="bfloat16", device="cuda", max_batch=8,
                  max_seq_len=2048, page_size=128, num_pages=512,
                  prefill_buckets=(128, 512, 2048), prefill_max_batch=4, seed=0)
    # the engine module's own names, which its decode super-step, verify,
    # admission and chunk rounds call
    with mock.patch.object(engine_module, "decode_step",
                           counted("decode", engine_module.decode_step)):
        engine = TorchEngine(EngineConfig(**{**config, **engine_kwargs}), **(handles or {}))
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    build_peak = torch.cuda.max_memory_allocated()
    build_decode_calls, calls["decode"] = calls["decode"], 0
    graphs = engine._graphs
    K = engine.config.fused_steps
    rungs = engine.config.k_rungs()
    spec = engine.config.spec_decode
    widths = engine._batch_buckets() if engine.config.batch_buckets else [engine.config.max_batch]
    decode_graphs = 2 * len(widths) * len(rungs)
    check(engine.stats.graph_captures == len(graphs.buffers)
          == decode_graphs + (2 if spec else 0),
          f"{engine.stats.graph_captures} graphs captured for {len(widths)} widths, "
          f"K rungs {rungs}{' and the verify' if spec else ''}")
    check(build_decode_calls == 2 * len(widths) * 2 * sum(rungs),
          f"decode_step ran {build_decode_calls} times while the engine was built")
    built = engine.compile_stats()
    check(built["warmup"]["graph_capture"] == engine.stats.graph_captures
          and built["warmup"]["kernel_build"] == 0 and built["serving"]["count"] == 0,
          f"the construction's events are not its {engine.stats.graph_captures} captures: "
          f"{built}")
    if not engine.config.kv_quant:
        absent = absent + INT8_WRITERS
    provider = TorchLocalProvider("tpu_local", engine, tracer=(handles or {}).get("tracer"),
                                  metrics=(handles or {}).get("metrics"))
    seen = []
    submit = engine.submit

    async def recording_submit(request):
        seen.append(request)
        return await submit(request)

    engine.submit = recording_submit
    check(len(engine.tokenizer.encode(SYSTEM)) >= 300,
          "the shared system prompt is under 300 tokens")

    def chat_one(request):
        return send(provider, request) if send is not None else provider.chat(request)

    async def run():
        await engine.start()
        try:
            for fn in wrappers.values():
                fn.launches = 0
            for kind in calls:
                calls[kind] = 0
            replays0 = {key: bufs.replays for key, bufs in graphs.buffers.items()}
            torch.cuda.reset_peak_memory_stats()
            stats0 = dict(engine.stats.__dict__)
            t_start = time.monotonic()
            first = asyncio.ensure_future(chat_one(requests[0]))
            while engine.allocator.cached_pages == 0:  # its prefix registered
                check(not first.done(), "the first request ended before its prefix registered")
                await asyncio.sleep(0.005)
            rest = [asyncio.ensure_future(chat_one(r)) for r in requests[1:]]
            watch = None
            if on_first_tokens is not None:
                async def first_tokens():
                    while len(seen) < len(requests) or any(
                            r.first_token_ts == 0.0 for r in seen[:len(requests)]):
                        await asyncio.sleep(0.001)
                    out = on_first_tokens(engine)
                    return await out if asyncio.iscoroutine(out) else out
                watch = asyncio.ensure_future(first_tokens())
            replies = await asyncio.wait_for(asyncio.gather(first, *rest), 600)
            knob = await watch if watch is not None else None
            wall = time.monotonic() - t_start
            counts = {k: fn.launches for k, fn in wrappers.items()}
            served_calls = dict(calls)
            replays = {key: bufs.replays - replays0[key] for key, bufs in graphs.buffers.items()}
            peak = torch.cuda.max_memory_allocated()
            served = list(seen)
            delta = {k: v - stats0[k] for k, v in engine.stats.__dict__.items()}
            for _ in range(2):
                await chat_one(requests[hit])
            repeats = seen[-2:]
            return (replies, wall, counts, served_calls, replays, peak, served, delta, knob,
                    repeats)
        finally:
            # a multi-rank engine keeps its group (and graphs) for the
            # checks below; close_ranks ends it after them
            await engine.stop(keep_group=True)

    with mock.patch.object(engine_module, "prefill_with_history",
                           counted("history", engine_module.prefill_with_history)), \
            mock.patch.object(engine_module, "prefill",
                              counted("prefill", engine_module.prefill)), \
            mock.patch.object(engine_module, "decode_step",
                              counted("decode", engine_module.decode_step)), \
            mock.patch.object(paged_cache, "_quant_store",
                              counted("quant_store", paged_cache._quant_store)):
        replies, wall, counts, served_calls, replays, peak, served, delta, knob, repeats = \
            asyncio.run(run())
        compiles = engine.compile_stats()
        prefix_hits = engine.allocator.prefix_hits   # before ``after`` may restart it
        try:
            after_result = after(engine) if after is not None else None
            eager = graph_against_eager(torch, engine) if graph_check else None
            verify = verify_against_eager(torch, engine) if spec else None
        finally:
            engine.close_ranks()
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    check(max(peak, build_peak) < card_bytes,
          f"peak memory {max(peak, build_peak)} exceeds the card's {card_bytes}")
    n = len(requests)
    check(len(replies) == n and len(served) == n, "not every request was served")
    for request in served:
        check(request.finish_reason in ("stop", "length"),
              f"a request ended with {request.finish_reason!r}")
        check(all(0 <= t < engine.model_config.vocab_size for t in request.generated),
              "a generated token id is outside the vocabulary")
    check(compiles["serving"]["kernel_build"] == compiles["serving"]["graph_capture"] == 0,
          f"kernels built or graphs captured while serving: {compiles['serving']}")
    check(prefix_hits >= 1, "no prefix hit")
    check(served[hit].hist > 0, "the request sharing the system prompt missed the cache")
    tokens_a, tokens_b = (r.generated for r in repeats)
    check(tokens_a == tokens_b, "repeated greedy request changed its tokens")
    for kernel in kernels:
        check(counts[kernel] > 0, f"{kernel} never launched on the {name} path")
    for kernel in absent:
        check(counts[kernel] == 0, f"{kernel} launched on the {name} path")
    check(served_calls["quant_store"] == 0,
          f"the plain int8 writer ran {served_calls['quant_store']} times on the card")
    # decode and verify: graph replays only, and every launch accounted for
    check(served_calls["decode"] == 0,
          f"decode_step ran {served_calls['decode']} times outside the graphs while serving")
    check(delta["graph_replays"] > 0 and delta["graph_replays"] == delta["decode_dispatches"]
          == sum(replays.values()), f"{delta['graph_replays']} replays for "
          f"{delta['decode_dispatches']} decode and verify dispatches")
    verify_replays = sum(r for key, r in replays.items() if key.kind == "verify")
    check(verify_replays == delta["spec_steps"],
          f"{verify_replays} verify replays for {delta['spec_steps']} verify steps")
    if spec:
        check(verify_replays > 0, "no speculative verify ran")
    in_graphs = {}
    for key, bufs in graphs.buffers.items():
        for kernel, per_replay in bufs.launches.items():
            in_graphs[kernel] = in_graphs.get(kernel, 0) + replays[key] * per_replay
    layers = engine.model_config.n_layers
    history_prefills = served_calls["history"]
    check(history_prefills > 0, "no history prefill ran")
    eager_launches = {
        "flash": (FLASH, layers * served_calls["prefill"]),
        "chunk": (CHUNK, layers * history_prefills),
        "span writer": (("kv_quant_store_span",),
                        layers * (served_calls["prefill"] + served_calls["sp_prefill"]
                                  + history_prefills) if engine.config.kv_quant else 0),
        **{kernel: ((kernel,), 0) for kernel in DECODE_ONLY}}
    accounted = {}
    for family, (names, eager_n) in eager_launches.items():
        got = sum(counts[k] for k in names)
        want = eager_n + sum(in_graphs.get(k, 0) for k in names)
        check(got == want, f"{family} launches {got} are not {eager_n} eager + replays x "
                           f"per-graph launches {want - eager_n}")
        accounted[family] = {"launches": got, "eager": eager_n, "in_graphs": want - eager_n}
    ttft = [(r.first_token_ts - r.created) * 1e3 for r in served]
    decode_tokens = sum(len(r.generated) - 1 for r in served)
    cfg = engine.model_config
    stats = {
        "model": name, "layers": cfg.n_layers, "weights": "random (seed 0)",
        "dtype": engine.config.dtype, "quant": engine.config.quant or "none",
        "kv_quant": engine.config.kv_quant or "none",
        "max_seq_len": engine.config.max_seq_len,
        "kv_pages": engine.num_kv_pages,
        "kv_pool_pages": engine.kv.k_pages.shape[1],
        "kv_page_dtype": str(engine.kv.k_pages.dtype),
        "moe_impl": cfg.moe_impl if cfg.n_experts else None,
        "superstep": K, "k_rungs": list(rungs),
        "decode_overlap": engine.config.decode_overlap,
        "spec_decode": spec, "engine_build_s": build_s, "requests": len(served),
        "prompt_tokens": [len(r.prompt_ids) for r in served],
        "buckets": [r.bucket for r in served],
        "chunked": [r.chunked for r in served],
        "prefix_hit_tokens": [r.hist for r in served],
        # rows of each request's prefill call (a call's rows share its wall)
        "prefill_group": [sum(o.prefill_ms == r.prefill_ms for o in served) for r in served],
        "finish_reasons": [r.finish_reason for r in served],
        "completion_tokens": [len(r.generated) for r in served],
        "ttft_ms": ttft, "ttft_p50_ms": statistics.median(ttft),
        "decode_tokens": decode_tokens,
        "decode_tokens_per_s": decode_tokens / (delta["decode_wall_ms_total"] / 1e3),
        "decode_steps": delta["decode_steps"],
        "decode_dispatches": delta["decode_dispatches"],
        "decode_ms_total": delta["decode_ms_total"],
        "decode_wall_ms_total": delta["decode_wall_ms_total"],
        "overlap_steps": delta["overlap_steps"],
        "pipeline_drains": delta["pipeline_drains"],
        "graph_captures": engine.stats.graph_captures,
        "graph_static_bytes": graphs.static_bytes,
        "graph_pool_bytes": graphs.pool_bytes,
        "graph_replays": delta["graph_replays"],
        "graph_launches_per_replay": {str(list(key)): bufs.launches
                                      for key, bufs in graphs.buffers.items()},
        "decode_step_calls_at_build": build_decode_calls,
        "prefill_batches": delta["prefill_batches"],
        "prefill_ms_total": delta["prefill_ms_total"],
        "total_s": wall, "peak_memory_bytes": peak,
        "build_peak_memory_bytes": build_peak,
        "repeat_tokens_equal": True, "repeat_tokens": len(tokens_a),
        "prefills": served_calls["prefill"], "history_prefills": history_prefills,
        "sequence_parallel_prefills": served_calls["sp_prefill"],
        "world": engine.world, "mesh_shape": engine.config.mesh_shape,
        "graph_collectives_per_replay": {str(list(key)): bufs.collectives
                                         for key, bufs in graphs.buffers.items()},
        "launches_accounted": accounted, "launches": counts,
        "compile_stats": {stage: compiles[stage] for stage in ("warmup", "serving")},
        **({"graph_against_eager": eager} if eager else {}),
        **({"on_first_tokens": knob} if on_first_tokens is not None else {}),
        **({"after": after_result} if after is not None else {}),
        "request_ids": [r.request_id for r in served],
        "generated": [r.generated for r in served]}
    if spec:
        steps = delta["spec_steps"]
        stats.update(
            spec_k=engine.config.spec_k, spec_steps=steps, spec_tokens=delta["spec_tokens"],
            spec_emitted=delta["spec_emitted"],
            tokens_per_verify=delta["spec_emitted"] / steps,
            verify_wall_ms_per_step=delta["spec_ms_total"] / steps,
            plain_decode_dispatches=delta["decode_dispatches"] - steps,
            verify_against_eager=verify)
    del engine, provider, seen, served
    return counts, stats


@contextlib.contextmanager
def staged_replays(torch, engine, lens: list[int], K: int):
    """Pages for columns of ``lens`` tokens of context (0: an empty column)
    on a stopped engine; yields (``stage``, ``launch``): ``stage()`` fills
    the input pack of the greedy K-step decode graph at the engine's width,
    ``launch(feed=None)`` replays it (``feed``: the handle whose tokens it
    takes, as the overlapped pipeline does) and returns the handle to
    ``fetch``. The KV written lands in slots freed afterwards."""
    from mcp_context_forge_tpu_torch.tpu_local.decode_graphs import (BUDGETS, POSITIONS,
                                                                     SEQ_LENS, TOKENS,
                                                                     GraphKey)

    key = GraphKey("decode", K, engine.config.max_batch, False)
    for slot, n in enumerate(lens):
        if n:
            check(engine.allocator.allocate_slot(slot, n + K), "no pages for the replay")

    def stage():
        pack = engine._graphs.stage(key)
        for slot, n in enumerate(lens):
            if n:
                pack[TOKENS, slot] = 1 + slot
                pack[POSITIONS, slot], pack[SEQ_LENS, slot], pack[BUDGETS, slot] = n - 1, n, K

    try:
        with torch.inference_mode():
            engine._sync_tables()
            yield stage, lambda feed=None: engine._graphs.launch(key, feed)
    finally:
        for slot in range(len(lens)):
            engine.allocator.free_slot(slot)


def time_replay(torch, engine, lens: list[int], K: int = 1, runs: int = 5) -> float:
    """The card's time of one greedy decode replay at ``K`` over columns of
    ``lens`` tokens of context: CUDA events around the launch, median of
    ``runs``."""
    times = []
    with staged_replays(torch, engine, lens, K) as (stage, launch):
        for _ in range(runs):
            stage()
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            handle = launch()
            end.record()
            engine._graphs.fetch(handle)
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def replay_device_events(torch, engine, lens: list[int]) -> dict:
    """What one greedy K = 1 decode dispatch of the overlapped pipeline runs
    on the card (the input upload, the tokens fed from the dispatch before
    it, the replay, the output read back), under ``torch.profiler`` (CUDA
    activity), after one unprofiled replay: every device event (kernels
    and copies: what ``profile_torch_engine.py`` counts per replay) and the
    copies among them. A session can miss its leading device events (on an
    H100 a later session of a process counted 2761 of 2762, its first
    copies lost, even behind a spinning kernel), so a fed dispatch runs
    first, uncounted, then a spinning kernel marks the start of the one
    counted: the device events after the marker."""
    from torch.profiler import ProfilerActivity, profile

    with staged_replays(torch, engine, lens, 1) as (stage, launch):
        stage()
        previous = launch()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
            stage()
            first = launch(feed=previous)
            engine._graphs.fetch(previous)
            engine._graphs.fetch(first)
            torch.cuda.synchronize()
            torch.cuda._sleep(SPIN_CYCLES)   # the marker
            torch.cuda.synchronize()
            stage()
            handle = launch(feed=first)
            engine._graphs.fetch(handle)
            torch.cuda.synchronize()
    device = sorted((e for e in prof.events() if e.device_type.name == "CUDA"),
                    key=lambda e: e.time_range.start)
    marker = max(i for i, e in enumerate(device) if "spin_kernel" in e.name)
    events = [e.name for e in device[marker + 1:]]
    return {"device_events": len(events),
            "copies": sum(name.lower().startswith(("memcpy", "memset")) for name in events)}


def ops_phase(torch, dev, engine_tokens: list, prompt_tokens: list) -> tuple[dict, dict]:
    """``engine_llama3_8b_ops``: the ``engine`` phase's llama3-8b serving
    with the operability machinery on: K rungs 1 and 4 captured
    (``k_ladder``), phase attribution every 4th decode dispatch, and the
    telemetry handles. Once every request has streamed its first token,
    ``request_knobs(superstep=4)`` must be accepted and land at a drain
    barrier (no K = 1 dispatch after a K = 4 one, K = 4 dispatches after
    it). Then: greedy streams equal to the ``engine`` phase's; sampled
    phase rows, each complete, whose parts sum to its total within 5 %;
    the median device compute of the K = 1 rows within 25 % of one K = 1
    replay's CUDA-event time; the roofline over the decode window with
    0 < hbm_roofline_frac <= 1.05 and 0 < mfu <= 1.05; the span names and
    metric families (with their label names) that the CPU tests pin.
    ``engine_tokens`` and ``prompt_tokens``: the ``engine`` phase's streams
    and prompt lengths (the replay is timed at those prompts + 16)."""
    handles = telemetry_handles()

    def move_k(engine):
        accepted = engine.request_knobs(superstep=4)
        return {"accepted": accepted, "at_decode_dispatch": engine.stats.decode_dispatches}

    def read(engine):
        lens = ([n + 16 for n in prompt_tokens] + [0] * 8)[:engine.config.max_batch]
        return {"ring": engine.recent_steps(), "roofline": engine.roofline_snapshot(),
                "knob_state": engine.knob_state(),
                "phase_samples": engine.stats.phase_samples,
                "replay_k1_device_ms": time_replay(torch, engine, lens),
                "replay_k4_device_ms": time_replay(torch, engine, lens, K=4),
                "replay_seq_lens": lens, "ledger": handles["ledger"].totals,
                "completion_tokens": engine.stats.completion_tokens,
                "prompt_tokens": engine.stats.prompt_tokens}

    counts, stats = engine_phase(
        torch, dev, "llama3-8b", ATTENTION, chat_requests("llama3-8b"), hit=1,
        absent=NOT_BF16, handles=handles, on_first_tokens=move_k, after=read,
        k_ladder=(1, 4), step_sample_every=4)
    ops = stats.pop("after")
    knob = stats["on_first_tokens"]
    check(knob["accepted"] == {"superstep": True}, f"request_knobs refused K = 4: {knob}")
    check(stats["generated"] == engine_tokens,
          "the K ladder, phase sampling or telemetry changed a greedy stream of the "
          "engine phase")
    ring = ops.pop("ring")
    decode = [row for row in ring if row["kind"] == "decode"]
    ks = [row["superstep"] for row in decode]
    check(4 in ks and ks[-1] == 4, f"no K = 4 decode dispatch followed the knob: {ks}")
    check(ks == sorted(ks), "a K = 1 dispatch followed a K = 4 one: the move did not "
                            "land at a barrier")
    check(ops["knob_state"]["superstep"] == 4 and ops["knob_state"]["warmed_k"] == [1, 4],
          f"knob state {ops['knob_state']}")
    rows = [row for row in decode if row["phases"] is not None]
    check(ops["phase_samples"] > 0 and rows, "no sampled phase row")
    worst = 0.0
    for row in rows:
        phases = row["phases"]
        check(set(phases) == PHASE_KEYS and all(v >= 0 for v in phases.values()),
              f"an incomplete phase row: {phases}")
        parts = sum(v for k, v in phases.items() if k != "total_ms")
        worst = max(worst, abs(phases["total_ms"] - parts) / phases["total_ms"])
    check(worst <= 0.05, f"a phase row's parts miss its total by {worst:.3f} of it")
    k1 = [row["phases"]["device_compute_ms"] for row in rows if row["superstep"] == 1]
    check(k1, "no sampled K = 1 row")
    k1_median = statistics.median(k1)
    replay = ops["replay_k1_device_ms"]
    check(abs(k1_median - replay) <= 0.25 * replay,
          f"sampled K = 1 device compute {k1_median:.3f} ms against one replay's "
          f"{replay:.3f} ms")
    roof = ops["roofline"]
    check(0 < roof.get("hbm_roofline_frac", 0) <= 1.05 and 0 < roof.get("mfu", 0) <= 1.05,
          f"roofline out of (0, 1.05]: {roof}")
    spans = {span.name for span in handles["tracer"].finished}
    check(spans == SERVED_SPANS, f"span names {sorted(spans)}")
    families = handles["metrics"].label_names()
    check(families == {**SERVED_FAMILIES, **CAPTURE_FAMILIES},
          f"metric families {sorted(families)}")
    ledger = handles["ledger"].totals
    check(sum(row.get("generated_tokens", 0) for row in ledger.values())
          == ops["completion_tokens"], "the ledger's tokens are not the engine's")

    def by_k(key):
        out = {}
        for k in (1, 4):
            values = [row[key] for row in decode if row["superstep"] == k and row[key]]
            out[f"k{k}"] = statistics.median(values) if values else None
        return out

    phase_medians = {f"k{k}": {key: statistics.median(row["phases"][key] for row in rows
                                                      if row["superstep"] == k)
                               for key in PHASE_KEYS}
                     for k in (1, 4) if any(row["superstep"] == k for row in rows)}
    stats.update(
        knob=knob, k_sequence_tail=ks[-12:], phase_rows=len(rows),
        phase_rows_k1=len(k1), phase_median_ms=phase_medians,
        phase_parts_worst_miss=worst, replay_k1_device_ms=replay,
        replay_k4_device_ms=ops["replay_k4_device_ms"],
        replay_seq_lens=ops["replay_seq_lens"], roofline=roof,
        ring_hbm_frac_median=by_k("hbm_frac"), ring_mfu_median=by_k("mfu"),
        knob_state=ops["knob_state"], spans=sorted(spans),
        metric_families=sorted(families), signals=sorted(
            {key.rsplit("@", 1)[0] for key in handles["signals"].snapshot()}),
        tokens_equal_engine=True)
    return counts, stats


def restart_phase(torch, dev) -> tuple[dict, dict]:
    """``engine_restart``: llama3-tiny in f32 with ``auto_restart`` and one
    slot. A prompt is served (its tokens kept), then a one-shot fault is
    planted in ``DecodeGraphs.launch``: the request decoding when it fires
    (the victim) must end "error", the one queued behind it must complete,
    ``engine_restarts`` be 1, no graph be captured (the pool was reset in
    place: the graphs and the pool's tensors are the same objects), no
    serving-stage event occur, the same prompt give the same tokens after
    the restart, and no page stay in use."""
    from mcp_context_forge_tpu_torch.tpu_local.engine import (EngineConfig, GenRequest,
                                                              TorchEngine)

    engine = TorchEngine(EngineConfig(model="llama3-tiny", dtype="float32", device="cuda",
                                      max_batch=1, max_seq_len=512, page_size=128,
                                      num_pages=16, prefill_buckets=(128,),
                                      auto_restart=True))
    captures = engine.stats.graph_captures
    graphs = dict(engine._graphs.buffers)
    pool = [engine.kv.k_pages, engine.kv.v_pages, engine.kv.block_tables]
    launch = engine._graphs.launch
    fired = []

    def one_shot(*args, **kwargs):
        if not fired:
            fired.append(time.monotonic())
            raise RuntimeError("planted fault in the decode launch")
        return launch(*args, **kwargs)

    wrappers = kernel_wrappers()

    async def run():
        await engine.start()
        try:
            ids = engine.tokenizer.encode("Which tools can read files?")
            before = [t async for t in engine.generate(ids, max_tokens=12)]
            for fn in wrappers.values():
                fn.launches = 0
            engine._graphs.launch = one_shot
            victim = GenRequest(request_id="victim", prompt_ids=ids, max_tokens=12)
            queued = GenRequest(request_id="queued", prompt_ids=ids, max_tokens=12)
            await engine.submit(victim)
            await engine.submit(queued)
            streams = []
            for request in (victim, queued):
                tokens = []
                while (t := await asyncio.wait_for(request.stream.get(), 60)) is not None:
                    tokens.append(t)
                streams.append(tokens)
            after = [t async for t in engine.generate(ids, max_tokens=12)]
            counts = {k: fn.launches for k, fn in wrappers.items()}
            return before, victim, queued, streams, after, counts
        finally:
            await engine.stop()

    before, victim, queued, streams, after, counts = asyncio.run(run())
    check(len(fired) == 1, "the planted fault did not fire once")
    check(victim.finish_reason == "error", f"the victim ended {victim.finish_reason!r}")
    check(queued.finish_reason in ("stop", "length") and streams[1] == before,
          "the queued request did not complete with the tokens served before the crash")
    check(after == before, "the prompt gave other tokens after the restart")
    check(engine.stats.engine_restarts == 1, f"{engine.stats.engine_restarts} restarts")
    check(engine.stats.graph_captures == captures and engine._graphs.buffers == graphs
          and all(a is b for a, b in zip(pool, [engine.kv.k_pages, engine.kv.v_pages,
                                                engine.kv.block_tables])),
          "the restart captured graphs or replaced the pool")
    compiles = engine.compile_stats()
    check(compiles["serving"]["count"] == 0, f"serving-stage events: {compiles['serving']}")
    check(compiles["warmup"]["graph_capture"] == captures, f"warmup events: {compiles['warmup']}")
    check(engine.allocator.pages_in_use == 0,
          f"{engine.allocator.pages_in_use} pages in use at the end")
    for kernel in ("flash_attention_mma", "paged_decode_attention"):
        check(counts[kernel] > 0, f"{kernel} never launched around the restart")
    stats = {"model": "llama3-tiny", "dtype": "float32", "max_batch": 1,
             "victim_finish": victim.finish_reason, "victim_tokens": len(streams[0]),
             "queued_finish": queued.finish_reason, "queued_tokens_equal_before": True,
             "tokens_equal_after_restart": True, "engine_restarts": 1,
             "graph_captures": captures, "pages_in_use": 0,
             "compile_stats": {stage: compiles[stage] for stage in ("warmup", "serving")},
             "launches": counts}
    del engine
    return counts, stats


# --------------------------------------------- admission and the controller

# kernels (and copies) of one bf16 llama3-8b K = 1 decode dispatch at width
# 8, as profile_torch_engine.py counts them per replay (PERF.md section 5)
DECODE_REPLAY_EVENTS = 2762
RING_KEYS = {"schema", "seq", "ts", "replica", "knob", "direction", "from", "to",
             "actuated", "safe_mode", "signals", "effect"}


def gateway_settings():
    """What admission reads of the gateway's settings, at their defaults but
    the JWT secret (the card has no pydantic: duck-typed)."""
    from types import SimpleNamespace

    return SimpleNamespace(auth_required=True, basic_auth_user="admin",
                           basic_auth_password="changeme",
                           platform_admin_email="admin@example.com",
                           jwt_secret_key="chip-smoke-secret-0123456789abcdef",
                           jwt_algorithm="HS256", jwt_audience="mcpforge-api",
                           jwt_issuer="mcpforge")


def bearer(settings, claims: dict, **overrides) -> str:
    from mcp_context_forge_tpu_torch.utils import jwt

    kwargs = dict(audience=settings.jwt_audience, issuer=settings.jwt_issuer)
    return "Bearer " + jwt.create_token(claims, settings.jwt_secret_key,
                                        **{**kwargs, **overrides})


def basic(user: str, password: str) -> str:
    import base64

    return "Basic " + base64.b64encode(f"{user}:{password}".encode()).decode()


class Admission:
    """The /v1 app's admission in front of a provider, through the port's
    stdlib pieces: ``gateway/auth.py`` resolves the header, then
    ``require("llm.chat")``, then the overload shedder's
    ``decide_admission`` on the engine's saturation, then the registry's
    chat under ``set_current_tenant``. A refusal raises (``AuthError``,
    ``PermissionDenied``); a shed verdict fails the run."""

    def __init__(self, settings, provider, shedder):
        from mcp_context_forge_tpu_torch.tpu_local.provider import LLMProviderRegistry

        self.settings, self.engine, self.shedder = settings, provider.engine, shedder
        self.registry = LLMProviderRegistry()
        self.registry.register(provider, [self.engine.config.model, "tpu_local"],
                               default_chat=True, default_embed=True)

    async def decide(self, header: str, request: dict, shedder=None):
        from mcp_context_forge_tpu_torch.gateway.auth import resolve_header
        from mcp_context_forge_tpu_torch.gateway.flight_recorder import compute_queue_state
        from mcp_context_forge_tpu_torch.observability import resolve_tenant

        auth = resolve_header(self.settings, header)
        auth.require("llm.chat")
        tenant = resolve_tenant(auth)
        state = compute_queue_state(None, self.engine)
        verdict = await (shedder or self.shedder).decide_admission(
            state["saturation"], tenant, est_tokens=float(request["max_tokens"]))
        return tenant, verdict

    async def chat(self, header: str, request: dict) -> dict:
        from mcp_context_forge_tpu_torch.observability import (reset_current_tenant,
                                                               set_current_tenant)

        tenant, verdict = await self.decide(header, request)
        check(verdict is None, f"an admitted tenant was shed: {verdict}")
        token = set_current_tenant(tenant)
        try:
            return await self.registry.chat(request)
        finally:
            reset_current_tenant(token)


def controller_for(engine, bus, tracer, safe_mode: bool = False, **bars):
    """A ``ServingController`` over ``engine`` with bars that the signals
    this engine really publishes cross: no bar on queue wait, any published
    idle share steps K up (the card is idle < 0.01 of a decode step), a
    cooldown past the phase (one move per knob), a 0.5 s effect window."""
    from mcp_context_forge_tpu_torch.tpu_local.controller import ServingController

    settings = dict(queue_wait_high_ms=1e9, queue_wait_low_ms=1e9, idle_frac_high=-1.0,
                    tick_s=0.05, cooldown_s=3600.0, eval_window_s=0.5, **bars)
    return ServingController(bus, lambda: [engine], tracer=tracer, safe_mode=safe_mode,
                             **settings)


async def fresh_signal(bus, name: str, replica: str, within_s: float = 10.0) -> dict:
    """Wait (bounded) for a publish of ``name`` under 0.3 s old."""
    deadline = time.monotonic() + within_s
    while True:
        view = bus.get(name, replica)
        if view is not None and view["age_s"] < 0.3:
            return view
        check(time.monotonic() < deadline, f"no fresh {name} signal in {within_s} s")
        await asyncio.sleep(0.001)


def move_of(row: dict) -> tuple:
    return row["replica"], row["knob"], row["direction"], row["from"], row["to"]


def fault_run(torch, engine) -> tuple[dict, dict]:
    """On the stopped ``auto_restart`` engine: a prompt served, then an
    ``engine.dispatch`` error fault armed ``once`` (scope: the replica)
    while a victim request decodes, with a second request queued behind
    it, then the prompt again. Checks: the victim ends "error", the queued
    request completes with the tokens served before, one restart, no graph
    captured, no serving-stage event, the same tokens after, no page in
    use. Returns the launches and the stats (the restart's seconds)."""
    from mcp_context_forge_tpu_torch.observability import faults
    from mcp_context_forge_tpu_torch.tpu_local.engine import GenRequest

    wrappers = kernel_wrappers()
    captures, buffers = engine.stats.graph_captures, dict(engine._graphs.buffers)
    restarts0 = engine.stats.engine_restarts
    restart, seconds = engine._restart_after_crash, []

    def timed_restart():
        t0 = time.monotonic()
        restart()
        seconds.append(time.monotonic() - t0)

    engine._restart_after_crash = timed_restart
    plane = faults.configure_fault_plane(True)

    async def drain(request) -> list:
        tokens = []
        while (t := await asyncio.wait_for(request.stream.get(), 60)) is not None:
            tokens.append(t)
        return tokens

    async def run():
        await engine.start()
        try:
            ids = engine.tokenizer.encode("Which tools can read files?")
            before = [t async for t in engine.generate(ids, max_tokens=12)]
            for fn in wrappers.values():
                fn.launches = 0
            victim = GenRequest(request_id="victim", prompt_ids=ids, max_tokens=64)
            await engine.submit(victim)
            first = await asyncio.wait_for(victim.stream.get(), 60)
            plane.arm(faults.FaultRule(point="engine.dispatch", kind="error", mode="once",
                                       scope=engine.config.replica_id))
            queued = GenRequest(request_id="queued", prompt_ids=ids, max_tokens=12)
            await engine.submit(queued)
            victim_tokens = [first] + await drain(victim)
            queued_tokens = await drain(queued)
            after = [t async for t in engine.generate(ids, max_tokens=12)]
            counts = {k: fn.launches for k, fn in wrappers.items()}
            return before, victim, victim_tokens, queued, queued_tokens, after, counts
        finally:
            await engine.stop()

    try:
        before, victim, victim_tokens, queued, queued_tokens, after, counts = asyncio.run(run())
        rule = plane.snapshot()["rules"][0]
    finally:
        faults.configure_fault_plane(False)
        engine._restart_after_crash = restart
    check(rule["fired"] == 1, f"the engine.dispatch fault fired {rule['fired']} times")
    check(victim.finish_reason == "error", f"the victim ended {victim.finish_reason!r}")
    check(victim_tokens[:len(before)] == before[:len(victim_tokens)],
          "the victim's tokens before the fault are not the prompt's")
    check(queued.finish_reason in ("stop", "length") and queued_tokens == before,
          "the queued request did not complete with the tokens served before the fault")
    check(after == before, "the prompt gave other tokens after the restart")
    check(engine.stats.engine_restarts - restarts0 == 1 and len(seconds) == 1,
          f"{engine.stats.engine_restarts - restarts0} restarts")
    check(engine.stats.graph_captures == captures and engine._graphs.buffers == buffers,
          "the restart captured graphs")
    compiles = engine.compile_stats()
    check(compiles["serving"]["count"] == 0, f"serving-stage events: {compiles['serving']}")
    check(engine.allocator.pages_in_use == 0,
          f"{engine.allocator.pages_in_use} pages in use after the fault")
    for kernel in ("flash_attention_tc", "paged_decode_attention"):
        check(counts[kernel] > 0, f"{kernel} never launched around the fault")
    return counts, {"fault": "engine.dispatch error once, scope " + rule["scope"],
                    "fired": rule["fired"], "calls_seen": rule["calls"],
                    "victim_finish": victim.finish_reason,
                    "victim_tokens": len(victim_tokens),
                    "queued_finish": queued.finish_reason, "queued_tokens_equal_before": True,
                    "tokens_equal_after_restart": True, "engine_restarts": 1,
                    "restart_s": seconds[0], "graph_captures": captures, "pages_in_use": 0}


def spec_toggle_phase(torch, dev, model: str, kernels: tuple, reference: list,
                      exact: bool = False, **engine_kwargs) -> tuple[dict, dict]:
    """``model`` built with ``spec_decode`` (no ``k_ladder``) serves
    ``chat_requests(model)``; once a fresh ``llm.spec_accept`` is on the
    bus, a ``ServingController`` whose ``spec_accept_off`` (``spec_k``) is
    above any acceptance turns drafting off, and ``spec_steps`` must not
    rise from the moment the knob lands. Each stream is compared with
    ``reference`` (a plain engine's streams of the same requests):
    ``exact`` requires them equal; otherwise (bf16) they are reported,
    since the verify's logits, and the KV it writes, drift from a decode
    step's and may flip a near-tie, even after drafting stops."""
    from mcp_context_forge_tpu_torch.observability.signals import SignalBus

    bus = SignalBus()
    state: dict = {}

    async def spec_off(engine):
        rid = engine.config.replica_id
        accept = await fresh_signal(bus, "llm.spec_accept", rid)
        controller = controller_for(engine, bus, None,
                                    spec_accept_off=float(engine.config.spec_k))
        apply_knobs = engine._apply_knobs

        def landed():
            """On the dispatch thread: each running request's tokens when
            drafting stops."""
            apply_knobs()
            if not engine._spec_enabled and "at_off" not in state:
                state["at_off"] = {r.request_id: len(r.generated)
                                   for r in list(engine._running.values())}

        engine._apply_knobs = landed
        rows = controller.tick()
        check([move_of(r) for r in rows] == [(rid, "spec", "off", 1, 0)] and rows[0]["actuated"],
              f"the controller's decisions: {rows}")
        deadline = time.monotonic() + 10
        while engine.knob_state()["spec_enabled"]:
            check(time.monotonic() < deadline, "drafting did not turn off")
            await asyncio.sleep(0.001)
        state["steps_at_off"] = engine.stats.spec_steps
        return {"spec_accept_ewma": accept["ewma"], "spec_accept_off": controller.spec_accept_off,
                "decision": move_of(rows[0]), "spec_steps_at_off": engine.stats.spec_steps}

    def spec_after(engine):
        check(engine.stats.spec_steps == state["steps_at_off"],
              f"spec_steps rose from {state['steps_at_off']} to "
              f"{engine.stats.spec_steps} after drafting turned off")
        return {"spec_steps_at_end": engine.stats.spec_steps,
                "knob_state": engine.knob_state()}

    counts, stats = engine_phase(torch, dev, model, kernels, chat_requests(model), hit=1,
                                 handles=dict(signals=bus), on_first_tokens=spec_off,
                                 after=spec_after, spec_decode=True, **engine_kwargs)
    equal = [a == b for a, b in zip(stats["generated"], reference)]
    if exact:
        check(all(equal), f"turning drafting off changed a greedy stream of the plain "
                          f"{model} phase: {equal}")
    first_diff = {rid: next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                            min(len(got), len(want)))
                  for rid, got, want in zip(stats["request_ids"], stats["generated"], reference)
                  if got != want}
    return counts, {**stats.pop("on_first_tokens"), **stats.pop("after"), "model": model,
                    "dtype": stats["dtype"], "layers": stats["layers"],
                    "spec_steps": stats["spec_steps"],
                    "tokens_per_verify": stats["tokens_per_verify"],
                    "ttft_p50_ms": stats["ttft_p50_ms"],
                    "decode_tokens_per_s": stats["decode_tokens_per_s"],
                    "engine_build_s": stats["engine_build_s"],
                    "tokens_at_off": state["at_off"], "streams_equal_plain": equal,
                    "first_diff": first_diff}


def serving_plane_phase(torch, dev, engine_tokens: list, tiny_tokens: list,
                        model: str = "llama3-8b") -> tuple[dict, dict, dict]:
    """``engine_llama3_8b_admission`` and ``engine_llama3_8b_controller``:
    llama3-8b at full width and depth in bf16, decode graphs for K = 1 and
    4 (``k_ladder``), ``auto_restart``, the port's signal bus as
    ``signals`` and its tracer (memory exporter).

    Admission: the ``engine`` phase's requests each go in through
    ``Admission`` with a minted JWT or the Basic admin credentials; once
    every request has streamed its first token, a request with no header,
    one with a wrong password, one whose JWT has the wrong audience and one
    whose JWT is scoped without ``llm.chat`` are refused before the engine
    sees them (its request count does not move), and a shedder with
    ``shed_at`` 0.0 and the class order ["batch"] gives a ``batch`` tenant a
    429 verdict and admits a ``default`` tenant. Greedy streams equal the
    ``engine`` phase's; the span names are SERVED_SPANS.

    Controller, on the same run: at the first tokens a ``safe_mode``
    controller and then an actuating one tick over the engine's live
    signals; both decide ``superstep`` 1 -> 4, the first records it
    without moving the knob, the engine accepts the second's, and it lands
    at a drain barrier (no K = 1 decode dispatch after a K = 4 one). A tick
    past ``eval_window_s`` settles the row's effect; every ring row carries
    RING_SCHEMA's keys. Then, with the fault plane disabled, arming is
    refused and one decode replay runs DECODE_REPLAY_EVENTS device events;
    then ``fault_run``. A second build with ``spec_decode`` (no
    ``k_ladder``): once a fresh ``llm.spec_accept`` is on the bus, a
    controller whose ``spec_accept_off`` (``spec_k``) is above any
    acceptance turns drafting off and ``spec_steps`` stops rising from the
    moment the knob lands; its streams' agreement with the ``engine``
    phase's is reported (``spec_toggle_phase``). The same toggle on
    llama3-tiny in f32 must leave every stream equal to
    ``engine_llama3_tiny_f32``'s (``tiny_tokens``)."""
    from mcp_context_forge_tpu_torch.observability import faults
    from mcp_context_forge_tpu_torch.observability.degradation import OverloadShedder
    from mcp_context_forge_tpu_torch.observability.signals import SignalBus
    from mcp_context_forge_tpu_torch.observability.tracing import Tracer
    from mcp_context_forge_tpu_torch.tpu_local.controller import RING_SCHEMA

    settings = gateway_settings()
    faults.configure_fault_plane(False)
    bus, tracer = SignalBus(), Tracer(exporter="memory")
    admitted = [bearer(settings, {"sub": "user@example.com"}),
                basic(settings.basic_auth_user, settings.basic_auth_password)]
    sent = []
    state: dict = {}

    def send(provider, request):
        if "admission" not in state:
            state["admission"] = Admission(settings, provider,
                                           OverloadShedder(shed_at=0.95, class_order=["batch"]))
        sent.append(len(sent) % 2)
        return state["admission"].chat(admitted[sent[-1]], request)

    refusals = [
        ("no_header", "", "AuthError"),
        ("wrong_password", basic(settings.basic_auth_user, "wrong"), "AuthError"),
        ("jwt_wrong_audience", bearer(settings, {"sub": "user@example.com"},
                                      audience="elsewhere"), "AuthError"),
        ("jwt_scoped_without_llm_chat", bearer(settings, {"sub": "ci@example.com",
                                                          "scopes": ["tools.read"]}),
         "PermissionDenied")]

    async def at_first_tokens(engine):
        from mcp_context_forge_tpu_torch.gateway.auth import AuthError, PermissionDenied

        errors = {"AuthError": AuthError, "PermissionDenied": PermissionDenied}
        admission = state["admission"]
        requests_before = engine.stats.requests
        refused = {}
        for name, header, error in refusals:
            try:
                await admission.chat(header, chat(model, "Refuse me."))
            except errors[error] as exc:
                refused[name] = f"{error}: {exc}"
            else:
                raise SmokeFailure(f"the {name} request was admitted")
        check(engine.stats.requests == requests_before,
              "a refused request reached the engine")
        strict = OverloadShedder(shed_at=0.0, class_order=["batch"],
                                 tenant_classes={"user:batch@example.com": "batch"})
        verdicts = {}
        for name, header in (("batch", bearer(settings, {"sub": "batch@example.com"})),
                             ("default", admitted[1])):
            verdicts[name] = (await admission.decide(header, chat(model, "x"), strict))[1]
        check(verdicts["batch"] is not None and verdicts["batch"]["status"] == 429
              and verdicts["batch"]["slo_class"] == "batch", f"batch verdict {verdicts}")
        check(verdicts["default"] is None, f"the default tenant was shed: {verdicts}")
        rid = engine.config.replica_id
        await fresh_signal(bus, "llm.idle_frac", rid)
        safe, real = (controller_for(engine, bus, tracer, safe_mode=m) for m in (True, False))
        safe_rows, rows = safe.tick(), real.tick()
        state["controllers"] = (safe, real)
        check([move_of(r) for r in rows] == [(rid, "superstep", "up", 1, 4)]
              and rows[0]["actuated"], f"the controller's decisions: {rows}")
        check([move_of(r) for r in safe_rows] == [move_of(r) for r in rows]
              and not safe_rows[0]["actuated"] and safe_rows[0]["safe_mode"],
              f"safe_mode decided otherwise: {safe_rows}")
        return {"refused": refused, "shed_verdicts": verdicts,
                "engine_requests_unchanged": True,
                "decision": {k: rows[0][k] for k in ("knob", "direction", "from", "to",
                                                     "actuated", "signals")},
                "safe_mode_decision": {k: safe_rows[0][k] for k in
                                       ("knob", "direction", "from", "to", "actuated")},
                "at_decode_dispatch": engine.stats.decode_dispatches}

    def after_serving(engine):
        safe, real = state["controllers"]
        due = real.decisions()[-1]["ts"] + real.eval_window_s
        time.sleep(max(0.0, due - time.time()) + 0.05)
        real.tick()
        ring = real.decisions() + safe.decisions()
        check(all(set(row) == RING_KEYS and row["schema"] == RING_SCHEMA for row in ring),
              f"ring rows {ring}")
        check(real.decisions()[0]["effect"], "the decision's effect did not settle")
        decode = [row for row in engine.recent_steps() if row["kind"] == "decode"]
        ks = [row["superstep"] for row in decode]
        check(4 in ks and ks == sorted(ks),
              f"the K move did not land at a drain barrier: {ks[-16:]}")
        try:
            faults.get_fault_plane().arm(faults.FaultRule(point="engine.dispatch"))
        except RuntimeError as exc:
            refusal = str(exc)
        else:
            raise SmokeFailure("a disabled fault plane armed a rule")
        check(faults.fault_point("engine.dispatch", engine.config.replica_id) is None,
              "the unarmed engine.dispatch point returned an action")
        events = replay_device_events(torch, engine, [300] * engine.config.max_batch)
        check(events["device_events"] == DECODE_REPLAY_EVENTS,
              f"one decode replay ran {events['device_events']} device events, "
              f"not {DECODE_REPLAY_EVENTS}")
        fault_counts, fault = fault_run(torch, engine)
        return {"effect": real.decisions()[0]["effect"], "k_sequence_tail": ks[-12:],
                "ring": [move_of(r) + (r["actuated"],) for r in ring],
                "disabled_plane_refused": refusal, "replay": events,
                "fault_counts": fault_counts, "fault": fault,
                "spans": sorted({span.name for span in tracer.finished})}

    counts, stats = engine_phase(
        torch, dev, model, ATTENTION, chat_requests(model), hit=1,
        absent=NOT_BF16, handles=dict(tracer=tracer, signals=bus),
        on_first_tokens=at_first_tokens, after=after_serving, send=send,
        k_ladder=(1, 4), auto_restart=True)
    check(stats["generated"] == engine_tokens,
          "admission or the controller's K move changed a greedy stream of the engine phase")
    check(len(sent) == len(chat_requests(model)) + 2,
          f"{len(sent)} requests went through admission")
    first, after = stats.pop("on_first_tokens"), stats.pop("after")
    check(set(after["spans"]) == SERVED_SPANS | {"controller.decision"},
          f"span names {after['spans']}")
    # every launch of the three runs, for the kernel table; each phase line
    # keeps its own run's
    total = dict(counts)

    def add(more: dict) -> None:
        for kernel, n in more.items():
            total[kernel] += n

    add(after.pop("fault_counts"))
    spec_counts, spec = spec_toggle_phase(torch, dev, model, ATTENTION[:2], engine_tokens,
                                          absent=NOT_BF16)
    add(spec_counts)
    free_device(torch)
    # the same toggle in f32, where the verify and a decode step agree to
    # 1e-4 of a row's largest logit: every stream equals the plain phase's
    spec_counts, spec_f32 = spec_toggle_phase(
        torch, dev, "llama3-tiny", ATTENTION_MMA[:2], tiny_tokens, exact=True,
        absent=TC_ATTENTION, dtype="float32")
    add(spec_counts)
    admission = {**stats, **{k: first[k] for k in ("refused", "shed_verdicts",
                                                   "engine_requests_unchanged")},
                 "admitted_via": ["jwt", "basic"], "spans": after["spans"],
                 "tokens_equal_engine": True}
    controller = {
        "model": model, "k_rungs": stats["k_rungs"],
        "decision": first["decision"], "safe_mode_decision": first["safe_mode_decision"],
        "at_decode_dispatch": first["at_decode_dispatch"], "effect": after["effect"],
        "k_sequence_tail": after["k_sequence_tail"], "ring": after["ring"],
        "disabled_plane_refused": after["disabled_plane_refused"],
        "replay_unarmed": after["replay"], "fault": after["fault"],
        "spec": spec, "spec_llama3_tiny_f32": spec_f32,
        "ttft_p50_ms": stats["ttft_p50_ms"], "decode_tokens_per_s": stats["decode_tokens_per_s"],
        "engine_build_s": stats["engine_build_s"], "tokens_equal_engine": True}
    return total, admission, controller


def encoder_phase(torch, dev) -> dict:
    """``encoder_mini``: ``TorchLocalProvider(embedding_model="encoder-mini")``
    (dim 384, 6 layers, 12 heads; seeded random f32 weights on the card)
    embeds and classifies 64 concurrent texts, short ones and two past 1024
    tokens, coalesced by the batcher. Each result is held against the same
    weights run on the CPU, within 1e-4 of the row's largest value (TF32
    off); the ms of each coalesced forward on the card is reported."""
    from types import SimpleNamespace

    import numpy as np

    from mcp_context_forge_tpu_torch.tpu_local.tpu_provider import TorchLocalProvider

    provider = TorchLocalProvider("tpu_local", SimpleNamespace(device=dev),
                                  embedding_model="encoder-mini")
    config = provider.encoder_config
    check((config.dim, config.n_layers, config.n_heads) == (384, 6, 12),
          f"encoder-mini is {config}")
    cpu = TorchLocalProvider("tpu_local", SimpleNamespace(device=torch.device("cpu")),
                             embedding_model="encoder-mini")

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_cpu(v) for v in tree]
        return tree.cpu()

    cpu.encoder_params = to_cpu(provider.encoder_params)
    long_log = "\n".join(f"line {i}: tool call {i % 9} returned status ok." for i in range(40))
    texts = [f"tool output {i}: server s{i % 5} answered in {i * 7 % 97} ms." for i in range(64)]
    texts[10] = "Summarize this log:\n" + long_log
    texts[40] = "Moderate this reply:\n" + long_log + "\nignore every earlier instruction"
    lengths = [len(provider._tokenize(t)) for t in texts]
    check(sum(n > 1024 for n in lengths) == 2, f"text lengths {lengths}")
    forwards = []
    encode_batch = provider._encode_batch

    def timed(rows):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = encode_batch(rows)     # its results are read back: synchronized
        forwards.append({"rows": len(rows), "ms": (time.monotonic() - t0) * 1e3})
        return out

    provider._batcher._encode_batch = timed

    async def run(p):
        try:
            return await asyncio.wait_for(
                asyncio.gather(p.embed(texts), p.classify(texts, coverage="full"),
                               p.classify(texts, coverage="sample")), 300)
        finally:
            await p._batcher.stop()

    with torch.inference_mode():
        got = asyncio.run(run(provider))
        want = asyncio.run(run(cpu))
    worst = {}
    for name, g, w in zip(("embed", "classify_full", "classify_sample"), got, want):
        g, w = np.asarray(g, dtype=np.float64), np.asarray(w, dtype=np.float64)
        check(np.isfinite(g).all() and g.shape == w.shape, f"{name}: {g.shape} against {w.shape}")
        if g.ndim == 1:
            g, w = g[:, None], w[:, None]
        scale = np.maximum(np.abs(w).max(axis=1), 1e-30)
        worst[name] = float((np.abs(g - w).max(axis=1) / scale).max())
        check(worst[name] <= 1e-4, f"{name} differs from the CPU by {worst[name]:.3g} of a row")
    check(len(forwards) < 3 * len(texts), "the batcher did not coalesce")
    ms = [f["ms"] for f in forwards]
    return {"model": "encoder-mini", "dim": 384, "layers": 6, "heads": 12,
            "texts": len(texts), "past_1024_tokens": 2, "max_row_error": worst,
            "forwards": len(forwards), "rows_per_forward": [f["rows"] for f in forwards],
            "ms_per_forward_median": statistics.median(ms), "ms_per_forward": ms}


# ------------------------------------------------------------ the spill tiers

# the tier phases' pool: 15 usable pages, under one ~1440-token summary (12
# pages with its reply) plus the shared system prompt's 3 registered pages,
# so a second summary evicts (spills) them
TIER_POOL_PAGES = 16
# the int8 pool of the same phases: a byte budget of 8 bf16 pages, 15 int8 pages
TIER_INT8_BUDGET = 8


# what a tier run's phase line leaves out (held by the checks)
RUN_DETAIL = ("streams", "launches", "hit_launches", "payloads")


def tier_requests(model: str) -> tuple[dict, list[dict]]:
    """The system-prompt request of ``chat_requests`` (index 1, whose first
    three pages, 384 tokens, match) and four ~1440-token log summaries that
    share no page with it or with one another (each names its log first)."""
    long_doc = " ".join(f"line {i}: the tool returned status ok." for i in range(37))
    return (chat_requests(model)[1],
            [chat(model, f"Summarize log {tag}:\n" + long_doc) for tag in "WXYZ"])


def tier_engine(model: str, params, **kwargs):
    """A TorchEngine at ``engine_phase``'s shapes on ``params`` (shared by
    every engine of a tier phase: one weight draw)."""
    from mcp_context_forge_tpu_torch.tpu_local.engine import EngineConfig, TorchEngine

    config = dict(model=model, dtype="bfloat16", device="cuda", max_batch=8,
                  max_seq_len=2048, page_size=128, num_pages=512,
                  prefill_buckets=(128, 512, 2048), prefill_max_batch=4, seed=0)
    return TorchEngine(EngineConfig(**{**config, **kwargs}), params=params)


def pool_page(engine, page: int) -> tuple:
    """Copies of one page of the pool on the card (K, V, and an int8 pool's
    scales)."""
    kv = engine.kv
    parts = [kv.k_pages[:, page], kv.v_pages[:, page]]
    if kv.quantized:
        parts += [kv.k_scales[:, page], kv.v_scales[:, page]]
    return tuple(t.clone() for t in parts)


def spread(values) -> dict:
    values = list(values)
    return {"n": len(values), "median": statistics.median(values) if values else None,
            "max": max(values) if values else None}


def tier_run(torch, engine, mode: str, after=None) -> dict:
    """Sequential chats through ``TorchLocalProvider.chat`` on a tier
    engine. ``mode`` "hbm" (a pool that never evicts): the system-prompt
    request cold, then again twice (resident hits: the second is the one
    timed, after the engine's first history prefill). Otherwise: cold, two
    summaries (the second evicts, so spills, its three pages), and the
    request again: its history is restored from the tiers (fetch-on-miss).
    "disk" first waits until the write-behind worker has put every spill
    on disk; "host" then evicts the restored pages again with two more
    summaries, flips a byte of the first page's chunk identity in the
    store and sends the request once more (a collision: a miss and a cold
    prefill); "disk" then arms a ``tier.disk.write`` error and sends a
    summary (its spills overflow to disk and fail). Spills and restores of
    the request's chain pages are held on the card: each restored page
    against a copy of the page taken when it spilled. Every kernel count
    is reset when the engine starts and read when the chats end. The host
    tier's payload of each chain page, as it spilled, is kept
    (``payloads``). ``after(engine)`` runs once the engine stopped, its
    multi-rank group still open (``stop(keep_group=True)``); its result is
    ``after``."""
    from mcp_context_forge_tpu_torch.observability import degradation, faults
    from mcp_context_forge_tpu_torch.tpu_local.kv.prefix_index import chain_hashes
    from mcp_context_forge_tpu_torch.tpu_local.tpu_provider import TorchLocalProvider

    hit_request, fillers = tier_requests(engine.config.model)
    provider = TorchLocalProvider("tpu_local", engine)
    seen = []
    submit = engine.submit

    async def recording_submit(request):
        seen.append(request)
        return await submit(request)

    engine.submit = recording_submit
    client = engine._tier_client
    store = client.store
    wrappers = kernel_wrappers()
    watch: set = set()
    spilled: dict = {}
    restored: dict = {}
    payloads: dict = {}
    real_spill, real_restore = client.spill, client.restore

    def spill(key_hash, parent, chunk, page):
        first = key_hash in watch and key_hash not in spilled
        if first:
            spilled[key_hash] = pool_page(engine, page)
        out = real_spill(key_hash, parent, chunk, page)
        if first and key_hash in store._host:
            payloads[key_hash] = store._host[key_hash]
        return out

    def restore(key_hash, parent, chunk, page):
        tier = real_restore(key_hash, parent, chunk, page)
        if tier is not None and key_hash in watch:
            restored.setdefault(key_hash, []).append((tier, pool_page(engine, page)))
        return tier

    client.spill, client.restore = spill, restore

    def drain_writer():
        deadline = time.monotonic() + 120
        while (store._pending or not store._writeq.empty()) and time.monotonic() < deadline:
            time.sleep(0.01)
        check(not store._pending, "the write-behind worker did not drain in 120 s")

    out: dict = {"mode": mode}

    async def send(request) -> object:
        await provider.chat(request)
        return seen[-1]

    async def run():
        await engine.start()
        try:
            for fn in wrappers.values():
                fn.launches = 0
            torch.cuda.reset_peak_memory_stats()
            cold = await send(hit_request)
            watch.update(chain_hashes(cold.prompt_ids, engine.config.page_size))
            out["chain_pages"] = len(watch)
            hits0 = dict(engine.allocator.tier_hit_tokens)
            if mode != "hbm":
                for request in fillers[:2]:
                    await send(request)
                check(all(h in spilled for h in watch),
                      f"{len(spilled)} of the {len(watch)} chain pages spilled")
                if mode == "disk":
                    await asyncio.to_thread(drain_writer)
                    out["before_hit"] = store.stats()
            at_hit = {k: fn.launches for k, fn in wrappers.items()}
            hit = await send(hit_request)
            out["hit_launches"] = {k: fn.launches - at_hit[k] for k, fn in wrappers.items()}
            out["hit_chunk_launches"] = sum(out["hit_launches"][k] for k in CHUNK)
            out["hit_flash_launches"] = sum(out["hit_launches"][k] for k in FLASH)
            out["hit_tokens"] = {tier: n - hits0[tier] for tier, n in
                                 engine.allocator.tier_hit_tokens.items()}
            served = [cold, hit]
            if mode == "hbm":
                served.append(await send(hit_request))
            if mode == "host":
                for request in fillers[2:]:
                    await send(request)
                key = chain_hashes(cold.prompt_ids, engine.config.page_size)[0]
                with store._lock:
                    payload = store._host[key]
                    payload.chunk = (payload.chunk[0] ^ 1,) + tuple(payload.chunk[1:])
                collisions = store.collisions
                served.append(await send(hit_request))
                out["collision"] = {"collisions": store.collisions - collisions,
                                    "probe_after": store.probe(key),
                                    "hist": served[-1].hist}
            if mode == "disk":
                errors = store.io_errors[("disk", "write")]
                plane = faults.configure_fault_plane(True)
                try:
                    plane.arm(faults.FaultRule(point="tier.disk.write", kind="error"))
                    await send(fillers[2])
                    await asyncio.to_thread(drain_writer)
                finally:
                    faults.configure_fault_plane(False)
                    degradation.configure_degradation()
                out["disk_write_errors"] = store.io_errors[("disk", "write")] - errors
            out["launches"] = {k: fn.launches for k, fn in wrappers.items()}
            out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
            out["tier_stats"] = engine.tier_stats()
            # the host tier's payloads: page-locked on the card
            out["pinned_host_bytes"] = out["tier_stats"]["store"]["host_bytes"]
            return served
        finally:
            await engine.stop(keep_group=after is not None)

    served = asyncio.run(run())
    if after is not None:
        try:
            out["after"] = after(engine)
        finally:
            engine.close_ranks()
    out["payloads"] = payloads
    engine.submit = submit
    out["streams"] = [r.generated for r in served]
    out["ttft_ms"] = [(r.first_token_ts - r.created) * 1e3 for r in served]
    out["hist"] = [r.hist for r in served]
    out["prompt_tokens"] = len(served[0].prompt_ids)
    client.spill, client.restore = real_spill, real_restore
    out["spill_ms"] = spread(client.spill_ms)
    out["restore_ms"] = spread(client.restore_ms)
    out["restored"] = {h.hex()[:12]: [tier for tier, _ in hits] for h, hits in restored.items()}
    # each restored page against the page as it was when it spilled
    diffs = []
    for key_hash, hits in restored.items():
        for tier, page in hits:
            before = spilled[key_hash]
            diffs.append(max(float((a.float() - b.float()).abs().max())
                             for a, b in zip(page, before)))
            if mode != "int8_spill":
                check(all(torch.equal(a, b) for a, b in zip(page, before)),
                      f"a page restored from {tier} differs from the page spilled")
    out["restored_max_abs_diff"] = max(diffs, default=None)
    return out


def spill_wait(torch, engine, runs: int = 5) -> dict:
    """What a spill costs a decode step it overlaps: one greedy K = 1 replay
    over 8 columns of 300 tokens, its outputs read back (host wall, launch
    to read back), alone and with one page's spill read
    (``_read_page_payload``, which waits on its D2H copy's event behind
    the replay) between the launch and the read back, each payload kept
    as the host tier keeps it (so each read allocates fresh page-locked
    buffers); medians. Then the spill read alone on an idle card, its
    buffers reused from the host allocator's cache (each payload dropped)
    and freshly allocated (each payload kept)."""
    lens = [300] * engine.config.max_batch
    alone, with_spill = [], []
    kept = []
    with staged_replays(torch, engine, lens, 1) as (stage, launch):
        page = engine.allocator._slots[0][0]
        for _ in range(runs):
            for walls, spill in ((alone, False), (with_spill, True)):
                stage()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                handle = launch()
                if spill:
                    kept.append(engine._read_page_payload(page))
                engine._graphs.fetch(handle)
                walls.append((time.perf_counter() - t0) * 1e3)
        reads = {"cached": [], "fresh": []}
        for kind in reads:
            for _ in range(runs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                payload = engine._read_page_payload(page)
                reads[kind].append((time.perf_counter() - t0) * 1e3)
                if kind == "fresh":
                    kept.append(payload)
        del kept
    replay, spilled = statistics.median(alone), statistics.median(with_spill)
    return {"replay_ms": replay, "replay_with_spill_ms": spilled,
            "extra_ms": spilled - replay,
            "read_ms_cached_buffers": statistics.median(reads["cached"]),
            "read_ms_fresh_buffers": statistics.median(reads["fresh"])}


def payload_bytes(model: str, int8: bool, page_size: int = 128) -> int:
    """Bytes of one page's spill payload: int8 K and V (an int8 pool, or
    the int8 spill) or the f32 container, and two f32 scales per (layer,
    KV head)."""
    from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS

    cfg = MODEL_CONFIGS[model]
    elems = cfg.n_layers * page_size * cfg.n_kv_heads * cfg.head_dim
    return 2 * elems * (1 if int8 else 4) + 2 * cfg.n_layers * cfg.n_kv_heads * 4


def tier_rates(run: dict, nbytes: int) -> dict:
    """Spill and restore ms per page and the GB/s they imply."""
    spill, restore = run["spill_ms"]["median"], run["restore_ms"]["median"]
    return {"payload_bytes": nbytes, "spill_ms": run["spill_ms"], "restore_ms": run["restore_ms"],
            "d2h_gbps": nbytes / spill / 1e6 if spill else None,
            "h2d_gbps": nbytes / restore / 1e6 if restore else None}


def check_tier_hit(run: dict, tier: str, pages: int, layers: int) -> None:
    """The restored hit: ``pages`` full pages from ``tier``, its history
    prefill one chunk-kernel launch per layer and no cold prefill."""
    tokens = pages * 128
    check(run["hist"][1] == tokens, f"the hit covered {run['hist'][1]} tokens, not {tokens}")
    want = {t: (tokens if t == tier else 0) for t in run["hit_tokens"]}
    check(run["hit_tokens"] == want, f"tier_hit_tokens {run['hit_tokens']}, not {want}")
    chunk, flash = run["hit_chunk_launches"], run["hit_flash_launches"]
    check(chunk == layers and flash == 0,
          f"the restored hit launched the chunk kernel {chunk} and flash {flash} times")


def tiers_phase(torch, dev, model: str = "llama3-8b") -> tuple[dict, dict, dict, dict]:
    """``engine_llama3_8b_tiers`` and ``engine_llama3_8b_int8_kv_tiers``:
    llama3-8b at full width and depth, bf16 weights (one seeded draw for
    every engine here), ``prefix_tiers`` on, max_seq_len 2048, the
    system-prompt request sent cold, then after two summaries that evict
    its three pages (a 16-page pool), again: its history comes back from
    the tiers. Four bf16-page runs: a pool that never evicts (512 pages:
    the resident hit, the stream the restored hits must give; one fed
    decode dispatch's device events; a spill's cost inside a decode step),
    the lossless spill from host RAM (``tier_spill_quant=""``; then a
    planted collision: a miss and the cold stream), the same from disk (a
    host budget of one page, a private temporary directory; then a
    ``tier.disk.write`` error counted), and the default int8 spill (tokens
    matching are reported). Then the int8 pool (the long phase's storage,
    15 pages): its bytes and scales spill as they are; the restored hit
    runs row 2b and gives the resident hit's stream. Restored pages equal
    the pages spilled, on the card, wherever the round trip is lossless.
    The fourth value is what ``rank1_tiers_phase`` holds the rank path to:
    the restored hits' streams, the lossless run's chain payloads and the
    spill and restore rates."""
    from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS
    from mcp_context_forge_tpu_torch.tpu_local.models.llama import init_params

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(MODEL_CONFIGS[model], gen, torch.bfloat16, dev)
    layers = MODEL_CONFIGS[model].n_layers
    counts = dict.fromkeys(REPLACES, 0)
    runs = {}

    def run(name, mode, **kwargs):
        engine = tier_engine(model, params, **kwargs)
        result = tier_run(torch, engine, mode)
        for k in counts:
            counts[k] += result["launches"][k]
        int8 = bool(engine.config.kv_quant or engine.config.tier_spill_quant)
        result["payload_bytes"] = payload_bytes(model, int8)
        runs[name] = result
        return engine

    engine = run("hbm", "hbm", prefix_tiers=True, tier_spill_quant="")
    ref = runs["hbm"]
    check(ref["hist"][1:] == [384, 384] and ref["streams"][1] == ref["streams"][2],
          f"the resident hits covered {ref['hist'][1:]} tokens or gave two streams")
    events = replay_device_events(torch, engine, [300] * engine.config.max_batch)
    check(events["device_events"] == DECODE_REPLAY_EVENTS,
          f"one fed decode dispatch with the tiers on ran {events['device_events']} device "
          f"events, not {DECODE_REPLAY_EVENTS}")
    wait = spill_wait(torch, engine)
    del engine
    free_device(torch)
    one_page = payload_bytes(model, int8=False)
    for name, tier, kwargs in (
            ("host", "host", dict(tier_spill_quant="", tier_host_bytes=2**31)),
            ("disk", "disk", dict(tier_spill_quant="", tier_host_bytes=one_page + 1,
                                  tier_disk_bytes=2**30)),
            ("int8_spill", "host", dict(tier_host_bytes=2**31))):
        engine = run(name, name, prefix_tiers=True, num_pages=TIER_POOL_PAGES, **kwargs)
        del engine
        free_device(torch)
        check_tier_hit(runs[name], tier, 3, layers)
    for name in ("host", "disk"):
        check(runs[name]["streams"][1] == ref["streams"][1],
              f"the hit restored from {name} gave another stream than the resident hit")
    collision = runs["host"]["collision"]
    check(collision["collisions"] == 1 and not collision["probe_after"]
          and collision["hist"] == 0 and runs["host"]["streams"][2] == runs["host"]["streams"][0],
          f"the planted collision was not a miss giving the cold stream: {collision}")
    check(runs["disk"]["disk_write_errors"] >= 1, "the armed tier.disk.write error was not counted")
    int8_match = sum(a == b for a, b in zip(runs["int8_spill"]["streams"][1], ref["streams"][1]))
    ttft = {"cold": runs["host"]["ttft_ms"][0], "hbm": ref["ttft_ms"][2],
            "host": runs["host"]["ttft_ms"][1], "disk": runs["disk"]["ttft_ms"][1],
            "int8_spill": runs["int8_spill"]["ttft_ms"][1]}
    bf16 = {"model": model, "layers": layers, "weights": "random (seed 0)",
            "dtype": "bfloat16", "pool_pages": TIER_POOL_PAGES,
            "prompt_tokens": ref["prompt_tokens"], "hit_tokens": 384,
            "ttft_ms": ttft, "spill_wait": wait, "replay_device_events": events,
            "rates": {name: tier_rates(runs[name], runs[name]["payload_bytes"])
                      for name in ("host", "disk", "int8_spill")},
            "int8_spill_tokens_matching": [int8_match, len(ref["streams"][1])],
            "chunk_launches_on_restored_hit": {name: runs[name]["hit_chunk_launches"]
                                               for name in ("host", "disk", "int8_spill")},
            "pinned_host_bytes": {name: runs[name]["pinned_host_bytes"]
                                  for name in ("host", "disk", "int8_spill")},
            "peak_memory_bytes": {name: r["peak_memory_bytes"] for name, r in runs.items()},
            "streams_equal_resident_hit": {"host": True, "disk": True},
            "restored_equal_spilled": {"host": True, "disk": True},
            "collision": collision, "disk_write_errors": runs["disk"]["disk_write_errors"],
            "runs": {name: {k: v for k, v in r.items() if k not in RUN_DETAIL}
                     for name, r in runs.items()}}
    int8_runs = {}
    for name, kwargs in (("hbm", {}), ("tiers", dict(num_pages=TIER_INT8_BUDGET))):
        engine = tier_engine(model, params, prefix_tiers=True, kv_quant="int8", **kwargs)
        int8_runs[name] = tier_run(torch, engine, "hbm" if name == "hbm" else "int8_pool")
        for k in counts:
            counts[k] += int8_runs[name]["launches"][k]
        int8_runs[name]["pool_pages"] = engine.num_kv_pages
        int8_runs[name]["payload_bytes"] = payload_bytes(model, int8=True)
        del engine
        free_device(torch)
    q8 = int8_runs["tiers"]
    check(q8["pool_pages"] == 15, f"the int8 tier pool has {q8['pool_pages']} pages")
    check_tier_hit(q8, "host", 3, layers)
    check(q8["hit_launches"]["paged_chunk_attention_tc_q8"] == layers,
          "the restored hit on the int8 pool did not run row 2b once per layer")
    check(q8["streams"][1] == int8_runs["hbm"]["streams"][1],
          "the hit restored into the int8 pool gave another stream than the resident hit")
    int8 = {"model": model, "layers": layers, "kv_quant": "int8",
            "pool_pages": q8["pool_pages"], "hit_tokens": 384,
            "ttft_ms": {"cold": q8["ttft_ms"][0], "hbm": int8_runs["hbm"]["ttft_ms"][2],
                        "host": q8["ttft_ms"][1]},
            "rates": tier_rates(q8, q8["payload_bytes"]),
            "chunk_launches_on_restored_hit": q8["hit_chunk_launches"],
            "pinned_host_bytes": q8["pinned_host_bytes"],
            "peak_memory_bytes": {name: r["peak_memory_bytes"] for name, r in int8_runs.items()},
            "restored_equal_spilled": True, "stream_equal_resident_hit": True,
            "runs": {name: {k: v for k, v in r.items() if k not in RUN_DETAIL}
                     for name, r in int8_runs.items()}}
    del params
    reference = {"streams": {name: runs[name]["streams"] for name in ("host", "int8_spill")},
                 "payloads": runs["host"]["payloads"], "rates": bf16["rates"]}
    return counts, bf16, int8, reference


def tiny_tiers_phase(torch, dev, reference: list) -> tuple[dict, dict]:
    """``engine_llama3_tiny_f32_tiers``: llama3-tiny in f32 (seed 0, the
    weights of ``engine_llama3_tiny_f32``), the lossless spill on the
    16-page pool: the request restored from host RAM gives exactly the
    stream ``engine_llama3_tiny_f32`` gave it as a resident hit, its
    restored pages equal the pages spilled, and the planted collision is a
    miss that gives the cold stream."""
    engine = tier_engine("llama3-tiny", None, dtype="float32", prefix_tiers=True,
                         tier_spill_quant="", num_pages=TIER_POOL_PAGES)
    run = tier_run(torch, engine, "host")
    layers = engine.model_config.n_layers
    del engine
    check_tier_hit(run, "host", 3, layers)
    check(run["streams"][1] == reference[1],
          "the restored hit's stream differs from engine_llama3_tiny_f32's")
    collision = run["collision"]
    check(collision["collisions"] == 1 and collision["hist"] == 0
          and run["streams"][2] == run["streams"][0],
          f"the planted collision was not a miss giving the cold stream: {collision}")
    stats = {"model": "llama3-tiny", "dtype": "float32", "pool_pages": TIER_POOL_PAGES,
             "stream_equal_engine_llama3_tiny_f32": True, "restored_equal_spilled": True,
             "ttft_ms": {"cold": run["ttft_ms"][0], "host": run["ttft_ms"][1]},
             "rates": tier_rates(run, payload_bytes("llama3-tiny", int8=False)),
             **{k: v for k, v in run.items()
                if k not in RUN_DETAIL + ("ttft_ms", "spill_ms", "restore_ms")}}
    return run["launches"], stats


# ------------------------------------------------------------- replica pool

POOL_PAGES = 256
POOL_HOST_BYTES = 2**30       # 31 lossless llama3-8b pages of 33,556,480 B
POOL_HEARTBEAT_S = 3.0
POOL_TOKENS = 32
# the migrated request's system prompt: as long as SYSTEM (three full pages
# and a tail), sharing no page with it, so no cache holds it before the hop
MIGRATE_SYSTEM = ("You route tool calls for an MCP gateway. Answer with the tools this "
                  "conversation lists and keep to their JSON schemas. Say which server "
                  "served every call. Be brief and plain. Do not make up tools, servers "
                  "or results. If a call fails, name the tool and the reason, then stop. "
                  "Before a call that writes, deletes or sends data, ask first. "
                  "Between two tools that can answer, pick the read-only one.")


def pool_config(model: str, dtype: str, **kwargs):
    """A replica's config: ``engine_phase``'s shapes on a 256-page pool,
    ``prefix_tiers`` on with the lossless spill into one shared host store
    of 1 GiB (no disk)."""
    from mcp_context_forge_tpu_torch.tpu_local.engine import EngineConfig

    config = dict(model=model, dtype=dtype, device="cuda", max_batch=8, max_seq_len=2048,
                  page_size=128, num_pages=POOL_PAGES, prefill_buckets=(128, 512, 2048),
                  prefill_max_batch=4, seed=0, prefix_tiers=True, tier_spill_quant="",
                  tier_host_bytes=POOL_HOST_BYTES, tier_disk_bytes=0)
    return EngineConfig(**{**config, **kwargs})


class PoolRecorder:
    """What a pool's factory built (each engine, weakly, with its build
    seconds and a sibling's decode steps retired meanwhile) and what
    reached each engine (every shadow, in order). ``on_submit`` hooks see
    each shadow as it is submitted. ``serving_events()`` reads every
    engine's serving-stage builds and captures: a replaced engine's when
    the next one is built, the others' at the call."""

    def __init__(self):
        self.engines: list = []            # weak references
        self.retired_serving: list[int] = []
        self.builds: list[dict] = []
        self.shadows: list[tuple[str, object]] = []
        self.on_submit: list = []
        self.watch = None   # a replica whose decode steps a build reports

    def factory(self, cfg, tracer, metrics, ledger=None, tier_store=None, prefix_index=None):
        from mcp_context_forge_tpu_torch.tpu_local.engine import TorchEngine

        watched = self.watch.engine.stats.decode_steps if self.watch is not None else None
        for ref in self.engines:
            old = ref()
            if old is not None and old.config.replica_id == cfg.replica_id:
                self.retired_serving.append(old.compile_stats()["serving"]["count"])
        t0 = time.monotonic()
        engine = TorchEngine(cfg, tracer=tracer, metrics=metrics, ledger=ledger,
                             tier_store=tier_store, prefix_index=prefix_index)
        build = {"replica": cfg.replica_id, "seconds": time.monotonic() - t0}
        if watched is not None:
            build["sibling_decode_steps_during_build"] = (
                self.watch.engine.stats.decode_steps - watched)
        self.builds.append(build)
        self.engines.append(weakref.ref(engine))
        engine_ref = weakref.ref(engine)   # no cycle through the recorder

        async def recording_submit(shadow):
            self.shadows.append((cfg.replica_id, shadow))
            for hook in self.on_submit:
                hook(cfg.replica_id, shadow)
            return await TorchEngine.submit(engine_ref(), shadow)

        engine.submit = recording_submit
        return engine

    def serving_events(self, replicas) -> list[int]:
        return self.retired_serving + [r.engine.compile_stats()["serving"]["count"]
                                       for r in replicas]

    def shadow(self, request_id: str):
        return next(s for _, s in self.shadows if s.request_id == request_id)

    def replica_of(self, request_id: str) -> str:
        return next(rid for rid, s in self.shadows if s.request_id == request_id)


async def timed_stream(request) -> list[tuple[int, float]]:
    out = []
    while (token := await asyncio.wait_for(request.stream.get(), 300)) is not None:
        out.append((token, time.monotonic()))
    return out


def standalone_reference(torch, model: str, dtype: str, ids: list[int]) -> dict:
    """One engine (the replicas' config and weights, no tiers): ``ids`` cold,
    then the continuation (``ids`` and the first token) as a resident prefix
    hit: what a migrated stream must give."""
    from mcp_context_forge_tpu_torch.tpu_local.engine import GenRequest, TorchEngine

    engine = TorchEngine(pool_config(model, dtype, prefix_tiers=False))

    async def run():
        await engine.start()
        try:
            out = []
            for rid, prompt, n in (("cold", ids, POOL_TOKENS), ("hit", None, POOL_TOKENS - 1)):
                prompt = prompt or ids + out[0][0][:1]
                request = GenRequest(request_id=rid, prompt_ids=prompt, max_tokens=n)
                await engine.submit(request)
                out.append(([t for t, _ in await timed_stream(request)], request.hist))
            return out
        finally:
            await engine.stop()

    (cold, cold_hist), (hit, hit_hist) = asyncio.run(run())
    check(cold_hist == 0 and hit_hist == (len(ids) + 1) // 128 * 128,
          f"the standalone reference ran {cold_hist} / {hit_hist} cached tokens")
    del engine
    free_device(torch)
    return {"cold": cold, "hit": hit, "hit_tokens": hit_hist}


def pool_phase(torch, dev, model: str, dtype: str, reference: dict, kernels: tuple,
               absent: tuple) -> tuple[dict, dict]:
    """``engine_llama3_8b_pool`` / ``engine_llama3_tiny_f32_pool``: an
    ``EnginePool`` of two replicas of ``model`` at full width and depth on
    the one card (each its own weights, drawn from seed 0, its 256-page
    pool and its graphs; one shared host store, the lossless spill; the
    health monitor at 0.1 s with a 3 s heartbeat bar), driven through the
    steps below. ``reference``: the engine phase's stats of the same model
    (its streams, the hit of each request). Every kernel count is reset
    just before step 1 and read after step 6; each of ``kernels`` must have
    launched, none of ``absent``. No kernel library is built and no graph
    captured on a dispatch thread, on any engine the pool built.

    1. Parity: ``engine``'s six requests through ``TorchLocalProvider.chat``
       over the pool (the first alone until its first token), then through
       ``EnginePool.generate``. Where a request hit as many cached tokens as
       in the engine phase (in bf16: and its prefill call had the same
       bucket and rows), its stream must equal that phase's; both
       replicas are routed; the system-prompt repeat is an affinity hit on
       the replica holding its 384 tokens.
    2. Failover: ``fail_replica`` on the serving replica after four tokens
       of a 32-token request: 32 tokens, the delivered prefix equal to the
       engine phase's, one requeue and a ``pool.requeue`` span; in f32 the
       whole stream equal. The gap around the hop is printed.
    3. Recovery under load: the dead replica reloads while the survivor
       serves six requests of 160 tokens (its decode steps advance during
       the build); every stream whole, the rebuilt replica ready. Then its
       decode dispatch blocks host-side: the health monitor fails it over
       (the detection seconds printed), and both requests sent finish.
    4. Spill on drain: the dead replica reloads, then the survivor reloads,
       spilling its resident prefix pages (>= 3); the rebuilt replica then
       serves the system-prompt repeat from the host tier (384 tokens) with
       the resident hit's stream. Aggregate decode tokens/s: eight
       128-token requests on one replica, then sixteen on both.
    5. Disaggregation: replica 0 ``prefill``, 1 ``decode``; a request whose
       system prompt no cache holds migrates: ok, 3 pages spilled and 3
       restored, 3 lossless payloads of bytes moved, its first token the
       cold run's and the rest the resident hit's of its continuation
       (``standalone_reference``), the chunk kernel once per layer and no
       flash on the decode leg. Then ``pool.migrate`` armed ``corrupt``:
       the hop degrades in place and the stream is whole.
    6. Capacity loss: with ``requeue_max`` 0 a killed replica's request ends
       "unavailable" and the provider raises ``LLMUnavailable``."""
    from mcp_context_forge_tpu_torch.observability import faults
    from mcp_context_forge_tpu_torch.observability.tracing import Tracer
    from mcp_context_forge_tpu_torch.tpu_local.engine import GenRequest
    from mcp_context_forge_tpu_torch.tpu_local.pool import EnginePool
    from mcp_context_forge_tpu_torch.tpu_local.provider import LLMUnavailable
    from mcp_context_forge_tpu_torch.tpu_local.tokenizer import load_tokenizer, render_chat
    from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS
    from mcp_context_forge_tpu_torch.tpu_local.tpu_provider import TorchLocalProvider

    cfg = MODEL_CONFIGS[model]
    layers = cfg.n_layers
    exact = dtype == "float32"
    tok = load_tokenizer(vocab_size=cfg.vocab_size)
    requests = chat_requests(model)
    ids = [tok.encode(render_chat(r["messages"])) for r in requests]
    check([len(i) for i in ids] == reference["prompt_tokens"],
          "the pool's prompts are not the engine phase's")
    migrate_ids = tok.encode(render_chat(chat(model, "Which servers answered today?",
                                              MIGRATE_SYSTEM)["messages"]))
    corrupt_ids = tok.encode(render_chat(chat(model, "List the failed calls.",
                                              MIGRATE_SYSTEM)["messages"]))
    check(migrate_ids[:128] != ids[0][:128] and len(migrate_ids) // 128 == 3,
          "the migrated prompt shares a page with SYSTEM or is not three pages")
    standalone = standalone_reference(torch, model, dtype, migrate_ids)
    ref_streams, ref_hist = reference["generated"], reference["prefix_hit_tokens"]

    wrappers = kernel_wrappers()
    tracer = Tracer(exporter="memory")
    rec = PoolRecorder()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    pool = EnginePool(pool_config(model, dtype), replicas=2, tracer=tracer,
                      health_interval_s=0.1, heartbeat_timeout_s=POOL_HEARTBEAT_S,
                      engine_factory=rec.factory)
    torch.cuda.synchronize()
    out: dict = {"model": model, "layers": layers, "dtype": dtype, "replicas": 2,
                 "pool_pages": POOL_PAGES, "weights": "random (seed 0), one tree per replica",
                 "pool_build_s": time.monotonic() - t0,
                 "build_peak_memory_bytes": torch.cuda.max_memory_allocated()}
    provider = TorchLocalProvider("tpu_local", pool)
    payload = payload_bytes(model, int8=False)

    async def generate(prompt, n=POOL_TOKENS, rid=None, **fields):
        request = GenRequest(request_id=rid or f"g{len(rec.shadows)}", prompt_ids=list(prompt),
                             max_tokens=n, **fields)
        await pool.submit(request)
        stream = await timed_stream(request)
        return request, [t for t, _ in stream], [ts for _, ts in stream]

    def span_of(name, trace_ctx):
        return [s for s in tracer.finished
                if s.name == name and s.trace_id == trace_ctx[0]]

    async def parity() -> dict:
        seen = []
        submit = pool.submit

        async def recording(request):
            seen.append(request)
            return await submit(request)

        pool.submit = recording
        try:
            first = asyncio.ensure_future(provider.chat(requests[0]))
            while not rec.shadows or rec.shadows[0][1].first_token_ts == 0.0:
                check(not first.done(), "the first request ended before its first token")
                await asyncio.sleep(0.002)
            rest = [asyncio.ensure_future(provider.chat(r)) for r in requests[1:]]
            await asyncio.wait_for(asyncio.gather(first, *rest), 300)
        finally:
            pool.submit = submit
        shadows = [rec.shadow(r.request_id) for r in seen]
        chat_streams = [r.generated for r in seen]
        routes = [rec.replica_of(r.request_id) for r in seen]
        ttft = [(s.first_token_ts - s.created) * 1e3 for s in shadows]
        gen_out = await asyncio.gather(*[generate(i, rid=f"gen{k}") for k, i in enumerate(ids)])
        gen_shadows = [rec.shadow(f"gen{k}") for k in range(len(ids))]

        def shape(shadow):
            """(cached tokens, bucket, rows of its prefill call) on its replica."""
            rid = rec.replica_of(shadow.request_id)
            rows = sum(r == rid and s.prefill_ms == shadow.prefill_ms for r, s in rec.shadows)
            return shadow.hist, shadow.bucket, rows

        ref_shapes = list(zip(ref_hist, reference["buckets"], reference["prefill_group"]))
        result = {"routes": routes, "shapes": [shape(s) for s in shadows],
                  "generate_shapes": [shape(s) for s in gen_shadows],
                  "engine_shapes": ref_shapes,
                  "ttft_ms": ttft, "ttft_p50_ms": statistics.median(ttft),
                  "engine_ttft_p50_ms": reference["ttft_p50_ms"],
                  "finish_reasons": [r.finish_reason for r in seen]}
        compared, equal, first_difference = [], [], {}
        for label, streams, shapes in (("chat", chat_streams, result["shapes"]),
                                       ("generate", [g[1] for g in gen_out],
                                        result["generate_shapes"])):
            for k, (stream, got) in enumerate(zip(streams, shapes)):
                check(len(stream) == POOL_TOKENS, f"{label} request {k} gave {len(stream)} tokens")
                same = stream == ref_streams[k]
                if not same:
                    first_difference[f"{label}{k}"] = next(
                        i for i, (a, b) in enumerate(zip(stream, ref_streams[k])) if a != b)
                # held where as many tokens were cached (f32), and in bf16
                # where the prefill call also had the engine phase's bucket
                # and rows: there a cold prefill alone and one batched with
                # others round apart (the GEMMs' M differs)
                if (got[0] == ref_shapes[k][0]) if exact else (got == ref_shapes[k]):
                    compared.append(f"{label}{k}")
                    if same:
                        equal.append(f"{label}{k}")
        result.update(compared_with_engine=compared, equal_engine=equal,
                      first_difference=first_difference)
        check(compared and equal == compared,
              f"streams differ from the engine phase's: compared {compared}, equal {equal}")
        check(len(set(routes)) == 2, f"the six requests took only replicas {routes}")
        check(routes[1] == routes[0] and shadows[1].hist == 384,
              f"the system-prompt repeat was not an affinity hit: routes {routes}, "
              f"hist {shadows[1].hist}")
        check(pool.router.affinity_hits >= 1, "the router counted no affinity hit")
        result["chat_stream_1"] = chat_streams[1]
        return result

    async def failover() -> dict:
        span_ctx = tracer.span("llm.request")
        span = span_ctx.__enter__()
        requeues = pool.requeues
        request = GenRequest(request_id="failover", prompt_ids=list(ids[3]),
                             max_tokens=POOL_TOKENS, trace_ctx=span.context())
        await pool.submit(request)
        stream = []
        while len(stream) < 4:
            token = await asyncio.wait_for(request.stream.get(), 120)
            check(token is not None, "the failover request ended before four tokens")
            stream.append((token, time.monotonic()))
        serving = next(r for r in pool.replicas if "failover" in r.outstanding)
        t_kill = time.monotonic()
        pool.fail_replica(serving, reason="chip smoke: kill after four tokens")
        stream += await timed_stream(request)
        span_ctx.__exit__(None, None, None)
        tokens = [t for t, _ in stream]
        delivered = len(rec.shadow("failover~r1").prompt_ids) - len(ids[3])
        check(len(tokens) == POOL_TOKENS and request.finish_reason == "length",
              f"the failover stream has {len(tokens)} tokens ({request.finish_reason})")
        check(tokens[:delivered] == ref_streams[3][:delivered],
              "the tokens delivered before the kill differ from the engine phase's")
        check(pool.requeues == requeues + 1 and serving.state == "dead",
              f"{pool.requeues - requeues} requeues, the replica {serving.state}")
        spans = span_of("pool.requeue", span.context())
        check(len(spans) == 1 and spans[0].attributes.get("llm.from_replica") == serving.id,
              "no pool.requeue span for the hop")
        after = tokens[delivered:]
        matching = sum(a == b for a, b in zip(after, ref_streams[3][delivered:]))
        if exact:
            check(tokens == ref_streams[3], "the failover stream differs from the engine phase's")
        first_after = stream[delivered][1]
        return {"killed": serving.id, "delivered_before_kill": delivered,
                "tokens_after_hop_matching_engine": [matching, len(after)],
                "gap_ms_kill_to_next_token": (first_after - t_kill) * 1e3,
                "gap_ms_last_to_next_token": (first_after - stream[delivered - 1][1]) * 1e3,
                "requeue_span_ms": spans[0].duration_ms,
                "stream_equal_engine": tokens == ref_streams[3]}, serving

    async def reload_under_load(dead) -> dict:
        survivor = next(r for r in pool.replicas if r is not dead)
        batch = [asyncio.ensure_future(generate(i, n=160, rid=f"load{k}"))
                 for k, i in enumerate(ids)]
        while sum(s.request_id.startswith("load") and s.first_token_ts > 0
                  for _, s in rec.shadows) < len(ids):
            await asyncio.sleep(0.002)
        rec.watch = survivor
        torch.cuda.reset_peak_memory_stats()
        status = await pool.reload(dead.id)
        reload_peak = torch.cuda.max_memory_allocated()
        rec.watch = None
        results = await asyncio.wait_for(asyncio.gather(*batch), 300)
        build = rec.builds[-1]
        check(status["state"] == "ready" and dead.engine.stats.graph_captures > 0,
              f"the reload ended {status['state']}")
        check(build["sibling_decode_steps_during_build"] > 0,
              "the survivor retired no decode step while the replica was rebuilt")
        for request, tokens, _ in results:
            check(len(tokens) == 160 and request.finish_reason == "length",
                  f"a stream served during the reload has {len(tokens)} tokens")
        # the rebuilt replica's decode dispatch blocks host-side
        rebuilt = dead.engine
        release = threading.Event()
        blocked_at = []
        launch = rebuilt._graphs.launch

        def blocking(*args, **kwargs):
            if not blocked_at:
                blocked_at.append(time.monotonic())
            release.wait(60)
            return launch(*args, **kwargs)

        rebuilt._graphs.launch = blocking
        failures = pool.health.failures
        sent = [asyncio.ensure_future(generate(ids[k], rid=f"wedge{k}")) for k in (3, 4)]
        while dead.state != "dead":
            check(not all(t.done() for t in sent), "the wedged replica was never failed over")
            await asyncio.sleep(0.01)
        detected_s = time.monotonic() - blocked_at[0]
        release.set()
        wedged = await asyncio.wait_for(asyncio.gather(*sent), 300)
        for request, tokens, _ in wedged:
            check(len(tokens) == POOL_TOKENS and request.finish_reason == "length",
                  f"a request of the wedged replica has {len(tokens)} tokens")
        check(pool.health.failures == failures + 1, "the health monitor failed no replica")
        return {"reload_peak_memory_bytes": reload_peak, "build": build,
                "survivor_streams_whole": True, "wedge_detected_s": detected_s,
                "wedge_last_failure": dead.last_failure}

    async def spill_on_drain(dead) -> dict:
        torch.cuda.reset_peak_memory_stats()
        await pool.reload(dead.id)
        peaks = [torch.cuda.max_memory_allocated()]
        survivor = next(r for r in pool.replicas if r is not dead)
        spilled = []
        real_spill = survivor.engine.spill_prefix_pages

        def counting_spill():
            spilled.append(real_spill())
            return spilled[-1]

        survivor.engine.spill_prefix_pages = counting_spill
        torch.cuda.reset_peak_memory_stats()
        await pool.reload(survivor.id)
        peaks.append(torch.cuda.max_memory_allocated())
        check(spilled and spilled[0] >= 3, f"spill on drain spilled {spilled} pages")
        other = dead
        await pool.drain(other.id)
        _, tokens, _ = await generate(ids[1], rid="restored")
        await pool.undrain(other.id)
        engine = survivor.engine
        check(rec.replica_of("restored") == survivor.id, "the repeat missed the rebuilt replica")
        hits = dict(engine.allocator.tier_hit_tokens)
        check(hits.get("host") == 384 and rec.shadow("restored").hist == 384,
              f"the rebuilt replica's tier hits are {hits}")
        return {"spill_prefix_pages": spilled[0], "tier_hit_tokens": hits,
                "reload_peak_memory_bytes": peaks, "stream": tokens}

    async def tokens_per_s(replicas) -> dict:
        prompts = [tok.encode(render_chat([{"role": "user", "content":
                                            f"Name {k + 2} tools an MCP server can offer."}]))
                   for k in range(8 * len(replicas))]
        steps0 = {r.id: (r.engine.stats.completion_tokens - r.engine.stats.prefill_requests,
                         r.engine.stats.decode_wall_ms_total) for r in pool.replicas}
        t0 = time.monotonic()
        results = await asyncio.gather(*[generate(p, n=128, rid=f"tps{len(replicas)}-{k}")
                                         for k, p in enumerate(prompts)])
        first = min(ts[0] for _, _, ts in results)
        last = max(ts[-1] for _, _, ts in results)
        decode_tokens = sum(len(t) - 1 for _, t, _ in results)
        per_replica = {}
        for r in pool.replicas:
            toks = r.engine.stats.completion_tokens - r.engine.stats.prefill_requests
            wall = r.engine.stats.decode_wall_ms_total
            if toks > steps0[r.id][0]:
                per_replica[r.id] = (toks - steps0[r.id][0]) / ((wall - steps0[r.id][1]) / 1e3)
        routed = {rid: sum(rec.replica_of(f"tps{len(replicas)}-{k}") == rid
                           for k in range(len(prompts))) for rid in ("0", "1")}
        return {"requests": len(prompts), "routed": routed, "decode_tokens": decode_tokens,
                "wall_s": time.monotonic() - t0,
                "tokens_per_s_first_to_last_token": decode_tokens / (last - first),
                "tokens_per_s_by_engine_walls": per_replica,
                "tokens_per_s_engine_walls_sum": sum(per_replica.values())}

    async def disaggregation() -> dict:
        prefill, decode = pool.replicas
        pool.set_role(prefill.id, "prefill")
        pool.set_role(decode.id, "decode")
        counts_at: dict = {}

        def snapshot(rid, shadow):
            if rid == decode.id and shadow.request_id == "migrate~r1":
                counts_at["decode_leg"] = {k: fn.launches for k, fn in wrappers.items()}

        rec.on_submit.append(snapshot)
        migrations, pages, nbytes = dict(pool.migrations), dict(pool.migration_pages), \
            pool.migration_bytes
        span_ctx = tracer.span("llm.request")
        span = span_ctx.__enter__()
        at_start = {k: fn.launches for k, fn in wrappers.items()}
        sent = time.monotonic()
        request, tokens, stamps = await generate(migrate_ids, rid="migrate",
                                                 trace_ctx=span.context())
        at_end = {k: fn.launches for k, fn in wrappers.items()}
        span_ctx.__exit__(None, None, None)
        rec.on_submit.remove(snapshot)
        check("decode_leg" in counts_at, "the continuation never reached the decode replica")
        leg = counts_at["decode_leg"]
        decode_leg = {k: at_end[k] - leg[k] for k in wrappers}
        prefill_leg = {k: leg[k] - at_start[k] for k in wrappers}
        moved = {k: pool.migration_pages[k] - pages[k] for k in pages}
        check(pool.migrations["ok"] == migrations["ok"] + 1,
              f"migrations {pool.migrations} (were {migrations})")
        check(moved == {"spilled": 3, "restored": 3, "degraded": 0}, f"migration pages {moved}")
        check(pool.migration_bytes - nbytes == 3 * payload,
              f"{pool.migration_bytes - nbytes} bytes moved, not {3 * payload}")
        check(tokens[0] == standalone["cold"][0],
              "the migrated stream's first token is not the cold run's")
        check(tokens[1:] == standalone["hit"],
              "the migrated continuation differs from the resident hit's")
        check(sum(decode_leg[k] for k in CHUNK) == layers
              and sum(decode_leg[k] for k in FLASH) == 0,
              f"the decode leg launched chunk {sum(decode_leg[k] for k in CHUNK)} and flash "
              f"{sum(decode_leg[k] for k in FLASH)} times")
        check(sum(prefill_leg[k] for k in FLASH) == layers,
              "the prefill leg was not one cold prefill")
        check(rec.shadow("migrate~r1").hist == 384 and rec.replica_of("migrate~r1") == decode.id,
              "the decode leg did not restore the chain")
        spans = span_of("pool.migrate", span.context())
        check(len(spans) == 1 and spans[0].attributes.get("llm.outcome") == "ok",
              "no pool.migrate span with outcome ok")
        result = {"roles": {r.id: r.role for r in pool.replicas}, "pages": moved,
                  "bytes": pool.migration_bytes - nbytes, "prompt_tokens": len(migrate_ids),
                  "migration_ms": spans[0].duration_ms,
                  "ttft_ms": (stamps[0] - sent) * 1e3,
                  "decode_leg_chunk_launches": sum(decode_leg[k] for k in CHUNK),
                  "first_token_equal_cold_run": True, "rest_equal_resident_hit": True}
        # the corrupt fault: the verify fails, the hop degrades in place
        degraded = pool.migrations["degraded"]
        plane = faults.configure_fault_plane(True)
        try:
            plane.arm(faults.FaultRule(point="pool.migrate", kind="corrupt"))
            corrupt, ctokens, _ = await generate(corrupt_ids, rid="corrupt")
        finally:
            faults.configure_fault_plane(False)
        check(pool.migrations["degraded"] == degraded + 1
              and rec.replica_of("corrupt~r1") == prefill.id,
              "the corrupt migration did not degrade in place")
        check(len(ctokens) == POOL_TOKENS and corrupt.finish_reason == "length",
              f"the degraded stream has {len(ctokens)} tokens")
        pages_now = pool.migration_pages
        check(pages_now["spilled"] == pages_now["restored"] + pages_now["degraded"],
              f"pages not conserved: {pages_now}")
        result["corrupt"] = {"degraded": True, "stream_whole": True,
                             "pages": dict(pages_now)}
        for r in pool.replicas:
            pool.set_role(r.id, "any")
        return result

    async def capacity_loss() -> dict:
        pool.requeue_max = 0
        task = asyncio.ensure_future(provider.chat(requests[4]))
        while not any(r.outstanding for r in pool.replicas):
            await asyncio.sleep(0.002)
        victim = next(r for r in pool.replicas if r.outstanding)
        pool.fail_replica(victim, reason="chip smoke: capacity loss")
        outcome = "returned"
        try:
            await asyncio.wait_for(task, 120)
        except LLMUnavailable:
            outcome = "LLMUnavailable"
        check(outcome == "LLMUnavailable", f"the provider {outcome} after capacity loss")
        return {"killed": victim.id, "provider": outcome}

    async def run():
        await pool.start()
        try:
            for fn in wrappers.values():
                fn.launches = 0
            t_start = time.monotonic()
            out["parity"] = await parity()
            out["failover"], dead = await failover()
            out["reload_under_load"] = await reload_under_load(dead)
            out["spill_on_drain"] = await spill_on_drain(dead)
            check(out["spill_on_drain"]["stream"] == out["parity"]["chat_stream_1"],
                  "the hit restored from host gave another stream than the resident hit")
            await pool.drain("1")
            out["tokens_per_s_one_replica"] = await tokens_per_s(["0"])
            await pool.undrain("1")
            out["tokens_per_s_two_replicas"] = await tokens_per_s(["0", "1"])
            out["disaggregation"] = await disaggregation()
            out["capacity_loss"] = await capacity_loss()
            out["steps_s"] = time.monotonic() - t_start
            out["launches"] = {k: fn.launches for k, fn in wrappers.items()}
            out["status"] = pool.status()
        finally:
            await pool.stop()

    asyncio.run(run())
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    out["builds"] = rec.builds
    launches = out.pop("launches")
    for kernel in kernels:
        check(launches[kernel] > 0, f"{kernel} never launched on the {model} pool path")
    for kernel in absent:
        check(launches[kernel] == 0, f"{kernel} launched on the {model} pool path")
    out["compile_stats_serving"] = rec.serving_events(pool.replicas)
    check(len(out["compile_stats_serving"]) == len(rec.builds)
          and not any(out["compile_stats_serving"]),
          f"engines built or captured while serving: {out['compile_stats_serving']}")
    # one fed decode dispatch per replica, its dispatch thread ended
    events = []
    for replica in pool.replicas:
        thread = replica.engine._thread
        if thread is not None:
            thread.join(30)
        events.append(replay_device_events(torch, replica.engine,
                                           [300] * replica.engine.config.max_batch))
    out["replay_device_events"] = events
    for replica in out["status"]["replicas"]:
        replica.pop("roofline", None)
    out["parity"].pop("chat_stream_1")
    out["spill_on_drain"].pop("stream")
    out["migrate_reference"] = standalone
    del pool, provider, rec
    free_device(torch)
    return launches, out


def int8_pool_migration(torch, dev, model: str = "llama3-tiny") -> tuple[dict, dict]:
    """One migration on int8 KV pages (llama3-tiny, f32 compute): the decode
    replica's restored chain pages equal the prefill replica's bit for bit
    (bytes and scales), through rows 2b and 3b and the int8 writers."""
    from mcp_context_forge_tpu_torch.tpu_local.engine import GenRequest
    from mcp_context_forge_tpu_torch.tpu_local.pool import EnginePool
    from mcp_context_forge_tpu_torch.tpu_local.tokenizer import load_tokenizer, render_chat
    from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS

    tok = load_tokenizer(vocab_size=MODEL_CONFIGS[model].vocab_size)
    ids = tok.encode(render_chat(chat(model, "Which servers answered today?",
                                      MIGRATE_SYSTEM)["messages"]))
    pool = EnginePool(pool_config(model, "float32", kv_quant="int8", num_pages=64),
                      replicas=2, roles="prefill,decode", health_interval_s=0.1,
                      heartbeat_timeout_s=POOL_HEARTBEAT_S)
    wrappers = kernel_wrappers()

    async def run():
        await pool.start()
        try:
            for fn in wrappers.values():
                fn.launches = 0
            request = GenRequest(request_id="migrate-int8", prompt_ids=ids,
                                 max_tokens=POOL_TOKENS)
            await pool.submit(request)
            tokens = [t for t, _ in await timed_stream(request)]
            return request, tokens, {k: fn.launches for k, fn in wrappers.items()}
        finally:
            await pool.stop()

    request, tokens, launches = asyncio.run(run())
    check(pool.migrations == {"ok": 1, "degraded": 0}
          and pool.migration_pages == {"spilled": 3, "restored": 3, "degraded": 0},
          f"the int8 migration: {pool.migrations}, {pool.migration_pages}")
    check(len(tokens) == POOL_TOKENS and request.finish_reason == "length",
          f"the int8 migrated stream has {len(tokens)} tokens")
    src, dst = (r.engine for r in pool.replicas)
    pages = 0
    for key, *_ in src.allocator._chain_steps(ids, full=True):
        a, b = src.allocator._cached[key], dst.allocator._cached[key]
        for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
            check(torch.equal(getattr(src.kv, name)[:, a], getattr(dst.kv, name)[:, b]),
                  f"restored {name} of a chain page differ from the exported ones")
        pages += 1
    check(pages == 3, f"{pages} chain pages compared")
    for kernel in ("paged_chunk_attention_mma_q8", "paged_decode_attention_q8") + INT8_WRITERS:
        check(launches[kernel] > 0, f"{kernel} never launched on the int8 migration")
    stats = {"model": model, "kv_quant": "int8", "pages_bit_exact": pages,
             "migrations": dict(pool.migrations), "pages": dict(pool.migration_pages),
             "bytes": pool.migration_bytes, "launches": launches}
    del pool, src, dst
    free_device(torch)
    return launches, stats


# --------------------------------------------------------------- checkpoints

CKPT_SEED = 10
# llama3-8b's checkpoint phase runs at full depth (32 layers, 16.06 GB of bf16)
CKPT_LLAMA_LAYERS = 32


def depth_config(model: str, n_layers: int):
    """``model``'s config, registered as ``<model>-<n>-layers`` when
    ``n_layers`` cuts its depth (the name the checkpoint and the engine
    both use)."""
    from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS

    cfg = MODEL_CONFIGS[model]
    if n_layers == cfg.n_layers:
        return cfg
    name = f"{model}-{n_layers}-layers"
    MODEL_CONFIGS[name] = dataclasses.replace(cfg, name=name, n_layers=n_layers)
    return MODEL_CONFIGS[name]


def hf_specs(cfg) -> list[tuple]:
    """Every tensor of an HF checkpoint of ``cfg``, in the order HF shards
    hold them (embedding first, head last): (HF name, tree path, shape in
    the tree's [in, out] layout, transposed in the file, expert index or
    None, fan-in; 0 for a norm)."""
    D, F, hd, E = cfg.dim, cfg.ffn_hidden, cfg.head_dim, cfg.n_experts
    specs = [("model.embed_tokens.weight", ("embed",), (cfg.vocab_size, D), False, None, D)]
    for i in range(cfg.n_layers):
        p, at = f"model.layers.{i}.", ("layers", i)
        specs += [
            (p + "input_layernorm.weight", at + ("attn_norm",), (D,), False, None, 0),
            (p + "self_attn.q_proj.weight", at + ("wq",), (D, cfg.n_heads * hd), True, None, D),
            (p + "self_attn.k_proj.weight", at + ("wk",), (D, cfg.n_kv_heads * hd), True, None, D),
            (p + "self_attn.v_proj.weight", at + ("wv",), (D, cfg.n_kv_heads * hd), True, None, D),
            (p + "self_attn.o_proj.weight", at + ("wo",), (cfg.n_heads * hd, D), True, None,
             cfg.n_heads * hd),
            (p + "post_attention_layernorm.weight", at + ("ffn_norm",), (D,), False, None, 0)]
        if E:
            specs.append((p + "block_sparse_moe.gate.weight", at + ("router",), (D, E), True,
                          None, D))
            for m in range(E):
                for name, shape, fan in (("w1", (D, F), D), ("w3", (D, F), D), ("w2", (F, D), F)):
                    specs.append((p + f"block_sparse_moe.experts.{m}.{name}.weight",
                                  at + (name,), shape, True, m, fan))
        else:
            for name, hf, shape, fan in (("w1", "gate_proj", (D, F), D),
                                         ("w3", "up_proj", (D, F), D),
                                         ("w2", "down_proj", (F, D), F)):
                specs.append((p + f"mlp.{hf}.weight", at + (name,), shape, True, None, fan))
    specs.append(("model.norm.weight", ("final_norm",), (D,), False, None, 0))
    if not cfg.tie_embeddings:
        specs.append(("lm_head.weight", ("lm_head",), (D, cfg.vocab_size), True, None, D))
    return specs


def draw_leaf(torch, dev, index: int, spec: tuple):
    """Tensor ``index`` of the checkpoint in bf16, in the tree's layout, from
    a generator of its own (any one is drawn again alone): normal over
    sqrt(fan-in), norms 1 + N(0, 0.1)."""
    shape, fan = spec[2], spec[5]
    gen = torch.Generator(device=dev)
    gen.manual_seed(CKPT_SEED * 1_000_003 + index)
    w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
    w = 1.0 + 0.1 * w if fan == 0 else w * (1.0 / math.sqrt(fan))
    return w.to(torch.bfloat16)


def write_hf_checkpoint(torch, dev, path: Path, specs: list, shards: list[list[int]]) -> dict:
    """The checkpoint in HF layout, written by this script: one file per
    shard (``shards`` holds spec indices), each an 8-byte little-endian
    header length, a JSON header padded to 8 bytes, then each tensor's raw
    little-endian bf16 bytes ([out, in] for transposed weights), drawn on
    the card and streamed one at a time. Returns the bytes, seconds and
    each tensor's (file, offset of its data)."""
    t0 = time.monotonic()
    where, total = {}, 0
    for n, indices in enumerate(shards):
        file = path / f"model-{n + 1:05d}-of-{len(shards):05d}.safetensors"
        header, offset = {}, 0
        for i in indices:
            name, _, shape, transposed = specs[i][:4]
            stored = list(shape[::-1] if transposed else shape)
            size = math.prod(stored) * 2
            header[name] = {"dtype": "BF16", "shape": stored,
                            "data_offsets": [offset, offset + size]}
            offset += size
        blob = json.dumps(header).encode()
        blob += b" " * (-len(blob) % 8)
        base = 8 + len(blob)
        with open(file, "wb") as fh:
            fh.write(len(blob).to_bytes(8, "little"))
            fh.write(blob)
            for i in indices:
                w = draw_leaf(torch, dev, i, specs[i])
                if specs[i][3]:
                    w = w.T.contiguous()
                fh.write(w.view(torch.uint8).cpu().numpy())
                where[specs[i][0]] = (file, base + header[specs[i][0]]["data_offsets"][0])
        total += base + offset
    return {"bytes": total, "seconds": time.monotonic() - t0, "where": where}


def loaded_mismatches(torch, dev, cfg, params, specs: list, quant: str) -> list:
    """The tree paths whose loaded leaf is not bit for bit what was drawn:
    full precision, bf16 (norms widened to f32); int8, ``quantize_tree``
    of the drawn bf16 leaf computed on the card (an expert stack's as a
    whole [E, ...] stack, drawn again expert by expert)."""
    from mcp_context_forge_tpu_torch.tpu_local.models.llama import params_logical
    from mcp_context_forge_tpu_torch.tpu_local.quantize import is_quant, quantize_tree

    logical = params_logical(cfg)

    def get(tree, path):
        for part in path:
            tree = tree[part]
        return tree

    def same(got, want) -> bool:
        if is_quant(want):
            return is_quant(got) and all(
                got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
                and torch.equal(got[k], want[k]) for k in ("q", "s"))
        return (not is_quant(got) and got.shape == want.shape and got.dtype == want.dtype
                and torch.equal(got, want))

    stacks: dict[tuple, list[int]] = {}
    bad = []
    for i, spec in enumerate(specs):
        path, expert, fan = spec[1], spec[4], spec[5]
        if expert is not None:
            stacks.setdefault(path, []).append(i)
            continue
        want = draw_leaf(torch, dev, i, spec)
        want = want.float() if fan == 0 else want
        if quant:
            want = quantize_tree(want, get(logical, path), scale_dtype=torch.bfloat16)
        if not same(get(params, path), want):
            bad.append(path)
    for path, indices in stacks.items():
        want = torch.stack([draw_leaf(torch, dev, i, specs[i]) for i in indices])
        if quant:
            want = quantize_tree(want, get(logical, path), scale_dtype=torch.bfloat16)
        if not same(get(params, path), want):
            bad.append(path)
        del want
    return bad


class LoadProbe:
    """Stands in for the engine module's ``load_params``: each call's
    seconds and the card's peak allocated bytes over it (reset at its
    start)."""

    def __init__(self, torch, fn):
        self.torch, self.fn, self.calls = torch, fn, []

    def __call__(self, *args, **kwargs):
        torch = self.torch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.monotonic()
        out = self.fn(*args, **kwargs)
        torch.cuda.synchronize()
        self.calls.append({"seconds": time.monotonic() - t0, "base_bytes": base,
                           "peak_bytes": torch.cuda.max_memory_allocated()})
        return out


def checkpoint_engine(torch, dev, model: str, checkpoint: Path, **kwargs):
    """``TorchEngine`` on ``checkpoint`` (bf16, 8 slots, pages of 128, the
    buckets of the engine phases) and the probe of its load."""
    from unittest import mock

    from mcp_context_forge_tpu_torch.tpu_local import engine as engine_module
    from mcp_context_forge_tpu_torch.tpu_local.engine import EngineConfig, TorchEngine

    probe = LoadProbe(torch, engine_module.load_params)
    config = dict(model=model, checkpoint=str(checkpoint), dtype="bfloat16", device=str(dev),
                  max_batch=8, max_seq_len=2048, page_size=128, num_pages=512,
                  prefill_buckets=(128, 512, 2048), prefill_max_batch=4, seed=0)
    t0 = time.monotonic()
    with mock.patch.object(engine_module, "load_params", probe):
        engine = TorchEngine(EngineConfig(**{**config, **kwargs}))
    build_s = time.monotonic() - t0
    check(len(probe.calls) == 1, f"the engine loaded its checkpoint {len(probe.calls)} times")
    return engine, {**probe.calls[0], "engine_build_s": build_s}


def serve_registry(torch, engine, requests: list[tuple[str, dict]]) -> tuple[dict, list]:
    """``requests`` ((``chat`` or ``stream``, request) each) served one after
    another through an ``LLMProviderRegistry`` holding the engine's
    ``TorchLocalProvider``, as the /v1 routes call it: a stream's chunks are
    framed with ``sse_event`` and closed with ``SSE_DONE``, the bytes the
    route writes. Every kernel's count is set to 0 just before and read
    just after. Returns the counts, each reply (a chat response, or the
    stream's decoded frames, ``[DONE]`` last) and each request's tokens
    generated (``EngineStats.completion_tokens``; a stream's text may be
    empty: random weights pick ids past the byte tokenizer's)."""
    from mcp_context_forge_tpu_torch.gateway.serialize import (SSE_DATA, SSE_DONE, SSE_END,
                                                               sse_event)
    from mcp_context_forge_tpu_torch.tpu_local.provider import LLMProviderRegistry
    from mcp_context_forge_tpu_torch.tpu_local.tpu_provider import TorchLocalProvider

    registry = LLMProviderRegistry()
    registry.register(TorchLocalProvider("tpu_local", engine),
                      [engine.config.model, "tpu_local"], default_chat=True, default_embed=True)
    wrappers = kernel_wrappers()

    def chat_one(request):
        return send(provider, request) if send is not None else provider.chat(request)

    async def run():
        await engine.start()
        try:
            for fn in wrappers.values():
                fn.launches = 0
            replies, tokens = [], []
            for kind, request in requests:
                before = engine.stats.completion_tokens
                if kind == "chat":
                    replies.append(await asyncio.wait_for(registry.chat(request), 300))
                else:
                    frames = [sse_event(c) async for c in registry.chat_stream(request)]
                    replies.append(frames + [SSE_DONE])
                tokens.append(engine.stats.completion_tokens - before)
            return {k: fn.launches for k, fn in wrappers.items()}, replies, tokens
        finally:
            await registry.shutdown()

    counts, replies, tokens = asyncio.run(run())
    check(all(n >= 1 for n in tokens), f"tokens generated per request: {tokens}")
    out = []
    for (kind, _), reply in zip(requests, replies):
        if kind == "chat":
            check(reply["usage"]["completion_tokens"] >= 1
                  and reply["choices"][0]["finish_reason"] in ("stop", "length"),
                  f"a chat reply is {reply['usage']}, {reply['choices'][0]['finish_reason']}")
            out.append(reply)
            continue
        check(reply[-1] == SSE_DONE, "the stream does not end in data: [DONE]")
        check(all(f.startswith(SSE_DATA) and f.endswith(SSE_END) for f in reply),
              "a stream frame is not an SSE data frame")
        chunks = [json.loads(f[len(SSE_DATA):-len(SSE_END)]) for f in reply[:-1]]
        check(chunks and chunks[-1]["choices"][0]["finish_reason"] in ("stop", "length"),
              "the stream's last chunk carries no finish reason")
        out.append(chunks + ["[DONE]"])
    return counts, out, tokens


def disk_room(path: Path, need: int) -> dict:
    import shutil

    path.mkdir(parents=True, exist_ok=True)
    usage = shutil.disk_usage(path)
    room = {"disk_total_bytes": usage.total, "disk_free_bytes": usage.free,
            "checkpoint_bytes_needed": need}
    print(json.dumps({"phase": "checkpoint_disk", "path": str(path), **room}), flush=True)
    check(usage.free > need * 1.1, f"{usage.free} bytes free on disk, the checkpoint needs {need}")
    return room


def checkpoint_dir(root: Path) -> Path:
    import tempfile

    return Path(tempfile.mkdtemp(prefix="checkpoint-", dir=root))


def checkpoint_llama3_phase(torch, dev, root: Path, model: str = "llama3-8b",
                            layers: int = CKPT_LLAMA_LAYERS) -> tuple[dict, dict]:
    """``checkpoint_llama3_8b``: a seeded llama3-8b tree (full width; depth
    ``layers``) drawn on the card and written in HF layout by this script
    (two shard files), then served through ``EngineConfig(checkpoint=...)``:
    in bf16, every leaf bit for bit the drawn one (norms f32), three
    requests through the registry (a chat, an SSE stream, a chat sharing
    the first's full-page prefix: flash, the paged chunk kernel and decode
    launch); with ``quant="int8"``, every leaf bit for bit ``quantize_tree``
    of the drawn leaf on the card, the load's peak device memory under the
    bf16 tree's bytes, one request. The directory is deleted at the end."""
    import shutil

    from mcp_context_forge_tpu_torch.tpu_local.quantize import param_bytes

    cfg = depth_config(model, layers)
    specs = hf_specs(cfg)
    need = sum(math.prod(s[2]) * 2 for s in specs)
    room = disk_room(root, need)
    path = checkpoint_dir(root)
    try:
        half = next(i for i, s in enumerate(specs) if s[1][:2] == ("layers", cfg.n_layers // 2))
        written = write_hf_checkpoint(torch, dev, path, specs,
                                      [list(range(half)), list(range(half, len(specs)))])
        free_device(torch)
        stats = {"model": cfg.name, "layers": cfg.n_layers, "dim": cfg.dim,
                 "vocab": cfg.vocab_size, "shards": 2, "checkpoint_bytes": written["bytes"],
                 "write_s": written["seconds"], "card": card_line(), **room}
        # bf16: the engine loads the directory; three requests through the registry
        engine, load = checkpoint_engine(torch, dev, cfg.name, path)
        bad = loaded_mismatches(torch, dev, cfg, engine.params, specs, quant="")
        check(not bad, f"bf16 leaves differ from the drawn ones: {bad[:5]}")
        bf16_bytes = param_bytes(engine.params)
        system = chat(cfg.name, "Which tools can read files?", SYSTEM)
        hits0 = engine.allocator.prefix_hits
        counts, replies, tokens = serve_registry(torch, engine, [
            ("chat", system), ("stream", chat(cfg.name, "List three MCP servers.")),
            ("chat", chat(cfg.name, "Summarize the last failure.", SYSTEM))])
        check(engine.allocator.prefix_hits > hits0, "the third request missed the prefix cache")
        for kernel in ATTENTION:
            check(counts[kernel] > 0, f"{kernel} never launched on the loaded bf16 engine")
        for kernel in NOT_BF16 + INT8_WRITERS:
            check(counts[kernel] == 0, f"{kernel} launched on the loaded bf16 engine")
        stats["bf16"] = {**load, "gb_per_s": written["bytes"] / load["seconds"] / 1e9,
                         "tree_bytes": bf16_bytes, "leaves_bit_equal": True,
                         "prefix_hit": True, "stream_frames": len(replies[1]),
                         "completion_tokens": tokens,
                         "launches": {k: counts[k] for k in ATTENTION},
                         "compile_stats": engine.compile_stats()}
        del engine
        free_device(torch)
        # int8 on the way in
        engine, load = checkpoint_engine(torch, dev, cfg.name, path, quant="int8")
        bad = loaded_mismatches(torch, dev, cfg, engine.params, specs, quant="int8")
        check(not bad, f"int8 leaves differ from quantize_tree of the drawn ones: {bad[:5]}")
        int8_bytes = param_bytes(engine.params)
        check(load["peak_bytes"] < bf16_bytes,
              f"the int8 load peaked at {load['peak_bytes']} bytes, the bf16 tree is {bf16_bytes}")
        counts8, _, tokens8 = serve_registry(torch, engine, [("chat", system)])
        for kernel in ("flash_attention_tc", "paged_decode_attention"):
            check(counts8[kernel] > 0, f"{kernel} never launched on the loaded int8 engine")
        stats["int8"] = {**load, "gb_per_s": written["bytes"] / load["seconds"] / 1e9,
                         "tree_bytes": int8_bytes, "bf16_tree_bytes": bf16_bytes,
                         "peak_under_bf16_tree": True, "leaves_bit_equal": True,
                         "completion_tokens": tokens8,
                         "launches": {k: counts8[k] for k in ATTENTION},
                         "compile_stats": engine.compile_stats()}
        del engine
        free_device(torch)
    finally:
        shutil.rmtree(path, ignore_errors=True)
    total = {k: counts[k] + counts8[k] for k in counts}
    return total, stats


def flip_byte(file: Path, offset: int) -> None:
    with open(file, "r+b") as fh:
        fh.seek(offset)
        byte = fh.read(1)[0]
        fh.seek(offset)
        fh.write(bytes([byte ^ 0x40]))


def drop_header_name(file: Path, name: str) -> bytes:
    """``name`` removed from the file's header (padded with spaces to its
    length, so the data stays where it is); returns the old header."""
    with open(file, "r+b") as fh:
        size = int.from_bytes(fh.read(8), "little")
        old = fh.read(size)
        header = json.loads(old)
        del header[name]
        new = json.dumps(header).encode()
        fh.seek(8)
        fh.write(new + b" " * (size - len(new)))
    return old


def restore_header(file: Path, old: bytes) -> None:
    with open(file, "r+b") as fh:
        fh.seek(8)
        fh.write(old)


def checkpoint_mixtral_phase(torch, dev, root: Path, model: str = "mixtral-8x7b",
                             layers: int = 1) -> tuple[dict, dict]:
    """``checkpoint_mixtral_int8``: a seeded mixtral-8x7b tree (full width,
    ``layers`` layer) written in HF layout with per-expert
    ``block_sparse_moe.experts.M.w{1,2,3}`` tensors, one expert's split
    across the two shard files, served through ``EngineConfig(checkpoint=
    ..., quant="int8")``: each expert stack's q and s bit for bit
    ``quantize_tree``'s (s [E, F] for w1/w3, [E, D] for w2), the load's
    peak under the bf16 tree's bytes, one long request on the grouped
    route (the int8 grouped-expert kernel launches). Then the int8 tree
    through ``save_params``/``load_params``, bit for bit; the bf16 tree
    saved the same way must refuse ``quant="int8"``. Planted faults: a
    flipped byte in a shard's data, an expert tensor dropped from a
    header (the incomplete-stack error), a loader that quantizes expert
    stacks over axis 0 (the expert axis)."""
    import shutil
    from unittest import mock

    from mcp_context_forge_tpu_torch.tpu_local import checkpoint as ckpt
    from mcp_context_forge_tpu_torch.tpu_local.quantize import param_bytes, quantize_leaf

    cfg = depth_config(model, layers)
    specs = hf_specs(cfg)
    E, D, F = cfg.n_experts, cfg.dim, cfg.ffn_hidden
    # the bf16 files, the saved bf16 tree, and room for the int8 one
    need = sum(math.prod(s[2]) * 2 for s in specs) * 3
    room = disk_room(root, need)
    path = checkpoint_dir(root)
    try:
        # expert E // 2 of layer 0: w1 in the first file, w3 and w2 in the second
        split = next(i for i, s in enumerate(specs)
                     if s[4] == E // 2 and s[1] == ("layers", 0, "w3"))
        written = write_hf_checkpoint(torch, dev, path, specs,
                                      [list(range(split)), list(range(split, len(specs)))])
        free_device(torch)
        stats = {"model": cfg.name, "layers": cfg.n_layers, "dim": D, "ffn": F, "experts": E,
                 "checkpoint_bytes": written["bytes"], "write_s": written["seconds"],
                 "card": card_line(), **room}
        engine, load = checkpoint_engine(torch, dev, cfg.name, path, quant="int8",
                                         moe_impl="grouped_pallas")
        params = engine.params
        bad = loaded_mismatches(torch, dev, cfg, params, specs, quant="int8")
        check(not bad, f"int8 leaves differ from quantize_tree of the drawn ones: {bad[:5]}")
        for layer in params["layers"]:
            check(layer["w1"]["s"].shape == layer["w3"]["s"].shape == (E, F)
                  and layer["w2"]["s"].shape == (E, D),
                  f"expert scales {layer['w1']['s'].shape}, {layer['w2']['s'].shape}")
        long_chat = chat_requests(cfg.name)[2]
        counts, replies, _ = serve_registry(torch, engine, [("chat", long_chat)])
        check(replies[0]["usage"]["prompt_tokens"] * cfg.moe_top_k >= E * cfg.moe_block,
              f"the prompt of {replies[0]['usage']['prompt_tokens']} tokens misses the grouped route")
        for kernel in ("flash_attention_tc", "expert_blocks_tc_q8", "paged_decode_attention"):
            check(counts[kernel] > 0, f"{kernel} never launched on the loaded int8 Mixtral")
        for kernel in MOE_WMMA + ("expert_blocks_tc",):
            check(counts[kernel] == 0, f"{kernel} launched on the loaded int8 Mixtral")
        int8_bytes = param_bytes(params)
        stats["int8"] = {**load, "gb_per_s": written["bytes"] / load["seconds"] / 1e9,
                         "tree_bytes": int8_bytes, "leaves_bit_equal": True,
                         "w1_scales": list(params["layers"][0]["w1"]["s"].shape),
                         "w2_scales": list(params["layers"][0]["w2"]["s"].shape),
                         "prompt_tokens": replies[0]["usage"]["prompt_tokens"],
                         "launches": {k: counts[k] for k in ATTENTION + ("expert_blocks_tc_q8",)},
                         "compile_stats": engine.compile_stats()}
        # the port's own format: the int8 tree saved once restores as it was
        own = path / "own-int8"
        t0 = time.monotonic()
        ckpt.save_params(str(own), params)
        save_s = time.monotonic() - t0
        torch.cuda.synchronize()
        t0 = time.monotonic()
        restored = ckpt.load_params(str(own), cfg, dev, torch.bfloat16, quant="int8")
        torch.cuda.synchronize()
        restore_s = time.monotonic() - t0
        check(not loaded_mismatches(torch, dev, cfg, restored, specs, quant="int8"),
              "the restored int8 tree differs from the saved one")
        stats["own_int8"] = {"save_s": save_s, "restore_s": restore_s,
                             "bytes": (own / ckpt.PARAMS_FILE).stat().st_size,
                             "bit_equal": True}
        del engine, params, restored
        free_device(torch)
        shutil.rmtree(own)
        # the bf16 tree, saved the same way, refuses quant="int8"
        bf16 = ckpt.load_params(str(path), cfg, dev, torch.bfloat16)
        bf16_bytes = param_bytes(bf16)
        check(load["peak_bytes"] < bf16_bytes,
              f"the int8 load peaked at {load['peak_bytes']} bytes, the bf16 tree is {bf16_bytes}")
        stats["int8"].update(bf16_tree_bytes=bf16_bytes, peak_under_bf16_tree=True)
        own = path / "own-bf16"
        ckpt.save_params(str(own), bf16)
        del bf16
        free_device(torch)
        try:
            ckpt.load_params(str(own), cfg, dev, torch.bfloat16, quant="int8")
            refused = None
        except ValueError as exc:
            refused = str(exc)
        check(refused is not None and "does not match the quantized (int8)" in refused,
              f"a bf16 tree restored under int8: {refused}")
        stats["own_bf16_under_int8"] = refused.split(":")[0]
        shutil.rmtree(own)
        free_device(torch)
        stats["planted_faults"] = mixtral_faults(torch, dev, cfg, path, specs, written["where"],
                                                 ckpt, quantize_leaf, mock)
    finally:
        shutil.rmtree(path, ignore_errors=True)
    return counts, stats


def mixtral_faults(torch, dev, cfg, path: Path, specs: list, where: dict, ckpt,
                   quantize_leaf, mock) -> dict:
    """Each planted fault must fail the phase's check: the loaded int8 tree
    against ``quantize_tree`` of the drawn leaves, or the loader's own
    incomplete-stack error."""
    faults = {}
    # a flipped exponent bit in the first element of layer 0's wq
    name = "model.layers.0.self_attn.q_proj.weight"
    file, offset = where[name]
    flip_byte(file, offset + 1)   # the high byte of a little-endian bf16
    try:
        bad = loaded_mismatches(torch, dev, cfg, ckpt.load_params(
            str(path), cfg, dev, torch.bfloat16, quant="int8"), specs, quant="int8")
    finally:
        flip_byte(file, offset + 1)
    free_device(torch)
    check(("layers", 0, "wq") in bad, f"a flipped byte of {name} passed the check: {bad}")
    faults["flipped_byte"] = [list(map(str, b)) for b in bad]
    # an expert tensor dropped from the second file's header
    name = next(s[0] for s in specs if s[4] == cfg.n_experts - 1 and s[1][-1] == "w2")
    file = where[name][0]
    old = drop_header_name(file, name)
    try:
        ckpt.load_params(str(path), cfg, dev, torch.bfloat16, quant="int8")
        error = None
    except ValueError as exc:
        error = str(exc)
    finally:
        restore_header(file, old)
    free_device(torch)
    check(error is not None and error.startswith("Checkpoint has incomplete expert stacks"),
          f"a checkpoint without {name} loaded: {error}")
    faults["dropped_expert"] = error
    # expert stacks staged full precision and quantized over axis 0
    real_axis, real_set = ckpt.reduction_axis, ckpt._set_path

    def axis_without_experts(name):
        return None if name.startswith("moe_") else real_axis(name)

    def set_quantizing_axis_0(tree, tree_path, value):
        if isinstance(value, torch.Tensor) and value.dim() == 3:
            value = quantize_leaf(value, 0, scale_dtype=torch.bfloat16)
        real_set(tree, tree_path, value)

    with mock.patch.object(ckpt, "reduction_axis", axis_without_experts), \
            mock.patch.object(ckpt, "_set_path", set_quantizing_axis_0):
        tree = ckpt.load_params(str(path), cfg, dev, torch.bfloat16, quant="int8")
    bad = loaded_mismatches(torch, dev, cfg, tree, specs, quant="int8")
    scales = list(tree["layers"][0]["w1"]["s"].shape)
    del tree
    free_device(torch)
    stacks = {("layers", i, w) for i in range(cfg.n_layers) for w in ("w1", "w2", "w3")}
    check(stacks <= set(bad), f"expert stacks quantized over axis 0 passed the check: {bad}")
    faults["expert_axis_0"] = {"failed": [list(map(str, b)) for b in bad], "w1_scales": scales}
    return faults


# ------------------------------------------------- the shared engine plane

PLANE_TTL_S = 3.0          # the owner lease and every worker heartbeat
PLANE_IDLE_S = 2.0         # a forwarded stream's idle bar before its liveness check
PLANE_RPC_TIMEOUT_S = 120.0
PLANE_SECRET_ENV = "MCPFORGE_BUS_TCP_SECRET"
PLANE_FAILOVER_TOKENS = 64
PLANE_HOP_RUNS = 5
PLANE_LOAD_CHATS = 16      # twice max_batch: half of them wait in the owner's queue
PLANE_PARTITION_TIMEOUT_S = 2.0
LEASE_POLL_S = 0.02


def plane_chats(model: str) -> dict:
    """The plane phase's own chats beside ``chat_requests``: each under one
    page, so that no cache holds any of it and every run of it is cold and
    alone (one bucket, one row)."""
    failover = chat(model, "Describe how a gateway retries a failed tool call.")
    failover["max_tokens"] = PLANE_FAILOVER_TOKENS
    return {"failover": failover, "hop": chat(model, "Name one MCP transport."),
            "load": [chat(model, f"Give one reason {i} for a tool to time out.")
                     for i in range(PLANE_LOAD_CHATS)]}


class SpelledTokenizer:
    """An engine's tokenizer whose ``decode`` spells every id as ``⟨id⟩``
    (encoding is the tokenizer's own). Random weights draw ids the byte
    tokenizer prints as nothing, so a stream would reach its worker as one
    empty chunk; spelled, each token is one chunk, and the worker reads
    every token of a forwarded stream, and its time, from the text."""

    def __init__(self, base):
        self.base = base

    def __getattr__(self, name):
        return getattr(self.base, name)

    def decode(self, ids) -> str:
        return "".join(f"⟨{i}⟩" for i in ids)


def spelled_ids(text: str) -> list[int]:
    return [int(i) for i in re.findall(r"⟨(\d+)⟩", text)]


def plane_engine_config(model: str, dtype: str, mesh_shape: str = ""):
    """``engine_phase``'s llama3-8b configuration (page 128, 512 pages,
    buckets 128/512/2048, max_batch 8, seed 0), at ``mesh_shape``."""
    from mcp_context_forge_tpu_torch.tpu_local.engine import EngineConfig

    return EngineConfig(model=model, dtype=dtype, device="cuda", max_batch=8,
                        max_seq_len=2048, page_size=128, num_pages=512,
                        prefill_buckets=(128, 512, 2048), prefill_max_batch=4, seed=0,
                        mesh_shape=mesh_shape)


class PlaneWorker:
    """One gateway worker of the shared engine plane: a ``HubClient`` with
    its ``TcpEventBus`` and ``TcpLeaseManager``, a ``BusRpc``, the worker
    heartbeat (TTL ``PLANE_TTL_S``) and a ``SharedEnginePlane`` whose
    factory builds ``TorchEngine`` + ``TorchLocalProvider`` on the card.
    Beside the plane's ``pool.*`` methods it serves the ``smoke.*`` methods
    by which this script drives and reads it: chats through the plane (or,
    on the owner, straight on its provider), a stream for the failover,
    readings of its queue state, an armed partition, its owner's report
    (builds, the requests its engine served with their shapes and tokens,
    the chunk times it emitted, the ledger, kernel launches, compile
    events), a reset of the launch counts, and exit. Runs in a process of
    its own (``--plane-worker``) or as a task of this script's loop. With a
    ``mesh_shape`` the owner's engine is a multi-rank one on the first
    cards, its followers processes of this worker's."""

    def __init__(self, worker_id: str, hub_port: int, secret: str, model: str, dtype: str,
                 mesh_shape: str = ""):
        self.worker_id = worker_id
        self.hub_port = hub_port
        self.secret = secret
        self.model = model
        self.dtype = dtype
        self.mesh_shape = mesh_shape
        self.builds: list[dict] = []
        self.served: list = []          # GenRequests, in the order submitted
        self.emitted: list[list[float]] = []   # wall times of each stream's chunks
        self.ledger = RecordingLedger()
        self.engine = None
        self.min_free_bytes = 0
        self.exit = None

    async def start(self) -> None:
        from mcp_context_forge_tpu_torch.coordination.heartbeat import WorkerHeartbeat
        from mcp_context_forge_tpu_torch.coordination.hub import (HubClient, TcpEventBus,
                                                                  TcpLeaseManager)
        from mcp_context_forge_tpu_torch.coordination.rpc import BusRpc
        from mcp_context_forge_tpu_torch.tpu_local.pool_rpc import SharedEnginePlane

        self.exit = asyncio.Event()
        self.client = HubClient("127.0.0.1", self.hub_port, secret=self.secret)
        self.bus = TcpEventBus(self.client)
        self.leases = TcpLeaseManager(self.client)
        await self.bus.start()     # raises when the hub is unreachable or refuses us
        self.rpc = BusRpc(self.bus, self.worker_id, leases=self.leases,
                          default_timeout_s=PLANE_RPC_TIMEOUT_S, idle_timeout_s=PLANE_IDLE_S)
        self.heartbeat = WorkerHeartbeat(self.leases, self.worker_id, ttl=PLANE_TTL_S)
        self.plane = SharedEnginePlane(self.rpc, self.leases, self.worker_id, self._factory,
                                       lease_ttl=PLANE_TTL_S, rpc_timeout_s=PLANE_RPC_TIMEOUT_S,
                                       stream_idle_timeout_s=PLANE_IDLE_S)
        for name in ("chat", "queue_watch", "partition", "report", "reset", "min_free",
                     "exit"):
            self.rpc.register(f"smoke.{name}", getattr(self, f"_smoke_{name}"))
        self.rpc.register_stream("smoke.stream", self._smoke_stream)
        await self.rpc.start()
        await self.heartbeat.start()
        await self.plane.start()

    async def stop(self) -> None:
        """A clean stop: the plane (its lease released, its engine
        stopped), the heartbeat (its lease released), the RPC seam, the
        hub connection."""
        await self.plane.stop()
        await self.heartbeat.stop()
        await self.rpc.stop()
        await self.bus.stop()

    async def serve_until_exit(self) -> None:
        await self.start()
        try:
            await self.exit.wait()
        finally:
            await self.stop()

    # ------------------------------------------------------------- the owner

    async def _factory(self):
        import torch

        from mcp_context_forge_tpu_torch.tpu_local.engine import TorchEngine
        from mcp_context_forge_tpu_torch.tpu_local.tpu_provider import TorchLocalProvider

        t_start = time.time()
        waited = time.monotonic()
        # a survivor builds only once the dead owner's memory is back
        while torch.cuda.mem_get_info()[0] < self.min_free_bytes:
            check(time.monotonic() - waited < 20.0,
                  f"{self.worker_id}: {torch.cuda.mem_get_info()[0]} bytes free, not "
                  f"{self.min_free_bytes}, 20 s after winning the lease")
            await asyncio.sleep(0.05)
        free_before = torch.cuda.mem_get_info()[0]
        t0 = time.monotonic()
        devices = None
        if self.mesh_shape:
            data, model = (int(n) for n in self.mesh_shape.split("x"))
            devices = [torch.device("cuda", i) for i in range(data * model)]
        engine = await asyncio.to_thread(
            TorchEngine, plane_engine_config(self.model, self.dtype, self.mesh_shape),
            ledger=self.ledger, devices=devices)
        build_s = time.monotonic() - t0
        engine.tokenizer = SpelledTokenizer(engine.tokenizer)
        submit = engine.submit

        async def recording(request):
            self.served.append(request)
            return await submit(request)

        engine.submit = recording
        await engine.start()
        provider = TorchLocalProvider("tpu_local", engine)
        chat_stream = provider.chat_stream

        async def timed_stream(request):
            times: list[float] = []
            self.emitted.append(times)
            async for chunk in chat_stream(request):
                if chunk["choices"][0]["delta"].get("content"):
                    times.append(time.time())
                yield chunk

        provider.chat_stream = timed_stream
        self.engine = engine
        self.builds.append({"worker": self.worker_id, "seconds": build_s,
                            "waited_for_memory_s": t0 - waited, "free_bytes_before": free_before,
                            "t_start": t_start, "t_end": time.time()})
        return provider

    # ------------------------------------------------------- smoke methods

    async def _smoke_chat(self, params: dict) -> dict:
        """A streamed chat through the plane (``direct``: straight on this
        owner's provider, no hop); the wall times of its sending, its first
        content chunk and its end, each chunk's arrival, and the error that
        ended it."""
        from mcp_context_forge_tpu_torch import observability

        body, stream = params["body"], None
        if params.get("direct"):
            check(self.plane.ready_local, f"{self.worker_id} is not the built owner")
            stream = self.plane.local_provider.chat_stream(dict(body))
        else:
            stream = self.plane.chat_stream(dict(body))
        token = observability.set_current_tenant(params.get("tenant"))
        arrivals, text, error = [], [], None
        t_send = time.time()
        try:
            async for chunk in stream:
                content = chunk["choices"][0]["delta"].get("content")
                if content:
                    arrivals.append(time.time())
                    text.append(content)
        except Exception as exc:   # reported: the caller checks the type
            error = f"{type(exc).__name__}: {exc}"
        finally:
            observability.reset_current_tenant(token)
        return {"t_send": t_send, "arrivals": arrivals, "t_end": time.time(),
                "content": "".join(text), "error": error}

    async def _smoke_stream(self, params: dict):
        """A chat through the plane, one chunk out per content chunk in (its
        count and wall time), then one last chunk with the error that ended
        it, if one did."""
        from mcp_context_forge_tpu_torch import observability

        token = observability.set_current_tenant(params.get("tenant"))
        count, error = 0, None
        try:
            async for chunk in self.plane.chat_stream(dict(params["body"])):
                if chunk["choices"][0]["delta"].get("content"):
                    count += 1
                    yield {"k": count, "t": time.time()}
        except Exception as exc:
            error = type(exc).__name__
            message = str(exc)
        finally:
            observability.reset_current_tenant(token)
        yield {"end": True, "k": count, "t": time.time(), "error": error,
               "message": message if error else None}

    async def _smoke_queue_watch(self, params: dict) -> dict:
        """``queue_state_sync()`` every 20 ms for ``seconds``, with the
        plane's cache refreshed as often."""
        self.plane.queue_cache_ttl_s = float(params.get("cache_ttl_s", 0.05))
        readings, nones = [], 0
        deadline = time.monotonic() + float(params["seconds"])
        while time.monotonic() < deadline:
            state = self.plane.queue_state_sync()
            if state is None:
                nones += 1
            else:
                readings.append(state)
            await asyncio.sleep(0.02)
        return {"readings": readings, "none": nones, "local_engine": self.engine is not None}

    async def _smoke_partition(self, params: dict) -> dict:
        """``coordination.hub.rpc`` armed ``corrupt`` for ``pool.chat``: the
        request frame is dropped, and the caller walks the timeout and the
        liveness check to ``LLMUnavailable``."""
        from mcp_context_forge_tpu_torch.observability import faults
        from mcp_context_forge_tpu_torch.tpu_local.provider import LLMUnavailable

        plane = faults.configure_fault_plane(True)
        plane.arm(faults.FaultRule(point="coordination.hub.rpc", kind="corrupt",
                                   scope="pool.chat"))
        timeout, self.plane.rpc_timeout_s = self.plane.rpc_timeout_s, PLANE_PARTITION_TIMEOUT_S
        t0 = time.monotonic()
        try:
            await asyncio.wait_for(self.plane.chat(dict(params["body"])), 30)
            outcome = "answered"
        except LLMUnavailable as exc:
            outcome = f"LLMUnavailable: {exc}"
        except asyncio.TimeoutError:
            outcome = "hung"
        finally:
            self.plane.rpc_timeout_s = timeout
            faults.configure_fault_plane(False)
        return {"outcome": outcome, "seconds": time.monotonic() - t0}

    async def _smoke_report(self, params: dict) -> dict:
        import torch

        served = []
        for r in self.served:
            served.append({"prompt_ids": r.prompt_ids, "generated": r.generated,
                           "finish": r.finish_reason, "hist": r.hist, "bucket": r.bucket,
                           "rows": sum(o.prefill_ms == r.prefill_ms for o in self.served),
                           "tenant": r.tenant,
                           "ttft_ms": (r.first_token_ts - r.created) * 1e3
                           if r.first_token_ts else None})
        engine = self.engine
        return {"worker": self.worker_id, "owner": self.plane.ready_local,
                "plane": self.plane.stats(), "rpc": self.rpc.stats(),
                "builds": self.builds, "served": served, "emitted": self.emitted,
                "ledger": self.ledger.totals,
                "launches": {k: fn.launches for k, fn in kernel_wrappers().items()},
                "serving_events": engine.compile_stats()["serving"]["count"] if engine else None,
                "cached_pages": engine.allocator.cached_pages if engine else None,
                "max_queue": engine.config.max_queue if engine else None,
                "world": engine.world if engine else None,
                "follower_pids": ([p.pid for p in engine._ranks.procs]
                                  if engine is not None and engine._ranks is not None else []),
                "reserved_bytes": torch.cuda.memory_reserved()}

    async def _smoke_reset(self, params: dict) -> dict:
        for fn in kernel_wrappers().values():
            fn.launches = 0
        self.served.clear()
        self.emitted.clear()
        return {}

    async def _smoke_min_free(self, params: dict) -> dict:
        self.min_free_bytes = int(params["bytes"])
        return {}

    async def _smoke_exit(self, params: dict) -> dict:
        self.exit.set()
        return {}


def plane_worker_main(argv: list[str]) -> int:
    """``chip_smoke.py --plane-worker ID HUB_PORT MODEL DTYPE [MESH]``: one
    worker process of the plane phase (the hub's secret in the
    environment). It loads the kernel libraries this script built and
    builds none: a missing one raises."""
    import torch

    worker_id, hub_port, model, dtype = argv[0], int(argv[1]), argv[2], argv[3]
    mesh_shape = argv[4] if len(argv) > 4 else ""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from mcp_context_forge_tpu_torch.tpu_local.ops import _build

    missing = [name for name in _build.KERNELS if not _build.library_path(name).exists()]
    check(not missing, f"{worker_id}: kernel libraries not built: {missing}")
    check(torch.cuda.is_available(), f"{worker_id}: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    torch.zeros(1, device="cuda")     # the context, before the worker contends
    worker = PlaneWorker(worker_id, hub_port, os.environ[PLANE_SECRET_ENV], model, dtype,
                         mesh_shape)
    asyncio.run(worker.serve_until_exit())
    return 0


class HubThread:
    """A ``CoordinationHub`` on 127.0.0.1 with a secret, on an event loop
    of its own in a thread of this process, so that it outlives every
    worker the plane phase starts and kills."""

    def __init__(self, secret: str):
        from mcp_context_forge_tpu_torch.coordination.hub import CoordinationHub

        self.secret = secret
        self.loop = asyncio.new_event_loop()
        self.hub = CoordinationHub("127.0.0.1", 0, secret=secret)
        started = threading.Event()

        def run():
            asyncio.set_event_loop(self.loop)
            self.loop.run_until_complete(self.hub.start())
            started.set()
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, name="coordination-hub", daemon=True)
        self.thread.start()
        check(started.wait(30), "the coordination hub did not start")
        self.port = self.hub.bound_port

    def close(self) -> None:
        asyncio.run_coroutine_threadsafe(self.hub.stop(), self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)


class PlaneConductor:
    """This script's own side of the plane phase: a client of the hub (a
    ``BusRpc`` named ``conductor``, which serves nothing) by which it calls the
    workers' ``smoke.*`` methods and reads the owner lease; and the
    workers, as processes (``spawn``) or as tasks of this loop."""

    def __init__(self, hub: HubThread, model: str, dtype: str, processes: bool,
                 mesh_shape: str = ""):
        self.hub, self.model, self.dtype, self.processes = hub, model, dtype, processes
        self.mesh_shape = mesh_shape
        self.procs: dict[str, subprocess.Popen] = {}
        self.tasks: dict[str, tuple] = {}
        self.logs = Path(__file__).resolve().parent / "build" / "plane"

    async def start(self) -> None:
        from mcp_context_forge_tpu_torch.coordination.hub import (HubClient, TcpEventBus,
                                                                  TcpLeaseManager)
        from mcp_context_forge_tpu_torch.coordination.rpc import BusRpc

        self.client = HubClient("127.0.0.1", self.hub.port, secret=self.hub.secret)
        self.bus = TcpEventBus(self.client)
        self.leases = TcpLeaseManager(self.client)
        await self.bus.start()
        self.rpc = BusRpc(self.bus, "conductor", leases=self.leases,
                          default_timeout_s=PLANE_RPC_TIMEOUT_S, idle_timeout_s=PLANE_IDLE_S)
        await self.rpc.start()

    async def stop(self) -> None:
        for wid in list(self.procs) + list(self.tasks):
            await self.retire(wid)
        await self.rpc.stop()
        await self.bus.stop()

    def spawn(self, wid: str) -> None:
        if self.processes:
            self.logs.mkdir(parents=True, exist_ok=True)
            log = open(self.logs / f"{wid}.log", "w")
            env = {**os.environ, PLANE_SECRET_ENV: self.hub.secret}
            self.procs[wid] = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--plane-worker", wid,
                 str(self.hub.port), self.model, self.dtype]
                + ([self.mesh_shape] if self.mesh_shape else []),
                cwd=str(Path(__file__).resolve().parent), env=env, stdout=log,
                stderr=subprocess.STDOUT)
            log.close()
        else:
            worker = PlaneWorker(wid, self.hub.port, self.hub.secret, self.model, self.dtype,
                                 self.mesh_shape)
            self.tasks[wid] = (worker, asyncio.ensure_future(worker.serve_until_exit()))

    def log_tail(self, wid: str) -> str:
        path = self.logs / f"{wid}.log"
        return path.read_text()[-3000:] if path.exists() else ""

    async def alive(self, wid: str, timeout_s: float) -> None:
        """Wait for ``wid``'s heartbeat lease (its plane is started then)."""
        deadline = time.monotonic() + timeout_s
        while await self.leases.holder(f"worker:{wid}") != wid:
            proc = self.procs.get(wid)
            check(proc is None or proc.poll() is None,
                  f"worker {wid} exited with {proc and proc.poll()}:\n{self.log_tail(wid)}")
            check(time.monotonic() < deadline, f"worker {wid} never came up:\n"
                                               f"{self.log_tail(wid)}")
            await asyncio.sleep(0.05)

    async def owner(self) -> str | None:
        from mcp_context_forge_tpu_torch.tpu_local.pool_rpc import LEASE_NAME

        return await self.leases.holder(LEASE_NAME)

    async def built_owner(self, candidates, timeout_s: float) -> str:
        """The worker of ``candidates`` that holds the owner lease and has
        built its engine."""
        deadline = time.monotonic() + timeout_s
        while True:
            owner = await self.owner()
            if owner in candidates and (await self.call(owner, "report"))["owner"]:
                return owner
            for wid in candidates:
                proc = self.procs.get(wid)
                check(proc is None or proc.poll() is None,
                      f"worker {wid} exited:\n{self.log_tail(wid)}")
            check(time.monotonic() < deadline, f"no built owner among {candidates}")
            await asyncio.sleep(0.05)

    async def call(self, wid: str, method: str, **params):
        return await self.rpc.call(wid, f"smoke.{method}", params)

    async def kill(self, wid: str) -> None:
        """The owner dies: SIGKILL for a process, reaped at once (its memory
        goes with it); for a task, its RPC, heartbeat and plane stop (the
        leases released), its streams cut without an end frame."""
        if self.processes:
            proc = self.procs.pop(wid)
            proc.kill()
            await asyncio.to_thread(proc.wait, 30)
        else:
            # the RPC first: its streams are cut without an end frame
            worker, task = self.tasks.pop(wid)
            await worker.rpc.stop()
            await worker.heartbeat.stop()
            await worker.plane.stop()
            await worker.bus.stop()
            task.cancel()

    async def retire(self, wid: str) -> None:
        """A clean exit, or a kill when the worker does not go."""
        if wid in self.procs:
            proc = self.procs.pop(wid)
            if proc.poll() is None:
                with contextlib.suppress(Exception):
                    await self.rpc.call(wid, "smoke.exit", {}, timeout_s=5.0)
                try:
                    await asyncio.to_thread(proc.wait, 30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    await asyncio.to_thread(proc.wait, 30)
        elif wid in self.tasks:
            worker, task = self.tasks.pop(wid)
            worker.exit.set()
            with contextlib.suppress(Exception):
                await asyncio.wait_for(task, 60)


def plane_streams_check(reference: dict, streams: list, shapes: list, exact: bool) -> dict:
    """The pool phase's rule for streams served by another engine of the
    same weights: where a request hit as many cached tokens as in the
    engine phase (in bf16: and its prefill call had the same bucket and
    rows), its stream must equal that phase's; the first request, sent
    alone to a cold owner, is always compared."""
    ref_shapes = list(zip(reference["prefix_hit_tokens"], reference["buckets"],
                          reference["prefill_group"]))
    compared, equal, first_difference = [], [], {}
    for k, (stream, got) in enumerate(zip(streams, shapes)):
        if stream != reference["generated"][k]:
            first_difference[k] = next((i for i, (a, b) in enumerate(
                zip(stream, reference["generated"][k])) if a != b), len(stream))
        if (got[0] == ref_shapes[k][0]) if exact else (tuple(got) == ref_shapes[k]):
            compared.append(k)
            if stream == reference["generated"][k]:
                equal.append(k)
    check(0 in compared and equal == compared,
          f"forwarded streams differ from the engine phase's: compared {compared}, "
          f"equal {equal}, first differences {first_difference}")
    return {"compared_with_engine": compared, "equal_engine": equal,
            "first_difference": first_difference}


def plane_phase(torch, dev, model: str, dtype: str, reference: dict, hub: HubThread,
                kernels: tuple, processes: bool) -> tuple[dict, dict]:
    """``engine_llama3_8b_shared_plane`` (``processes``: three worker
    processes on the card) and ``engine_llama3_tiny_f32_shared_plane`` (three
    workers as tasks of this process), on ``hub``. W0 starts first and is
    waited for until it owns the lease and has built; W1 and W2 start after.

    1. Parity: ``engine``'s six chats through W1 (as tenant ``team:alpha``)
       and W2, the first alone until its prefix is registered on the owner;
       the owner's streams are held to the engine phase's
       (``plane_streams_check``); W1's chats are billed to ``team:alpha``.
    2. The hop: a one-page chat ``PLANE_HOP_RUNS`` times straight on the
       owner and through W1 (TTFT each), and each forwarded chunk's
       arrival on W1 against its emission on the owner.
    3. Queue state: ``PLANE_LOAD_CHATS`` chats through W1 while W2 reads
       ``queue_state_sync()``: the owner's depth (> 0 at some reading), its
       capacity; W2 has no engine.
    4. A partition: ``coordination.hub.rpc`` armed ``corrupt`` for
       ``pool.chat`` on W1: ``LLMUnavailable`` after the timeout and the
       liveness check, no hang.
    5. Failover: the failover chat straight on the owner (the direct run),
       then through W1; after four chunks W0 dies (SIGKILL, or its plane
       stopped). W1's stream ends with ``LLMUnavailable`` within the idle
       bar and one lease TTL; W1 or W2 wins the lease and builds (on the
       card: only once W0's memory is back); the chat sent again through
       the other worker equals the direct run's stream. The gap from the
       kill to its first token is split into the lease's lapse, the
       election, the build and the first token.

    Every owner builds and captures nothing while it serves. Kernel counts:
    zeroed on the owner just before step 1 and read after step 5's direct
    run; the new owner's read after the retried chat. Returns (their sum,
    stats)."""
    from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS
    from mcp_context_forge_tpu_torch.tpu_local.tokenizer import load_tokenizer, render_chat

    cfg = MODEL_CONFIGS[model]
    tok = load_tokenizer(vocab_size=cfg.vocab_size)
    requests = chat_requests(model)
    ids = [tok.encode(render_chat(r["messages"])) for r in requests]
    check([len(i) for i in ids] == reference["prompt_tokens"],
          "the plane's prompts are not the engine phase's")
    extra = plane_chats(model)
    for name in ("failover", "hop"):
        check(len(tok.encode(render_chat(extra[name]["messages"]))) < 128,
              f"the {name} chat is not under one page")
    exact = dtype == "float32"
    conductor = PlaneConductor(hub, model, dtype, processes)
    counts = dict.fromkeys(REPLACES, 0)
    out: dict = {"model": model, "layers": cfg.n_layers, "dtype": dtype,
                 "workers": "processes" if processes else "tasks of one process",
                 "lease_ttl_s": PLANE_TTL_S, "heartbeat_ttl_s": PLANE_TTL_S,
                 "stream_idle_timeout_s": PLANE_IDLE_S}

    def served_for(report, prompt_ids, start=0):
        rows = [r for r in report["served"] if r["prompt_ids"] == prompt_ids]
        check(len(rows) > start, "a forwarded chat never reached the owner's engine")
        return rows[start]

    async def run():
        await conductor.start()
        try:
            free_alone = torch.cuda.mem_get_info()[0]
            t0 = time.monotonic()
            conductor.spawn("W0")
            await conductor.alive("W0", 120)
            check(await conductor.built_owner(["W0"], 300) == "W0", "W0 did not build")
            out["w0_ready_s"] = time.monotonic() - t0
            for wid in ("W1", "W2"):
                conductor.spawn(wid)
            for wid in ("W1", "W2"):
                await conductor.alive(wid, 120)
            check(await conductor.owner() == "W0", "the lease left W0 while W1 and W2 started")
            free_with_w0 = torch.cuda.mem_get_info()[0]

            # 1. parity, with the tenant
            await conductor.call("W0", "reset")
            first = asyncio.ensure_future(conductor.call("W1", "chat", body=requests[0],
                                                      tenant="team:alpha"))
            while not (await conductor.call("W0", "report"))["cached_pages"]:
                check(not first.done(), "the first chat ended before its prefix registered")
                await asyncio.sleep(0.005)
            senders = ["W1"] + ["W2" if k % 2 else "W1" for k in range(1, len(requests))]
            rest = [asyncio.ensure_future(conductor.call(
                w, "chat", body=r, tenant="team:alpha" if w == "W1" else None))
                for w, r in zip(senders[1:], requests[1:])]
            replies = await asyncio.wait_for(asyncio.gather(first, *rest), 600)
            check(all(r["error"] is None for r in replies),
                  f"a forwarded chat failed: {[r['error'] for r in replies]}")
            report = await conductor.call("W0", "report")
            rows = [served_for(report, i) for i in ids]
            streams = [r["generated"] for r in rows]
            check([spelled_ids(r["content"]) for r in replies] == streams,
                  "a forwarded stream is not the tokens its owner generated")
            shapes = [(r["hist"], r["bucket"], r["rows"]) for r in rows]
            out["parity"] = {"senders": senders, "shapes": shapes,
                             **plane_streams_check(reference, streams, shapes, exact)}
            # a planted fault: one token of a forwarded stream changed
            bad = [list(s) for s in streams]
            bad[0][len(bad[0]) // 2] = (bad[0][len(bad[0]) // 2] + 1) % cfg.vocab_size
            try:
                plane_streams_check(reference, bad, shapes, exact)
                check(False, "a forwarded stream with one token changed passed the check")
            except SmokeFailure as exc:
                check("differ" in str(exc), f"the planted fault failed otherwise: {exc}")
            alpha = report["ledger"].get("team:alpha", {})
            want_alpha = senders.count("W1")
            check(alpha.get("requests") == want_alpha,
                  f"team:alpha billed {alpha.get('requests')} requests, not {want_alpha}")
            check(all(r["tenant"] == ("team:alpha" if s == "W1" else "")
                      for r, s in zip(rows, senders)), "a chat reached the owner under "
                                                       "another tenant")
            out["tenant"] = {"team:alpha": alpha, "tenants": sorted(report["ledger"])}
            out["forwarded_ttft_ms"] = [(r["arrivals"][0] - r["t_send"]) * 1e3 for r in replies]
            out["engine_ttft_ms"] = [r["ttft_ms"] for r in rows]

            # 2. the hop: TTFT straight on the owner against through W1, and
            # each forwarded chunk's arrival against its emission
            direct, forwarded, chunk_ms = [], [], []
            for _ in range(PLANE_HOP_RUNS):
                d = await conductor.call("W0", "chat", body=extra["hop"], direct=True)
                f = await conductor.call("W1", "chat", body=extra["hop"])
                check(d["error"] is None and f["error"] is None and d["content"] == f["content"]
                      and len(f["arrivals"]) == len(spelled_ids(f["content"])),
                      "the hop chat failed or its forwarded tokens differ from the direct")
                direct.append((d["arrivals"][0] - d["t_send"]) * 1e3)
                forwarded.append((f["arrivals"][0] - f["t_send"]) * 1e3)
                emitted = (await conductor.call("W0", "report"))["emitted"][-1]
                arrivals = f["arrivals"]
                check(len(emitted) >= len(arrivals), "fewer chunks emitted than arrived")
                chunk_ms += [(a - e) * 1e3 for a, e in zip(arrivals, emitted[-len(arrivals):])]
            out["hop"] = {"runs": PLANE_HOP_RUNS, "direct_ttft_ms": direct,
                          "forwarded_ttft_ms": forwarded,
                          "direct_ttft_p50_ms": statistics.median(direct),
                          "forwarded_ttft_p50_ms": statistics.median(forwarded),
                          "hop_ttft_cost_ms": statistics.median(forwarded)
                          - statistics.median(direct),
                          "ms_per_forwarded_chunk": spread(chunk_ms)}

            # 3. the owner's queue, read on W2 under load
            watch = asyncio.ensure_future(conductor.call("W2", "queue_watch", seconds=3.0))
            await asyncio.sleep(0.2)
            load = await asyncio.gather(*[conductor.call("W1", "chat", body=r)
                                          for r in extra["load"]])
            watched = await watch
            check(all(r["error"] is None for r in load), "a chat of the load failed")
            depths = [s["depth"] for s in watched["readings"]]
            owner_report = await conductor.call("W0", "report")
            check(not watched["local_engine"], "W2 has an engine of its own")
            check(depths and max(depths) > 0,
                  f"W2 never read the owner's queue depth: {depths[:20]}, "
                  f"{watched['none']} None")
            check(all(s["capacity"] == owner_report["max_queue"] for s in watched["readings"]),
                  "W2 read another capacity than the owner's max_queue")
            out["queue_state"] = {"chats": PLANE_LOAD_CHATS, "readings": len(depths),
                                  "max_depth": max(depths), "none_readings": watched["none"],
                                  "capacity": owner_report["max_queue"]}

            # 4. a partition
            part = await conductor.call("W1", "partition", body=extra["hop"])
            check(part["outcome"].startswith("LLMUnavailable")
                  and part["seconds"] < PLANE_PARTITION_TIMEOUT_S + 5,
                  f"the partitioned call ended {part}")
            out["partition"] = part

            # 5. failover
            direct_run = await conductor.call("W0", "chat", body=extra["failover"], direct=True)
            check(direct_run["error"] is None, "the direct failover chat failed")
            report = await conductor.call("W0", "report")
            failover_ids = tok.encode(render_chat(extra["failover"]["messages"]))
            reference_stream = served_for(report, failover_ids)["generated"]
            check(spelled_ids(direct_run["content"]) == reference_stream,
                  "the direct run's chunks are not its owner's tokens")
            check(len(reference_stream) == PLANE_FAILOVER_TOKENS,
                  f"the direct run gave {len(reference_stream)} tokens")
            check(report["serving_events"] == 0,
                  f"W0 built or captured {report['serving_events']} times while serving")
            for name in counts:
                counts[name] += report["launches"][name]
            w0_reserved = report["reserved_bytes"]
            out["w0"] = {"build": report["builds"], "launches": report["launches"],
                         "reserved_bytes": w0_reserved, "rpc": report["rpc"]}
            if processes:
                for wid in ("W1", "W2"):
                    await conductor.call(wid, "min_free",
                                      bytes=int(free_with_w0 + 0.9 * w0_reserved))
            lease_log: dict = {}

            async def watch_lease(t_kill):
                while "elected" not in lease_log:
                    owner = await conductor.owner()
                    now = time.time()
                    if owner != "W0" and "lapsed" not in lease_log:
                        lease_log["lapsed"] = now
                    if owner in ("W1", "W2"):
                        lease_log.update(elected=now, owner=owner)
                    check(now - t_kill < 60, "no survivor took the lease")
                    await asyncio.sleep(LEASE_POLL_S)

            chunks, t_kill = [], None
            stream = conductor.rpc.call_stream(
                "W1", "smoke.stream", {"body": extra["failover"], "tenant": "team:alpha"},
                idle_timeout_s=PLANE_IDLE_S)
            async for chunk in stream:
                chunks.append(chunk)
                if chunk.get("k") == 4 and not chunk.get("end"):
                    t_kill = time.time()
                    await conductor.kill("W0")
                    break
            check(t_kill is not None, "the failover stream ended before four chunks")

            async def rest_of_stream():
                async for chunk in stream:
                    chunks.append(chunk)

            # the rest of W1's stream, beside the election: the retried chat
            # goes out once a survivor has built, whenever W1's stream ends
            rest = asyncio.ensure_future(rest_of_stream())
            await asyncio.wait_for(watch_lease(t_kill), 90)
            new_owner = await conductor.built_owner([lease_log["owner"]], 300)
            other = "W2" if new_owner == "W1" else "W1"
            await conductor.call(new_owner, "reset")
            retried = await conductor.call(other, "chat", body=extra["failover"])
            await asyncio.wait_for(rest, 60)
            end = chunks[-1]
            check(end.get("end") and end["error"] == "LLMUnavailable",
                  f"W1's stream ended with {end}")
            last_chunk_t = max(c["t"] for c in chunks[:-1])
            check(end["t"] - t_kill <= PLANE_IDLE_S + PLANE_TTL_S + 2.0,
                  f"W1's stream took {end['t'] - t_kill:.3f} s to end after the kill")
            check(retried["error"] is None, f"the retried chat failed: {retried['error']}")
            check(spelled_ids(retried["content"]) == reference_stream,
                  "the retried chat's forwarded tokens differ from the direct run's")
            survivor = await conductor.call(new_owner, "report")
            build = survivor["builds"][-1]
            retried_stream = served_for(survivor, failover_ids)["generated"]
            check(retried_stream == reference_stream,
                  "the retried chat's stream differs from the direct run's")
            check(survivor["serving_events"] == 0,
                  f"{new_owner} built or captured while serving")
            if processes:
                check(build["free_bytes_before"] >= free_with_w0 + 0.9 * w0_reserved,
                      f"{new_owner} built with {build['free_bytes_before']} bytes free: W0's "
                      f"{w0_reserved} bytes were not back")
            for name in counts:
                counts[name] += survivor["launches"][name]
            first_token = retried["arrivals"][0]
            out["failover"] = {
                "stream_chunks_before_kill": 4, "stream_chunks": end["k"],
                "stream_end": end["message"], "stream_end_after_kill_s": end["t"] - t_kill,
                "stream_end_after_last_chunk_s": end["t"] - last_chunk_t,
                "new_owner": new_owner, "retried_equals_direct": True,
                "gap_s": first_token - t_kill,
                "split_s": {"lease_lapse": lease_log["lapsed"] - t_kill,
                            "election": lease_log["elected"] - lease_log["lapsed"],
                            "build": build["t_end"] - lease_log["elected"],
                            "first_token": first_token - build["t_end"]},
                "build": build, "free_bytes_alone": free_alone,
                "free_bytes_with_w0": free_with_w0, "w0_reserved_bytes": w0_reserved}
            out["build_s"] = {"W0": report["builds"][0]["seconds"],
                              new_owner: build["seconds"]}
            rpc_stats = [report["rpc"]] + [(await conductor.call(w, "report"))["rpc"]
                                           for w in ("W1", "W2")]
            out["rpc"] = {key: sum(s[key] for s in rpc_stats)
                          for key in ("calls_served", "streams_served", "batches_sent",
                                      "batched_calls")}
            out["launches"] = dict(counts)
        finally:
            await conductor.stop()

    asyncio.run(run())
    for name in kernels:
        check(counts[name] > 0, f"{name} was not launched on the plane's path")
    return counts, out


# ------------------------------------------------ the object tier on the card

def fabric_phase(torch, dev, model: str, dtype: str, hub: HubThread,
                 kernels: tuple) -> tuple[dict, dict]:
    """``engine_llama3_8b_fabric`` / ``engine_llama3_tiny_f32_fabric``: the
    cross-host object hit of ``tests/tpu_local/test_kv_fabric.py`` at full
    width. Host A and host B are two engines of ``model`` on the card
    (``tier_engine``'s shapes, a 16-page pool, ``prefix_tiers`` with the
    lossless spill, a host tier of one page and no disk, so that every
    spill displaces the one before it through the write-behind worker to
    the object tier, one ``file://`` directory of this run's temp dir that
    both share). A serves the system-prompt request cold and again (the
    resident hit), then two summaries evict its three chain pages; once
    the write-behind worker has put them in the object tier, A's publisher
    advertises them (``publish_once``, bus RPC over ``hub``) to B's
    ``fabric.advert`` handler. B, built beside A (both stay up), serves the
    request: 384 tokens from the object tier, the tier conservation law,
    A's resident-hit stream, the chunk kernel once per layer on the hit.
    Planted fault: an advert merged under another tenant's namespace
    covers nothing B may serve (its probes miss); in f32 a third engine
    that received only that advert serves the request cold, with A's cold
    stream. Prints the restore's ms per page and GB/s."""
    import tempfile

    from mcp_context_forge_tpu_torch.coordination.hub import HubClient, TcpEventBus
    from mcp_context_forge_tpu_torch.coordination.rpc import BusRpc
    from mcp_context_forge_tpu_torch.tpu_local.kv.fabric import (ADVERT_METHOD, FabricAdvert,
                                                                 FabricIndexPublisher)
    from mcp_context_forge_tpu_torch.tpu_local.kv.prefix_index import chain_hashes
    from mcp_context_forge_tpu_torch.tpu_local.tpu_provider import TorchLocalProvider

    exact = dtype == "float32"
    hit_request, fillers = tier_requests(model)
    bucket = Path(tempfile.mkdtemp(prefix="fabric-")) / "bucket"
    nbytes = payload_bytes(model, int8=False)
    tiers = dict(dtype=dtype, prefix_tiers=True, tier_spill_quant="", num_pages=TIER_POOL_PAGES,
                 tier_host_bytes=nbytes + 1, tier_disk_bytes=0,
                 tier_object_url=f"file://{bucket}")
    wrappers = kernel_wrappers()
    out: dict = {"model": model, "dtype": dtype, "pool_pages": TIER_POOL_PAGES,
                 "object_url": "file://<run temp dir>/bucket", "payload_bytes": nbytes}
    host_a = tier_engine(model, None, **tiers)
    host_b = tier_engine(model, host_a.params, **tiers)
    engines = [host_a, host_b]
    served: dict = {}

    def recording(engine, name):
        submit = engine.submit

        async def record(request):
            served.setdefault(name, []).append(request)
            return await submit(request)

        engine.submit = record

    recording(host_a, "A")
    recording(host_b, "B")

    def drain(store):
        deadline = time.monotonic() + 120
        while (store._pending or not store._writeq.empty()) and time.monotonic() < deadline:
            time.sleep(0.01)
        check(not store._pending, "the write-behind worker did not drain in 120 s")

    async def run():
        clients = [HubClient("127.0.0.1", hub.port, secret=hub.secret) for _ in range(2)]
        buses = [TcpEventBus(c) for c in clients]
        rpcs = [BusRpc(bus, name, default_timeout_s=30.0) for bus, name in
                zip(buses, ("hostA", "hostB"))]
        for engine in engines:
            await engine.start()
        for bus, rpc in zip(buses, rpcs):
            await bus.start()
            await rpc.start()
        try:
            a, b = (TorchLocalProvider("tpu_local", e) for e in engines)
            await a.chat(dict(hit_request))
            await a.chat(dict(hit_request))             # the resident hit
            cold, resident = served["A"]
            check(cold.hist == 0 and resident.hist == 384,
                  f"A's runs hit {cold.hist} / {resident.hist} cached tokens")
            chain = chain_hashes(cold.prompt_ids, host_a.config.page_size)
            for request in fillers[:2]:
                await a.chat(dict(request))
            store_a, store_b = (e._tier_client.store for e in engines)
            await asyncio.to_thread(drain, store_a)
            on_object = store_a.object_hashes()
            check(all(h in on_object for h in chain),
                  f"{sum(h in on_object for h in chain)} of A's {len(chain)} chain pages "
                  f"reached the object tier")
            out["a_object_pages"] = store_a.stats()["object_pages"]
            pub_a = FabricIndexPublisher(store_a, "hostA", rpc=rpcs[0],
                                         bus_peers=lambda: ["hostA", "hostB"])
            pub_b = FabricIndexPublisher(lambda: store_b, "hostB", rpc=rpcs[1])
            rpcs[1].register(ADVERT_METHOD, pub_b.handle_advert)
            # a planted fault: A's advert under another tenant's namespace
            wrong = FabricAdvert(tenant="team-b", host="hostA", hashes=on_object,
                                 ttl_s=300.0).to_wire()
            merged = (await pub_b.handle_advert({"adverts": [wrong]}))["merged"]
            check(merged == len(on_object) and not any(store_b.probe(h) for h in chain),
                  "an advert under another tenant made B's probes hit")
            out["wrong_tenant_advert"] = {"merged": merged, "b_probe_hits": 0}
            report = await pub_a.publish_once()
            check(report == {"sent": 1, "hashes": len(on_object)},
                  f"A's publisher reported {report}")
            check(all(store_b.fabric.covers(h, store_b.object_namespace) for h in chain),
                  "B's fabric index does not cover A's chain")
            for fn in wrappers.values():
                fn.launches = 0
            hits0 = dict(host_b.allocator.tier_hit_tokens)
            await b.chat(dict(hit_request))
            counts = {k: fn.launches for k, fn in wrappers.items()}
            (got,) = served["B"]
            hits = {t: n - hits0[t] for t, n in host_b.allocator.tier_hit_tokens.items()}
            check(got.hist == 384 and hits["object"] == 384,
                  f"B hit {got.hist} tokens, {hits['object']} from the object tier")
            alloc = host_b.allocator
            check(sum(alloc.tier_hit_tokens.values()) == alloc.prefix_hit_tokens,
                  "the tier conservation law does not hold on B")
            check(got.generated == resident.generated,
                  "B's object-tier hit differs from A's resident hit")
            layers = host_b.model_config.n_layers
            chunk = sum(counts[k] for k in CHUNK)
            flash = sum(counts[k] for k in FLASH)
            check(chunk == layers and flash == 0,
                  f"B's hit ran {chunk} chunk and {flash} flash launches for {layers} layers")
            out.update(publisher=report, b_pub=pub_b.stats(), hit_tokens=hits,
                       b_object_reads=store_b.stats()["object_reads"],
                       ttft_ms={"a_cold": (cold.first_token_ts - cold.created) * 1e3,
                                "a_resident": (resident.first_token_ts - resident.created) * 1e3,
                                "b_object": (got.first_token_ts - got.created) * 1e3},
                       hit_launches=counts, stream_equal_resident_hit=True)
            if exact:
                # the wrong tenant's advert alone, on a third engine: a cold run
                host_c = tier_engine(model, host_a.params, **tiers)
                engines.append(host_c)
                recording(host_c, "C")
                await host_c.start()
                pub_c = FabricIndexPublisher(lambda: host_c._tier_client.store, "hostC")
                await pub_c.handle_advert({"adverts": [wrong]})
                await TorchLocalProvider("tpu_local", host_c).chat(dict(hit_request))
                (c_run,) = served["C"]
                check(c_run.hist == 0 and c_run.generated == cold.generated
                      and host_c.allocator.tier_hit_tokens["object"] == 0,
                      "an engine that knew A's chain only under another tenant served it")
                out["wrong_tenant_engine"] = {"hist": c_run.hist, "stream_equal_cold": True}
            return counts
        finally:
            for rpc, bus in zip(rpcs, buses):
                await rpc.stop()
                await bus.stop()
            for engine in engines:
                await engine.stop()

    counts = asyncio.run(run())
    restore = spread(host_b._tier_client.restore_ms)
    out["restore_ms"] = restore
    out["restore_gb_per_s"] = (nbytes / (restore["median"] / 1e3) / 1e9
                               if restore["median"] else None)
    for name in kernels:
        check(counts[name] > 0, f"{name} was not launched on B's object-tier hit")
    del host_a, host_b, engines
    free_device(torch)
    return counts, out


# ------------------------------------------------- training and the parallel layer

TINY_CKPT_STEPS = 400
TRAIN_1B_BATCH = (2, 1024)        # B x S seeded tokens, one batch for every step
TRAIN_1B_STEPS = 5
TRAIN_1B_LR, TRAIN_1B_WD = 3e-4, 0.1
REPLAY_BATCH = (1, 256)           # the CPU replay of one step at 2 layers
GRAD_REL = 5e-5                   # card vs CPU gradients: max|diff| <= GRAD_REL x max|cpu|
                                  # (H100: 3.0e-6-3.8e-6 sound, 1.1e-3-1.8e-3 with TF32 on)
ADAMW_TOL = 1e-3                  # x lr: one AdamW step against its rule
WORLD1_ATOL = 1e-5


def fact_streams(torch, engine, tokenizer) -> tuple[dict, list]:
    """Greedy token ids of each fact prompt of the tiny checkpoint's corpus
    (as many tokens as its answer has bytes: positions the corpus trains),
    one request at a time, then 16 tokens of a 79-token prompt of the
    repeated-phrase row whose first page is the first fact's (a prefix hit:
    its 63-token suffix takes a smaller bucket than the whole prompt, so it
    prefills through the paged chunk kernel). Every kernel's count is set
    to 0 just before and read just after."""
    from mcp_context_forge_tpu_torch.tools.tiny_checkpoint import _FACTS

    wrappers = kernel_wrappers()
    prompts = [(p, len(a.encode())) for p, a in _FACTS] + [
        ("the capital of france is paris. " * 2 + "the capital of", 16)]

    async def run():
        await engine.start()
        try:
            for fn in wrappers.values():
                fn.launches = 0
            streams = []
            for prompt, max_tokens in prompts:
                ids = tokenizer.encode(prompt)
                streams.append([t async for t in engine.generate(ids, max_tokens=max_tokens)])
            if engine.device.type == "cuda":
                torch.cuda.synchronize()
            return {k: fn.launches for k, fn in wrappers.items()}, streams
        finally:
            await engine.stop()

    return asyncio.run(run())


def memorized(tokenizer, streams: list) -> list[bool]:
    """Whether each fact prompt's greedy continuation is its answer."""
    from mcp_context_forge_tpu_torch.tools.tiny_checkpoint import _FACTS

    return [tokenizer.decode(s) == a for s, (_, a) in zip(streams, _FACTS)]


def tiny_engine(dev, path: Path):
    from mcp_context_forge_tpu_torch.tpu_local.engine import EngineConfig, TorchEngine

    return TorchEngine(EngineConfig(model="llama3-test", checkpoint=str(path), dtype="float32",
                                    device=str(dev), max_batch=4, max_seq_len=512,
                                    page_size=16, num_pages=64, prefill_buckets=(32, 64, 128),
                                    prefill_max_batch=2, seed=0))


def train_tiny_ckpt_phase(torch, dev, root: Path) -> tuple[dict, dict]:
    """``train_llama3_test_tiny_ckpt``: the tiny checkpoint's trainer on the
    card with the byte tokenizer (``ByteTokenizerAdapter``: the card has no
    ``tokenizers``): llama3-test, f32, AdamW lr 3e-3 without decay, the
    whole corpus (10 rows, each whole at the covering width) as one batch
    per step, 400 steps from a seeded generator. The result is saved with
    ``checkpoint.save_params`` and served by ``TorchEngine(checkpoint=...)``
    on the card (flash 1f, the mma.sync chunk kernel on a prefix hit,
    decode: all at hd 16): greedy answers to the four fact prompts decode
    the memorized answers, and every stream equals the CPU port engine's
    on the same directory. Planted fault: the step-0 checkpoint must fail
    the answer check."""
    import shutil

    from mcp_context_forge_tpu_torch.tools import tiny_checkpoint as tc
    from mcp_context_forge_tpu_torch.tpu_local.checkpoint import save_params
    from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS
    from mcp_context_forge_tpu_torch.tpu_local.models.llama import init_params
    from mcp_context_forge_tpu_torch.tpu_local.tokenizer import ByteTokenizer

    phase_t0 = time.monotonic()
    adapter = tc.ByteTokenizerAdapter()
    seq_len = tc.covering_seq_len(adapter)
    check(seq_len < MODEL_CONFIGS["llama3-test"].max_seq_len,
          f"the byte corpus needs {seq_len} positions")
    gen = torch.Generator(device=dev).manual_seed(42)
    start = init_params(MODEL_CONFIGS["llama3-test"], gen, dtype=torch.float32, device=dev)
    step0 = _clone_tree(start)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    losses = []
    t0 = time.monotonic()
    params, last = tc.train_model(adapter, steps=TINY_CKPT_STEPS, seq_len=seq_len, device=dev,
                                  params=start, losses=losses)
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    first = float(losses[0])
    check(math.isfinite(last) and last < 0.5 < first,
          f"the tiny checkpoint's loss went {first} -> {last}")
    stats = {"model": "llama3-test", "dtype": "float32", "tokenizer": "bytes",
             "rows": len(tc.CORPUS), "seq_len": seq_len, "steps": TINY_CKPT_STEPS,
             "loss_first": first, "loss_last": last,
             "train_s": seconds, "steps_per_s": TINY_CKPT_STEPS / seconds,
             "peak_bytes": torch.cuda.max_memory_allocated(), "card": card_line()}
    trained, untrained = root / "tiny-trained", root / "tiny-step0"
    shutil.rmtree(root, ignore_errors=True)
    trained.mkdir(parents=True)
    untrained.mkdir(parents=True)
    try:
        save_params(str(trained), params)
        save_params(str(untrained), step0)
        tokenizer = ByteTokenizer(512)
        engine = tiny_engine(dev, trained)
        counts, streams = fact_streams(torch, engine, tokenizer)
        hits = engine.allocator.prefix_hits
        del engine
        free_device(torch)
        answers = memorized(tokenizer, streams)
        check(all(answers), f"the card's answers: {[tokenizer.decode(s) for s in streams]}")
        check(hits >= 1, "the shared-prefix prompt missed the prefix cache")
        for kernel in ATTENTION_MMA:
            check(counts[kernel] > 0, f"{kernel} never launched on the trained checkpoint")
        for kernel in TC_ATTENTION + INT8_WRITERS:
            check(counts[kernel] == 0, f"{kernel} launched on the f32 tiny checkpoint")
        cpu_engine = tiny_engine(torch.device("cpu"), trained)
        _, cpu_streams = fact_streams(torch, cpu_engine, tokenizer)
        del cpu_engine
        check(streams == cpu_streams, f"card streams {streams} != CPU streams {cpu_streams}")
        engine = tiny_engine(dev, untrained)
        counts0, streams0 = fact_streams(torch, engine, tokenizer)
        del engine
        free_device(torch)
        check(not any(memorized(tokenizer, streams0)),
              "the step-0 checkpoint passed the answer check (planted fault not caught)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    stats.update({"answers": [tokenizer.decode(s) for s in streams],
                  "streams_equal_cpu": True, "prefix_hits": hits,
                  "step0_rejected": True, "step0_answers": [tokenizer.decode(s)
                                                            for s in streams0[:4]],
                  "launches": {k: counts[k] for k in ATTENTION_MMA},
                  "phase_s": time.monotonic() - phase_t0})
    stats["step0_launches"] = {k: counts0[k] for k in ATTENTION_MMA}
    return counts, stats


def _clone_tree(tree, device=None):
    """A detached copy of a param tree (on ``device``, else where it is)."""
    if isinstance(tree, dict):
        return {k: _clone_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone_tree(v, device) for v in tree]
    return tree.detach().to(device or tree.device, copy=True)


class DoubleDecayAdamW:
    """A planted fault: AdamW that applies the weight decay a second time
    after its step."""

    def __init__(self, torch, leaves, lr, weight_decay):
        self.inner = torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=weight_decay)
        self.leaves, self.factor = leaves, 1 - lr * weight_decay

    def step(self):
        self.inner.step()
        for p in self.leaves:
            p.data.mul_(self.factor)


def adamw_first_step_error(torch, p0, grad, p1, lr: float, wd: float) -> float:
    """max |p1 - the first step of optax.adamw's rule from p0 with grad| in
    units of lr (the rule in f64: bias-corrected moments, eps outside the
    square root, decay decoupled)."""
    g, p = grad.double(), p0.double()
    m_hat = (0.1 * g) / (1 - 0.9)
    v_hat = (0.001 * g * g) / (1 - 0.999)
    want = p - lr * (m_hat / (v_hat.sqrt() + 1e-8) + wd * p)
    return float((p1.double() - want).abs().max()) / lr


def train_1b_phase(torch, dev) -> dict:
    """``train_llama3_1b``: the whole llama3-1b (full width, all 16 layers,
    tied embeddings; f32 params, gradients and both AdamW moments, ~19.8
    GB) takes ``train_step`` for 5 steps on one seeded batch of 2 x 1024
    tokens (attention through its plain version, as training runs): the
    loss is finite and falls. The first step of the embedding, layer 0's
    wq and norm and the final norm is held to the AdamW rule; planted
    fault: an optimizer that applies the decay twice must fail that check.
    One step is replayed on the CPU at the same width and 2 layers (B 1,
    S 256): loss to rtol 1e-4, the gradients of embed, wq and w2 within
    GRAD_REL of the CPU's largest; the same step with TF32 matmuls must
    fail that check."""
    from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS
    from mcp_context_forge_tpu_torch.tpu_local.models.llama import init_params, param_count
    from mcp_context_forge_tpu_torch.tpu_local.train import (
        init_train_state, leaves, make_optimizer, train_step)

    phase_t0 = time.monotonic()
    cfg = MODEL_CONFIGS["llama3-1b"]
    B, S = TRAIN_1B_BATCH
    gen = torch.Generator(device=dev).manual_seed(7)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, gen, dtype=torch.float32, device=dev)
    data = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen, device=dev)
    tokens, targets = data[:, :-1], data[:, 1:]
    mask = torch.ones((B, S), device=dev)
    state = init_train_state(params, make_optimizer(TRAIN_1B_LR, TRAIN_1B_WD))
    watched = {"embed": params["embed"], "layers.0.wq": params["layers"][0]["wq"],
               "layers.0.attn_norm": params["layers"][0]["attn_norm"],
               "final_norm": params["final_norm"]}
    before = {k: v.detach().clone() for k, v in watched.items()}
    losses, step_ms = [], []
    for i in range(TRAIN_1B_STEPS):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        state, loss = train_step(state, cfg, tokens, targets, mask)
        losses.append(float(loss))
        step_ms.append((time.monotonic() - t0) * 1e3)
        if i == 0:
            grads = {k: v.grad.detach().clone() for k, v in watched.items()}
            rule = {k: adamw_first_step_error(torch, before[k], grads[k], v.detach(),
                                              TRAIN_1B_LR, TRAIN_1B_WD)
                    for k, v in watched.items()}
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"llama3-1b losses {losses}")
    check(max(rule.values()) <= ADAMW_TOL, f"the first AdamW step off its rule (x lr): {rule}")
    # planted fault: decay applied twice, on copies of the same leaves and gradients
    copies = {k: v.clone().requires_grad_(True) for k, v in before.items()}
    faulty = DoubleDecayAdamW(torch, list(copies.values()), TRAIN_1B_LR, TRAIN_1B_WD)
    for k, p in copies.items():
        p.grad = grads[k]
    faulty.step()
    fault = {k: adamw_first_step_error(torch, before[k], grads[k], p.detach(), TRAIN_1B_LR,
                                       TRAIN_1B_WD) for k, p in copies.items()}
    check(max(fault.values()) > ADAMW_TOL,
          f"an AdamW that decays twice passed the rule check: {fault}")
    n_params = sum(p.numel() for p in leaves(state.params))
    state_bytes = sum(p.numel() * p.element_size() * 4 for p in leaves(state.params))
    del state, params, watched, before, grads, copies, faulty
    free_device(torch)
    median_ms = statistics.median(step_ms[1:])
    stats = {"model": cfg.name, "layers": cfg.n_layers, "dim": cfg.dim,
             "params": n_params, "param_count": param_count(cfg), "batch": [B, S],
             "steps": TRAIN_1B_STEPS, "lr": TRAIN_1B_LR, "weight_decay": TRAIN_1B_WD,
             "losses": losses, "step_ms": step_ms, "step_ms_median_2_5": median_ms,
             "tokens_per_s": B * S / (median_ms / 1e3), "peak_bytes": peak,
             "params_grads_moments_bytes": state_bytes, "adamw_rule_x_lr": rule,
             "double_decay_rejected": True, "double_decay_x_lr": fault,
             "replay": train_replay(torch, dev), "card": card_line()}
    stats["phase_s"] = time.monotonic() - phase_t0
    return stats


def train_replay(torch, dev) -> dict:
    """One step's loss and gradients of llama3-1b at 2 layers on the card
    against the same on the CPU (same seeded weights and tokens). Planted
    fault: the card's step with TF32 matmuls (a 10-bit mantissa) must fail
    the gradient check."""
    from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS
    from mcp_context_forge_tpu_torch.tpu_local.models.llama import init_params
    from mcp_context_forge_tpu_torch.tpu_local.train import leaves, loss_fn

    check(not torch.backends.cuda.matmul.allow_tf32, "the replay needs TF32 off")
    cfg = dataclasses.replace(MODEL_CONFIGS["llama3-1b"], name="llama3-1b-2-layers",
                              n_layers=2)
    B, S = REPLAY_BATCH
    gen = torch.Generator().manual_seed(11)
    cpu = torch.device("cpu")
    params = init_params(cfg, gen, dtype=torch.float32, device=cpu)
    data = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen)
    out = {}
    for where, device, tf32 in (("card", dev, False), ("card_tf32", dev, True),
                                ("cpu", cpu, False)):
        tree = _clone_tree(params, device)
        for leaf in leaves(tree):
            leaf.requires_grad_(True)
        batch = data.to(device)
        t0 = time.monotonic()
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            loss = loss_fn(tree, cfg, batch[:, :-1], batch[:, 1:],
                           torch.ones((B, S), device=device))
            loss.backward()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        out[where] = {"loss": float(loss.detach()), "seconds": time.monotonic() - t0,
                      "embed": tree["embed"].grad.cpu(),
                      "wq": tree["layers"][0]["wq"].grad.cpu(),
                      "w2": tree["layers"][1]["w2"].grad.cpu()}
        del tree, loss
    card, tf32, ref = out["card"], out["card_tf32"], out["cpu"]
    check(abs(card["loss"] - ref["loss"]) <= 1e-4 * abs(ref["loss"]),
          f"replay loss card {card['loss']} cpu {ref['loss']}")
    rel, control = ({k: float((got[k] - ref[k]).abs().max() / ref[k].abs().max())
                     for k in ("embed", "wq", "w2")} for got in (card, tf32))
    check(max(rel.values()) <= GRAD_REL, f"replay gradients off the CPU's: {rel}")
    check(max(control.values()) > GRAD_REL,
          f"the card's TF32 step passed the gradient check (planted fault not caught): {control}")
    free_device(torch)
    return {"model": cfg.name, "batch": [B, S], "loss_card": card["loss"],
            "loss_cpu": ref["loss"], "loss_card_tf32": tf32["loss"], "grad_max_rel": rel,
            "grad_max_rel_tf32": control, "grad_rel_limit": GRAD_REL,
            "cpu_s": ref["seconds"]}


# ----------------------------------------------------- multi-rank serving

def tp_rank_geometries(torch, dev) -> dict:
    """Rows 1, 2, 2b, 3 and 3b against their plain versions at the per-rank
    head counts tensor parallelism gives (``serving_layout``): llama3-8b (hd
    128, G 4) at TP 2, 4 and 8 (KV 4, 2 and 1 per rank: each rank's shard of
    the pool), gemma-2b at TP 2 (hd 256: 4 query heads per rank over the one
    KV head every rank holds), and llama3-8b at TP 16 (rank 11: 2 query heads
    over a replicated pool of 8 KV heads, read from head 5 through the
    kernels' ``kv_offset``); rows 4 and 5 at Mixtral's per-rank F = 7168 (TP
    2), 512 tokens routed top-2 over 8 experts. Bf16; a chunk of 256 queries
    at positions 768-1023 (row 1 half padding) over 1024 cached tokens, a
    decode over 1024 and 724. Each row within ROW_REL of its largest value
    (rows 4, 5: ``moe_checks``). Planted fault: the TP 16 rank reading KV
    head 6 for 5 fails the row check on both paged kernels."""
    from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS
    from mcp_context_forge_tpu_torch.tpu_local.models.llama import serving_layout
    from mcp_context_forge_tpu_torch.tpu_local.ops import attention as att
    from mcp_context_forge_tpu_torch.tpu_local.ops import grouped_moe as gm
    from mcp_context_forge_tpu_torch.tpu_local.ops import paged_attention as paged
    from mcp_context_forge_tpu_torch.tpu_local.parallel.moe import router_probs
    from mcp_context_forge_tpu_torch.tpu_local.quantize import quantize_leaf

    t0 = time.monotonic()
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(16)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf16)

    B, S, page, ctx = 2, 256, 128, 1024
    P = ctx // page
    geometries, faults = [], {}
    for model, tp, rank in (("llama3-8b", 2, 1), ("llama3-8b", 4, 3), ("llama3-8b", 8, 5),
                            ("gemma-2b", 2, 1), ("llama3-8b", 16, 11)):
        cfg = MODEL_CONFIGS[model]
        replicated, kv_groups, offset = serving_layout(cfg, tp, rank)
        hd, H = cfg.head_dim, cfg.n_heads // tp
        G = H // kv_groups
        pool_kv = cfg.n_kv_heads if replicated else cfg.n_kv_heads // tp
        where = f"{model} TP {tp} rank {rank}"
        row = {"model": model, "tp": tp, "rank": rank, "q_heads": H, "kv_groups": kv_groups,
               "G": G, "pool_kv_heads": pool_kv, "kv_offset": offset, "hd": hd,
               "replicated_pool": replicated}
        # row 1: the prompt's own k/v, the rank's window of its KV heads
        q, k, v = randn(B, S, H, hd), randn(B, S, kv_groups, hd), randn(B, S, kv_groups, hd)
        valid = torch.ones((B, S), dtype=torch.bool, device=dev)
        valid[1, S - 37:] = False
        out = att.flash_attention(q, k, v, valid)
        ref = att.attention_reference(q, k, v, valid)
        row["flash"] = compare_paged(torch, f"flash {where}", out, ref, valid)
        # the pool: distinct pages per row, page 0 unused
        tables = (torch.randperm(B * P, generator=torch.Generator().manual_seed(tp))
                  .add(1).reshape(B, P).to(torch.int32).to(dev))
        n_pages = B * P + 1
        kp, vp = randn(n_pages, page, pool_kv, hd), randn(n_pages, page, pool_kv, hd)
        k8, v8 = (torch.randint(-127, 128, (n_pages, page, pool_kv, hd), generator=gen,
                                device=dev, dtype=torch.int8) for _ in range(2))
        scales = tuple((torch.rand((n_pages, pool_kv), generator=gen, device=dev) + 0.5)
                       .div(127).to(bf16) for _ in range(2))
        pos = torch.arange(ctx - S, ctx, dtype=torch.int32, device=dev).repeat(B, 1)
        pos[1, S // 2:] = -1
        qc = randn(B, S, kv_groups, G, hd)
        seq = torch.tensor([ctx, ctx - 300], dtype=torch.int32, device=dev)
        qd = randn(B, kv_groups, G, hd)
        every = torch.ones(B, dtype=torch.bool, device=dev)
        for name, pages in (("chunk", (kp, vp)), ("chunk_q8", (k8, v8, *scales))):
            kpp, vpp, *sc = pages
            out = paged.paged_chunk_attention(qc, kpp, vpp, tables, pos, *sc, kv_offset=offset)
            ref = paged.paged_chunk_attention_ref(qc, kpp, vpp, tables, pos, *sc,
                                                  kv_offset=offset)
            row[name] = compare_paged(torch, f"{name} {where}", out, ref, pos >= 0)
            if replicated and pool_kv > 1:
                faults[f"{name}: {where} reads KV head {offset + 1} for {offset}"] = (
                    paged.paged_chunk_attention(qc, kpp, vpp, tables, pos, *sc,
                                                kv_offset=offset + 1), ref, pos >= 0)
        for name, pages in (("decode", (kp, vp)), ("decode_q8", (k8, v8, *scales))):
            kpp, vpp, *sc = pages
            out = paged.paged_decode_attention(qd, kpp, vpp, tables, seq, *sc, kv_offset=offset)
            ref = paged.paged_decode_attention_ref(qd, kpp, vpp, tables, seq, *sc,
                                                   kv_offset=offset)
            row[name] = compare_paged(torch, f"{name} {where}", out, ref, every)
            if replicated and pool_kv > 1:
                faults[f"{name}: {where} reads KV head {offset + 1} for {offset}"] = (
                    paged.paged_decode_attention(qd, kpp, vpp, tables, seq, *sc,
                                                 kv_offset=offset + 1), ref, every)
        torch.cuda.synchronize()
        geometries.append(row)
    check(len(faults) == 4, f"{len(faults)} planted faults")
    planted = {}
    for fault, (out, ref, rows) in faults.items():
        planted.update(planted_faults(torch, fault, {fault: out}, ref, rows))

    # rows 4, 5: each expert's hidden slice of one rank at TP 2
    D, F, E, K, T, Bt = 4096, 14336 // 2, 8, 2, 512, 128
    w1, w3 = randn(E, D, F, scale=D ** -0.5), randn(E, D, F, scale=D ** -0.5)
    w2 = randn(E, F, D, scale=F ** -0.5)
    x = randn(T, D)
    plan = gm.route_sorted_blocks(router_probs(randn(D, E, scale=D ** -0.5), x), K, Bt)
    be = plan["block_expert"]
    NB = be.numel()
    x_pad = (x[plan["sorted_token"].long()]
             * plan["row_valid"][:, None].to(bf16)).reshape(NB, Bt, D)
    rows = plan["row_valid"].reshape(NB, Bt) > 0
    check(gm.moe_route(bf16, Bt, D, F) == "tc", "the per-rank F does not route to tc")
    moe = {"D": D, "F_per_rank": F, "E": E, "tokens": T, "blocks": NB}
    moe["expert_blocks_tc"] = moe_checks(torch, "expert_blocks_tc at F 7168",
                                         gm.expert_blocks(x_pad, w1, w3, w2, be),
                                         gm.expert_blocks_ref(x_pad, w1, w3, w2, be), rows)

    def quantize(w):
        leaves = [quantize_leaf(w[e], 0, bf16) for e in range(E)]
        return {key: torch.stack([leaf[key] for leaf in leaves]) for key in ("q", "s")}

    q1, q3, q2 = quantize(w1), quantize(w3), quantize(w2)
    del w1, w3, w2
    moe["expert_blocks_tc_q8"] = moe_checks(torch, "expert_blocks_tc_q8 at F 7168",
                                            gm.expert_blocks_q8(x_pad, q1, q3, q2, be),
                                            gm.expert_blocks_q8_ref(x_pad, q1, q3, q2, be),
                                            rows)
    torch.cuda.synchronize()
    return {"tolerance": {"atol": TOL, "rtol": TOL, "row_relative": ROW_REL},
            "attention": geometries, "planted_faults": planted, "moe_tp2": moe,
            "seconds": time.monotonic() - t0}


def rank1_phase(torch, dev, reference: dict) -> tuple[dict, dict]:
    """``engine_llama3_8b_rank1``: the ``engine`` phase's llama3-8b (bf16,
    full width, random weights from the same seed, each leaf drawn and kept
    through the rank path's ``place``) at ``mesh_shape="1x1"``: the rank path
    on a one-rank NCCL group, the forward's all-reduces and all-gathers and
    the sampled tokens' broadcast inside every captured decode graph. Its
    greedy streams must equal the ``engine`` phase's token for token (an
    all-reduce over one rank changes no value). Reports the graphs'
    captures, replays, launches and collectives per replay, and one fed
    decode dispatch's device events beside the ``engine`` phase's
    DECODE_REPLAY_EVENTS. The engine's group is its own and ends with it."""
    t0 = time.monotonic()
    events = {}

    def after(engine):
        check(engine._ranks is not None and engine.world == 1, "the 1x1 engine is not on the rank path")
        check(all(bufs.collectives > 0 for bufs in engine._graphs.buffers.values()),
              "a decode graph holds no collective")
        events.update(replay_device_events(torch, engine, [300] * engine.config.max_batch))
        return events

    counts, stats = engine_phase(torch, dev, "llama3-8b", ATTENTION, chat_requests("llama3-8b"),
                                 hit=1, absent=NOT_BF16, mesh_shape="1x1", after=after)
    check(stats["generated"] == reference["generated"],
          "a 1x1 rank-path stream differs from the one-device engine's")
    stats.update(streams_equal_engine=True, seconds=time.monotonic() - t0,
                 replay_device_events=events, engine_replay_device_events=DECODE_REPLAY_EVENTS,
                 engine_phase_decode_tokens_per_s=reference["decode_tokens_per_s"],
                 engine_phase_ttft_p50_ms=reference["ttft_p50_ms"])
    return counts, stats


def payload_diff(a, b) -> list[str]:
    """The fields in which two spill payloads differ, byte for byte."""
    import numpy as np

    return [name for name in ("k", "v", "k_scales", "v_scales")
            if getattr(a, name).dtype != getattr(b, name).dtype
            or not np.array_equal(getattr(a, name), getattr(b, name))]


def head_faults(torch, engine, page: int, reference) -> dict:
    """On a stopped 1x1 engine whose group is open, with ``reference`` the
    rank-less engine's payload of ``page``'s chain key: the payload read
    through the rank path's gather equals it byte for byte, and two planted
    faults are rejected. (1) A payload gathered in the wrong head order
    (``_join_heads`` reversing the KV heads): the read differs from the
    reference. (2) A restore that uploads rank 0's heads to every rank: one
    rank cannot show it, so on the card, over the real page, each rank's
    slice of an upload (``_rank_heads``) at a model axis of 2, 4 and 8,
    joined again in rank order (``_join_heads``), must give the page bit for
    bit, and the same with every rank given rank 0's slice must not."""
    from mcp_context_forge_tpu_torch.tpu_local import engine as engine_module

    got = engine._read_page_payload(page)
    check(not payload_diff(got, reference),
          f"the rank path's payload differs from the rank-less engine's in "
          f"{payload_diff(got, reference)}")
    join = engine_module._join_heads

    def reversed_heads(pieces):
        return tuple(t.flip(2 if i < 2 else 1) for i, t in enumerate(join(pieces)))

    engine_module._join_heads = reversed_heads
    try:
        wrong_order = payload_diff(engine._read_page_payload(page), reference)
    finally:
        engine_module._join_heads = join
    check(bool(wrong_order), "a payload gathered in reversed head order passed the check")
    whole = tuple(torch.from_numpy(getattr(got, name)).to(engine.device)
                  for name in ("k", "v", "k_scales", "v_scales"))
    kv = whole[0].shape[2]
    slices = {}
    axes = [m for m in (2, 4, 8) if kv % m == 0]
    check(bool(axes), f"{kv} KV heads split over no model axis of 2, 4 or 8")
    for m in axes:
        n = kv // m
        good = join([engine_module._rank_heads(whole, r * n, n) for r in range(m)])
        check(all(torch.equal(a, b) for a, b in zip(good, whole)),
              f"the per-rank slices of an upload at model axis {m} do not rejoin the page")
        bad = join([engine_module._rank_heads(whole, 0, n) for _ in range(m)])
        check(not all(torch.equal(a, b) for a, b in zip(bad, whole)),
              f"rank 0's heads uploaded to every rank at model axis {m} passed the check")
        slices[m] = {"heads_per_rank": n, "rejoined_equal": True, "rank0_heads_rejected": True}
    return {"payload_equal_rankless": True, "wrong_head_order_rejected": wrong_order,
            "upload_slices": slices}


def rank1_tiers_phase(torch, dev, reference: dict, model: str = "llama3-8b"
                      ) -> tuple[dict, dict]:
    """``engine_llama3_8b_rank1_tiers``: ``tiers_phase``'s 16-page eviction
    scenario (the same seeded weights) through the rank path at
    ``mesh_shape="1x1"``: each spill an announced ``_op_read_page`` whose
    shards are gathered on the data plane (a one-rank NCCL group), each
    restore an ``_op_upload_page`` that broadcasts the page, every rank
    keeping its heads. Lossless (``tier_spill_quant=""``, from host RAM,
    with the planted collision) and the int8 spill: the restored hits'
    streams must equal ``engine_llama3_8b_tiers``'s, token for token, and
    each lossless chain payload must equal the rank-less engine's of the
    same chain key, byte for byte; then ``head_faults``. Spill and restore
    ms per page beside the rank-less phase's."""
    from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS
    from mcp_context_forge_tpu_torch.tpu_local.models.llama import init_params

    t0 = time.monotonic()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(MODEL_CONFIGS[model], gen, torch.bfloat16, dev)
    layers = MODEL_CONFIGS[model].n_layers
    counts = dict.fromkeys(REPLACES, 0)
    out: dict = {"model": model, "layers": layers, "mesh_shape": "1x1", "dtype": "bfloat16",
                 "pool_pages": TIER_POOL_PAGES, "hit_tokens": 384}
    for name, kwargs in (("host", dict(tier_spill_quant="", tier_host_bytes=2**31)),
                         ("int8_spill", dict(tier_host_bytes=2**31))):
        engine = tier_engine(model, params, prefix_tiers=True, num_pages=TIER_POOL_PAGES,
                             mesh_shape="1x1", **kwargs)
        check(engine._ranks is not None and engine.world == 1 and engine._kv_sharded,
              "the tier engine is not on the rank path")

        def after(engine):
            alloc = engine.allocator
            pages = {h: p for p, (h, _) in alloc._page_hash.items() if p in alloc._page_key}
            keys = [k for k in reference["payloads"] if k in pages]
            check(bool(keys), "no chain page of the request is resident after the run")
            return head_faults(torch, engine, pages[keys[0]], reference["payloads"][keys[0]])

        run = tier_run(torch, engine, name, after=after if name == "host" else None)
        del engine
        free_device(torch)
        for k in counts:
            counts[k] += run["launches"][k]
        check_tier_hit(run, "host", 3, layers)
        check(run["streams"][1] == reference["streams"][name][1],
              f"the {name} hit restored through the rank path gave another stream than "
              f"engine_llama3_8b_tiers's")
        if name == "host":
            check(sorted(run["payloads"]) == sorted(reference["payloads"]),
                  "the rank path spilled other chain pages than the rank-less engine")
            diffs = {k.hex()[:12]: payload_diff(p, reference["payloads"][k])
                     for k, p in run["payloads"].items()}
            check(not any(diffs.values()),
                  f"lossless chain payloads differ from the rank-less engine's: {diffs}")
            collision = run["collision"]
            check(collision["collisions"] == 1 and collision["hist"] == 0
                  and run["streams"][2] == run["streams"][0],
                  f"the planted collision was not a miss giving the cold stream: {collision}")
            out["payloads_equal_rankless"] = len(diffs)
            out["faults"] = run["after"]
        int8 = name == "int8_spill"
        out[name] = {"streams_equal_rankless": True, "ttft_ms": run["ttft_ms"],
                     "hist": run["hist"], "hit_tokens": run["hit_tokens"],
                     "hit_chunk_launches": run["hit_chunk_launches"],
                     "rates": tier_rates(run, payload_bytes(model, int8)),
                     "rankless_rates": reference["rates"][name],
                     "restored_max_abs_diff": run["restored_max_abs_diff"],
                     "peak_memory_bytes": run["peak_memory_bytes"]}
    del params
    out["seconds"] = time.monotonic() - t0
    return counts, out


def rank1_pool_phase(torch, dev, reference: dict, rank1_events: int,
                     model: str = "llama3-8b") -> tuple[dict, dict]:
    """``engine_llama3_8b_rank1_pool``: an ``EnginePool`` of two llama3-8b
    replicas (``pool_config``: bf16, 256 pages, the lossless spill into one
    shared host store) at ``mesh_shape="1x1"`` on the one card, roles
    ``prefill,decode``: two multi-rank engines in this process, each on its
    own one-rank NCCL group (``torch.distributed``'s default group never
    initialized). The prompt with ``MIGRATE_SYSTEM`` (three full pages)
    prefills on replica 0, its chain is exported through the rank path's
    gather and restored into replica 1 through its upload: its first token
    must be the cold run's and the rest the resident hit's of the pool
    phase's ``standalone_reference``; ok, 3 pages spilled and 3 restored.
    Each replica's decode graphs hold collectives, and one fed decode
    dispatch of each runs the device events ``engine_llama3_8b_rank1``
    measured for the 1x1 rank path (``rank1_events``; the rank-less
    engine's DECODE_REPLAY_EVENTS beside it)."""
    import torch.distributed as dist

    from mcp_context_forge_tpu_torch.tpu_local.engine import GenRequest
    from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS
    from mcp_context_forge_tpu_torch.tpu_local.pool import EnginePool
    from mcp_context_forge_tpu_torch.tpu_local.tokenizer import load_tokenizer, render_chat

    t0 = time.monotonic()
    cfg = MODEL_CONFIGS[model]
    tok = load_tokenizer(vocab_size=cfg.vocab_size)
    ids = tok.encode(render_chat(chat(model, "Which servers answered today?",
                                      MIGRATE_SYSTEM)["messages"]))
    rec = PoolRecorder()
    wrappers = kernel_wrappers()
    pool = EnginePool(pool_config(model, "bfloat16", mesh_shape="1x1"), replicas=2,
                      roles="prefill,decode", health_interval_s=0.1,
                      heartbeat_timeout_s=POOL_HEARTBEAT_S, engine_factory=rec.factory)
    engines = [r.engine for r in pool.replicas]
    check(all(e._ranks is not None and e.world == 1 for e in engines),
          "a replica is not on the rank path")
    check(engines[0]._mesh.get_group("world") is not engines[1]._mesh.get_group("world"),
          "the two replicas share a process group")
    check(not dist.is_initialized(), "a replica initialized the default process group")
    for engine in engines:
        check(all(bufs.collectives > 0 for bufs in engine._graphs.buffers.values()),
              f"a decode graph of replica {engine.config.replica_id} holds no collective")
    out: dict = {"model": model, "layers": cfg.n_layers, "replicas": 2, "mesh_shape": "1x1",
                 "pool_pages": POOL_PAGES, "build_s": [b["seconds"] for b in rec.builds],
                 "collectives_per_replay": [sorted({b.collectives for b in
                                                    e._graphs.buffers.values()})
                                            for e in engines]}

    async def run():
        await pool.start()
        try:
            for fn in wrappers.values():
                fn.launches = 0
            request = GenRequest(request_id="migrate-rank1", prompt_ids=ids,
                                 max_tokens=POOL_TOKENS)
            sent = time.monotonic()
            await pool.submit(request)
            stamps = await timed_stream(request)
            launches = {k: fn.launches for k, fn in wrappers.items()}
            await pool.health.stop()
            for engine in engines:      # the groups stay for the replays below
                await engine.stop(keep_group=True)
            events = [replay_device_events(torch, e, [300] * e.config.max_batch)
                      for e in engines]
            return request, [t for t, _ in stamps], (stamps[0][1] - sent) * 1e3, \
                launches, events
        finally:
            await pool.stop()

    request, tokens, ttft, launches, events = asyncio.run(run())
    check(pool.migrations == {"ok": 1, "degraded": 0}
          and pool.migration_pages == {"spilled": 3, "restored": 3, "degraded": 0},
          f"the migration: {pool.migrations}, {pool.migration_pages}")
    pages = pool.migration_pages
    check(pages["spilled"] == pages["restored"] + pages["degraded"],
          f"migration pages not conserved: {pages}")
    check(tokens[0] == reference["cold"][0] and tokens[1:] == reference["hit"],
          "the migrated stream differs from the standalone engine's")
    check(rec.replica_of("migrate-rank1~r1") == engines[1].config.replica_id,
          "the continuation did not reach the decode replica")
    for e, ev in zip(engines, events):
        check(ev["device_events"] == rank1_events,
              f"one fed decode dispatch of replica {e.config.replica_id} ran "
              f"{ev['device_events']} device events, not the 1x1 rank path's {rank1_events}")
    for kernel in ATTENTION:
        check(launches[kernel] > 0, f"{kernel} never launched on the rank-path pool")
    out.update(stream_equal_standalone=True, migrations=dict(pool.migrations),
               migration_pages=dict(pages), migration_bytes=pool.migration_bytes,
               ttft_ms=ttft, replay_device_events=events,
               rank1_replay_device_events=rank1_events,
               engine_replay_device_events=DECODE_REPLAY_EVENTS,
               default_group_initialized=dist.is_initialized(),
               seconds=time.monotonic() - t0)
    check(not out["default_group_initialized"], "the default process group was initialized")
    del pool, engines, rec
    free_device(torch)
    return launches, out


def sp1_phase(torch, dev, reference: list) -> tuple[dict, dict]:
    """``engine_llama3_tiny_sp1``: llama3-tiny (f32) at ``mesh_shape="1x1"``
    with ``sp_impl`` ring, then Ulysses, and ``sp_threshold`` 128: the
    prompts of the 512 and 2048 buckets prefill with their attention
    sequence-parallel over the one-rank NCCL group (the JAX package's
    ``test_sp_serving`` case), the rest through the kernels. Each stream
    must equal the f32 engine phase's (dense) one."""
    t0 = time.monotonic()
    out, counts = {}, dict.fromkeys(REPLACES, 0)
    for impl in ("ring", "ulysses"):
        launched, stats = engine_phase(
            torch, dev, "llama3-tiny", ATTENTION_MMA[1:], chat_requests("llama3-tiny"), hit=1,
            absent=TC_ATTENTION, dtype="float32", mesh_shape="1x1", sp_impl=impl,
            sp_threshold=128)
        free_device(torch)
        check(stats["sequence_parallel_prefills"] > 0, f"no {impl} prefill ran")
        check(stats["generated"] == reference,
              f"an sp_impl={impl} stream differs from the dense engine's")
        for name in counts:
            counts[name] += launched[name]
        out[impl] = {key: stats[key] for key in (
            "world", "buckets", "sequence_parallel_prefills", "prefills", "history_prefills",
            "ttft_ms", "decode_tokens_per_s", "graph_captures", "graph_replays",
            "engine_build_s", "total_s")}
        out[impl]["streams_equal_dense"] = True
    return counts, {**out, "sp_threshold": 128, "seconds": time.monotonic() - t0}


def free_local_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parallel_world1_phase(torch, dev) -> dict:
    """``parallel_nccl_world1``: a one-rank NCCL group on the card (a
    ``tcp://127.0.0.1`` rendezvous: no network), and on a 1x1 mesh every
    sharded entry point against its single-device function in f32: ring and
    Ulysses attention against ``attention_reference`` (B 2, S 256, 8 q / 4
    kv heads, hd 32, padded rows) and the pipeline's forward (llama3-tiny,
    1 stage, 2 microbatches) against the layer-by-layer forward, both to
    1e-5; ``moe_ffn`` (mixtral-test geometry) with its experts "split" over
    the one rank against ``moe_ffn`` without a mesh, to 1e-5;
    ``build_sharded_train_step`` (llama3-test, 3 steps) against
    ``train_step``: loss rtol 1e-5, parameters within 1e-2 x lr. Planted
    fault: a ring without the causal mask must fail its check. The group
    is torn down before the phases that follow."""
    from datetime import timedelta

    import torch.distributed as dist

    from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS
    from mcp_context_forge_tpu_torch.tpu_local.models.llama import init_params
    from mcp_context_forge_tpu_torch.tpu_local.ops.attention import attention_reference
    from mcp_context_forge_tpu_torch.tpu_local.parallel import moe
    from mcp_context_forge_tpu_torch.tpu_local.parallel.mesh import make_mesh
    from mcp_context_forge_tpu_torch.tpu_local.parallel.pipeline import (
        build_pp_forward, stack_layers)
    from mcp_context_forge_tpu_torch.tpu_local.parallel.ring_attention import (
        make_ring_attention, make_ulysses_attention)
    from mcp_context_forge_tpu_torch.tpu_local.train import (
        build_sharded_train_step, forward_logits, init_train_state, leaves, make_optimizer,
        train_step)

    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)   # the rank's card, before the mesh's communicator
    t0 = time.monotonic()
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{free_local_port()}",
                            world_size=1, rank=0, timeout=timedelta(seconds=120))
    stats = {"backend": backend, "world": dist.get_world_size()}
    try:
        mesh = make_mesh("1x1", dev.type)
        stats["init_s"] = time.monotonic() - t0
        gen = torch.Generator(device=dev).manual_seed(5)
        B, S, H, KV, hd = 2, 256, 8, 4, 32
        q = torch.randn((B, S, H, hd), generator=gen, device=dev)
        k = torch.randn((B, S, KV, hd), generator=gen, device=dev)
        v = torch.randn((B, S, KV, hd), generator=gen, device=dev)
        valid = torch.ones((B, S), dtype=torch.bool, device=dev)
        valid[1, 200:] = False
        want = attention_reference(q, k, v, valid)
        errors = {}
        for name, maker in (("ring", make_ring_attention), ("ulysses", make_ulysses_attention)):
            got = maker(mesh)(q, k, v, valid)
            errors[name] = float((got - want).abs().max())
            check(errors[name] <= WORLD1_ATOL, f"{name} attention off by {errors[name]}")
        open_ring = make_ring_attention(mesh, causal=False)(q, k, v, valid)
        errors["ring_without_causal_mask"] = float((open_ring - want).abs().max())
        check(errors["ring_without_causal_mask"] > WORLD1_ATOL,
              "a ring without the causal mask passed the check (planted fault not caught)")
        # the pipeline: one stage, two microbatches
        cfg = MODEL_CONFIGS["llama3-tiny"]
        params = init_params(cfg, gen, dtype=torch.float32, device=dev)
        pipe_mesh = make_mesh("1x1", dev.type, axis_names=("data", "pipe"))
        forward, shard_stacked = build_pp_forward(pipe_mesh, cfg, n_stages=1, microbatches=2)
        tokens = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen, device=dev)
        positions = torch.arange(64, device=dev).expand(4, 64)
        with torch.no_grad():
            got = forward(shard_stacked(stack_layers(params, 1)), tokens, positions)
            ref = forward_logits(params, cfg, tokens)
        errors["pipeline"] = float((got - ref).abs().max())
        check(errors["pipeline"] <= WORLD1_ATOL, f"the pipeline off by {errors['pipeline']}")
        # capacity-dispatch MoE at mixtral-test's geometry
        mix = MODEL_CONFIGS["mixtral-test"]
        moe_cfg = moe.MoEConfig(dim=mix.dim, n_experts=mix.n_experts,
                                expert_hidden=mix.ffn_hidden, top_k=mix.moe_top_k)
        moe_params = moe.init_moe_params(moe_cfg, gen, device=dev)
        x = torch.randn((2, 24, mix.dim), generator=gen, device=dev)
        expert_mesh = make_mesh("1x1", dev.type, axis_names=("data", "expert"))
        got = moe.moe_ffn(moe.shard_moe_params(moe_params, expert_mesh), x, moe_cfg,
                          mesh=expert_mesh)
        errors["moe_ffn"] = float((got - moe.moe_ffn(moe_params, x, moe_cfg)).abs().max())
        check(errors["moe_ffn"] <= WORLD1_ATOL, f"moe_ffn off by {errors['moe_ffn']}")
        stats["errors"] = errors
        stats["train"] = world1_train(torch, dev, mesh, gen, build_sharded_train_step,
                                      init_train_state, leaves, make_optimizer, train_step)
    finally:
        dist.destroy_process_group()
    check(not dist.is_initialized(), "the process group outlived its phase")
    stats["seconds"] = time.monotonic() - t0
    return stats


def world1_train(torch, dev, mesh, gen, build_sharded_train_step, init_train_state, leaves,
                 make_optimizer, train_step) -> dict:
    """Three steps of the sharded step on the 1x1 mesh against
    ``train_step`` from the same llama3-test params and batches."""
    from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS
    from mcp_context_forge_tpu_torch.tpu_local.models.llama import init_params

    cfg, lr = MODEL_CONFIGS["llama3-test"], 1e-4
    start = init_params(cfg, gen, dtype=torch.float32, device=dev)
    step, init_state = build_sharded_train_step(mesh, cfg, lr=lr)
    sharded = init_state(_clone_tree(start))
    plain = init_train_state(_clone_tree(start), make_optimizer(lr))
    near = [torch.zeros_like(p, dtype=torch.bool) for p in leaves(plain.params)]
    losses = []
    for _ in range(3):
        tokens = torch.randint(0, cfg.vocab_size, (4, 65), generator=gen, device=dev)
        batch = (tokens[:, :-1], tokens[:, 1:], torch.ones((4, 64), device=dev))
        sharded, loss = step(sharded, *batch)
        plain, ref = train_step(plain, cfg, *batch)
        losses.append((float(loss), float(ref)))
        for i, (a, b) in enumerate(zip(leaves(sharded.params), leaves(plain.params))):
            delta = float((a.grad - b.grad).abs().max())
            g = b.grad.abs()
            near[i] |= (g != 0) & ((g < 1e-7) | ((g + 1e-8) ** 2 < 1e3 * 1e-8 * delta))
    check(all(abs(a - b) <= 1e-5 * abs(b) for a, b in losses),
          f"sharded vs plain losses {losses}")
    worst, excluded = 0.0, 0
    for a, b, skip in zip(leaves(sharded.params), leaves(plain.params), near):
        err = (a.detach() - b.detach()).abs()[~skip]
        worst = max(worst, float(err.max()) if err.numel() else 0.0)
        excluded += int(skip.sum())
    check(worst <= 1e-2 * lr, f"sharded step parameters off by {worst} (lr {lr})")
    return {"model": cfg.name, "losses": losses, "param_max_err": worst,
            "excluded_near_zero_grad": excluded, "lr": lr}


if __name__ == "__main__":
    if sys.argv[1:2] == ["--plane-worker"]:
        sys.exit(plane_worker_main(sys.argv[2:]))
    sys.exit(main())
