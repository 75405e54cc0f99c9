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
    counts, bf16_tiers, int8_tiers = tiers_phase(torch, dev)
    emit({"phase": "engine_llama3_8b_tiers", **bf16_tiers})
    emit({"phase": "engine_llama3_8b_int8_kv_tiers", **int8_tiers})
    count(counts)
    free_device(torch)
    counts, stats = pool_phase(torch, dev, "llama3-8b", "bfloat16", engine_reference, ATTENTION,
                               NOT_BF16 + INT8_WRITERS + ("paged_chunk_attention_tc_q8",
                                                          "paged_decode_attention_q8"))
    for events in stats["replay_device_events"]:
        check(events["device_events"] == DECODE_REPLAY_EVENTS,
              f"one fed decode dispatch of a replica ran {events['device_events']} device "
              f"events, not {DECODE_REPLAY_EVENTS}")
    emit({"phase": "engine_llama3_8b_pool", **stats})
    count(counts)
    free_device(torch)
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
    calls = dict.fromkeys(("decode", "prefill", "history", "quant_store"), 0)

    def counted(kind, fn):
        def wrapped(*args, **kwargs):
            calls[kind] += 1
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
            await engine.stop()

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
        after_result = after(engine) if after is not None else None
        eager = graph_against_eager(torch, engine) if graph_check else None
        verify = verify_against_eager(torch, engine) if spec else None
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
        "span writer": (("kv_quant_store_span",), layers * (served_calls["prefill"] + history_prefills)
                        if engine.config.kv_quant else 0),
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
RUN_DETAIL = ("streams", "launches", "hit_launches")


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


def tier_run(torch, engine, mode: str) -> dict:
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
    is reset when the engine starts and read when the chats end."""
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
    real_spill, real_restore = client.spill, client.restore

    def spill(key_hash, parent, chunk, page):
        if key_hash in watch and key_hash not in spilled:
            spilled[key_hash] = pool_page(engine, page)
        return real_spill(key_hash, parent, chunk, page)

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
            await engine.stop()

    served = asyncio.run(run())
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


def tiers_phase(torch, dev, model: str = "llama3-8b") -> tuple[dict, dict, dict]:
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
    the pages spilled, on the card, wherever the round trip is lossless."""
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
    return counts, bf16, int8


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


if __name__ == "__main__":
    sys.exit(main())
