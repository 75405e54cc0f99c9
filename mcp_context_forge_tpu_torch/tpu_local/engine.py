"""Continuous-batching inference engine on PyTorch.

An asyncio front (request queue, per-request token streams) bridged to a
**dispatch thread** that owns every device call, so prefill and decode never
stall the caller's event loop; tokens hop back with one
``call_soon_threadsafe`` per step.

- Admission (``_admit_batch``): priority, then FIFO; requests that share a
  prefill bucket and a prefix-cache posture (hit or cold) prefill together,
  up to ``prefill_max_batch`` rows padded to the bucket, in one call. A hit
  row prefills only its suffix, through the paged chunk kernel; the first
  token is sampled on the device.
- Chunked prefill (``_chunk_round``): a prompt longer than every bucket
  (but within ``max_seq_len - 1``) is admitted to ``_chunking`` and
  prefills one bucket-sized chunk per loop iteration through the history
  path, each chunk attending over the pages the earlier ones wrote. Rows
  carry absolute positions, so long prompts at different offsets share
  one round of up to ``prefill_max_batch`` rows. Decode never touches a
  chunking slot.
- Decode runs the JAX engine's machinery: each dispatch is one K-step
  SUPER-STEP (``superstep``; ``_decode_and_sample``) over fixed-width
  columns (slot = column) with per-row token budgets and an EOS/stop
  table, so a finished row freezes inside the dispatch; the host syncs
  once per K tokens. With ``decode_overlap`` (the default) dispatches run
  as a depth-2 pipeline: dispatch N+1 takes its input tokens from N's
  on-device output while N's tokens are read back and emitted, with drain
  barriers (admission, chunk rounds, stale feeds, page pressure, width
  changes, stop) that keep greedy streams identical to the serial order.
  ``batch_buckets`` sizes the columns by the active slot ceiling (powers
  of two, slot compaction, shrink hysteresis).
- Speculative decoding (``spec_decode``): prompt-lookup drafting
  (``_draft_tokens``: the most recent earlier occurrence of the context's
  trailing ``spec_ngram`` tokens proposes up to ``spec_k - 1`` more), and
  one [B, ``spec_k``] verify per step through the history path, sampling
  at every position (``_spec_step_all``): drafts are accepted while they
  agree with the model's own tokens, so a greedy row emits 1 to ``spec_k``
  tokens per dispatch and its stream equals plain decoding's. Sampled rows
  ride the verify one token at a time; a step where no row would draft
  runs the plain decode dispatch. The overlapped pipeline is off.
- On the card every decode and verify dispatch is one replay of a CUDA
  graph (``decode_graphs.py``), one per (kind, K, width, greedy-only or
  sampling), all captured when the engine is built; inputs are staged in
  pinned host memory and uploaded without blocking, outputs read back
  behind an event. On the CPU the same dispatches run eagerly.
- Spill tiers (``prefix_tiers``; ``kv/tiers.py``): an evicted prefix
  page's bytes go to host RAM (page-locked on the card), then disk, then
  an object store, instead of being lost; a later prompt that shares the
  prefix restores them into a pool page at admission (fetch-on-miss) and
  prefills only its suffix. The device side (``_read_page_payload``,
  ``_upload_page``) is plain tensor ops on the pool, written in place.
- There are no context-width buckets (the JAX engine's ``_ctx_bucket_for``
  and ``_hist_ctx_for``, which bounded XLA's static gather): the attention
  kernels walk only the pages each row uses.

- Operability and observability, as in the JAX engine: serving knobs
  (``request_knobs``: K along the captured ``k_ladder`` rungs, spec decode
  on and off, a decode width floor) that land at the dispatch thread's
  next drain barrier; the step ring (``recent_steps``), dispatch-gap and
  idle share, health reads (``heartbeat_age``, ``dispatch_alive``,
  ``kill``); sampled phase attribution (``step_sample_every``: every Nth
  decode dispatch runs serially, its device time bracketed by two CUDA
  events); a live roofline (``roofline.step_cost`` over each decode or
  verify step's own wall: ``roofline_snapshot``); kernel-build and graph-
  capture tracking by lifecycle stage (``compile_stats``); crash restart
  (``auto_restart``) that resets the KV pool in place, since the graphs
  hold its addresses; the ``engine.dispatch`` fault point
  (``observability/faults.py``) at the top of every loop iteration, which
  an armed error rule turns into a crash of that path; and duck-typed
  telemetry handles (``tracer``,
  ``metrics``, ``signals``, ``ledger``), each site one attribute check
  when its handle is None.
- The seams a replica pool (``pool/``) calls: ``warmed`` (true once the
  graphs are captured, at construction), ``kill``, the health reads,
  ``request_cancel``, and ``request_chain_export`` (a migration's copy of
  a prompt's KV chain into the shared tiers, landed at the loop's knob
  barrier with the pipeline drained); ``probe_devices`` finds the devices
  a pool places its replicas on.

- Multi-rank serving (``mesh_shape`` "DxM"): M-way Megatron tensor
  parallelism over the ``model`` axis and D data replicas, which compute
  the same thing (the JAX engine's data axis shards no state either). One
  process per device (``ranks.py``, which has no JAX counterpart): this
  engine is rank 0, whose scheduler drives every rank; the followers it
  starts build the same weights shard (``parallel/sharding.py``'s rules,
  cut on the host or drawn leaf by leaf, so that no device holds the whole
  tree), KV shard (the pages' kv-head dim over ``model`` when it splits,
  ``kv_pages_spec``, else replicated) and decode graphs (with the
  collectives inside), and run each device call rank 0 announces. Rank 0
  alone holds the page allocator; each call carries the block-table rows
  it changed. Every rank samples, and rank 0's tokens are broadcast inside
  the step, so every rank writes the KV of the same tokens. Prefill buckets
  above ``sp_threshold`` run their attention sequence-parallel
  (``sp_impl`` ring or Ulysses) over the ``model`` axis. The roofline
  divides by the world's peak. The spill tiers and a migration's
  ``request_chain_export`` work over ranks: a page's spill and restore
  are announced device calls (``_op_read_page``, ``_op_upload_page``)
  whose shards cross on the data plane, so the store holds whole pages,
  the same bytes at any mesh. The groups are the engine's own
  (``ranks.py``): one process can hold several multi-rank engines.

Prefill, chunk rounds and prefix hits run eagerly. The engine runs on
``config.device`` ("cuda" by default) and raises at construction when
that device is absent; it never moves to the CPU by itself. Weights come
from ``checkpoint`` (an HF safetensors directory or the port's own saved
tree, ``checkpoint.py``), with its ``tokenizer.json`` when it has one, or
are drawn from ``seed``. ``quant="int8"`` serves int8 weights; ``kv_quant="int8"`` stores the KV
pool as int8 pages with per-page scales (``num_pages`` is then a byte
budget counted in compute-dtype pages, which holds about twice as many
int8 pages: ``num_kv_pages``). MoE models (Mixtral) pick their FFN
formulation with ``moe_impl`` and ``moe_block``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import math
import queue
import threading
import time
from collections import deque
from contextlib import nullcontext
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, AsyncIterator

import numpy as np
import torch
import torch.distributed as dist

from ..observability import trace_extra
from ..observability.faults import fault_point
from ..utils import new_id
from .checkpoint import load_params
from .compile_events import CompileTracker, restore_thread, track_thread
from .decode_graphs import (BUDGETS, POSITIONS, SEQ_LENS, STOP_TBL_WIDTH, STOPS,
                            TEMPERATURE, TOKENS, TOP_K, TOP_P, V_TEMPERATURE,
                            V_TOKENS, V_TOP_K, V_TOP_P, DecodeBuffers,
                            DecodeGraphs, GraphKey)
from .kv import (PageAllocator, SpilledPage, TierClient, TieredPageStore,
                 init_kv_state, kv_page_bytes, num_pages_for_budget)
from .kv.fabric import object_store_or_none
from .models import MODEL_CONFIGS, LlamaConfig
from .models.llama import (decode_step, init_params, params_logical, prefill,
                           prefill_with_history, serving_layout)
from .parallel.collectives import broadcast_
from .parallel.mesh import mesh_shape_from_string, parse_mesh_shape
from .parallel.sharding import kv_pages_spec, shard_leaf
from .quantize import (is_quant, kv_dequantize, kv_quantize, map_tree,
                       quantize_logical)
from .ranks import RankGroup, group_timeout
from .roofline import (H100_HBM_GBPS, H100_PEAK_BF16_TFLOPS, CostEntry,
                       CostRegistry, roofline_fractions, step_cost)
from .sampling import SamplingParams, sample_tokens
from .tokenizer import load_tokenizer

logger = logging.getLogger(__name__)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# smoothing of the tokens-per-dispatch EWMA (gauge twin and signal)
_TPD_EWMA_ALPHA = 0.2


@dataclass
class EngineConfig:
    model: str = "llama3-tiny"
    # weights to serve: an HF safetensors directory or the port's own
    # saved tree (checkpoint.py); "" = seeded random weights
    checkpoint: str = ""
    max_batch: int = 8              # decode slots
    max_seq_len: int = 2048
    page_size: int = 128
    num_pages: int = 512
    prefill_buckets: tuple[int, ...] = (128, 512, 2048)
    prefill_max_batch: int = 4      # admissions fused into one prefill call
    # the device mesh "DxM": M-way tensor parallelism over the model axis
    # and D data replicas; "" = (1, every device the engine is given: a
    # standalone CUDA engine takes every visible card). One process per
    # device (ranks.py). A world of one device runs in this process with
    # no process group, unless mesh_shape is given ("1x1" runs the rank
    # path on a one-rank group) or sp_impl is set
    mesh_shape: str = ""
    dtype: str = "bfloat16"
    max_queue: int = 1024
    # sequence-parallel long prefill: prompts in buckets above sp_threshold
    # tokens run their attention as ring or Ulysses over the mesh's model
    # axis (none|ring|ulysses)
    sp_impl: str = "none"
    sp_threshold: int = 1024
    # prefix cache: reuse resident KV pages for shared full-page prompt
    # prefixes; only each request's suffix pays prefill
    prefix_cache: bool = True
    # tiered prefix cache (kv/tiers.py): evicted prefix pages SPILL to a
    # bounded host-RAM store (page-locked on the card) with a disk write-
    # behind tier below it (and an object store below that, with
    # tier_object_url), and admission restores tier-resident chain pages
    # into the pool on a match (fetch-on-miss). Requires prefix_cache.
    prefix_tiers: bool = False
    tier_host_bytes: int = 256 * 1024 * 1024   # T1 (host RAM) byte budget
    tier_disk_bytes: int = 1024 * 1024 * 1024  # T2 (disk) byte budget; 0 = off
    tier_disk_dir: str = ""                    # "" = a private temporary directory
    # spill storage of a full-precision pool: "int8" (the default)
    # quantizes on spill, one scale per (layer, KV head): restored pages
    # carry the same small greedy drift as resident int8 KV; "" spills an
    # f32 container, lossless for bf16 and f32 pools. An int8 pool always
    # spills its bytes and scales as they are (a bit-exact round trip).
    tier_spill_quant: str = "int8"
    # disk and object I/O: transient errors retry this many times with
    # jittered backoff, then the entry drops to a clean miss
    tier_io_retry_max: int = 2
    tier_io_retry_backoff_ms: float = 10.0
    # the T3 object store below disk ("" = none; file://<dir> or
    # gcs://<bucket>[/prefix]); the namespace qualifies every blob key
    tier_object_url: str = ""
    fabric_namespace: str = "shared"
    device: str = "cuda"
    # the watchdog of device discovery (probe_devices) when a pool builds;
    # on the rank path also the groups' rendezvous and collective timeout
    # (a rank that stalls a collective this long fails it; 0 = 30 minutes)
    init_timeout_s: float = 120.0
    seed: int = 0                   # random weights and the sampler
    # weight-only quantization: "" (full precision) or "int8" (quantize.py;
    # random weights quantize as they are drawn, one expert at a time)
    quant: str = ""
    # MoE FFN formulation (models/configs.py moe_impl): dense | grouped |
    # grouped_pallas; moe_block overrides the kernel row-block AND the
    # T*k >= E*block gate. "" / 0 keep the model config's.
    moe_impl: str = ""
    moe_block: int = 0
    # KV pool storage: "" (the compute dtype) or "int8" (int8 pages with
    # per-(layer, page, kv-head) scales); under int8, num_pages is a byte
    # budget in compute-dtype pages
    kv_quant: str = ""
    # decode iterations fused per dispatch (the K of a super-step): the
    # host syncs once per K tokens; tokens past a row's end inside a
    # super-step are masked on the device
    superstep: int = 1
    # depth-2 overlapped decode pipeline: dispatch N+1 is fed by N's
    # on-device sampled tokens while N's results are read back and emitted
    decode_overlap: bool = True
    # decode width buckets: size a dispatch by the active slot ceiling
    # (powers of two from 8, slot compaction) instead of max_batch; a
    # width shrinks only after batch_shrink_steps narrower dispatches, and
    # resets at an admission after batch_idle_reset_s fully idle
    batch_buckets: bool = False
    batch_shrink_steps: int = 64
    batch_idle_reset_s: float = 2.0
    # speculative decoding by prompt lookup: a verify of spec_k tokens per
    # row (the last token and up to spec_k - 1 drafts found by matching the
    # context's trailing spec_ngram tokens earlier in it); exclusive with
    # superstep > 1
    spec_decode: bool = False
    spec_k: int = 4
    spec_ngram: int = 2
    # identity within a pool of engines: labels metrics and spans ("0"
    # for a standalone engine)
    replica_id: str = "0"
    # the legacy alias of superstep (setting both to different values is
    # refused)
    decode_block: int = 1
    # crash recovery: a crashed dispatch thread resets the KV pool in
    # place, re-queues the requests that have emitted nothing, fails the
    # ones mid-stream and restarts, at most auto_restart_max times
    auto_restart: bool = False
    auto_restart_max: int = 3
    # the step ring: one summary per dispatch (kind, batch, width,
    # duration, tokens), the last step_log_size kept
    step_log_size: int = 256
    # phase attribution: every Nth decode dispatch runs serially and
    # splits its wall into host dispatch / table sync / device compute /
    # read back / emission (0 = off, the default: no extra sync)
    step_sample_every: int = 0
    # the live roofline: each decode or verify step's FLOPs and bytes
    # (roofline.step_cost) over its wall, against these peaks
    cost_analysis: bool = True
    peak_tflops_per_chip: float = H100_PEAK_BF16_TFLOPS
    hbm_gbps_per_chip: float = H100_HBM_GBPS
    # extra super-step rungs captured beside fused_steps, so that
    # request_knobs can move K at a drain barrier onto graphs that exist
    # (() = none: exactly the graphs of the static K)
    k_ladder: tuple[int, ...] = ()

    @property
    def fused_steps(self) -> int:
        """Decode iterations per dispatch: superstep when set, else the
        legacy decode_block."""
        return self.superstep if self.superstep > 1 else self.decode_block

    def k_rungs(self) -> tuple[int, ...]:
        """The super-step values the decode graphs are captured for:
        fused_steps and every ladder rung, ascending."""
        rungs = {self.fused_steps}
        rungs.update(int(k) for k in self.k_ladder if int(k) >= 1)
        return tuple(sorted(rungs))

    @classmethod
    def from_settings(cls, settings) -> "EngineConfig":
        """The config from the gateway's ``tpu_local_*`` settings (duck-
        typed), with the JAX engine's fallbacks for absent fields. Settings
        of what the port does not have (warm-up modes, the compile cache)
        are not read, and neither are the roofline peaks, whose settings
        describe a TPU chip: the port keeps the H100's. ``device`` and
        ``seed`` keep their defaults."""
        return cls(
            model=settings.tpu_local_model,
            checkpoint=settings.tpu_local_checkpoint,
            max_batch=settings.tpu_local_max_batch,
            max_seq_len=settings.tpu_local_max_seq_len,
            page_size=settings.tpu_local_page_size,
            num_pages=settings.tpu_local_num_pages,
            prefill_buckets=tuple(settings.tpu_local_prefill_buckets),
            prefill_max_batch=getattr(settings, "tpu_local_prefill_max_batch", 4),
            mesh_shape=getattr(settings, "tpu_local_mesh_shape", ""),
            dtype=settings.tpu_local_dtype,
            sp_impl=getattr(settings, "tpu_local_sp_impl", "none"),
            sp_threshold=getattr(settings, "tpu_local_sp_threshold", 1024),
            decode_block=getattr(settings, "tpu_local_decode_block", 1),
            superstep=getattr(settings, "tpu_local_superstep", 1),
            decode_overlap=getattr(settings, "tpu_local_decode_overlap", True),
            prefix_cache=getattr(settings, "tpu_local_prefix_cache", True),
            prefix_tiers=getattr(settings, "tpu_local_prefix_tiers", False),
            tier_host_bytes=getattr(settings, "tpu_local_tier_host_bytes", 256 * 1024 * 1024),
            tier_disk_bytes=getattr(settings, "tpu_local_tier_disk_bytes", 1024 * 1024 * 1024),
            tier_disk_dir=getattr(settings, "tpu_local_tier_disk_dir", ""),
            tier_spill_quant=getattr(settings, "tpu_local_tier_spill_quant", "int8"),
            tier_io_retry_max=getattr(settings, "tier_io_retry_max", 2),
            tier_io_retry_backoff_ms=getattr(settings, "tier_io_retry_backoff_ms", 10.0),
            tier_object_url=getattr(settings, "tpu_local_tier_object_url", ""),
            fabric_namespace=getattr(settings, "tpu_local_fabric_namespace", "shared"),
            init_timeout_s=getattr(settings, "tpu_local_init_timeout_s", 120.0),
            spec_decode=getattr(settings, "tpu_local_spec_decode", False),
            spec_k=getattr(settings, "tpu_local_spec_k", 4),
            spec_ngram=getattr(settings, "tpu_local_spec_ngram", 2),
            quant=getattr(settings, "tpu_local_quant", ""),
            kv_quant=getattr(settings, "tpu_local_kv_quant", ""),
            moe_impl=getattr(settings, "tpu_local_moe_impl", ""),
            batch_buckets=getattr(settings, "tpu_local_batch_buckets", False),
            max_queue=getattr(settings, "tpu_local_max_queue", 1024),
            auto_restart=getattr(settings, "tpu_local_auto_restart", False),
            auto_restart_max=getattr(settings, "tpu_local_auto_restart_max", 3),
            step_log_size=getattr(settings, "tpu_local_step_log_size", 256),
            step_sample_every=getattr(settings, "tpu_local_step_sample_every", 0),
            cost_analysis=getattr(settings, "tpu_local_cost_analysis", True),
            # extra K rungs only when the serving controller is on
            k_ladder=(tuple(getattr(settings, "controller_k_ladder", ()))
                      if getattr(settings, "controller_enabled", False) else ()),
        )


@dataclass
class GenRequest:
    request_id: str
    prompt_ids: list[int]
    max_tokens: int = 128
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    stop_ids: tuple[int, ...] = ()
    # admission class: 0 = interactive, 1 = background; lower admits first
    priority: int = 0
    # unbounded: a bounded queue could drop the end-of-stream sentinel
    stream: asyncio.Queue = field(default_factory=asyncio.Queue)
    created: float = field(default_factory=time.time)
    # filled by the engine
    slot: int = -1
    generated: list[int] = field(default_factory=list)
    finish_reason: str | None = None
    first_token_ts: float = 0.0
    prefill_ms: float = 0.0
    queue_ms: float = 0.0
    # billing identity ("" = unattributed): the ledger's key and the
    # (clamped) tenant label of the latency histograms
    tenant: str = ""
    # (trace_id, span_id) of the submitter's llm.request span: the parent
    # of the engine's llm.queue / llm.prefill / llm.decode spans
    trace_ctx: tuple[str, str] | None = None
    # once-only guards: a request re-queued by crash recovery passes
    # admission twice, and must not observe its queue wait or TTFT twice
    queue_observed: bool = False
    ttft_observed: bool = False
    # prefix-cache admission state: probed cached-history length and the
    # (suffix) bucket; bucket -1 means not yet probed. ``chunked``: the
    # prompt (or its suffix after ``hist``) exceeds every bucket and
    # prefills in chunk rounds; ``chunk_pos`` counts the tokens prefilled
    chunked: bool = False
    chunk_pos: int = 0
    hist: int = 0
    bucket: int = -1
    # a pool's routing class ("" = classified by prompt length when the
    # pool's replicas carry roles; "prefill", "decode" or a fleet class)
    route_class: str = ""


class EngineStats:
    def __init__(self) -> None:
        self.requests = 0
        self.prompt_tokens = 0
        self.completion_tokens = 0
        self.decode_steps = 0
        self.prefill_batches = 0
        self.prefill_requests = 0
        self.queue_depth = 0
        self.chunking = 0             # long prompts mid-chunk-prefill
        self.prefill_ms_total = 0.0   # host wall of prefill dispatches (synced)
        # decode: dispatch -> outputs read back, summed; under the overlapped
        # pipeline each spans about two dispatches
        self.decode_ms_total = 0.0
        # decode: each dispatch's own wall, retire to retire (dispatch to
        # read back when the card was idle at dispatch)
        self.decode_wall_ms_total = 0.0
        self.decode_dispatches = 0    # host syncs; decode_steps / this = K
        self.overlap_steps = 0        # dispatches fed by device tokens
        self.pipeline_drains = 0      # overlap barriers that forced a drain
        # host time from a read back to the next host-fed dispatch
        self.dispatch_gap_ms_total = 0.0
        self.graph_captures = 0       # graphs captured (at construction)
        self.graph_replays = 0        # decode and verify dispatches run as replays
        self.spec_steps = 0           # speculative verify dispatches
        self.spec_tokens = 0          # tokens emitted beyond one per row and verify
        self.spec_emitted = 0         # tokens emitted by verify dispatches
        self.spec_ms_total = 0.0      # verify dispatch -> read back, summed
        self.engine_restarts = 0      # crash-recovery restarts (auto_restart)
        self.phase_samples = 0        # decode dispatches with phase attribution


def _spill_scale(pages: torch.Tensor) -> torch.Tensor:
    """The f32 scale per (layer, KV head) of an int8 spill of one page
    [L, page, KV, hd]: its max |value| / 127 as the JAX engine's jitted
    ``_tier_read_fn`` computes it, where XLA folds the division by the
    constant into a product by its f32 reciprocal (which differs from
    ``kv_int8_scale``'s true division in the last bit for some maxima)."""
    amax = pages.float().abs().amax(dim=(1, 3))
    return amax * torch.full_like(amax, 1.0 / 127.0)


def _pack(parts: tuple[torch.Tensor, ...]) -> torch.Tensor:
    """A page's parts as one flat byte tensor (one transfer on the data
    plane)."""
    return torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in parts])


def _nbytes(shape: tuple[int, ...], dtype: torch.dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def _unpack(flat: torch.Tensor, layout: list[tuple[tuple[int, ...], torch.dtype]]
            ) -> list[torch.Tensor]:
    """The inverse of ``_pack`` for parts of ``layout``'s shapes and dtypes
    (views of ``flat``)."""
    parts, at = [], 0
    for shape, dtype in layout:
        n = _nbytes(shape, dtype)
        parts.append(flat[at:at + n].view(dtype).reshape(shape))
        at += n
    return parts


def _join_heads(pieces: list[list[torch.Tensor]]) -> tuple[torch.Tensor, ...]:
    """A page's parts from the shards of ``model`` ranks 0.. in order: each
    rank holds a contiguous block of KV heads (the pages' dim 2, the
    scales' dim 1)."""
    return tuple(torch.cat([p[i] for p in pieces], dim=2 if i < 2 else 1)
                 for i in range(4))


def _rank_heads(parts: list[torch.Tensor], offset: int, n: int) -> tuple[torch.Tensor, ...]:
    """The ``n`` KV heads from ``offset`` of a whole page's parts: what one
    rank's pool holds of it."""
    return tuple(t[:, :, offset:offset + n] if i < 2 else t[:, offset:offset + n]
                 for i, t in enumerate(parts))


class EngineInitTimeout(RuntimeError):
    """Device discovery exceeded the watchdog budget (a hung driver)."""


def probe_devices(timeout_s: float, device: str = "cuda") -> list[torch.device]:
    """The devices an engine of ``device``'s type could take, found under a
    watchdog: a hung CUDA driver blocks context creation indefinitely, so
    the probe runs on a daemon thread and a hang becomes an exception
    instead of a gateway that never binds its port. A CPU engine's list is
    ``[cpu]``; a CUDA one's is every visible card, and raises when there
    is none (the engine never moves to the CPU by itself)."""
    if torch.device(device).type == "cpu":
        return [torch.device("cpu")]

    def _probe() -> list[torch.device]:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run the plain PyTorch path explicitly")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]

    if timeout_s <= 0:
        return _probe()
    result: dict[str, Any] = {}

    def _run() -> None:
        try:
            result["devices"] = _probe()
        except Exception as exc:  # surfaced on the caller's thread
            result["error"] = exc

    thread = threading.Thread(target=_run, name="cuda-init-probe", daemon=True)
    thread.start()
    thread.join(timeout_s)
    if thread.is_alive():
        raise EngineInitTimeout(
            f"CUDA device discovery did not complete within {timeout_s:.0f}s "
            "(set MCPFORGE_TPU_LOCAL_ENABLED=false to serve without the "
            "engine, or raise MCPFORGE_TPU_LOCAL_INIT_TIMEOUT_S)")
    if "error" in result:
        raise result["error"]
    return result["devices"]


def _resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("EngineConfig.device is 'cuda' but CUDA is not "
                           "available; pass device='cpu' to run the plain "
                           "PyTorch path explicitly")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _to(tree: Any, device: torch.device) -> Any:
    """A param tree's leaves on ``device``."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _shard_tree(params: Any, logical: Any, sizes: dict[str, int],
                coords: dict[str, int]) -> Any:
    """The blocks of a whole tree (full precision or int8 leaves) that the
    rank at ``coords`` holds, cut where the leaves lie."""
    return map_tree(lambda leaf, name: shard_leaf(
        leaf, quantize_logical(name) if is_quant(leaf) else name, sizes, coords),
        params, logical)


def engine_devices(config: EngineConfig, devices: list | None = None) -> list[torch.device]:
    """The devices an engine of ``config`` serves on, one rank each:
    ``devices`` when given (a pool's replica subset); on the CPU, as many
    as an explicit ``mesh_shape`` names (else one); a CUDA device with an
    index, that one; else every visible card (``probe_devices``), as the
    JAX engine takes every chip."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    device = torch.device(config.device)
    if device.type == "cpu":
        data, model = parse_mesh_shape(config.mesh_shape) if config.mesh_shape else (1, 1)
        return [device] * (data * model)
    if device.type == "cuda" and device.index is None:
        return probe_devices(config.init_timeout_s)
    return [device]


class TorchEngine:
    """Owns params + the KV pool on one device; device work runs on the
    dispatch thread, token emission hops back to the asyncio loop.

    ``params``: a parameter tree to serve as given, full precision or
    already quantized (e.g. from ``models.convert.params_from_jax``);
    else ``config.checkpoint`` is loaded (quantized on the way in when
    ``config.quant``), else seeded random weights are drawn, quantized
    when ``config.quant``.
    ``tracer``, ``metrics``, ``signals`` and ``ledger`` are optional
    telemetry handles, duck-typed as the JAX engine's (``tracer.emit_span``,
    the ``llm_*`` metric families, ``signals.publish(name, value,
    replica)``, ``ledger.add(tenant, **counts)``); None costs one attribute
    check per site.
    ``tier_store`` and ``prefix_index``: a spill store and a prefix index
    shared with other engines (a pool's); without them an engine with
    ``prefix_tiers`` owns a private store, which ``stop`` closes.
    ``devices``: the devices to serve on, one rank each (``engine_devices``
    by default); more than one, an explicit ``mesh_shape`` or an
    ``sp_impl`` makes this engine rank 0 of a multi-rank group
    (``ranks.py``). ``params`` may then be a whole tree, whose blocks rank
    0 cuts on the host and sends. ``_rank``: a follower's (rank, port,
    mesh shape, how it gets its weights), set by ``ranks.follower_main``."""

    def __init__(self, config: EngineConfig,
                 params: dict[str, Any] | None = None, tracer=None,
                 metrics=None, signals=None, ledger=None,
                 tier_store: TieredPageStore | None = None, prefix_index=None,
                 devices: list | None = None, _rank: tuple | None = None):
        self.tracer = tracer
        self.metrics = metrics
        self.signals = signals
        self.ledger = ledger
        self.config = config
        self.devices = engine_devices(config, devices)
        data, model = mesh_shape_from_string(config.mesh_shape, len(self.devices))
        self.world = data * model
        rank = 0 if _rank is None else _rank[0]
        self.device = _resolve_device(str(self.devices[rank]))
        # the rank path: a process group over the world, this engine its rank
        self._ranks: RankGroup | None = None
        self._mesh = None
        rank_path = (_rank is not None or self.world > 1 or bool(config.mesh_shape)
                     or config.sp_impl != "none")
        self._params_mode = None if _rank is None else _rank[3]
        if config.sp_impl not in ("none", "ring", "ulysses"):
            raise ValueError(f"sp_impl must be none|ring|ulysses, got {config.sp_impl!r}")
        if config.sp_impl != "none":
            # the sequence (bucket) must divide the axis; refused here, not
            # on the first long prefill
            bad = [b for b in config.prefill_buckets
                   if b > config.sp_threshold and b % model != 0]
            if bad:
                raise ValueError(
                    f"sp_impl={config.sp_impl!r}: prefill buckets {bad} not"
                    f" divisible by mesh model axis {model}")
        if config.dtype not in _DTYPES:
            raise ValueError(f"unsupported dtype {config.dtype!r}")
        self.dtype = _DTYPES[config.dtype]
        if config.quant not in ("", "int8"):
            raise ValueError(f"unsupported quant mode {config.quant!r}")
        if config.kv_quant not in ("", "int8"):
            raise ValueError(f"unsupported kv_quant mode {config.kv_quant!r}")
        if config.decode_block < 1:
            raise ValueError(f"decode_block must be >= 1, got {config.decode_block}")
        if config.superstep < 1:
            raise ValueError(f"superstep must be >= 1, got {config.superstep}")
        if (config.superstep > 1 and config.decode_block > 1
                and config.superstep != config.decode_block):
            raise ValueError(
                f"superstep={config.superstep} and decode_block="
                f"{config.decode_block} disagree: set only one "
                "(decode_block is the legacy alias)")
        if config.spec_decode and config.fused_steps > 1:
            raise ValueError("spec_decode and superstep/decode_block>1 are "
                             "mutually exclusive (both widen the "
                             "per-dispatch step)")
        if config.spec_decode and any(int(k) > 1 for k in config.k_ladder):
            raise ValueError("k_ladder rungs > 1 are mutually exclusive "
                             "with spec_decode (as superstep > 1 is)")
        if config.spec_decode and config.spec_k < 2:
            raise ValueError(f"spec_k must be >= 2, got {config.spec_k}")
        if config.spec_decode and config.spec_ngram < 1:
            raise ValueError(f"spec_ngram must be >= 1, got {config.spec_ngram}")
        if config.checkpoint and params is not None:
            raise ValueError("pass either params or config.checkpoint, not both")
        if config.moe_impl not in ("", "dense", "grouped", "grouped_pallas"):
            # a typo must not silently serve the dense path
            raise ValueError(
                f"moe_impl must be dense|grouped|grouped_pallas, "
                f"got {config.moe_impl!r}")
        if config.prefix_tiers and not config.prefix_cache:
            raise ValueError("prefix_tiers requires prefix_cache (the tiers "
                             "spill and restore prefix-cache pages)")
        if config.tier_spill_quant not in ("", "int8"):
            raise ValueError(f"unsupported tier_spill_quant mode "
                             f"{config.tier_spill_quant!r}")
        # the tiered prefix cache: bind to a shared store and index when
        # given, else own a private store. A client with only an index
        # still publishes resident pages (a router's affinity). Rank 0's
        # alone: a follower runs the page I/O rank 0 announces
        self._owned_tier_store: TieredPageStore | None = None
        self._tier_client: TierClient | None = None
        if _rank is None and config.prefix_cache and (
                config.prefix_tiers or prefix_index is not None or tier_store is not None):
            store = tier_store
            if store is None and config.prefix_tiers:
                store = TieredPageStore(
                    host_bytes=config.tier_host_bytes, disk_bytes=config.tier_disk_bytes,
                    disk_dir=config.tier_disk_dir, index=prefix_index, metrics=metrics,
                    device=self.device, io_retry_max=config.tier_io_retry_max,
                    io_retry_backoff_ms=config.tier_io_retry_backoff_ms,
                    object_store=object_store_or_none(config.tier_object_url),
                    object_namespace=config.fabric_namespace)
                self._owned_tier_store = store
            self._tier_client = TierClient(config.replica_id, store=store,
                                           index=prefix_index, metrics=metrics,
                                           tracer=tracer)
        # the tier hit counts already exported (dispatch thread)
        self._tier_hits_exported: dict[str, int] = {}
        self.model_config: LlamaConfig = MODEL_CONFIGS[config.model]
        overrides: dict[str, Any] = {}
        if config.moe_impl:
            overrides["moe_impl"] = config.moe_impl
        if config.moe_block:
            overrides["moe_block"] = config.moe_block
        if overrides:
            self.model_config = dataclasses.replace(self.model_config,
                                                    **overrides)
        if rank_path:
            # heads that do not split raise here, before any process starts
            serving_layout(self.model_config, model, 0)
            if _rank is None:
                mode = ("checkpoint" if config.checkpoint else
                        "shipped" if params is not None else "seed")
                self._ranks = RankGroup.lead(config, self.model_config, self.devices, mode)
            else:
                self._ranks = RankGroup.follow(rank, self.world, _rank[2], _rank[1],
                                               self.device, group_timeout(config))
            self._mesh = self._ranks.mesh
        self.tokenizer = load_tokenizer(config.checkpoint,
                                        vocab_size=self.model_config.vocab_size)
        self.stats = EngineStats()
        # the step ring (the asyncio side only copies it: recent_steps)
        self.step_log: deque[dict[str, Any]] = deque(
            maxlen=max(1, config.step_log_size))
        self._step_seq = 0
        # dispatch gaps: (gap_s, step_wall_s) per decode step
        self._gap_window: deque[tuple[float, float]] = deque(maxlen=256)
        # phase attribution and the live roofline: the dispatch count sets
        # the sampling cadence, phase rows ride llm.decode spans as events,
        # the roofline window backs roofline_snapshot()
        self._dispatch_count = 0
        self._phase_events: deque[tuple[float, dict[str, float]]] = deque(maxlen=64)
        self._roofline_window: deque[tuple[float, float, float]] = deque(maxlen=256)
        self.cost_registry = CostRegistry()
        self._tpd_ewma: float | None = None
        self._signals_slow_ts = 0.0
        # kernel builds and graph captures: the construction's are
        # "warmup", the dispatch thread's "serving" (on a built card, a
        # serving event stalls traffic and is a fault)
        self.compile_tracker = CompileTracker(self._on_kernel_event)
        token = track_thread(self.compile_tracker, "warmup")
        try:
            self._build_device_state(params)
            if self._ranks is not None:
                self._ranks.ready()
            if self._tier_client is not None and self._tier_client.store is not None:
                # one spill and one restore of the trash page (zeros either
                # way), so the first of each while serving is steady state;
                # on the rank path once every rank is built, as announced calls
                self._upload_page(0, self._read_page_payload(0))
        except BaseException:
            if self._ranks is not None:
                self._ranks.abort()
            raise
        finally:
            restore_thread(token)
        self._work: queue.Queue[GenRequest] = queue.Queue(maxsize=config.max_queue)
        self._pending: deque[GenRequest] = deque()   # dispatch thread only
        self._running: dict[int, GenRequest] = {}    # slot -> request
        self._chunking: dict[int, GenRequest] = {}   # slot -> mid-chunk-prefill
        self._emit_buf: list[list[Any]] = []
        self._cancels: set[str] = set()
        self._cancel_lock = threading.Lock()
        # serving knobs: callers stage validated moves under the lock; the
        # dispatch thread lands them at the top of its next iteration,
        # draining the pipeline first when K changes
        self._pending_knobs: dict[str, Any] = {}
        self._knob_lock = threading.Lock()
        # a pool's chain exports (the prefill -> decode migration), staged
        # the same way and landed at the same barrier
        self._pending_exports: list[tuple[tuple[int, ...], Future]] = []
        self._export_lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stop_event = threading.Event()
        self._wake = threading.Event()
        self._loop: asyncio.AbstractEventLoop | None = None
        self._started = False
        self._killed = False
        # the dispatch loop crashed for good (no restart): set before the
        # outstanding streams end, so that a pool reading their "error"
        # terminals sees the replica dead and never routes work back to it
        self._dead = False
        # liveness: bumped once per dispatch-loop iteration (the idle wait
        # is bounded at 50 ms, so a healthy loop beats at >= 20 Hz)
        self._heartbeat_ts = time.monotonic()
        # a multi-rank engine's digests of the tokens each rank wrote, in
        # rank order, once stop() ended the group (equal on every rank)
        self.rank_digests: list[int] | None = None
        # stop(keep_group=True): the group outlives the dispatch thread
        self._keep_group = False

    def _build_device_state(self, params: dict[str, Any] | None) -> None:
        """Params, the KV pool and the decode graphs of every (kind, K
        rung, width, greedy-only or sampling): the construction's device
        work, attributed to the "warmup" stage."""
        config = self.config
        self.params = self._place_params(params)
        max_pages_per_slot = config.max_seq_len // config.page_size
        self.num_kv_pages = config.num_pages
        if config.kv_quant:
            budget = config.num_pages * kv_page_bytes(
                self.model_config, config.page_size, self.dtype)
            self.num_kv_pages = num_pages_for_budget(
                self.model_config, config.page_size, budget, self.dtype,
                config.kv_quant)
        # bytes one page costs in the pool's storage (the KV byte gauges)
        self._kv_page_bytes = kv_page_bytes(self.model_config, config.page_size,
                                            self.dtype, config.kv_quant)
        kv_heads = self.model_config.n_kv_heads
        # the pool's KV heads: this rank's shard from _kv_head_offset on
        # (and of their int8 scales, kv_scales_spec), or all of them
        self._kv_sharded = self._mesh is not None and bool(kv_pages_spec(self._mesh, kv_heads))
        self._kv_head_offset = 0
        if self._kv_sharded:
            kv_heads //= self._ranks.shape[1]
            self._kv_head_offset = self._mesh.get_local_rank("model") * kv_heads
        self.kv = init_kv_state(self.model_config, self.num_kv_pages,
                                config.page_size, config.max_batch,
                                max_pages_per_slot, dtype=self.dtype,
                                device=self.device, quant=config.kv_quant,
                                kv_heads=kv_heads)
        # a multi-rank engine's hash of the tokens each rank wrote
        self._digest = (torch.zeros((), dtype=torch.int64, device=self.device)
                        if self.world > 1 else None)
        self._table_rows: dict[int, np.ndarray] = {}
        if self._tier_client is not None:
            # a new pool holds none of the pages a shared index may still
            # place on this replica id (a pool's reload rebuilds the
            # engine): stale locations would mis-route
            self._tier_client.drop_replica()
        self.allocator = self._new_allocator()
        if self._tier_client is not None and self._tier_client.store is not None:
            self._tier_client.read_fn = self._read_page_payload
            self._tier_client.write_fn = self._upload_page
        self._sample_gen = torch.Generator(device=self.device)
        self._sample_gen.manual_seed(config.seed + 1)
        # decode machinery (dispatch thread only after start)
        self._k = config.fused_steps
        self._inflight: dict[str, Any] | None = None
        self._last_step_done_ts: float | None = None
        # every width is captured at construction, so the width starts at
        # max (the JAX engine's warmed posture) and may shrink to any bucket
        self._batch_width = config.max_batch
        self._shrink_streak = 0
        self._shrink_peak = 0
        self._last_active_ts = time.monotonic()
        # speculative verify steps run while this holds (request_knobs
        # spec_enabled); engines built without spec_decode ignore it
        self._spec_enabled = True
        # a decode width floor (request_knobs width_floor; 0 = none)
        self._width_floor = 0
        widths = self._batch_buckets() if config.batch_buckets else [config.max_batch]
        rungs = config.k_rungs()
        keys = [GraphKey("decode", k, B, sampled) for k in rungs for B in widths
                for sampled in (False, True)]
        if config.spec_decode:
            keys += [GraphKey("verify", config.spec_k, config.max_batch, sampled)
                     for sampled in (False, True)]
        self._graphs = DecodeGraphs(
            self._graph_body, keys, self.device, self.model_config.vocab_size,
            self._sample_gen)
        self.stats.graph_captures = self._graphs.captures
        # what exists to move to: a K or a width floor with no graph is
        # refused by request_knobs, never captured while serving
        self._warmed_k: set[int] = set(rungs)
        self._warmed_widths: set[int] = set(widths)

    def _place_params(self, params: dict[str, Any] | None) -> dict[str, Any]:
        """This engine's weights: ``params`` as given, else the checkpoint,
        else drawn from ``seed``. On the rank path each rank keeps only its
        block of every leaf: a checkpoint's leaves are cut as they are read,
        seeded leaves as they are drawn (every rank draws the whole tree,
        one leaf at a time), and a given tree is cut on rank 0, which sends
        every follower its blocks."""
        config = self.config
        place = None
        if self._ranks is not None:
            sizes, coords = self._ranks.coords

            def place(leaf: Any, name: Any) -> Any:
                return shard_leaf(leaf, name, sizes, coords)

        if config.checkpoint:
            return load_params(config.checkpoint, self.model_config, self.device,
                               self.dtype, quant=config.quant, shard=place)
        if params is None and self._params_mode == "shipped":
            return _to(self._ranks.receive_params(), self.device)
        if params is None:
            init_gen = torch.Generator(device=self.device)
            init_gen.manual_seed(config.seed)
            return init_params(self.model_config, init_gen, self.dtype,
                               self.device, quant=config.quant, place=place)
        if place is None:
            return params
        logical = params_logical(self.model_config)
        model = self._ranks.shape[1]
        for rank in range(1, self.world):
            at = {"data": rank // model, "model": rank % model}
            self._ranks.send_params(_shard_tree(params, logical, sizes, at), rank)
        return _to(_shard_tree(params, logical, sizes, coords), self.device)

    def _new_allocator(self) -> PageAllocator:
        config = self.config
        return PageAllocator(self.num_kv_pages, config.page_size, config.max_batch,
                             config.max_seq_len // config.page_size,
                             tiers=self._tier_client)

    # ------------------------------------------------------- spill tier I/O

    def _to_host(self, tensors: tuple[torch.Tensor, ...]) -> list[np.ndarray]:
        """Copies of device tensors in host memory, as numpy arrays. On the
        card each lands in a page-locked buffer by a non-blocking copy on
        the dispatch thread's stream, behind every replay queued before
        it, and the host waits on one event after the last copy: a page
        leaves the pool before a later device call can give it a new
        tenant, without draining the pipeline."""
        cuda = self.device.type == "cuda"
        out = [torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda) for t in tensors]
        for dst, src in zip(out, tensors):
            dst.copy_(src, non_blocking=cuda)
        self._wait_stream()
        return [t.numpy() for t in out]

    def _wait_stream(self) -> None:
        """On the card, wait for the work queued so far on the dispatch
        thread's stream (one event; other streams run on)."""
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
            done.synchronize()

    def _read_page_payload(self, page: int) -> SpilledPage:
        """Device -> host read of one prefix page for spilling, as the JAX
        engine's ``_tier_read_fn``: an int8 pool's bytes and scales as they
        are (a bit-exact round trip); with ``tier_spill_quant=""`` an f32
        container (lossless for bf16 and f32 pools); else int8 quantized
        on spill with one f32 scale per (layer, KV head) (``_spill_scale``).
        On the rank path an announced device call (``_op_read_page``) that
        gathers the whole page on rank 0: the payload is the one a
        one-device engine spills, whatever the mesh."""
        with torch.inference_mode():
            self._announce("read_page", page=page)
            parts = self._op_read_page(page)
            k, v, k_scales, v_scales = self._to_host(parts)
        return SpilledPage(chunk=(), parent=b"", k=k, v=v, k_scales=k_scales,
                           v_scales=v_scales)

    def _page_parts(self, page: int) -> tuple[torch.Tensor, ...]:
        """(k, v, k_scales, v_scales) of one page of this rank's pool, as
        the spill stores them: k/v [L, page, KV, hd] and scales [L, KV]
        over the pool's heads. Every rule is per (layer, KV head), so a
        shard's parts are exactly the matching heads of the whole page's."""
        kv = self.kv
        k, v = kv.k_pages[:, page], kv.v_pages[:, page]
        if kv.quantized:
            return k, v, kv.k_scales[:, page].float(), kv.v_scales[:, page].float()
        if self.config.tier_spill_quant == "":
            ones = torch.ones((k.shape[0], k.shape[2]), dtype=torch.float32,
                              device=self.device)
            return k.float(), v.float(), ones, ones
        k_scales, v_scales = _spill_scale(k), _spill_scale(v)
        return (kv_quantize(k, k_scales[:, None, :, None]),
                kv_quantize(v, v_scales[:, None, :, None]), k_scales, v_scales)

    def _page_layout(self, kv_heads: int) -> list[tuple[tuple[int, ...], torch.dtype]]:
        """Shapes and dtypes of a page's parts over ``kv_heads`` heads."""
        cfg = self.model_config
        L, page, hd = cfg.n_layers, self.config.page_size, cfg.head_dim
        quant = self.kv.quantized or self.config.tier_spill_quant == "int8"
        pages = ((L, page, kv_heads, hd), torch.int8 if quant else torch.float32)
        scales = ((L, kv_heads), torch.float32)
        return [pages, pages, scales, scales]

    def _op_read_page(self, page: int) -> tuple[torch.Tensor, ...] | None:
        """One page's parts on rank 0 (None on a follower). A sharded pool's
        shards are gathered from the ranks of data row 0 over its ``model``
        group (the data replicas hold the same pages) and joined in head
        order; a replicated pool is read on rank 0 alone."""
        if self._mesh is None or (self._ranks.leader and not self._kv_sharded):
            return self._page_parts(page)
        if not self._kv_sharded or self._mesh.get_local_rank("data") != 0:
            return None
        group = self._mesh.get_group("model")
        flat = _pack(self._page_parts(page))
        out = torch.empty(group.size() * flat.numel(), dtype=torch.uint8,
                          device=self.device)
        dist.all_gather_into_tensor(out, flat, group=group)
        if not self._ranks.leader:
            return None
        layout = self._page_layout(self.kv.k_pages.shape[3])
        return _join_heads([_unpack(piece, layout) for piece in out.chunk(group.size())])

    def _upload_page(self, page: int, payload: SpilledPage) -> None:
        """Host -> device upload of a restored page into this engine's
        pool (fetch-on-miss, inside admission, after its drain barrier):
        the inverse of ``_read_page_payload``, dequantizing an int8 spill
        of a full-precision pool. Written IN PLACE: the decode graphs hold
        the pool's addresses. On the card the host waits for the upload
        (the payload may leave host memory once this returns). On the rank
        path an announced device call (``_op_upload_page``)."""
        cuda = self.device.type == "cuda"
        parts = tuple(torch.from_numpy(np.asarray(a)).to(self.device, non_blocking=cuda)
                      for a in (payload.k, payload.v, payload.k_scales, payload.v_scales))
        with torch.inference_mode():
            self._announce("upload_page", page=page)
            self._op_upload_page(page, parts)
        self._wait_stream()

    def _op_upload_page(self, page: int, parts: tuple[torch.Tensor, ...] | None = None
                        ) -> None:
        """Write one page's parts into this rank's pool: on the rank path
        rank 0 broadcasts the whole page over the world group (every data
        replica is written), and each rank keeps its own heads
        (``_rank_heads``; all of them over a replicated pool)."""
        if self._mesh is not None:
            group = self._mesh.get_group("world")
            layout = self._page_layout(self.model_config.n_kv_heads)
            flat = (_pack(parts) if self._ranks.leader else
                    torch.empty(sum(_nbytes(*part) for part in layout), dtype=torch.uint8,
                                device=self.device))
            dist.broadcast(flat, group=group, group_src=0)
            parts = _rank_heads(_unpack(flat, layout), self._kv_head_offset,
                                self.kv.k_pages.shape[3])
        kv = self.kv
        k, v, k_scales, v_scales = parts
        if kv.quantized:
            kv.k_scales[:, page].copy_(k_scales)
            kv.v_scales[:, page].copy_(v_scales)
        elif self.config.tier_spill_quant == "int8":
            k = kv_dequantize(k, k_scales[:, None, :, None], kv.k_pages.dtype)
            v = kv_dequantize(v, v_scales[:, None, :, None], kv.v_pages.dtype)
        kv.k_pages[:, page].copy_(k)
        kv.v_pages[:, page].copy_(v)

    # ------------------------------------------------------------- lifecycle

    async def start(self) -> None:
        if self._started:
            return
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("previous dispatch thread still running")
        self._started = True
        self._dead = False
        self._loop = asyncio.get_running_loop()
        self._stop_event = threading.Event()
        self._wake = threading.Event()
        self._thread = threading.Thread(target=self._device_loop,
                                        name="torch-engine-dispatch",
                                        daemon=True)
        self._thread.start()

    async def stop(self, *, keep_group: bool = False) -> None:
        """Stop the dispatch thread; a multi-rank engine's followers end
        with it, unless ``keep_group``: then the group stays for calls made
        after the stop (a pool's spill on drain, ``spill_prefix_pages``)
        until ``close_ranks``."""
        self._keep_group = keep_group
        if not self._started:
            if not keep_group:
                self.close_ranks()
            return
        self._started = False
        self._stop_event.set()
        self._wake.set()
        thread = self._thread
        if thread is not None:
            await asyncio.to_thread(thread.join, 30.0)
            if thread.is_alive():
                logger.error("dispatch thread failed to stop within 30s")
                return  # keep self._thread so start() refuses a double start
        self._thread = None
        self._close_owned_tiers()

    def close_ranks(self) -> None:
        """End a multi-rank engine's followers and groups (rank 0; once):
        each rank's digest of the tokens it wrote lands in ``rank_digests``,
        and digests that differ (ranks that diverged) are logged as an
        error. The decode graphs go first (``DecodeGraphs.release``): they
        hold the groups' communicators. While a wedged dispatch thread still
        runs, the group is left to it: it closes it when it exits."""
        thread = self._thread
        if (thread is not None and thread.is_alive()
                and thread is not threading.current_thread()):
            self._keep_group = False
            return
        if self._ranks is not None and self._ranks.leader:
            try:
                with (torch.cuda.device(self.device) if self.device.type == "cuda"
                      else nullcontext()):
                    digest = self._digest_value()
                    self._graphs.release()
                    digests = self._ranks.close(digest)
            except Exception:
                logger.exception("torch engine: closing the rank group failed")
                digests = None
            if digests is not None:
                self.rank_digests = digests
                if len(set(digests)) > 1:
                    logger.error("torch engine: the ranks wrote the KV of different "
                                 "tokens (digests %s)", digests)

    def spill_prefix_pages(self) -> int:
        """Spill on drain: copy every ref==0 resident prefix page into the
        spill store, so an engine rebuilt on the same store restores the
        corpus on a miss instead of losing it with the pool. The dispatch
        thread must be quiesced (``stop()`` returned): this reads device
        pages from the calling thread. A multi-rank engine reads them over
        its group, so it must have stopped with ``keep_group=True``."""
        client = self._tier_client
        if client is None or not client.active:
            return 0
        with torch.inference_mode(), (torch.cuda.device(self.device)
                                      if self.device.type == "cuda" else nullcontext()):
            spilled = self.allocator.spill_resident_prefix()
        if spilled:
            logger.info("torch engine: spilled %d resident prefix page(s) to the "
                        "tier store before teardown", spilled)
        return spilled

    def _close_owned_tiers(self) -> None:
        """Shut a standalone engine's private spill store (its write-behind
        worker and temporary directory); a shared store is its owner's to
        close."""
        if self._owned_tier_store is not None:
            self._owned_tier_store.close()
            self._owned_tier_store = None
            if self._tier_client is not None:
                self._tier_client.store = None

    def kill(self) -> None:
        """Signal the dispatch thread to stop without joining it (a pool's
        failover: a wedged device call may hold the thread for minutes).
        The engine then refuses new submissions."""
        self._killed = True
        self._started = False
        self._stop_event.set()
        self._wake.set()

    def heartbeat_age(self) -> float:
        """Seconds since the dispatch loop last started an iteration (a
        thread stuck inside a device call stops beating)."""
        return max(0.0, time.monotonic() - self._heartbeat_ts)

    def last_step_age(self) -> float | None:
        """Seconds since the last device dispatch retired; None before
        the first."""
        if self._last_step_done_ts is None:
            return None
        return max(0.0, time.monotonic() - self._last_step_done_ts)

    def dispatch_alive(self) -> bool:
        """True while the dispatch thread runs and has not crashed for good
        (the crash half of a health check)."""
        return bool(self._started and not self._dead and self._thread is not None
                    and self._thread.is_alive()
                    and (self._ranks is None or self._ranks.failure() is None))

    @property
    def warmed(self) -> bool:
        """True once the construction captured the decode graphs of at
        least one width: nothing is captured or built for them while
        serving, so a pool's health monitor may read a stale heartbeat as a
        wedge even before the first step retires."""
        return bool(self._warmed_widths)

    def warmup(self, mode: str | None = None) -> None:
        """The JAX engine's precompile entry, kept for a pool's ``warmup``:
        here a no-op, since the construction already captured every decode
        (and verify) graph and nothing compiles later; ``warmed`` stays
        true. ``mode`` is accepted and ignored."""
        del mode

    def request_cancel(self, request_id: str) -> bool:
        """Thread-safe: ask the dispatch thread to end a generation; its
        stream then terminates with ``finish_reason="cancelled"``. Returns
        False when no pending or running request has that id."""
        for _ in range(8):
            try:
                known = any(r.request_id == request_id
                            for bucket in (list(self._pending),
                                           list(self._running.values()),
                                           list(self._chunking.values()))
                            for r in bucket)
                break
            except RuntimeError:  # a table changed mid-snapshot: retry
                continue
        else:
            known = True
        if not known:
            return False
        with self._cancel_lock:
            self._cancels.add(request_id)
        self._wake.set()
        return True

    # ------------------------------------------------------------- submission

    async def submit(self, request: GenRequest) -> GenRequest:
        self._check_alive()
        self.stats.requests += 1
        self.stats.prompt_tokens += len(request.prompt_ids)
        if self.ledger is not None:
            # the same site as stats.prompt_tokens: the tenants' slices sum
            # to the untagged total
            self.ledger.add(request.tenant, requests=1,
                            prompt_tokens=len(request.prompt_ids))
        while True:
            try:
                self._work.put_nowait(request)
                self._wake.set()
                break
            except queue.Full:  # backpressure without blocking the loop
                await asyncio.sleep(0.005)
                # a kill() during the sleep must not let the retry queue
                # work that nothing will drain
                self._check_alive()
        self.stats.queue_depth = self._work.qsize() + len(self._pending)
        if self.metrics is not None:
            self.metrics.llm_queue_depth.labels(
                replica=self.config.replica_id).set(self.stats.queue_depth)
        return request

    def _check_alive(self) -> None:
        """Refuse work that no dispatch thread would drain (a killed
        engine, or a crashed thread)."""
        if self._killed:
            raise RuntimeError("engine was killed")
        if self._dead or (self._started and (self._thread is None
                                             or not self._thread.is_alive())):
            raise RuntimeError("engine dispatch thread is not running")

    async def generate(self, prompt_ids: list[int],
                       **kwargs) -> AsyncIterator[int]:
        """Submit and yield token ids as they decode."""
        request = GenRequest(request_id=new_id(), prompt_ids=prompt_ids,
                             **kwargs)
        await self.submit(request)
        while True:
            token = await request.stream.get()
            if token is None:
                break
            yield token

    # --------------------------------------------------------- dispatch thread

    def _device_loop(self) -> None:
        """Owns every device call. Each iteration: take new work, apply
        cancels and knob moves, drain the decode pipeline when admission or
        a chunk round is due (or nothing runs), admit one prefill group
        when a slot is free, advance every chunking prompt by one chunk
        round, dispatch one speculative verify (when some row would draft)
        or one decode super-step over the running slots (retiring the one
        before it), then flush the emitted tokens. A crash fails the
        outstanding requests, or with ``auto_restart`` restarts the loop
        (``_restart_after_crash``)."""
        overlap = self.config.decode_overlap and not self.config.spec_decode
        crashed = False
        # a kernel build or graph capture on this thread stalls serving
        token = track_thread(self.compile_tracker, "serving")
        try:
            with torch.inference_mode():
                if self.device.type == "cuda":
                    torch.cuda.set_device(self.device)
                while not self._stop_event.is_set():
                    self._heartbeat_ts = time.monotonic()
                    if self._ranks is not None:
                        self._ranks.check()   # a dead follower ends the loop
                    # fault point engine.dispatch, scope = replica id: a
                    # latency fault is a slow replica (the heartbeat still
                    # beats), an error one a dispatch-thread crash through
                    # the real crash path below. Unarmed: one dict miss.
                    fault = fault_point("engine.dispatch", scope=self.config.replica_id)
                    if fault is not None:
                        fault.apply()
                    self._drain_work()
                    did_work = False
                    if self._cancels:
                        self._apply_cancels()
                        did_work = True
                    if self._pending_knobs:
                        # knob moves land here, before admission and decode:
                        # a K change drains the pipeline first
                        self._apply_knobs()
                        did_work = True
                    if self._pending_exports:
                        # a pool's chain exports land at the same barrier,
                        # the pipeline drained first: every exported page
                        # holds fully retired prefill state
                        self._apply_exports()
                        did_work = True
                    occupied = len(self._running) + len(self._chunking)
                    can_admit = (bool(self._pending)
                                 and occupied < self.config.max_batch)
                    if self._inflight is not None and (
                            can_admit or self._chunking or not self._running):
                        # drain barriers: admission and chunk completion move
                        # requests into slots and pages the in-flight
                        # lookahead indexes; with no running row it holds
                        # only rows that already finished
                        self._drain_pipeline()
                        did_work = True
                    if can_admit:
                        did_work = self._admit_batch() or did_work
                    if self._chunking:
                        self._chunk_round()
                        did_work = True
                    if self._running:
                        if (self.config.spec_decode and self._spec_enabled
                                and self._any_would_draft()):
                            self._drain_pipeline()
                            self._spec_step_all()
                        elif overlap:
                            self._decode_step_overlapped()
                        else:
                            self._decode_step_all()
                        did_work = True
                    self.stats.queue_depth = (self._work.qsize()
                                              + len(self._pending))
                    self.stats.chunking = len(self._chunking)
                    self._flush_emits()
                    if not did_work:
                        self._wait_for_work()
                # a clean stop: tokens already sampled reach their streams
                self._drain_pipeline()
        except Exception:
            crashed = True
            self._inflight = None   # device state is suspect: never read it back
            logger.exception("torch engine dispatch thread crashed")
        finally:
            self._flush_emits()
            try:
                if (crashed and self.config.auto_restart
                        and not self._stop_event.is_set()
                        and self.stats.engine_restarts < self.config.auto_restart_max
                        and (self._ranks is None or self._ranks.failure(wait_s=1.0) is None)):
                    self._restart_after_crash()
                else:
                    self._dead = crashed
                    self._fail_outstanding("cancelled" if self._stop_event.is_set()
                                           else "error")
                    if crashed or not self._keep_group:
                        self.close_ranks()
            finally:
                restore_thread(token)

    def _restart_after_crash(self) -> None:
        """Crash recovery, on the dying dispatch thread: requests mid-stream
        fail (their tokens were emitted; a retry would repeat them), the
        pending and mid-chunk ones (nothing emitted) re-queue, the KV pool
        is reset and a new dispatch thread takes over.

        Unlike the JAX engine, which rebuilds its pool (a crashed jitted
        call may have consumed the donated buffers), the pool is reset IN
        PLACE: the decode graphs hold its addresses, and a new pool would
        leave them writing into freed memory. First the device is probed
        with a synchronize: a sticky CUDA error (an illegal address, a
        device-side assert) poisons the context, and then everything
        outstanding fails instead of looping. The synchronize also retires
        the dropped dispatch's staging copies before its pinned buffers can
        be reused."""
        self.stats.engine_restarts += 1
        logger.warning("torch engine: restarting after crash (%d/%d)",
                       self.stats.engine_restarts, self.config.auto_restart_max)
        self._inflight = None
        self._drain_work()
        requeue = list(self._pending)
        self._pending.clear()
        requeue.extend(self._chunking.values())
        self._chunking.clear()
        for request in list(self._running.values()):
            if request.finish_reason is None:
                request.finish_reason = "error"
            self._observe_finish(request)
            self._running.pop(request.slot, None)
            self._post_tokens(request, [], done=True)
        # flush before the new thread exists: two threads never share the
        # emit buffer
        self._flush_emits()
        try:
            self._reset_device_state()
            for request in requeue:
                request.slot = -1
                request.bucket = -1
                request.hist = 0
                request.chunked = False
                request.chunk_pos = 0
                self._pending.append(request)
            requeue = []
            replacement = threading.Thread(target=self._device_loop,
                                           name="torch-engine-dispatch",
                                           daemon=True)
            # start before publishing: stop() must never join a thread
            # that has not started
            replacement.start()
            self._thread = replacement
        except Exception:
            logger.exception("torch engine: crash recovery failed; engine down")
            self._dead = True
            self._pending.extendleft(reversed(requeue))
            self._fail_outstanding("error")

    def _reset_device_state(self) -> None:
        """Probe the device, then zero the pool's pages, scales and block
        table in place and start a fresh allocator (no resident prefix).
        The probe and the final wait are syncs of this thread's stream, not
        of the device: any sync raises on a poisoned context, and a sibling
        engine of the same process (a pool's replica, which may be capturing
        its graphs) keeps its own work in flight."""
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)
        if stream is not None:
            stream.synchronize()    # raises on a poisoned context
        if self._ranks is not None:
            self._ranks.check()     # no restart over a dead follower
        self._table_rows = {}
        self._device_call("reset")
        if self._tier_client is not None:
            # every resident page is gone: stale HBM locations would
            # mis-route, and the new allocator's hit counts start at zero
            self._tier_client.drop_replica()
        self._tier_hits_exported.clear()
        self.allocator = self._new_allocator()
        self._last_step_done_ts = None
        if stream is not None:
            stream.synchronize()

    def _reset_pool(self) -> None:
        """Zero the pool's pages, scales and block table in place (the
        graphs hold their addresses)."""
        kv = self.kv
        with torch.inference_mode():
            for t in (kv.k_pages, kv.v_pages, kv.k_scales, kv.v_scales,
                      kv.block_tables):
                if t is not None:
                    t.zero_()

    def _wait_for_work(self) -> None:
        self._wake.clear()
        if self._work.qsize() or self._stop_event.is_set():
            return
        self._wake.wait(0.05)

    def _drain_work(self) -> None:
        while True:
            try:
                self._pending.append(self._work.get_nowait())
            except queue.Empty:
                return

    def _fail_outstanding(self, reason: str) -> None:
        self._inflight = None
        self._drain_work()
        with self._export_lock:
            exports, self._pending_exports = self._pending_exports, []
        for _ids, fut in exports:
            # a migration waiting on this export degrades (decode in
            # place, or a requeue) instead of hanging on a dead engine
            if not fut.done():
                fut.set_exception(RuntimeError(
                    f"engine dispatch thread ended ({reason}) before the "
                    "chain export ran"))
        for request in list(self._running.values()):
            if request.finish_reason is None:
                request.finish_reason = reason
            # the incident line of a generation cut mid-decode joins the
            # trace of the request it truncated
            logger.warning(
                "torch engine: failing in-flight request %s (%s) after %d "
                "generated token(s)", request.request_id,
                request.finish_reason, len(request.generated),
                extra=trace_extra(request.trace_ctx))
            self._finish(request)
        for request in list(self._chunking.values()):
            self._chunking.pop(request.slot, None)
            self.allocator.free_slot(request.slot)
            if request.finish_reason is None:
                request.finish_reason = reason
            self._post_tokens(request, [], done=True)
        while self._pending:
            request = self._pending.popleft()
            if request.finish_reason is None:
                request.finish_reason = reason
            self._post_tokens(request, [], done=True)
        self._flush_emits()

    def _apply_cancels(self) -> None:
        with self._cancel_lock:
            ids, self._cancels = self._cancels, set()
        for request in list(self._running.values()):
            if request.request_id in ids and request.finish_reason is None:
                request.finish_reason = "cancelled"
                self._finish(request)
        for request in list(self._chunking.values()):
            if request.request_id in ids and request.finish_reason is None:
                self._chunking.pop(request.slot, None)
                self.allocator.free_slot(request.slot)
                request.finish_reason = "cancelled"
                self._post_tokens(request, [], done=True)
        kept: deque[GenRequest] = deque()
        for request in self._pending:
            if request.request_id in ids and request.finish_reason is None:
                request.finish_reason = "cancelled"
                self._post_tokens(request, [], done=True)
            else:
                kept.append(request)
        self._pending = kept

    # ------------------------------------------------------------------ knobs

    def request_knobs(self, *, superstep: int | None = None,
                      spec_enabled: bool | None = None,
                      width_floor: int | None = None) -> dict[str, bool]:
        """Stage serving-knob moves for the dispatch thread to land at its
        next drain barrier; returns {knob: accepted}. Validation happens
        here, against what the construction captured: K may only move to a
        rung with decode graphs (nothing is captured while serving), spec
        decoding toggles only on a spec-built engine, and a width floor
        must be a captured width. Thread-safe."""
        accepted: dict[str, bool] = {}
        staged: dict[str, Any] = {}
        if superstep is not None:
            k = int(superstep)
            ok = k >= 1 and k in self._warmed_k
            if self.config.spec_decode and k > 1:
                ok = False   # the constructor's exclusivity
            accepted["superstep"] = ok
            if ok:
                staged["superstep"] = k
        if spec_enabled is not None:
            ok = self.config.spec_decode
            accepted["spec_enabled"] = ok
            if ok:
                staged["spec_enabled"] = bool(spec_enabled)
        if width_floor is not None:
            w = int(width_floor)
            ok = w == 0 or (self.config.batch_buckets and w in self._warmed_widths)
            accepted["width_floor"] = ok
            if ok:
                staged["width_floor"] = min(w, self.config.max_batch)
        if staged:
            with self._knob_lock:
                self._pending_knobs.update(staged)
            self._wake.set()
        return accepted

    def _apply_knobs(self) -> None:
        """Land staged knob moves on the dispatch thread. A K change drains
        the pipeline first (the in-flight dispatch retires at its own K),
        so the next dispatch replays the new rung's graph from a clean
        barrier; spec and width-floor moves are host-side flips."""
        with self._knob_lock:
            knobs, self._pending_knobs = self._pending_knobs, {}
        if not knobs:
            return
        new_k = knobs.get("superstep")
        if new_k is not None and new_k != self._k:
            if self._inflight is not None:
                self._drain_pipeline()
            self._k = int(new_k)
        if "spec_enabled" in knobs:
            self._spec_enabled = bool(knobs["spec_enabled"])
        if "width_floor" in knobs:
            self._width_floor = int(knobs["width_floor"])

    def request_chain_export(self, prompt_ids: list[int]) -> Future:
        """Stage a KV chain export for the dispatch thread (a pool's
        prefill -> decode migration): the prompt's registered full-page
        chain is copied into the shared tier store at the next drain
        barrier; the pages stay resident. Staged like ``request_knobs``,
        since only the dispatch thread touches device state. Returns a
        future of the number of pages now in the store, which fails if the
        engine dies first. Thread-safe. On a multi-rank engine each page's
        read is the announced ``_op_read_page``: the store gets whole pages."""
        self._check_alive()
        fut: Future = Future()
        with self._export_lock:
            self._pending_exports.append((tuple(prompt_ids), fut))
        self._wake.set()
        return fut

    def _apply_exports(self) -> None:
        """Land staged chain exports on the dispatch thread, draining the
        decode pipeline first: the prefill leg's pages must hold retired
        state before their bytes are read."""
        with self._export_lock:
            exports, self._pending_exports = self._pending_exports, []
        if not exports:
            return
        if self._inflight is not None:
            self._drain_pipeline()
        for prompt_ids, fut in exports:
            if fut.cancelled():
                continue
            try:
                fut.set_result(self.allocator.spill_chain(list(prompt_ids)))
            except Exception as exc:  # a failed read degrades the pool's
                fut.set_exception(exc)  # migration; the engine lives on

    def knob_state(self) -> dict[str, Any]:
        """The live knob posture."""
        return {
            "superstep": self._k,
            "spec_built": self.config.spec_decode,
            "spec_enabled": bool(self.config.spec_decode and self._spec_enabled),
            "width_floor": self._width_floor,
            "batch_width": self._batch_width,
            "warmed_k": sorted(self._warmed_k),
            "warmed_widths": sorted(self._warmed_widths),
        }

    # -------------------------------------------------------------- admission

    def _bucket_for(self, length: int) -> int | None:
        for bucket in sorted(self.config.prefill_buckets):
            if length <= bucket:
                return bucket
        return None

    def _assign_bucket(self, request: GenRequest) -> int:
        """Request's prefill bucket (0 = cannot be served). A prefix-cache
        hit buckets by SUFFIX length, and only when that lands a strictly
        smaller bucket than a dense prefill of the whole prompt (the history
        path costs more per padded token). A prompt (or a hit's suffix)
        longer than every bucket is ``chunked``, from its cached history
        on, and takes the largest bucket. The probe takes no page
        references; the real match happens at admission."""
        if request.bucket != -1:
            return request.bucket
        config = self.config
        ids = request.prompt_ids
        request.hist = 0
        request.chunked = False
        if len(ids) + 1 > config.max_seq_len:
            # the prompt plus >= 1 generated token must fit the block table
            request.bucket = 0
            return 0
        dense_bucket = self._bucket_for(len(ids))
        if config.prefix_cache:
            hist = self.allocator.probe_prefix(ids)
            bucket = self._bucket_for(len(ids) - hist) if hist else None
            # a sequence-parallel bucket never carries history: such a hit
            # prefills the whole prompt, as the JAX engine does
            if hist and (bucket is None or dense_bucket is None
                         or bucket < dense_bucket) and not (
                             bucket is not None and self._sp_bucket(bucket)):
                request.hist = hist
                request.chunked = bucket is None
                request.bucket = bucket or max(config.prefill_buckets)
                return request.bucket
        request.chunked = dense_bucket is None
        request.bucket = dense_bucket or max(config.prefill_buckets)
        return request.bucket

    def _admit_batch(self) -> bool:
        """Admit up to prefill_max_batch requests in ONE prefill call: the
        head's bucket and hit posture, or (a chunked head) other chunked
        requests, which then prefill in ``_chunk_round``. At most
        prefill_max_batch prompts chunk at once: a chunked request beyond
        that steps aside so the requests behind it can still admit."""
        config = self.config
        was_idle = (not self._running and not self._chunking
                    and (time.monotonic() - self._last_active_ts
                         >= config.batch_idle_reset_s))
        if len({r.priority for r in self._pending}) > 1:
            # stable sort: FIFO holds within each priority class
            self._pending = deque(sorted(self._pending,
                                         key=lambda r: r.priority))
        free_slots = [s for s in range(config.max_batch)
                      if s not in self._running and s not in self._chunking]
        deferred: list[GenRequest] = []
        head: GenRequest | None = None
        while self._pending:
            candidate = self._pending[0]
            if self._assign_bucket(candidate) == 0:
                self._pending.popleft()
                candidate.finish_reason = "length"
                self._post_tokens(candidate, [], done=True)
                continue
            if (candidate.chunked
                    and len(self._chunking) >= config.prefill_max_batch):
                deferred.append(self._pending.popleft())
                continue
            head = candidate
            break
        if head is None or not free_slots:
            self._pending.extendleft(reversed(deferred))
            return False
        bucket = head.bucket
        with_hist = head.hist > 0
        group: list[GenRequest] = []
        skipped: list[GenRequest] = []
        limit = min(len(free_slots), config.prefill_max_batch)
        if head.chunked:
            limit = min(limit, config.prefill_max_batch - len(self._chunking))
        while self._pending and len(group) < limit:
            request = self._pending.popleft()
            if head.chunked:
                # chunk rounds batch rows at any offset, hit or not
                ok = self._assign_bucket(request) != 0 and request.chunked
            else:
                ok = (self._assign_bucket(request) == bucket
                      and (request.hist > 0) == with_hist
                      and not request.chunked)
            (group if ok else skipped).append(request)
        # FIFO for other buckets; capacity-blocked chunkers go first
        self._pending.extendleft(reversed(skipped))
        self._pending.extendleft(reversed(deferred))

        admitted: list[GenRequest] = []
        for request in group:
            total = min(len(request.prompt_ids) + request.max_tokens,
                        config.max_seq_len)
            slot = free_slots[len(admitted)]
            shared: list[int] = []
            # the spills and restores of this match and allocation are
            # tier.spill / tier.restore spans in this request's trace
            if self._tier_client is not None:
                self._tier_client.trace_ctx = request.trace_ctx
            try:
                if request.hist:
                    hist, shared = self.allocator.match_prefix(request.prompt_ids)
                    if hist != request.hist:
                        # the cache moved since the probe: re-probe later
                        self.allocator.release_prefix(shared)
                        request.bucket = -1
                        self._pending.appendleft(request)
                        continue
                if not self.allocator.allocate_slot(slot, total,
                                                    prefix_pages=shared):
                    # page pressure: release the match and retry later
                    if self.metrics is not None:
                        self.metrics.llm_kv_alloc_failures.inc()
                    self.allocator.release_prefix(shared)
                    request.bucket = -1
                    self._pending.appendleft(request)
                    continue
            finally:
                if self._tier_client is not None:
                    self._tier_client.trace_ctx = None
            if shared and self.ledger is not None:
                # tokens served from shared prefix pages, counted where the
                # match is consumed (the allocator's prefix_hit_tokens)
                self.ledger.add(request.tenant, cache_hit_tokens=(
                    len(shared) * self.allocator.page_size))
            request.slot = slot
            request.queue_ms = (time.time() - request.created) * 1000
            self._observe_admitted(request)
            if request.chunked:
                # the chunk rounds own it until its prompt is prefilled
                request.chunk_pos = request.hist
                self._chunking[slot] = request
            else:
                self._running[slot] = request
            admitted.append(request)
        if not admitted:
            return False
        self._sync_tables()
        self._last_active_ts = time.monotonic()
        if was_idle and config.batch_buckets:
            # idle-boundary width reset: a width left by a drained burst
            # must not tax the next arrivals for batch_shrink_steps
            # dispatches; the ceiling counts the load that could admit
            # (slots were assigned from 0 up, so the bucket covers them)
            active = len(self._running) + len(self._chunking)
            admissible = max(0, min(
                len(self._pending), config.max_batch - active,
                self.allocator.free_pages // self.allocator.avg_slot_pages()))
            desired = self._batch_bucket_for(
                max(min(active + admissible, config.max_batch), 1))
            if desired < self._batch_width:
                self._batch_width = desired
                self._shrink_streak = 0
                self._shrink_peak = 0
        if head.chunked:
            return True   # the device work happens in _chunk_round

        started = time.monotonic()
        first = self._device_call(
            "prefill", rows=self._pack_rows([(r, r.hist, len(r.prompt_ids)) for r in admitted],
                                            bucket),
            hist=with_hist, sp=self._sp_bucket(bucket),
            any_sampled=any(r.temperature > 0 for r in admitted))
        if config.prefix_cache:
            # register the full prompt pages for later prompts to share
            for request in admitted:
                self.allocator.register_prefix(request.slot,
                                               request.prompt_ids)
        self._last_step_done_ts = time.monotonic()
        elapsed_ms = (self._last_step_done_ts - started) * 1000
        self.stats.prefill_ms_total += elapsed_ms
        self.stats.prefill_batches += 1
        self.stats.prefill_requests += len(admitted)
        self._record_step("prefill", batch=len(admitted), width=len(admitted),
                          dur_ms=elapsed_ms, tokens=len(admitted), bucket=bucket)
        for request, token in zip(admitted, first):
            request.prefill_ms = elapsed_ms
            self._emit(request, int(token))
        return True

    def _chunk_round(self) -> None:
        """Advance every chunking prompt by ONE chunk, in one batched call
        of the history path: chunk i attends over chunks 0..i-1 (and any
        cached prefix) already in the slot's pages. S is the smallest
        bucket that covers the widest remaining span. Samples taken
        mid-prompt predict known prompt tokens and are discarded; a row
        whose prompt completes registers its prefix, moves to decode and
        emits its first token."""
        config = self.config
        batch = list(self._chunking.values())[:config.prefill_max_batch]
        widest = max(len(r.prompt_ids) - r.chunk_pos for r in batch)
        S = self._bucket_for(widest) or max(config.prefill_buckets)
        started = time.monotonic()
        rows = []
        for request in batch:
            start = request.chunk_pos
            end = min(start + S, len(request.prompt_ids))
            rows.append((request, start, end))
            request.chunk_pos = end
        sampled = self._device_call("prefill", rows=self._pack_rows(rows, S), hist=True,
                                    sp=False, any_sampled=any(r.temperature > 0 for r in batch))
        self._last_step_done_ts = time.monotonic()
        elapsed_ms = (self._last_step_done_ts - started) * 1000
        self.stats.prefill_ms_total += elapsed_ms
        self.stats.prefill_batches += 1
        self._record_step(
            "chunk_prefill", batch=len(batch), width=len(batch), dur_ms=elapsed_ms,
            tokens=sum(1 for r in batch if r.chunk_pos >= len(r.prompt_ids)),
            bucket=S)
        for request, token in zip(batch, sampled):
            request.prefill_ms += elapsed_ms
            if request.chunk_pos < len(request.prompt_ids):
                continue
            del self._chunking[request.slot]
            # register BEFORE emitting: a first token that ends the request
            # frees the slot's pages, and registration would cache nothing
            if config.prefix_cache:
                self.allocator.register_prefix(request.slot,
                                               request.prompt_ids)
            self.stats.prefill_requests += 1
            self._running[request.slot] = request
            self._emit(request, int(token))

    def _pack_rows(self, rows: list[tuple[GenRequest, int, int]], S: int
                   ) -> dict[str, np.ndarray]:
        """Pack each (request, start, end) prompt span into [B, S] host
        arrays at absolute positions, padded to S: padding has position -1
        (its KV write goes to the trash page) and the pad token; with each
        row's slot and sampling parameters."""
        B = len(rows)
        tokens = np.full((B, S), self.tokenizer.pad_id, dtype=np.int64)
        positions = np.full((B, S), -1, dtype=np.int32)
        last_idx = np.zeros((B,), dtype=np.int64)
        for i, (request, start, end) in enumerate(rows):
            tokens[i, :end - start] = request.prompt_ids[start:end]
            positions[i, :end - start] = np.arange(start, end)
            last_idx[i] = end - start - 1
        requests = [r for r, _, _ in rows]
        return {"tokens": tokens, "positions": positions, "last_idx": last_idx,
                "slots": np.array([r.slot for r in requests], np.int64),
                "temperature": np.array([r.temperature for r in requests], np.float32),
                "top_k": np.array([r.top_k for r in requests], np.int32),
                "top_p": np.array([r.top_p for r in requests], np.float32)}

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(array).to(self.device)

    def _sp_bucket(self, bucket: int) -> bool:
        """True when a cold prefill of ``bucket`` runs sequence-parallel."""
        return self.config.sp_impl != "none" and bucket > self.config.sp_threshold

    # ------------------------------------------------------- device calls

    def _announce(self, op: str, **args: Any) -> None:
        """A multi-rank engine's next device call (``_op_<op>(**args)``) to
        its followers, with the block-table rows changed since the last."""
        if self._ranks is not None and self.world > 1:
            rows, self._table_rows = self._table_rows, {}
            self._ranks.announce({"op": op, "args": args, "rows": rows})

    def _device_call(self, op: str, **args: Any) -> Any:
        """Run one device call (``_op_<op>``) on this rank, announced first."""
        self._sync_tables()
        self._announce(op, **args)
        return getattr(self, f"_op_{op}")(**args)

    def _op_prefill(self, rows: dict[str, np.ndarray], hist: bool, sp: bool,
                    any_sampled: bool) -> list[int]:
        """A packed prefill (``_pack_rows``): a cold one (sequence-parallel
        when ``sp``), or through the history path (a prefix hit's suffix or a
        chunk round); returns each row's sampled token."""
        t = {name: self._to_device(a) for name, a in rows.items()}
        if hist:
            logits, self.kv = prefill_with_history(
                self.params, self.model_config, t["tokens"], t["positions"], self.kv,
                t["slots"], last_idx=t["last_idx"], mesh=self._mesh)
        else:
            logits, self.kv = prefill(
                self.params, self.model_config, t["tokens"], t["positions"], self.kv,
                t["slots"], attn_impl=self.config.sp_impl if sp else "auto",
                mesh=self._mesh, last_idx=t["last_idx"])
        self._note_written(t["tokens"], t["positions"], t["positions"] >= 0)
        sampling = SamplingParams(t["temperature"], t["top_k"], t["top_p"])
        return self._sample(logits, sampling, any_sampled).tolist()

    def _op_launch(self, key: tuple, pack: np.ndarray, feed: tuple | None) -> tuple:
        """A follower's decode or verify dispatch: ``pack`` staged and the
        key's graph replayed (fed by ``feed``'s last tokens)."""
        key = GraphKey(*key)
        self._graphs.stage(key)[:] = pack
        return self._graphs.launch(key, None if feed is None else (GraphKey(*feed), 0))

    def _op_reset(self) -> None:
        self._reset_pool()

    def _launch(self, key: GraphKey, pack: np.ndarray, feed: tuple | None = None,
                timed: bool = False) -> tuple:
        """Rank 0's dispatch of a staged pack: announced to the followers,
        then ``DecodeGraphs.launch``."""
        self._announce("launch", key=tuple(key), pack=pack.copy(),
                       feed=None if feed is None else tuple(feed[0]))
        return self._graphs.launch(key, feed, timed=timed)

    def _sample(self, logits: torch.Tensor, sampling: SamplingParams,
                any_sampled: bool) -> torch.Tensor:
        """``sample_tokens`` on this rank; on the rank path rank 0's tokens
        are then broadcast, so that every rank writes the same ones."""
        out = sample_tokens(logits, sampling, self._sample_gen, any_sampled)
        if self._mesh is not None:
            broadcast_(out, self._mesh.get_group("world"))
        return out

    def _note_written(self, tokens: torch.Tensor, positions: torch.Tensor,
                      mask: torch.Tensor) -> None:
        """Fold the tokens whose KV this call wrote into the rank's digest
        (a multi-rank engine only; ``rank_digests``)."""
        if self._digest is None:
            return
        terms = (tokens.long() * 1_000_003 + positions.long() * 7_919 + 1) * mask.long()
        self._digest.mul_(6_364_136_223_846_793_005).add_(terms.sum())

    def follow(self) -> None:
        """A follower's loop: run each device call rank 0 announces, until
        its stop, which gathers every rank's digest; then leave the group."""
        with torch.inference_mode():
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            while True:
                message = self._ranks.receive()
                if message["op"] == "stop":
                    digest = self._digest_value()
                    self._graphs.release()
                    self._ranks.close(digest)
                    return
                rows = message.get("rows")
                if rows:
                    index = torch.tensor(sorted(rows), dtype=torch.long)
                    values = torch.from_numpy(np.stack([rows[r] for r in sorted(rows)]))
                    self.kv.block_tables[index.to(self.device)] = values.to(self.device)
                getattr(self, f"_op_{message['op']}")(**message["args"])

    def _digest_value(self) -> int | None:
        return None if self._digest is None else int(self._digest.item())

    # ------------------------------------------------------ speculative step

    def _draft_tokens(self, request: GenRequest, k: int) -> list[int]:
        """Prompt-lookup drafting: the most recent earlier occurrence of the
        trailing spec_ngram in (prompt + generated), returning up to k
        tokens that followed it. No draft model: the context itself is the
        proposer (summaries and tool outputs echo their inputs, and greedy
        decoding revisits its own phrases)."""
        n = self.config.spec_ngram
        ctx = request.prompt_ids + request.generated
        if len(ctx) <= n:
            return []
        tail = ctx[-n:]
        lo = max(0, len(ctx) - n - 512)  # bounded scan window
        for start in range(len(ctx) - n - 1, lo - 1, -1):
            if ctx[start:start + n] == tail:
                return ctx[start + n:start + n + k]
        return []

    def _any_would_draft(self) -> bool:
        """True iff some running row can take drafts this step: a greedy
        row with more than one token left. Otherwise the [B, K] verify
        would cost about K times the attention and MLP work of a decode
        step for no extra token, and the plain decode runs instead."""
        for request in self._running.values():
            if (request.temperature == 0.0
                    and request.max_tokens - len(request.generated) > 1):
                return True
        return False

    def _spec_step_all(self) -> None:
        """One [B, K] verify over every running slot: row = the last token
        and up to K - 1 drafted continuations, at their positions. Drafts
        are accepted while the model's own token at the position before
        agrees, so each dispatch emits 1..K tokens per row for one read of
        the weights. Greedy rows only get drafts; sampled rows ride at
        width 1 (their token is drawn from the true distribution).
        Rejected drafts' KV stays in the pages, dead until a later step
        rewrites those positions (attention at a position reads only
        positions before it); on int8 pages a rejected draft may still
        have grown its page's scale."""
        config = self.config
        B, K = config.max_batch, config.spec_k
        active = list(self._running.items())
        key = GraphKey("verify", K, B, any(r.temperature > 0 for _, r in active))
        pack = self._graphs.stage(key)
        temperature = pack[V_TEMPERATURE].view(np.float32)
        top_p = pack[V_TOP_P].view(np.float32)
        widths: dict[int, int] = {}
        chunks: dict[int, list[int]] = {}
        contexts: dict[int, int] = {}   # keys before each chunk's second token
        for slot, request in active:
            p0 = len(request.prompt_ids) + len(request.generated) - 1
            remaining = max(0, request.max_tokens - len(request.generated))
            chunk = [request.generated[-1]]
            if request.temperature == 0.0 and remaining > 1:
                chunk += self._draft_tokens(request, K - 1)
            chunk = chunk[:min(K, remaining)]   # running => remaining >= 1
            # one grant per slot: the usable width falls out of the granted
            # capacity (the chunk's first token sits at p0)
            usable = self.allocator.pregrant_block(slot, p0 + 1, len(chunk))
            widths[slot] = usable
            if usable == 0:
                # the page pool is exhausted: the request ends "length"
                request.finish_reason = "length"
                if self.metrics is not None:
                    self.metrics.llm_kv_alloc_failures.inc()
                continue
            chunks[slot] = chunk = chunk[:usable]
            contexts[slot] = p0 + 1
            pack[V_TOKENS:V_TOKENS + usable, slot] = chunk
            pack[V_TOKENS + K:V_TOKENS + K + usable, slot] = np.arange(p0, p0 + usable)
            temperature[slot] = request.temperature
            pack[V_TOP_K, slot] = request.top_k
            top_p[slot] = request.top_p
        self._sync_tables()
        started = time.monotonic()
        if self._last_step_done_ts is not None:
            self.stats.dispatch_gap_ms_total += max(
                0.0, started - self._last_step_done_ts) * 1000
        graphs_before = self._graphs.replays
        block = self._graphs.fetch_verify(self._launch(key, pack))   # [B, K]
        self.stats.graph_replays += self._graphs.replays - graphs_before
        done_ts = time.monotonic()
        self._last_step_done_ts = done_ts
        elapsed_ms = (done_ts - started) * 1000
        self.stats.decode_ms_total += elapsed_ms
        self.stats.decode_wall_ms_total += elapsed_ms
        self.stats.spec_ms_total += elapsed_ms
        self.stats.decode_steps += 1
        self.stats.decode_dispatches += 1
        self.stats.spec_steps += 1
        spec_emitted = 0
        for slot, request in active:
            if request.finish_reason == "length" and slot in self._running:
                self._finish(request)
                continue
            chunk = chunks.get(slot, [])
            emitted = 0
            for j in range(widths[slot]):
                # chunk[j] (j > 0) is a draft: it stands iff it equals the
                # model's token at the position before
                if j > 0 and chunk[j] != block[slot, j - 1]:
                    break
                self._emit(request, int(block[slot, j]))
                emitted += 1
                if self._running.get(slot) is not request:
                    break   # EOS, a stop id or max_tokens inside the chunk
            self.stats.spec_tokens += max(0, emitted - 1)
            spec_emitted += emitted
        self.stats.spec_emitted += spec_emitted
        ctx_pages = self._ctx_pages(max(contexts.values(), default=0) + K)
        cost = None
        if config.cost_analysis and chunks:
            cost = step_cost(self.model_config, "verify", B, K,
                             [contexts[slot] for slot in chunks],
                             self._weight_dtype(), self._kv_dtype(),
                             page_size=config.page_size, compute_dtype=config.dtype,
                             widths=[len(chunks[slot]) for slot in chunks])
        mfu, hbm_frac = self._observe_roofline("spec_verify", B, ctx_pages,
                                               elapsed_ms, cost)
        if self.signals is not None and active:
            # acceptance: extra tokens per row of this verify (0..K-1)
            self.signals.publish("llm.spec_accept",
                                 max(0.0, spec_emitted / len(active) - 1.0),
                                 config.replica_id)
        self._record_step("spec_decode", batch=len(active), width=B,
                          dur_ms=elapsed_ms, tokens=spec_emitted,
                          ctx_pages=ctx_pages, mfu=mfu, hbm_frac=hbm_frac)

    def _verify_and_sample(self, tokens: torch.Tensor, positions: torch.Tensor,
                           sampling: SamplingParams, slot_ids: torch.Tensor,
                           any_sampled: bool
                           ) -> tuple[torch.Tensor, torch.Tensor]:
        """Speculative verify: a [B, K] chunk (the last token and up to
        K - 1 drafts per row; padding at position -1) through the history
        prefill, sampling at every position. Position j's token is the
        model's next token given the chunk up to j. Returns ([B, K] tokens,
        [B, K, V] f32 logits)."""
        logits, self.kv = prefill_with_history(
            self.params, self.model_config, tokens, positions, self.kv, slot_ids,
            mesh=self._mesh)
        self._note_written(tokens, positions, positions >= 0)
        B, K, V = logits.shape
        flat = SamplingParams(*(p.repeat_interleave(K) for p in sampling))
        out = self._sample(logits.reshape(B * K, V), flat, any_sampled)
        return out.reshape(B, K), logits

    # ----------------------------------------------------------------- decode

    def _batch_buckets(self) -> list[int]:
        """Decode widths: powers of two from 8 (or max_batch if smaller)
        up to max_batch."""
        buckets = []
        width = min(8, self.config.max_batch)
        while width < self.config.max_batch:
            buckets.append(width)
            width *= 2
        buckets.append(self.config.max_batch)
        return buckets

    def _batch_bucket_for(self, active_ceiling: int) -> int:
        for bucket in self._batch_buckets():
            if bucket >= active_ceiling:
                return bucket
        return self.config.max_batch

    def _compact_slots(self) -> None:
        """Move the highest-slot requests into the lowest free slots, so
        the active ceiling equals the active count. Only block-table rows
        move (``move_slot``); the table uploads at the next dispatch."""
        if not self._running:
            return
        occupied = len(self._running) + len(self._chunking)
        ceiling = max(max(self._running), max(self._chunking, default=-1)) + 1
        if ceiling == occupied:
            return
        for slot in sorted(self._running, reverse=True):
            frees = [s for s in range(slot)
                     if s not in self._running and s not in self._chunking]
            if not frees:
                break
            target = frees[0]
            request = self._running.pop(slot)
            self.allocator.move_slot(slot, target)
            request.slot = target
            self._running[target] = request

    def _decode_width(self, allow_compact: bool = True) -> int:
        """The dispatch width: the bucket covering the active slot ceiling
        plus the queued load that could admit (slots compacted first)
        under batch_buckets, else max_batch. It grows at once and shrinks
        only after batch_shrink_steps narrower dispatches, to the widest
        width wanted over that streak. ``allow_compact=False`` keeps slots
        where they are (an in-flight lookahead indexes them)."""
        config = self.config
        if self._running or self._chunking:
            self._last_active_ts = time.monotonic()
        if not config.batch_buckets:
            return config.max_batch
        incoming = self._work.qsize() + len(self._pending)
        free_slots = config.max_batch - len(self._running) - len(self._chunking)
        page_capacity = (self.allocator.free_pages
                         // self.allocator.avg_slot_pages())
        admissible = max(0, min(incoming, free_slots, page_capacity))
        if admissible == 0 and allow_compact:
            # holes that the next admission will not refill
            self._compact_slots()
        ceiling = min(max(max(self._running) + 1,
                          len(self._running) + len(self._chunking) + admissible),
                      config.max_batch)
        desired = self._batch_bucket_for(ceiling)
        if self._width_floor:
            # the knob's floor: the next burst would only grow back
            desired = max(desired, self._batch_bucket_for(
                min(self._width_floor, config.max_batch)))
        if desired >= self._batch_width:
            self._batch_width = desired
            self._shrink_streak = 0
            self._shrink_peak = 0
        else:
            self._shrink_streak += 1
            self._shrink_peak = max(self._shrink_peak, desired)
            if self._shrink_streak >= config.batch_shrink_steps:
                self._batch_width = self._shrink_peak
                self._shrink_streak = 0
                self._shrink_peak = 0
        return self._batch_width

    def _decode_step_all(self) -> None:
        """Serial decode: one super-step over every active slot, dispatched
        and retired back to back (also the first step after a drain)."""
        self._decode_retire(self._decode_dispatch(self._decode_width(), None))

    def _decode_step_overlapped(self) -> None:
        """Depth-2 pipelined decode: dispatch step N+1 fed by step N's
        on-device tokens, then retire step N while N+1 runs. Rows that
        finish in step N still ride N+1 (their writes land in pages that
        are re-granted only to later dispatches, after N+1 in stream
        order), and their lookahead tokens are discarded at retire."""
        if self._phase_sample_due():
            # a sampled step runs serially, so that its timed window holds
            # this dispatch alone; the drain is admission's barrier, so the
            # streams stay those of the unsampled run
            self._drain_pipeline()
            if self._running:
                self._decode_step_all()
            return
        k = self._k
        feed = self._inflight
        self._inflight = None
        if feed is not None:
            # the lookahead is stale when a running row is not the one the
            # fed step covers (defensive: admission drains upstream), or
            # has a partial budget and survives its retire (its true last
            # token is not the block's row k-1); under batch_buckets, when
            # slots have holes or the width would change
            stale = any(
                feed["reqs"].get(slot) is not request
                or (0 < feed["budgets"].get(slot, 0) < k
                    and len(request.generated) + feed["budgets"][slot]
                    < request.max_tokens)
                for slot, request in self._running.items())
            holes = False
            if self.config.batch_buckets:
                ceiling = max(self._running) + 1
                holes = (ceiling != len(self._running) + len(self._chunking)
                         or self._batch_bucket_for(ceiling) != self._batch_width)
            if stale or holes:
                if not self._drain_feed(feed):
                    return
                feed = None
        if feed is not None and all(
                request.max_tokens - len(request.generated)
                - feed["budgets"].get(slot, 0) <= 0
                for slot, request in self._running.items()):
            # every surviving row's budget is spent by the in-flight tokens
            # (a max_tokens tail): a lookahead would sample only discards
            self._decode_retire(feed)
            return
        if feed is not None:
            # page pressure: the lookahead grants pages before retire N
            # frees finished rows' pages; when the pool cannot cover every
            # surviving row's full want, drain first, so that truncation
            # falls where the serial order puts it
            deficit = 0
            for slot, request in self._running.items():
                pending = feed["budgets"].get(slot, 0)
                n_ctx = len(request.prompt_ids) + len(request.generated) + pending
                want = min(k, max(0, request.max_tokens
                                  - len(request.generated) - pending))
                if want > 0:
                    deficit += max(0, self.allocator.pages_needed(n_ctx + want - 1)
                                   - self.allocator.slot_pages(slot))
            if deficit > self.allocator.free_pages:
                if not self._drain_feed(feed):
                    return
                feed = None
        B = self._decode_width(allow_compact=feed is None)
        if feed is not None and feed["B"] != B:
            # a width change: the fed block's shape no longer matches
            if not self._drain_feed(feed):
                return
            feed = None
            B = self._decode_width()
        self._inflight = self._decode_dispatch(B, feed)
        if feed is not None:
            self._decode_retire(feed)

    def _drain_pipeline(self) -> None:
        """Retire the in-flight dispatch, if any (a pipeline barrier)."""
        inflight = self._inflight
        if inflight is None:
            return
        self._inflight = None
        self.stats.pipeline_drains += 1
        self._decode_retire(inflight)

    def _drain_feed(self, feed: dict[str, Any]) -> bool:
        """A barrier inside the overlapped step: retire the fed dispatch
        now; returns whether any row still runs."""
        self.stats.pipeline_drains += 1
        self._decode_retire(feed)
        return bool(self._running)

    def _decode_dispatch(self, B: int, feed: dict[str, Any] | None
                         ) -> dict[str, Any]:
        """Stage and launch one super-step of width ``B``; returns the
        in-flight record ``_decode_retire`` consumes. ``feed``: the previous,
        still in-flight dispatch, whose last sampled tokens are this one's
        inputs; the host then advances each row by the fed step's budget
        (a row that survives its step used its whole budget: a short one
        means max_tokens or the page pool ends the row at that retire).
        A phase-sampled dispatch (serial: the caller drained) times its
        staging, table sync and, by two CUDA events around the replay,
        its device compute; one wait on the second event is the sync the
        sampling buys."""
        config = self.config
        k = self._k
        build_ts = time.monotonic()
        sampled = self._phase_sample_due()
        self._dispatch_count += 1
        reqs = dict(self._running)
        key = GraphKey("decode", k, B, any(r.temperature > 0 for r in reqs.values()))
        pack = self._graphs.stage(key)
        temperature = pack[TEMPERATURE].view(np.float32)
        top_p = pack[TOP_P].view(np.float32)
        budgets: dict[int, int] = {}
        truncated: set[int] = set()
        contexts: list[int] = []
        for slot, request in reqs.items():
            pending = feed["budgets"].get(slot, 0) if feed is not None else 0
            # every token that exists, the fed step's unseen ones included;
            # the input token sits at position n_ctx - 1 and is written now
            n_ctx = len(request.prompt_ids) + len(request.generated) + pending
            contexts.append(n_ctx)
            if feed is None:
                pack[TOKENS, slot] = request.generated[-1]
            pack[POSITIONS, slot] = n_ctx - 1
            pack[SEQ_LENS, slot] = n_ctx
            temperature[slot] = request.temperature
            pack[TOP_K, slot] = request.top_k
            top_p[slot] = request.top_p
            remaining = max(0, request.max_tokens - len(request.generated) - pending)
            want = min(k, remaining)
            usable = 0
            if want > 0:
                usable = self.allocator.pregrant_block(slot, n_ctx, want)
                if usable == 0:
                    # the page pool is exhausted: the row ends "length" at
                    # retire, after the previous step's tokens
                    truncated.add(slot)
                    if self.metrics is not None:
                        self.metrics.llm_kv_alloc_failures.inc()
            budgets[slot] = usable
            pack[BUDGETS, slot] = usable
            stops = (self.tokenizer.eos_id,
                     *tuple(request.stop_ids)[:STOP_TBL_WIDTH - 1])
            pack[STOPS:STOPS + len(stops), slot] = stops
        sync_start = time.monotonic()
        self._sync_tables()
        sync_s = time.monotonic() - sync_start
        started = time.monotonic()
        gap_s = 0.0
        if feed is None and self._last_step_done_ts is not None:
            gap_s = max(0.0, started - self._last_step_done_ts)
        self.stats.overlap_steps += int(feed is not None)
        self.stats.dispatch_gap_ms_total += gap_s * 1000
        if self.metrics is not None:
            self.metrics.llm_dispatch_gap.labels(
                replica=config.replica_id).observe(gap_s)
        graphs_before = self._graphs.replays
        handle = self._launch(key, pack, feed["handle"] if feed else None, timed=sampled)
        self.stats.graph_replays += self._graphs.replays - graphs_before
        phases: dict[str, float] | None = None
        ready_ts = 0.0
        if sampled:
            device_ms = self._graphs.window_device_ms()
            ready_ts = time.monotonic()
            phases = {
                "host_dispatch_ms": max(
                    0.0, (self._graphs.window_ts - build_ts - sync_s) * 1000),
                "table_sync_ms": sync_s * 1000,
                "device_compute_ms": device_ms,
            }
        self.stats.decode_steps += k
        self.stats.decode_dispatches += 1
        return {"handle": handle, "budgets": budgets, "reqs": reqs,
                "truncated": truncated, "B": B, "k": k, "contexts": contexts,
                "ctx_pages": self._ctx_pages(max(contexts, default=0) + k),
                "batch": len(reqs), "dispatch_ts": started, "gap_s": gap_s,
                "fed": feed is not None, "build_ts": build_ts, "ready_ts": ready_ts,
                "phases": phases}

    def _decode_retire(self, inflight: dict[str, Any]) -> None:
        """Read back one dispatch (its [K, B] tokens and the device's
        valid/done masks, behind its event) and emit up to K tokens per
        row. Under overlap this runs while the next dispatch executes.
        Then the step's telemetry: its phase row (when sampled), its
        roofline over its own wall (retire to retire), the ring row."""
        block, valid, done = self._graphs.fetch(inflight["handle"])
        done_ts = time.monotonic()
        prev_done_ts = self._last_step_done_ts
        self._last_step_done_ts = done_ts
        decode_elapsed_ms = (done_ts - inflight["dispatch_ts"]) * 1000
        # under the depth-2 pipeline this step was dispatched while its
        # predecessor ran, so dispatch -> read back spans about two steps:
        # the step's own wall is retire to retire
        step_wall_ms = (done_ts - max(inflight["dispatch_ts"], prev_done_ts or 0.0)) * 1000
        self.stats.decode_ms_total += decode_elapsed_ms
        self.stats.decode_wall_ms_total += step_wall_ms
        emitted = 0
        for slot, request in inflight["reqs"].items():
            if self._running.get(slot) is not request:
                continue  # finished at an earlier retire: lookahead discarded
            if slot in inflight["truncated"]:
                request.finish_reason = request.finish_reason or "length"
                self._finish(request)
                continue
            for step in range(inflight["budgets"][slot]):
                if not valid[step, slot]:
                    break   # the device froze the row (EOS or a stop id)
                self._emit(request, int(block[step, slot]))
                emitted += 1
                if self._running.get(slot) is not request:
                    break   # finished: the rest of the block is discarded
        emit_done_ts = time.monotonic()
        phases = inflight["phases"]
        if phases is not None:
            # a phase row exists only for a sampled dispatch that reached
            # its retire (a crash drops the in-flight record); the read back
            # runs from the end of the device window to the outputs on the
            # host, so the parts tile the step's wall but for the window's
            # device time against the host's clock
            phases["readback_ms"] = (done_ts - inflight["ready_ts"]) * 1000
            phases["emit_ms"] = (emit_done_ts - done_ts) * 1000
            phases["total_ms"] = (emit_done_ts - inflight["build_ts"]) * 1000
            self._observe_phases(phases)
        k = inflight["k"]
        cost = None
        if self.config.cost_analysis:
            cost = step_cost(self.model_config, "decode", inflight["B"], k,
                             inflight["contexts"], self._weight_dtype(),
                             self._kv_dtype(), page_size=self.config.page_size,
                             compute_dtype=self.config.dtype)
        kind = "decode_fb" if inflight["fed"] else "decode"
        if k != self.config.fused_steps:
            kind += f"@k{k}"
        mfu, hbm_frac = self._observe_roofline(kind, inflight["B"], inflight["ctx_pages"],
                                               step_wall_ms, cost)
        self._gap_window.append((inflight["gap_s"], decode_elapsed_ms / 1000))
        self._record_step("decode", batch=inflight["batch"], width=inflight["B"],
                          dur_ms=decode_elapsed_ms, tokens=emitted,
                          ctx_pages=inflight["ctx_pages"],
                          gap_ms=inflight["gap_s"] * 1000, phases=phases, mfu=mfu,
                          hbm_frac=hbm_frac, superstep=k, frozen=int(done.sum()),
                          wall_ms=step_wall_ms)
        if self.metrics is not None:
            self.metrics.llm_device_idle_frac.labels(
                replica=self.config.replica_id).set(self.device_idle_fraction())

    def _graph_body(self, bufs: DecodeBuffers) -> None:
        """One dispatch over a key's static buffers: what each graph holds."""
        kind, K, _, sampled = bufs.key
        if kind == "verify":
            tokens, logits = self._verify_and_sample(*bufs.verify_views(),
                                                     any_sampled=sampled)
            bufs.outputs.copy_(tokens.t())
            bufs.logits.copy_(logits)
            return
        tokens, valid, done, logits = self._decode_and_sample(
            *bufs.views(), k=K, any_sampled=sampled)
        bufs.outputs[:K].copy_(tokens)
        bufs.outputs[K:2 * K].copy_(valid)
        bufs.outputs[2 * K].copy_(done)
        bufs.logits.copy_(logits)

    def _decode_and_sample(self, tokens: torch.Tensor, positions: torch.Tensor,
                           seq_lens: torch.Tensor, budgets: torch.Tensor,
                           stop_tbl: torch.Tensor, sampling: SamplingParams,
                           slot_ids: torch.Tensor, k: int, any_sampled: bool
                           ) -> tuple[torch.Tensor, ...]:
        """One decode SUPER-STEP: k decode iterations unrolled, each writing
        its input token's KV, attending and sampling, with per-row budgets
        and stop ids masking on the device so a finished row freezes (no
        KV write after its last token, no advance). Columns with seq_len 0
        (empty or chunking slots) never write.

        Returns (tokens [k, B], valid [k, B] bool, done [B] bool, the last
        iteration's logits [B, V]): valid marks the tokens to emit."""
        active = seq_lens > 0
        done = torch.zeros_like(active)
        prev_valid = active
        out_tokens, out_valid = [], []
        for j in range(k):
            # iteration j writes the KV of its input token (sampled at j - 1,
            # or fed at j = 0): the write mask trails validity by one
            write = active & prev_valid & ~done
            logits, self.kv = decode_step(
                self.params, self.model_config, tokens, positions, self.kv,
                slot_ids, seq_lens, write_mask=write, mesh=self._mesh)
            self._note_written(tokens, positions, write)
            sampled = self._sample(logits, sampling, any_sampled)
            valid = active & ~done & (j < budgets)
            done = done | (valid & (sampled[:, None] == stop_tbl).any(dim=1))
            positions = torch.where(valid, positions + 1, positions)
            seq_lens = torch.where(valid, seq_lens + 1, seq_lens)
            prev_valid, tokens = valid, sampled
            out_tokens.append(sampled)
            out_valid.append(valid)
        return torch.stack(out_tokens), torch.stack(out_valid), done, logits

    def _sync_tables(self) -> None:
        """Upload the block table when the allocator changed a row: a
        non-blocking copy from page-locked memory on the card, ordered on
        the dispatch thread's stream before the next device call. (Every
        device call of the engine runs on that one stream, the current
        one, so eager prefill reuses the allocator's cached blocks as it
        did before decode moved to graphs.)"""
        if self.allocator.dirty:
            rows = self.allocator.dirty_rows() if self.world > 1 else ()
            table = self.allocator.tables(pin=self.device.type == "cuda")
            self.kv.block_tables.copy_(table, non_blocking=True)
            for row in rows:   # for the followers, with the next call
                self._table_rows[row] = table[row].numpy().copy()

    # -------------------------------------------------------------- telemetry

    def _ctx_pages(self, tokens: int) -> int:
        """Pages covering ``tokens`` (the ring's context width of a step)."""
        return -(-tokens // self.config.page_size)

    def _weight_dtype(self) -> str:
        return "int8" if self.config.quant else self.config.dtype

    def _kv_dtype(self) -> str:
        return "int8" if self.config.kv_quant else self.config.dtype

    def device_idle_fraction(self) -> float:
        """Share of recent decode wall the device waited on the host:
        dispatch gaps / (gaps + in-step wall)."""
        gaps = walls = 0.0
        for gap_s, wall_s in list(self._gap_window):   # the loop side reads too
            gaps += gap_s
            walls += wall_s
        total = gaps + walls
        return gaps / total if total > 0 else 0.0

    def _phase_sample_due(self) -> bool:
        """True when the next decode dispatch takes the timed window (every
        Nth; 0 turns it off)."""
        n = self.config.step_sample_every
        return n > 0 and self._dispatch_count % n == 0

    def _observe_phases(self, phases: dict[str, float]) -> None:
        """Publish one sampled step's phase row: the counter, the phase
        histogram, and the events llm.decode spans carry."""
        self.stats.phase_samples += 1
        self._phase_events.append((time.time(), dict(phases)))
        if self.metrics is not None:
            rid = self.config.replica_id
            for key, dur_ms in phases.items():
                if key == "total_ms":
                    continue
                self.metrics.llm_step_phase.labels(
                    replica=rid, phase=key[:-3]).observe(max(0.0, dur_ms / 1e3))

    def _observe_roofline(self, kind: str, width: int, ctx_pages: int,
                          dur_ms: float, cost: CostEntry | None
                          ) -> tuple[float | None, float | None]:
        """One step's cost (``roofline.step_cost``) over its wall: the
        registry entry, the snapshot window and the mfu / HBM gauges.
        (None, None) with no cost (``cost_analysis`` off) or no wall."""
        if cost is None or dur_ms <= 0:
            return None, None
        self.cost_registry.record(kind, width, ctx_pages, cost.flops,
                                  cost.bytes_accessed)
        dur_s = dur_ms / 1e3
        mfu, frac = roofline_fractions(cost.flops, cost.bytes_accessed, dur_s, self.world,
                                       self.config.peak_tflops_per_chip,
                                       self.config.hbm_gbps_per_chip)
        self._roofline_window.append((cost.flops, cost.bytes_accessed, dur_s))
        if self.metrics is not None:
            rid = self.config.replica_id
            self.metrics.llm_mfu.labels(replica=rid).set(mfu)
            self.metrics.llm_hbm_roofline.labels(replica=rid).set(frac)
        return mfu, frac

    def roofline_snapshot(self) -> dict[str, Any]:
        """The roofline over the recent decode and verify window: summed
        FLOPs and bytes over summed step walls, against the world's peak
        (``world`` devices x one H100's, the JAX engine's ``mesh.size``; a
        multi-rank engine reports its ``world``)."""
        flops = byts = dur = 0.0
        window = list(self._roofline_window)
        for f, b, d in window:
            flops += f
            byts += b
            dur += d
        out: dict[str, Any] = {"window_steps": len(window),
                               "cost_entries": self.cost_registry.counts()}
        if self._ranks is not None:
            out["world"] = self.world
        if dur > 0:
            mfu, frac = roofline_fractions(flops, byts, dur, self.world,
                                           self.config.peak_tflops_per_chip,
                                           self.config.hbm_gbps_per_chip)
            out["mfu"] = round(mfu, 12)
            out["hbm_roofline_frac"] = round(frac, 12)
        return out

    def _on_kernel_event(self, stage: str, duration_s: float, kind: str) -> None:
        """CompileTracker callback, on whichever thread built or captured:
        the compile counters (the JAX engine's families), and for a
        serving-stage event a span (``llm.kernel_build`` or
        ``llm.graph_capture``) beside the request traces it stalled."""
        rid = self.config.replica_id
        if self.metrics is not None:
            self.metrics.llm_xla_compiles.labels(replica=rid, stage=stage).inc()
            self.metrics.llm_xla_compile_time.labels(replica=rid).observe(duration_s)
        if stage == "serving" and self.tracer is not None:
            now = time.time()
            self.tracer.emit_span(f"llm.{kind}", now - duration_s, now,
                                  attributes={"gen_ai.request.model": self.config.model,
                                              "llm.replica_id": rid,
                                              "llm.compile_stage": stage})

    def compile_stats(self) -> dict[str, Any]:
        """Kernel builds and graph captures by stage: counts, times, the
        recent events."""
        return self.compile_tracker.snapshot()

    def _record_step(self, kind: str, *, batch: int, width: int,
                     dur_ms: float, tokens: int, bucket: int | None = None,
                     ctx_pages: int | None = None,
                     gap_ms: float | None = None,
                     phases: dict[str, float] | None = None,
                     mfu: float | None = None,
                     hbm_frac: float | None = None,
                     superstep: int | None = None,
                     frozen: int | None = None,
                     wall_ms: float | None = None) -> None:
        """One ring entry and the gauge refresh, per dispatch (the JAX
        engine's keys). ``ctx_pages`` is the pages covering the longest
        row's context (the port has no context-width buckets)."""
        self._step_seq += 1
        depth = self._work.qsize() + len(self._pending)
        pages_in_use = self.allocator.pages_in_use
        self.step_log.append({
            "seq": self._step_seq,
            "ts": time.time(),
            "kind": kind,                       # prefill|chunk_prefill|decode|spec_decode
            "batch": batch,                     # rows carrying real work
            "width": width,                     # dispatch width
            "bucket": bucket,                   # prefill token bucket (S)
            "ctx_pages": ctx_pages,
            "duration_ms": round(dur_ms, 3),
            "tokens": tokens,                   # tokens emitted by this step
            "superstep": superstep,             # decode iterations fused
            "frozen": frozen,                   # rows the device froze
            "queue_depth": depth,
            "kv_pages_in_use": pages_in_use,
            "gap_ms": round(gap_ms, 3) if gap_ms is not None else None,
            "phases": ({k: round(v, 3) for k, v in phases.items()}
                       if phases is not None else None),
            "mfu": round(mfu, 12) if mfu is not None else None,
            "hbm_frac": round(hbm_frac, 12) if hbm_frac is not None else None,
        })
        if self._ranks is not None:
            self.step_log[-1]["world"] = self.world   # the devices the step ran on
        if kind in ("decode", "spec_decode") and superstep is not None and tokens:
            self._tpd_ewma = (float(tokens) if self._tpd_ewma is None
                              else _TPD_EWMA_ALPHA * tokens
                              + (1.0 - _TPD_EWMA_ALPHA) * self._tpd_ewma)
        m = self.metrics
        if m is not None:
            rid = self.config.replica_id
            m.llm_batch_occupancy.labels(replica=rid).set(
                len(self._running) + len(self._chunking))
            m.llm_kv_pages_in_use.labels(replica=rid).set(pages_in_use)
            m.llm_kv_page_utilization.labels(replica=rid).set(
                pages_in_use / max(1, self.num_kv_pages - 1))
            m.llm_kv_bytes_in_use.labels(replica=rid).set(self.kv_bytes_in_use())
            m.llm_queue_depth.labels(replica=rid).set(depth)
            # tokens/s over the step's own wall (retire to retire)
            rate_ms = wall_ms if wall_ms is not None else dur_ms
            if rate_ms > 0 and tokens:
                m.llm_step_tokens_per_sec.labels(replica=rid).set(tokens / (rate_ms / 1e3))
            if superstep is not None and tokens:
                m.llm_tokens_per_dispatch.labels(replica=rid).set(tokens)
                if self._tpd_ewma is not None:
                    m.llm_tokens_per_dispatch_ewma.labels(replica=rid).set(self._tpd_ewma)
            if self._tier_client is not None:
                self._export_tier_metrics(m, rid)
        if kind in ("decode", "spec_decode"):
            self._publish_signals(tokens=tokens, depth=depth, mfu=mfu,
                                  hbm_frac=hbm_frac, gap_ms=gap_ms,
                                  wall_ms=wall_ms if wall_ms is not None else dur_ms)

    def _publish_signals(self, *, tokens: int, depth: int,
                         mfu: float | None, hbm_frac: float | None,
                         gap_ms: float | None, wall_ms: float | None) -> None:
        """Push one decode or verify dispatch's signals onto the bus (a
        serving controller's inputs); the O(window) idle share goes out at
        most every 0.25 s."""
        bus = self.signals
        if bus is None:
            return
        rid = self.config.replica_id
        if tokens:
            bus.publish("llm.tokens_per_dispatch", tokens, rid)
        if mfu is not None:
            bus.publish("llm.mfu", mfu, rid)
        if hbm_frac is not None:
            bus.publish("llm.hbm_roofline_frac", hbm_frac, rid)
        if gap_ms is not None:
            bus.publish("llm.dispatch_gap_ms", gap_ms, rid)
        if wall_ms is not None and wall_ms > 0 and tokens:
            bus.publish("llm.step_tokens_per_sec", tokens / (wall_ms / 1e3), rid)
        bus.publish("llm.saturation", depth / max(1, self.config.max_queue), rid)
        bus.publish("llm.occupancy", (len(self._running) + len(self._chunking))
                    / max(1, self.config.max_batch), rid)
        now = time.monotonic()
        if now - self._signals_slow_ts >= 0.25:
            self._signals_slow_ts = now
            bus.publish("llm.idle_frac", self.device_idle_fraction(), rid)

    def _export_tier_metrics(self, m, rid: str) -> None:
        """The per-tier prefix families, with each step's gauges: hit
        counts as deltas of the allocator's consume-site totals, bytes
        resident in the pool and the store's host/disk/object footprint
        (a shared store: every replica reports the same number)."""
        alloc = self.allocator
        for tier, count in alloc.tier_hits.items():
            prev = self._tier_hits_exported.get(tier, 0)
            if count > prev:
                m.llm_prefix_tier_hits.labels(replica=rid, tier=tier).inc(count - prev)
                self._tier_hits_exported[tier] = count
        m.llm_prefix_tier_bytes.labels(replica=rid, tier="hbm").set(
            alloc.cached_pages * self._kv_page_bytes)
        store = self._tier_client.store
        if store is not None:
            s = store.stats()
            m.llm_prefix_tier_bytes.labels(replica=rid, tier="host").set(s["host_bytes"])
            m.llm_prefix_tier_bytes.labels(replica=rid, tier="disk").set(s["disk_bytes"])
            if "object_bytes" in s:
                m.llm_prefix_tier_bytes.labels(replica=rid, tier="object").set(
                    s["object_bytes"])

    def tier_stats(self) -> dict[str, Any] | None:
        """The tiered prefix cache's snapshot: the per-tier hit split (at
        the consume site: it sums to prefix_hit_tokens), spill and restore
        counts with the restore p95, and the store's footprint per tier.
        None when no tier client is wired."""
        if self._tier_client is None:
            return None
        out = self._tier_client.stats()
        out["enabled"] = self._tier_client.store is not None
        out["hits"] = dict(self.allocator.tier_hits)
        out["hit_tokens"] = dict(self.allocator.tier_hit_tokens)
        return out

    def recent_steps(self, limit: int | None = None) -> list[dict[str, Any]]:
        """The last ``limit`` (all) step summaries, oldest first."""
        steps = list(self.step_log)
        if limit is not None and limit > 0:
            steps = steps[-limit:]
        return steps

    def _span(self, name: str, request: GenRequest, start_ts: float,
              end_ts: float, status: str = "OK",
              events: list[tuple[float, str, dict[str, Any]]] | None = None,
              **attrs: Any) -> None:
        """One per-request engine span, parented to the submitter's
        llm.request span (the dispatch thread has no contextvars)."""
        if self.tracer is None or request.trace_ctx is None:
            return
        attributes: dict[str, Any] = {
            "gen_ai.system": "tpu_local",
            "gen_ai.request.model": self.config.model,
            "llm.replica_id": self.config.replica_id,
            "llm.slot": request.slot,
        }
        if request.tenant:
            attributes["llm.tenant"] = request.tenant
        attributes.update(attrs)
        try:
            self.tracer.emit_span(name, start_ts, end_ts, trace_ctx=request.trace_ctx,
                                  attributes=attributes, status=status, events=events)
        except Exception:
            logger.exception("span %s not emitted", name)   # never kill the loop

    def _tenant_label(self, request: GenRequest) -> str:
        """The registry's clamped tenant label of a request."""
        return self.metrics.tenant_clamp.label(request.tenant)

    def _exemplar(self, metric: str, value: float, request: GenRequest,
                  labels: tuple = ()) -> dict[str, str] | None:
        """A trace-id exemplar for a latency observation (None when the
        request has no trace)."""
        if self.metrics is None or request.trace_ctx is None:
            return None
        return self.metrics.exemplar(metric, value, request.trace_ctx[0], labels)

    def _observe_admitted(self, request: GenRequest) -> None:
        """Queue-phase telemetry when a request wins a slot."""
        if request.queue_observed:
            return  # re-admitted after crash recovery
        request.queue_observed = True
        if self.metrics is not None:
            wait_s = max(0.0, request.queue_ms / 1e3)
            tenant = self._tenant_label(request)
            self.metrics.llm_queue_wait.labels(tenant=tenant).observe(
                wait_s, exemplar=self._exemplar("llm_queue_wait", wait_s,
                                                request, (tenant,)))
        if self.signals is not None:
            self.signals.publish("llm.queue_wait_ms", max(0.0, request.queue_ms),
                                 self.config.replica_id)
        self._span("llm.queue", request, request.created, time.time(),
                   **{"llm.queue_ms": round(request.queue_ms, 2),
                      "llm.priority": request.priority})

    def _observe_finish(self, request: GenRequest) -> None:
        """Decode-phase telemetry when a request leaves the engine (before
        its slot is freed: its pages are still held): TPOT, the KV
        residency the ledger bills, the llm.decode span with the sampled
        phase rows of its decode window as events."""
        now = time.time()
        n = len(request.generated)
        decode_start = request.first_token_ts or now
        if self.metrics is not None and n > 1:
            tpot_s = max(0.0, (now - decode_start) / (n - 1))
            tenant = self._tenant_label(request)
            labels = (self.config.model, self.config.replica_id, tenant)
            self.metrics.llm_tpot.labels(
                model=self.config.model, replica=self.config.replica_id,
                tenant=tenant).observe(
                tpot_s, exemplar=self._exemplar("llm_tpot", tpot_s, request, labels))
        if self.signals is not None and n > 1:
            self.signals.publish("llm.tpot_ms",
                                 max(0.0, (now - decode_start) / (n - 1)) * 1e3,
                                 self.config.replica_id)
        if self.ledger is not None and request.slot >= 0:
            admitted_ts = request.created + request.queue_ms / 1e3
            self.ledger.add(request.tenant, kv_page_seconds=(
                self.allocator.slot_pages(request.slot) * max(0.0, now - admitted_ts)))
        reason = request.finish_reason or "stop"
        phase_events = [(ts, "decode.step.phases", attrs)
                        for ts, attrs in list(self._phase_events)
                        if ts >= decode_start][-8:]
        self._span("llm.decode", request, decode_start, now,
                   status="OK" if reason in ("stop", "length") else "ERROR",
                   events=phase_events or None,
                   **{"gen_ai.usage.completion_tokens": n,
                      "llm.finish_reason": reason,
                      "llm.kv_pages": self.allocator.slot_pages(request.slot)})

    def kv_bytes_in_use(self) -> int:
        """Device bytes of the pages in use, in the pool's storage."""
        return self.allocator.pages_in_use * self._kv_page_bytes

    def kv_bytes_capacity(self) -> int:
        """Device bytes of the whole KV pool (fixed at construction)."""
        return self.num_kv_pages * self._kv_page_bytes

    # --------------------------------------------------------------- emission

    def _emit(self, request: GenRequest, token: int) -> None:
        request.generated.append(token)
        self.stats.completion_tokens += 1
        if self.ledger is not None:
            # the same site as stats.completion_tokens
            self.ledger.add(request.tenant, generated_tokens=1)
        if request.first_token_ts == 0.0:
            request.first_token_ts = time.time()
            if not request.ttft_observed:
                self._observe_first_token(request)
        stop = token == self.tokenizer.eos_id or token in request.stop_ids
        done = stop or len(request.generated) >= request.max_tokens
        if done and request.finish_reason is None:
            request.finish_reason = "stop" if stop else "length"
        if done:
            self._observe_finish(request)   # before free_slot: pages still held
            self._running.pop(request.slot, None)
            self.allocator.free_slot(request.slot)
        self._post_tokens(request, [token], done=done)

    def _observe_first_token(self, request: GenRequest) -> None:
        """TTFT (signal and histogram) and the llm.prefill span, once per
        request."""
        request.ttft_observed = True
        ttft_s = max(0.0, request.first_token_ts - request.created)
        if self.signals is not None:
            self.signals.publish("llm.ttft_ms", ttft_s * 1e3, self.config.replica_id)
        if self.metrics is not None:
            tenant = self._tenant_label(request)
            labels = (self.config.model, self.config.replica_id, tenant)
            self.metrics.llm_ttft.labels(
                model=self.config.model, replica=self.config.replica_id,
                tenant=tenant).observe(
                ttft_s, exemplar=self._exemplar("llm_ttft", ttft_s, request, labels))
        self._span("llm.prefill", request, request.created + request.queue_ms / 1e3,
                   request.first_token_ts,
                   **{"gen_ai.usage.prompt_tokens": len(request.prompt_ids),
                      "llm.prefill_ms": round(request.prefill_ms, 2),
                      "llm.bucket": request.bucket,
                      "llm.cached_prefix_tokens": request.hist,
                      "llm.chunked": request.chunked,
                      "llm.kv_pages": self.allocator.slot_pages(request.slot)})

    def _finish(self, request: GenRequest) -> None:
        self._observe_finish(request)
        self._running.pop(request.slot, None)
        self.allocator.free_slot(request.slot)
        self._post_tokens(request, [], done=True)

    def _post_tokens(self, request: GenRequest, tokens: list[int],
                     done: bool) -> None:
        """Queue tokens for the consumer; posts merge per request and reach
        the loop in one hop per step (``_flush_emits``)."""
        buf = self._emit_buf
        if buf and buf[-1][0] is request and not buf[-1][2]:
            buf[-1][1].extend(tokens)
            buf[-1][2] = done
        else:
            buf.append([request, list(tokens), done])

    def _flush_emits(self) -> None:
        if not self._emit_buf:
            return
        batch, self._emit_buf = self._emit_buf, []

        def _put() -> None:
            for request, tokens, done in batch:
                for token in tokens:
                    request.stream.put_nowait(token)
                if done:
                    request.stream.put_nowait(None)

        loop = self._loop
        if loop is not None and not loop.is_closed():
            try:
                loop.call_soon_threadsafe(_put)
                return
            except RuntimeError:
                pass  # loop shut down mid-flight
        _put()
