"""Decode and speculative-verify dispatches as CUDA-graph replays, with
static buffers and double-buffered host staging.

A dispatch is one of two kinds over B columns (slot = column), greedy-only
or sampling: a K-step decode super-step (key ("decode", K, B, sampled)),
or a speculative verify of K tokens per row through the history prefill
(key ("verify", K, B, sampled)). For every key the holder keeps

- the static device inputs, one int32 pack: decode [INPUT_ROWS, B]
  (tokens, positions, seq_lens, budgets, top_k, temperature and top_p as
  f32 bits, the stop table), verify [verify_rows(K), B] (temperature,
  top_k, top_p, then K rows of tokens and K of positions); the outputs,
  one int32 pack, decode [2K + 1, B] (tokens [K, B], valid [K, B], done
  [B]) and verify [K, B] (the token sampled at each position), and the
  logits in f32, decode the last sub-step's [B, V], verify every
  position's [B, K, V], all allocated outside any capture;
- two host staging slots for the inputs and two for the outputs
  (page-locked on the card), used in turn: a dispatch's slot is reused two
  dispatches of its key later, after its retire has read it;
- on the card, one captured ``torch.cuda.CUDAGraph``.

All graphs share one private memory pool: replays never overlap, and every
input and output lives outside the pool. Capture runs once, when the
holder is built: for each key an eager warm-up on a side stream first (it
loads every kernel module and creates every library handle and workspace
outside the pool), then the capture, then an upload of the executable
graph to the device (``cuGraphUpload``: without it the first replay
uploads, and the first decode step a server runs pays that; an upload
runs no node, so no page, buffer or generator changes). A failed capture,
upload or replay raises;
nothing falls back to eager decode or verify on the card. On the CPU no
graph is captured and each dispatch runs the same body eagerly, through
the plain versions of the kernels.

A dispatch (``launch``) uploads its staged inputs with one non-blocking
copy, optionally feeds the previous dispatch's last sampled tokens with one
device-to-device copy (the overlapped pipeline), replays, and enqueues a
non-blocking copy of the outputs into its staging slot followed by an
event; ``fetch`` (``fetch_verify``) waits on that event, never on the
stream. Everything runs
on the caller's current stream, whose order makes each output copy finish
before the next replay overwrites the outputs.

Captured kernels do not run at capture, and a replay does not run the
Python wrappers, so the wrappers' ``launches`` counts would read wrong both
ways: each capture's launches count apart (``ops.capturing``), are kept
per key as the graph's launches, and every replay adds them once.

On a multi-rank engine (``ranks.py``) the bodies hold the forward's
collectives and the sampled tokens' broadcast (NCCL on the card), captured
on every rank for the same keys; each graph keeps how many it holds
(``collectives``, counted in ``ops.capturing()`` as its launches are, so
that two engines' graphs coexist in one process). A follower
replays without reading its outputs back, so ``stage`` first waits on the
event of the slot it reuses: its staged inputs may still be in flight.

Each key's warm-up and capture is one ``graph_capture`` event
(``compile_events``) of the building thread. A ``timed`` launch brackets
the replay with two CUDA events on the same stream (outside the graph: a
capture may read nothing back), for the engine's sampled phase
attribution; ``window_device_ms`` then waits on the second.
"""

from __future__ import annotations

import ctypes
import time
from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from .compile_events import record_event
from .ops import COLLECTIVES, capturing, kernel_wrappers
from .sampling import SamplingParams

# rows of the int32 input pack
TOKENS, POSITIONS, SEQ_LENS, BUDGETS, TOP_K, TEMPERATURE, TOP_P, STOPS = range(8)
# stop-id columns the super-step's on-device freeze checks: column 0 is EOS,
# the rest a request's first stop ids (a request with more is still ended
# by the host at retire; its row just does not freeze early)
STOP_TBL_WIDTH = 4
INPUT_ROWS = STOPS + STOP_TBL_WIDTH
# rows of the int32 verify pack: the sampling rows, then K rows of tokens
# (row V_TOKENS + j: every column's j-th token) and K rows of positions
V_TEMPERATURE, V_TOP_K, V_TOP_P, V_TOKENS = range(4)


def verify_rows(K: int) -> int:
    return V_TOKENS + 2 * K


class GraphKey(NamedTuple):
    kind: str           # "decode" or "verify"
    k: int              # decode: steps per super-step; verify: tokens per row
    width: int          # columns
    sampled: bool       # some row samples (else greedy-only)


def neutral_inputs(key: GraphKey) -> np.ndarray:
    """An input pack of inactive columns: decode seq_len 0 (no KV write, no
    token), verify position -1 (padding: no KV write); greedy, top_p 1,
    no stop ids."""
    B = key.width
    if key.kind == "verify":
        pack = np.zeros((verify_rows(key.k), B), dtype=np.int32)
        pack[V_TOP_P] = np.ones(B, dtype=np.float32).view(np.int32)
        pack[V_TOKENS + key.k:] = -1
        return pack
    pack = np.zeros((INPUT_ROWS, B), dtype=np.int32)
    pack[TOP_P] = np.ones(B, dtype=np.float32).view(np.int32)
    pack[STOPS:] = -1
    return pack


def upload_graph(graph: torch.cuda.CUDAGraph, stream: torch.cuda.Stream) -> None:
    """Upload ``graph``'s executable to the device on ``stream`` through the
    driver's ``cuGraphUpload``, ordered behind the stream's work; raises on
    any error."""
    cuda = ctypes.CDLL("libcuda.so.1")
    result = cuda.cuGraphUpload(ctypes.c_void_p(graph.raw_cuda_graph_exec()),
                                ctypes.c_void_p(stream.cuda_stream))
    if result != 0:
        raise RuntimeError(f"cuGraphUpload failed with CUresult {result}")


@dataclass
class DecodeBuffers:
    key: GraphKey
    inputs: torch.Tensor                # the input pack, int32, device
    outputs: torch.Tensor               # the output pack, int32, device
    logits: torch.Tensor                # decode [B, V], verify [B, K, V]; f32, device
    slot_ids: torch.Tensor              # arange(B) int32, device
    staging_in: list[torch.Tensor]      # 2 x [INPUT_ROWS, B] int32, host
    staging_out: list[torch.Tensor]     # 2 x [2K + 1, B] int32, host
    events: list[Any]                   # 2 CUDA events (none on the CPU)
    graph: Any = None
    launches: dict[str, int] = field(default_factory=dict)   # per replay
    collectives: int = 0                # per replay (a multi-rank engine's)
    replays: int = 0                    # graph replays (none on the CPU)
    slot: int = 0                       # the staging slot of the next dispatch

    @property
    def k(self) -> int:
        return self.key.k

    def views(self) -> tuple:
        """Decode: (tokens, positions, seq_lens, budgets, stop_tbl [B, W],
        sampling, slot_ids): views of the input pack."""
        x = self.inputs
        sampling = SamplingParams(x[TEMPERATURE].view(torch.float32),
                                  x[TOP_K], x[TOP_P].view(torch.float32))
        return (x[TOKENS], x[POSITIONS], x[SEQ_LENS], x[BUDGETS],
                x[STOPS:].t(), sampling, self.slot_ids)

    def verify_views(self) -> tuple:
        """Verify: (tokens [B, K], positions [B, K], sampling, slot_ids);
        tokens and positions are copies, laid out row by row."""
        x, K = self.inputs, self.k
        sampling = SamplingParams(x[V_TEMPERATURE].view(torch.float32),
                                  x[V_TOP_K], x[V_TOP_P].view(torch.float32))
        return (x[V_TOKENS:V_TOKENS + K].t().contiguous(),
                x[V_TOKENS + K:V_TOKENS + 2 * K].t().contiguous(), sampling,
                self.slot_ids)


class DecodeGraphs:
    """The buffers of every key and, on the card, their graphs.

    ``body(buffers)`` runs one dispatch of ``buffers.key`` (a decode
    super-step over ``buffers.views()``, or a verify over
    ``buffers.verify_views()``) into ``buffers.outputs`` and
    ``buffers.logits``; ``generator`` is the sampler's, registered with
    every graph so that replays advance its offset instead of repeating
    one draw."""

    def __init__(self, body: Callable[[DecodeBuffers], None],
                 keys: list[GraphKey], device: torch.device,
                 vocab_size: int, generator: torch.Generator):
        self.body = body
        self.device = device
        self.on_card = device.type == "cuda"
        self.captures = 0
        self.pool_bytes = 0   # device memory the graphs' pool holds (card only)
        self.buffers: dict[GraphKey, DecodeBuffers] = {}
        # the timed window of the last ``timed`` launch: the host's clock
        # at the replay, and on the card two CUDA events around it
        self.window_ts = 0.0
        self._window_events = ([torch.cuda.Event(enable_timing=True) for _ in range(2)]
                               if self.on_card else [])

        def host(t: torch.Tensor) -> torch.Tensor:
            return t.pin_memory() if self.on_card else t

        for key in keys:
            K, B, verify = key.k, key.width, key.kind == "verify"
            out_rows = K if verify else 2 * K + 1
            logits = (B, K, vocab_size) if verify else (B, vocab_size)
            self.buffers[key] = DecodeBuffers(
                key=key,
                inputs=torch.from_numpy(neutral_inputs(key)).to(device),
                outputs=torch.zeros((out_rows, B), dtype=torch.int32, device=device),
                logits=torch.zeros(logits, dtype=torch.float32, device=device),
                slot_ids=torch.arange(B, dtype=torch.int32, device=device),
                staging_in=[host(torch.from_numpy(neutral_inputs(key))) for _ in range(2)],
                staging_out=[host(torch.zeros((out_rows, B), dtype=torch.int32))
                             for _ in range(2)],
                events=[torch.cuda.Event() for _ in range(2)] if self.on_card else [])
        if self.on_card:
            self._capture(generator)

    @property
    def static_bytes(self) -> int:
        """Device bytes of the static inputs and outputs of every key."""
        return sum(t.numel() * t.element_size() for bufs in self.buffers.values()
                   for t in (bufs.inputs, bufs.outputs, bufs.logits, bufs.slot_ids))

    def _capture(self, generator: torch.Generator) -> None:
        """Warm up and capture every key on a side stream. Other engines of
        the process (a pool's replicas) may serve meanwhile, so nothing here
        reaches beyond this thread and its streams: captures run in
        ``thread_local`` error mode (another thread's syncs and allocations
        do not invalidate them), their launches count in ``capturing()``
        instead of the wrappers' shared counts, and the host waits on this
        stream, never on the device. The one process-wide call kept is the
        cuBLAS workspace reset around each capture (below)."""
        pool = torch.cuda.graph_pool_handle()
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.inference_mode(), torch.cuda.stream(stream):
            for bufs in self.buffers.values():
                t0 = time.monotonic()
                with capturing():
                    # the warm-up: every kernel and handle built outside the
                    # pool; its launches count nowhere
                    self.body(bufs)
                stream.synchronize()
                graph = torch.cuda.CUDAGraph()
                graph.register_generator_state(generator)
                # cuBLAS keeps one workspace per (handle, stream) for the
                # process's life: dropped before the capture, the capture's
                # own comes from the pool, and dropped after, it stays the
                # pool's (where the replays use it) instead of outliving
                # the engine, as the warm-up stream's would. No stream- or
                # event-scoped call does this; a reset costs a serving
                # sibling one workspace allocation at its next eager GEMM
                # (its graphs keep the workspaces their captures took)
                torch._C._cuda_clearCublasWorkspaces()
                with capturing() as counts, torch.cuda.graph(
                        graph, pool=pool, stream=stream,
                        capture_error_mode="thread_local"):
                    self.body(bufs)
                torch._C._cuda_clearCublasWorkspaces()
                upload_graph(graph, stream)
                bufs.collectives = counts.pop(COLLECTIVES, 0)
                bufs.launches = counts
                bufs.graph = graph
                self.captures += 1
                record_event("graph_capture", time.monotonic() - t0)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        stream.synchronize()
        # the pool's segments: reserved for the replays, outside the
        # allocator's allocated bytes once the captures have ended
        self.pool_bytes = sum(
            seg["total_size"] for seg in torch.cuda.memory._snapshot()["segments"]
            if tuple(seg.get("segment_pool_id", ())) == tuple(pool))

    def release(self) -> None:
        """Drop every captured graph (a stopped multi-rank engine's): NCCL
        tears a communicator down only once no graph holds its collectives.
        A launch afterwards raises."""
        for bufs in self.buffers.values():
            bufs.graph = None

    def get(self, key: GraphKey) -> DecodeBuffers:
        bufs = self.buffers.get(key)
        if bufs is None:
            raise RuntimeError(f"no graph for {key}; captured: {sorted(self.buffers)}")
        return bufs

    def stage(self, key: GraphKey) -> np.ndarray:
        """The host input pack of ``key``'s next dispatch, reset to
        inactive columns, for the caller to fill."""
        bufs = self.get(key)
        if bufs.events:
            bufs.events[bufs.slot].synchronize()   # its last upload has landed
        pack = bufs.staging_in[bufs.slot].numpy()
        pack[:] = neutral_inputs(key)
        return pack

    def launch(self, key: GraphKey, feed: tuple | None = None,
               timed: bool = False) -> tuple:
        """Run ``key``'s dispatch on the staged inputs; ``feed`` (a handle
        of the previous, still in-flight decode dispatch) supplies the
        input tokens from its last sampled row; ``timed`` brackets the
        replay for ``window_device_ms``. Returns the handle ``fetch`` or
        ``fetch_verify`` takes."""
        bufs = self.get(key)
        slot = bufs.slot
        bufs.slot ^= 1
        bufs.inputs.copy_(bufs.staging_in[slot], non_blocking=True)
        if feed is not None:
            fed = self.buffers[feed[0]]
            bufs.inputs[TOKENS].copy_(fed.outputs[fed.k - 1])
        if timed:
            self.window_ts = time.monotonic()
            if self._window_events:
                self._window_events[0].record()
        if bufs.graph is not None:
            bufs.graph.replay()
            bufs.replays += 1
            wrappers = kernel_wrappers()
            for name, n in bufs.launches.items():
                wrappers[name].launches += n
        elif self.on_card:
            raise RuntimeError(f"graph {key} was not captured")
        else:
            self.body(bufs)
        if timed and self._window_events:
            self._window_events[1].record()
        bufs.staging_out[slot].copy_(bufs.outputs, non_blocking=True)
        if bufs.events:
            bufs.events[slot].record()
        return key, slot

    def window_device_ms(self) -> float:
        """The last timed launch's device time: on the card, the CUDA
        events' interval, after one wait on the second event; on the CPU,
        where the body ran eagerly, the host's wall since the replay
        began."""
        if self._window_events:
            start, end = self._window_events
            end.synchronize()
            return start.elapsed_time(end)
        return (time.monotonic() - self.window_ts) * 1000

    def _outputs(self, handle: tuple) -> np.ndarray:
        """A dispatch's host output pack, once its copy has landed."""
        key, slot = handle
        bufs = self.buffers[key]
        if bufs.events:
            bufs.events[slot].synchronize()
        return bufs.staging_out[slot].numpy()

    def fetch(self, handle: tuple) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Wait for a decode dispatch's outputs: (tokens [K, B], valid
        [K, B] bool, done [B] bool) as host arrays of their own."""
        out = self._outputs(handle)
        K = handle[0].k
        return out[:K].copy(), out[K:2 * K] != 0, out[2 * K] != 0

    def fetch_verify(self, handle: tuple) -> np.ndarray:
        """Wait for a verify dispatch's sampled tokens: [B, K], a host
        array of its own."""
        return self._outputs(handle).T.copy()

    @property
    def replays(self) -> int:
        return sum(bufs.replays for bufs in self.buffers.values())
