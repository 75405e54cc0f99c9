"""One process per device for a multi-rank engine (``EngineConfig.mesh_shape``).

This module has no counterpart in the JAX package. The JAX engine is one
SPMD controller: one process drives every device of its mesh, and GSPMD
places each sharded array and inserts the collectives. PyTorch has no such
controller, so a port engine over N devices is N processes, one per
device:

- **Rank 0** is the engine the caller built: the asyncio front, the
  scheduler, the page allocator and the prefix cache. It starts the N - 1
  followers (``python -m mcp_context_forge_tpu_torch.tpu_local.ranks``),
  one per device of the engine's ``devices``, and they rendezvous on
  127.0.0.1 at a free port.
- **A follower** builds the same weights shard, KV shard and decode graphs
  as rank 0 (``TorchEngine`` with ``_rank``), then runs every device call
  rank 0 announces, in the order rank 0 runs it (``TorchEngine.follow``):
  a prefill batch, a chunk round or a prefix hit, a decode dispatch or
  verify (a graph replay on the card), a KV reset.
- **The groups are the engine's own.** Rank 0 hosts a private
  ``TCPStore`` at a free port, and every rank builds the engine's process
  groups on it (``parallel/mesh.py`` ``ServingMesh``, ``private_group``)
  without ``init_process_group``: the default group is never touched, so
  one process can hold several multi-rank engines (a pool's replicas, each
  with its rank 0 in the pool's process).
- **The data plane** is NCCL on CUDA devices and gloo on the CPU: the
  forward's all-reduces and all-gathers, the sequence-parallel attention,
  the sampled tokens' broadcast and the spill tiers' page transfers. On
  the card the decode step's collectives run inside the captured decode
  graphs.
- **The control plane** is a gloo group over every rank. Rank 0 broadcasts
  one small descriptor per device call (``announce``): the call, its host
  inputs (a staged input pack, a prefill's rows, the sampling rows, a
  spilled or restored page's index) and the block-table rows the allocator
  changed since the last call, which a follower writes into its own table
  before it runs the call.
- **The same tokens on every rank.** Every rank samples its own gathered
  logits with a generator seeded as rank 0's, and rank 0's tokens are then
  broadcast inside the step, so that every rank writes the KV of rank 0's
  tokens whatever its own draw was.
- **A follower that dies** is seen by a monitor thread, which marks the
  group failed (``failure``). Rank 0's next device call raises, or the
  gloo collective it is blocked in does (a dead peer's socket closes), so
  its streams end with the engine's ``error`` terminal. Its
  ``dispatch_alive`` turns false at once, and no restart runs over the
  dead rank. On the card the monitor also aborts the engine's NCCL
  communicators, meant to release a collective already running (inside a
  graph replay, which no watchdog tracks); that case has not been seen on
  the card. ``close`` ends every follower: a stop message, every rank
  leaving the groups together (the engine drops its graphs first, which
  hold the communicators), then a wait of up to the group timeout, then a
  kill. A group lives exactly as long as its engine's serving: a one-rank
  group (``"1x1"``: the rank path on one device) closes as a larger one
  does.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import pickle
import socket
import subprocess
import sys
import threading
import time
from datetime import timedelta
from typing import Any

import torch
import torch.distributed as dist

from .parallel.mesh import ServingMesh, mesh_shape_from_string, private_group
from .parallel.sharding import mesh_sizes

logger = logging.getLogger(__name__)

ROOT = 0
CONTROL_TIMEOUT = timedelta(days=7)
_CPU = torch.device("cpu")


def _abort_nccl(mesh: ServingMesh) -> None:
    try:
        mesh.abort()
    except Exception:
        logger.exception("multi-rank engine: aborting NCCL failed")


def group_timeout(config) -> float:
    """The groups' rendezvous and collective timeout, in seconds:
    ``init_timeout_s`` (0: 30 minutes)."""
    return config.init_timeout_s or 1800.0


def free_port() -> int:
    """A free TCP port on 127.0.0.1 (the rendezvous of one group)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _package_root() -> str:
    """The directory that holds the ``mcp_context_forge_tpu_torch`` package."""
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class RankGroup:
    """This process's place in a multi-rank engine: its rank, the world,
    the ``data`` x ``model`` mesh (rank r at (r // model, r % model)), the
    control group, and on rank 0 the follower processes."""

    def __init__(self, rank: int, world: int, shape: tuple[int, int], device: torch.device,
                 timeout_s: float, procs: list[subprocess.Popen] | None = None):
        self.rank, self.world, self.shape = rank, world, shape
        self.device = device
        self.timeout_s = timeout_s
        self.procs = procs or []
        self.store: dist.Store | None = None
        self.mesh: ServingMesh | None = None
        self.ctrl: dist.ProcessGroup | None = None
        self._failure: str | None = None
        self._poll_lock = threading.Lock()   # the monitor's and the dispatch thread's polls
        self._stopping = False
        self._closed = False
        self._monitor: threading.Thread | None = None
        self._aborting: threading.Thread | None = None

    @property
    def leader(self) -> bool:
        return self.rank == ROOT

    @property
    def coords(self) -> tuple[dict[str, int], dict[str, int]]:
        """(axis sizes, this rank's coordinates) of the mesh."""
        return mesh_sizes(self.mesh)

    # ------------------------------------------------------------ building

    @classmethod
    def lead(cls, config, model_config, devices: list[torch.device],
             params_mode: str) -> "RankGroup":
        """Rank 0: start a follower on each of ``devices[1:]`` and join the
        groups with them. ``params_mode``: how followers get their weights
        ("seed", "checkpoint", or "shipped" by ``send_params``)."""
        shape = mesh_shape_from_string(config.mesh_shape, len(devices))
        world = shape[0] * shape[1]
        port = free_port()
        args = json.dumps({
            "config": dataclasses.asdict(config),
            "model_config": dataclasses.asdict(model_config),
            "port": port, "shape": list(shape),
            "devices": [str(d) for d in devices], "params": params_mode,
            "threads": torch.get_num_threads()})
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_package_root(), env.get("PYTHONPATH", "")) if p)
        procs = []
        try:
            for rank in range(1, world):
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", __name__, "--rank", str(rank)],
                    stdin=subprocess.PIPE, env=env))
                procs[-1].stdin.write(args.encode())
                procs[-1].stdin.close()
            group = cls(ROOT, world, shape, devices[0], group_timeout(config), procs)
            group._join(port)
        except BaseException:
            for proc in procs:
                proc.kill()
                proc.wait()
            raise
        group._monitor = threading.Thread(target=group._watch, name="rank-monitor",
                                          daemon=True)
        group._monitor.start()
        return group

    @classmethod
    def follow(cls, rank: int, world: int, shape: tuple[int, int], port: int,
               device: torch.device, timeout_s: float) -> "RankGroup":
        group = cls(rank, world, shape, device, timeout_s)
        group._join(port)
        return group

    def _join(self, port: int) -> None:
        """Build the engine's groups on the store rank 0 hosts at ``port``:
        the mesh's data plane and the control group. A failure raises (the
        engine never falls back to fewer devices)."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        timeout = timedelta(seconds=self.timeout_s)
        self.store = dist.TCPStore("127.0.0.1", port, self.world, self.leader,
                                   timeout=timeout, wait_for_workers=False)
        self.mesh = ServingMesh(self.shape, self.rank, self.store, self.device, timeout)
        # a follower waits on the control group for as long as rank 0 is
        # idle; a dead peer still fails it at once (its socket closes)
        self.ctrl = private_group(self.store, "ctrl", self.rank, self.world, _CPU,
                                  CONTROL_TIMEOUT)

    def ready(self) -> None:
        """Every rank built: a barrier on the control group, so that rank
        0's first collective never waits on a follower's construction
        (which the data plane's timeout would count)."""
        if self.world > 1:
            dist.barrier(group=self.ctrl)

    # ----------------------------------------------------------- liveness

    def _poll(self) -> None:
        """Mark the group failed when a follower exited before ``close``;
        on the card, abort the NCCL communicators then, so that a collective
        already on the card (inside a graph replay, which no watchdog
        tracks) returns instead of waiting for the dead peer."""
        with self._poll_lock:
            for rank, proc in enumerate(self.procs, start=1):
                code = proc.poll()
                if code is None or self._stopping or self._failure is not None:
                    continue
                self._failure = f"follower rank {rank} exited with code {code}"
                logger.error("multi-rank engine: %s", self._failure)
                if self.device.type == "cuda":
                    # on a thread of its own: an abort may itself wait
                    self._aborting = threading.Thread(target=_abort_nccl, args=(self.mesh,),
                                                      name="rank-nccl-abort", daemon=True)
                    self._aborting.start()

    def _watch(self) -> None:
        """Rank 0's monitor thread."""
        while not self._stopping:
            self._poll()
            time.sleep(0.05)

    def failure(self, wait_s: float = 0.0) -> str | None:
        """Why the group can serve no more (a follower died), or None. With
        ``wait_s``, watch the followers that long first: a killed peer's
        socket closes (and fails a collective) before its exit lands."""
        deadline = time.monotonic() + wait_s
        while True:
            self._poll()
            if self._failure is not None or time.monotonic() >= deadline:
                return self._failure
            time.sleep(0.02)

    def check(self) -> None:
        if self._failure is not None:
            raise RuntimeError(f"multi-rank engine: {self._failure}")

    # ------------------------------------------------------------ control

    def announce(self, message: dict[str, Any]) -> None:
        """Rank 0: one device call's descriptor to every follower."""
        self.check()
        dist.broadcast_object_list([message], group=self.ctrl, group_src=ROOT)

    def receive(self) -> dict[str, Any]:
        """A follower: the next descriptor rank 0 announces."""
        box = [None]
        dist.broadcast_object_list(box, group=self.ctrl, group_src=ROOT)
        return box[0]

    def gather(self, value: Any) -> list[Any] | None:
        """Every rank's ``value`` on rank 0 (None on a follower)."""
        out = [None] * self.world if self.leader else None
        dist.gather_object(value, out, group=self.ctrl, group_dst=ROOT)
        return out

    def _send(self, buf: torch.Tensor, rank: int) -> None:
        """Host bytes to one rank over the control group (the group's own
        ``send``: the module-level one names global ranks)."""
        self.ctrl.send([buf], rank, 0).wait()

    def _recv(self, buf: torch.Tensor) -> None:
        self.ctrl.recv([buf], ROOT, 0).wait()

    def _send_object(self, value: Any, rank: int) -> None:
        data = torch.frombuffer(bytearray(pickle.dumps(value)), dtype=torch.uint8)
        self._send(torch.tensor([data.numel()], dtype=torch.int64), rank)
        self._send(data, rank)

    def _recv_object(self) -> Any:
        size = torch.empty(1, dtype=torch.int64)
        self._recv(size)
        data = torch.empty(int(size.item()), dtype=torch.uint8)
        self._recv(data)
        # bytes rank 0 of this engine pickled (_send_object)
        return pickle.loads(data.numpy().tobytes())

    def send_params(self, tree: Any, rank: int) -> None:
        """Rank 0: a follower's weights (its blocks of every leaf) over the
        control group: the tree's structure with each leaf's shape and
        dtype, then the leaves' host bytes in order."""
        leaves: list[torch.Tensor] = []

        def skeleton(node: Any) -> Any:
            if isinstance(node, dict):
                return {k: skeleton(v) for k, v in node.items()}
            if isinstance(node, list):
                return [skeleton(v) for v in node]
            leaves.append(node)
            return (tuple(node.shape), str(node.dtype).removeprefix("torch."))

        self._send_object(skeleton(tree), rank)
        for t in leaves:
            if t.numel():
                self._send(t.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8),
                           rank)

    def receive_params(self) -> Any:
        """A follower: its weights from rank 0 (``send_params``), in host
        memory."""
        skeleton = self._recv_object()

        def fill(node: Any) -> Any:
            if isinstance(node, dict):
                return {k: fill(v) for k, v in node.items()}
            if isinstance(node, list):
                return [fill(v) for v in node]
            shape, dtype = node
            t = torch.empty(shape, dtype=getattr(torch, dtype))
            if t.numel():
                buf = torch.empty(t.numel() * t.element_size(), dtype=torch.uint8)
                self._recv(buf)
                t = buf.view(t.dtype).reshape(shape)
            return t

        return fill(skeleton)

    # ------------------------------------------------------------ closing

    def abort(self) -> None:
        """End the group at once (a failed construction: the followers are
        not in their loop yet, so no stop message can reach them)."""
        self._failure = self._failure or "the construction failed"
        self.close()

    def close(self, digest: int | None = None) -> list[Any] | None:
        """End the group: rank 0 announces the stop, every rank's ``digest``
        is gathered (returned in rank order on rank 0, unless a follower
        died), and every rank shuts its groups down together (NCCL's
        teardown waits for all of them); rank 0 then waits up to the group
        timeout for the followers to exit, and kills what is left. After a
        failure the followers are killed at once, and on the card the broken
        NCCL communicators are aborted, not shut down (a shutdown could wait
        on the dead rank). Safe to call twice."""
        if self._closed:
            return None
        self._stopping = self._closed = True
        digests = None
        if self.world > 1 and self._failure is None:
            try:
                if self.leader:
                    self.announce({"op": "stop"})
                digests = self.gather(digest)
            except Exception:
                logger.exception("multi-rank engine: the stop message failed")
                self._failure = "the stop message failed"
        if self._failure is None or self.device.type != "cuda":
            try:
                self.mesh.shutdown()
                self.ctrl.shutdown()
            except Exception:
                logger.exception("multi-rank engine: tearing the groups down failed")
        elif self._aborting is None:
            _abort_nccl(self.mesh)
        if self._aborting is not None:
            self._aborting.join(self.timeout_s)   # the NCCL abort, before an exit
        deadline = time.monotonic() + (0.0 if self._failure else self.timeout_s)
        for proc in self.procs:
            try:
                proc.wait(max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                if not self._failure:
                    logger.error("multi-rank engine: killing a follower that did not stop")
                proc.kill()
                proc.wait()
        self.store = None   # rank 0's hosts the rendezvous: after every follower left
        return digests


def follower_main(argv: list[str] | None = None) -> int:
    """A follower process: its arguments as JSON on stdin (``RankGroup.lead``)."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rank", type=int, required=True)
    rank = parser.parse_args(argv).rank
    args = json.loads(sys.stdin.read())
    logging.basicConfig(level=logging.WARNING,
                        format=f"rank {rank}: %(levelname)s %(name)s: %(message)s")
    from .engine import EngineConfig, TorchEngine
    from .models import MODEL_CONFIGS, LlamaConfig

    torch.set_num_threads(args["threads"])   # rank 0's: ranks share the host's cores

    fields = args["config"]
    for name in ("prefill_buckets", "k_ladder"):
        fields[name] = tuple(fields[name])
    config = EngineConfig(**fields)
    model = LlamaConfig(**args["model_config"])
    MODEL_CONFIGS[model.name] = model   # exactly the config rank 0 built
    devices = [torch.device(d) for d in args["devices"]]
    parent = os.getppid()

    def orphaned() -> None:
        # rank 0's process is gone (even by SIGKILL): nothing will stop us
        while os.getppid() == parent:
            time.sleep(0.5)
        os._exit(1)

    threading.Thread(target=orphaned, name="rank-orphan-watch", daemon=True).start()
    engine = TorchEngine(config, devices=devices,
                         _rank=(rank, args["port"], tuple(args["shape"]), args["params"]))
    try:
        engine.follow()
    except Exception:
        # rank 0 is gone (its control socket closed): leave at once. An
        # orderly exit would tear down NCCL communicators whose peer died,
        # which can wait forever
        logger.exception("rank %d: the control group failed; exiting", rank)
        logging.shutdown()
        os._exit(1)
    return 0


if __name__ == "__main__":
    sys.exit(follower_main())
