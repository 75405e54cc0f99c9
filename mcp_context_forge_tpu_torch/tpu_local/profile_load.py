"""Where a checkpoint load's time goes on the card's host.

    python3 -m mcp_context_forge_tpu_torch.tpu_local.profile_load [--gib 4]

Run from the root of a checkout, on a machine with one CUDA card. Prints
one JSON line (the card's name and power limit as ``nvidia-smi`` gives
them), every rate in GB/s:

- the host's read of a ``--gib`` GiB file just written (so from the page
  cache) in 256 MiB reads: into a fresh buffer per read, into one reused
  buffer, into one pinned buffer;
- host-to-device copies of 256 MiB from pageable and from pinned memory;
- a read followed by its copy to the card, through a fresh pageable
  buffer per read (the first reader of ``tpu_local/checkpoint.py``)
  and through one pinned buffer (its ``Staging``);
- the port's own-format restore of a one-layer int8 Mixtral-8x7B tree
  (``save_params``/``load_params``), in seconds: ``expected_tree``, the
  first operation that runs on the meta device (what a skeleton built by
  ``init_params(..., "meta")`` pays once per process), the memory-mapped
  ``torch.load`` onto the card, and ``load_params`` whole.

Its files live under ``build/profile_load/`` and are deleted at the end.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]   # the checkout
CHUNK = 256 << 20


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--gib", type=int, default=4, help="size of the file read")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_load: CUDA is not available", file=sys.stderr)
        return 1
    from . import checkpoint
    from .models import MODEL_CONFIGS
    from .models.llama import init_params

    dev = torch.device("cuda", 0)
    work = ROOT / "build" / "profile_load"
    work.mkdir(parents=True, exist_ok=True)
    out: dict = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]}
    try:
        blob = work / "blob.bin"
        total = args.gib << 30
        reads = total // CHUNK

        def rate(name: str, fn, nbytes: int = total) -> None:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            fn()
            torch.cuda.synchronize()
            out[name] = nbytes / (time.monotonic() - t0) / 1e9

        data = torch.randint(0, 255, (CHUNK,), dtype=torch.uint8).numpy()

        def write():
            with open(blob, "wb") as fh:
                for _ in range(reads):
                    fh.write(data)

        rate("write", write)
        reused = torch.empty(CHUNK, dtype=torch.uint8)
        pinned = torch.empty(CHUNK, dtype=torch.uint8, pin_memory=True)

        def read(into, copy: bool = False):
            def run():
                with open(blob, "rb") as fh:
                    for _ in range(reads):
                        buf = into()
                        fh.readinto(buf.numpy())
                        if copy:
                            buf.to(dev)
            return run

        def fresh():
            return torch.frombuffer(bytearray(CHUNK), dtype=torch.uint8)

        rate("read_fresh_buffer", read(fresh))
        rate("read_reused_buffer", read(lambda: reused))
        rate("read_pinned_buffer", read(lambda: pinned))
        rate("h2d_pageable", lambda: [reused.to(dev) for _ in range(16)], 16 * CHUNK)
        rate("h2d_pinned", lambda: [pinned.to(dev) for _ in range(16)], 16 * CHUNK)
        rate("read_then_copy_fresh_pageable", read(fresh, copy=True))
        rate("read_then_copy_pinned", read(lambda: pinned, copy=True))
        blob.unlink()

        # the own format: a one-layer int8 Mixtral-8x7B tree
        cfg = dataclasses.replace(MODEL_CONFIGS["mixtral-8x7b"], n_layers=1,
                                  name="mixtral-8x7b-1-layers")
        MODEL_CONFIGS[cfg.name] = cfg
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             torch.bfloat16, dev, quant="int8")
        own = work / "own"
        checkpoint.save_params(str(own), params)
        del params
        torch.cuda.empty_cache()

        def seconds(name: str, fn):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            result = fn()
            torch.cuda.synchronize()
            out[name] = time.monotonic() - t0
            return result

        seconds("expected_tree_s", lambda: checkpoint.expected_tree(cfg, torch.bfloat16, "int8"))
        seconds("first_meta_op_s", lambda: torch.randn((8, 8), device="meta").abs().amax(dim=0))
        seconds("meta_op_again_s", lambda: torch.randn((8, 8), device="meta").abs().amax(dim=0))
        file = own / checkpoint.PARAMS_FILE
        tree = seconds("torch_load_mmap_to_card_s", lambda: torch.load(
            file, map_location=dev, weights_only=True, mmap=True))
        del tree
        seconds("load_params_s", lambda: checkpoint.load_params(
            str(own), cfg, dev, torch.bfloat16, quant="int8"))
        out["own_bytes"] = file.stat().st_size
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
