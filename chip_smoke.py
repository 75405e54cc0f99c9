#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each printing one JSON line:

1. device: the card (nvidia-smi name and power limit); TF32 off.
2. build: nvcc builds the three attention kernels from ``csrc/`` for
   sm_90a, in parallel, into ``build/kernels/``.
3. kernels: each kernel against its plain PyTorch version at Llama-3-8B
   serving shapes in bf16 (atol = rtol = 2e-2 on the rows anyone reads: both
   sides accumulate in f32; the order of the sums and the bf16 rounding of
   the output differ), with CUDA-event times (median of 25 runs, L2 flushed
   before each) and each kernel's bound on this card.
4. model: a tiny f32 model on the card (kernels) against the same model on
   the CPU (plain versions): prefill, prefix-hit suffix prefill, decode.
5. engine: ``TorchEngine`` at the full width of llama3-8b (32 layers,
   seeded random weights, bf16) behind ``TorchLocalProvider.chat``: six
   concurrent greedy requests (two share a 300+ token system prompt, so the
   second hits the prefix cache; one is ~1500 tokens), then one request sent
   twice must give the same tokens. Every kernel's launch count is reset
   just before this phase and must be > 0 after it.

Then the card line, the kernel table (JSON), and last the contract line.
Any failure raises: the exit code is non-zero and the last line is absent.
Exits 1 at once when CUDA is not available.
"""

from __future__ import annotations

import asyncio
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

TOL = 2e-2
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet, dense peak
BF16_FLOPS_PER_S = 989e12     # H100 SXM data sheet, dense bf16 tensor cores
RUNS = 25


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


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from mcp_context_forge_tpu_torch.tpu_local.ops import _build
    from mcp_context_forge_tpu_torch.tpu_local.ops import attention as attn
    from mcp_context_forge_tpu_torch.tpu_local.ops import paged_attention as paged

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

    # --------------------------------------------------------------- kernels
    results = kernel_phase(torch, dev, attn, paged)
    torch.cuda.empty_cache()

    # ----------------------------------------------------------------- model
    model_check(torch, dev)

    # ---------------------------------------------------------------- engine
    launches, engine_stats = engine_phase(torch, dev, (attn, paged))
    emit({"phase": "engine", **engine_stats})

    replaces = {
        "flash_attention": "mcp_context_forge_tpu/tpu_local/ops/attention.py:88",
        "paged_chunk_attention": "mcp_context_forge_tpu/tpu_local/ops/paged_attention.py:148",
        "paged_decode_attention": "mcp_context_forge_tpu/tpu_local/ops/paged_attention.py:199",
    }
    table = []
    for name, tpu_kernel in replaces.items():
        r = results[name]
        table.append({
            "name": name, "route": "cuda",
            "source": f"mcp_context_forge_tpu_torch/tpu_local/csrc/{name}.cu",
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


def kernel_phase(torch, dev, attn, paged) -> dict:
    """Each kernel against its plain version at Llama-3-8B serving shapes
    in bf16; times, bounds. Returns the per-kernel results."""
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)

    def time_ms(fn) -> float:
        for _ in range(3):
            fn()
        times = []
        for _ in range(RUNS):
            flush.zero_()  # the real caller finds these pages cold in L2
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def compare(out, ref, rows) -> float:
        out, ref = out[rows].float(), ref[rows].float()
        check(torch.isfinite(out).all(), "non-finite kernel output")
        torch.testing.assert_close(out, ref, atol=TOL, rtol=TOL)
        return float((out - ref).abs().max())

    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    KV, G, hd, PAGE, NUM_PAGES, P = 8, 4, 128, 128, 512, 16
    H = KV * G

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(bf16)

    k_pages = randn(NUM_PAGES, PAGE, KV, hd)
    v_pages = randn(NUM_PAGES, PAGE, KV, hd)

    def tables_for(n_tokens: list[int]) -> torch.Tensor:
        tables = torch.zeros((len(n_tokens), P), dtype=torch.int32)
        nxt = 1
        for b, n in enumerate(n_tokens):
            pages = -(-n // PAGE)
            tables[b, :pages] = torch.arange(nxt, nxt + pages)
            nxt += pages
        check(nxt <= NUM_PAGES, "the test tables overflow the page pool")
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
    err = compare(out, ref, active)
    check(torch.count_nonzero(out[~active]) == 0, "seq_len 0 row is not zero")
    tokens = sum(seq_lens_list)
    nbytes = 2 * tokens * KV * hd * 2 + 2 * q.numel() * 2 + tables.numel() * 4 + 8 * 4
    results["paged_decode_attention"] = dict(
        shape={"q": list(q.shape), "pages": list(k_pages.shape),
               "seq_lens": seq_lens_list},
        max_abs_err=err,
        kernel_ms=time_ms(lambda: paged.paged_decode_attention(q, k_pages, v_pages, tables, seq_lens)),
        plain_ms=time_ms(lambda: paged.paged_decode_attention_ref(q, k_pages, v_pages, tables, seq_lens)),
        library_ms=None, bytes=nbytes, flops=4 * hd * G * KV * tokens)

    # chunk: a 128-query suffix over 2-6 history pages; row 3 is half padding
    hist_pages, S = [2, 3, 4, 6], 128
    n_valid = [128, 128, 128, 60]
    qc = randn(4, S, KV, G, hd)
    pos = torch.full((4, S), -1, dtype=torch.int32)
    for b, (hp, n) in enumerate(zip(hist_pages, n_valid)):
        pos[b, :n] = torch.arange(hp * PAGE, hp * PAGE + n)
    pos = pos.to(dev)
    ctables = tables_for([hp * PAGE + S for hp in hist_pages])
    out = paged.paged_chunk_attention(qc, k_pages, v_pages, ctables, pos)
    ref = paged.paged_chunk_attention_ref(qc, k_pages, v_pages, ctables, pos)
    torch.cuda.synchronize()
    valid = pos >= 0
    err = compare(out, ref, valid)
    keys = sum(int(p.max()) + 1 for p in pos)
    pairs = int((pos[valid].long() + 1).sum())
    nbytes = 2 * keys * KV * hd * 2 + 2 * qc.numel() * 2 + ctables.numel() * 4 + pos.numel() * 4
    results["paged_chunk_attention"] = dict(
        shape={"q": list(qc.shape), "pages": list(k_pages.shape),
               "history_pages": hist_pages, "valid_queries": n_valid},
        max_abs_err=err,
        kernel_ms=time_ms(lambda: paged.paged_chunk_attention(qc, k_pages, v_pages, ctables, pos)),
        plain_ms=time_ms(lambda: paged.paged_chunk_attention_ref(qc, k_pages, v_pages, ctables, pos)),
        library_ms=None, bytes=nbytes, flops=4 * hd * G * KV * pairs)

    # flash: B=4 at S=512 and S=2048, with padded rows
    flash_runs = []
    for S in (512, 2048):
        lens = [S, S - 37, S // 2 + 5, 1]
        qf, kf, vf = randn(4, S, H, hd), randn(4, S, KV, hd), randn(4, S, KV, hd)
        validf = torch.arange(S, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]
        out = attn.flash_attention(qf, kf, vf, validf)
        ref = attn.attention_reference(qf, kf, vf, validf)
        torch.cuda.synchronize()
        err = compare(out, ref, validf)
        del ref
        qt = qf.transpose(1, 2).contiguous()
        kt = kf.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
        vt = vf.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
        sdpa = torch.nn.functional.scaled_dot_product_attention
        pairs = sum(n * (n + 1) // 2 for n in lens)
        nbytes = (qf.numel() * 2 * 2 + kf.numel() * 2 * 2 + validf.numel())
        run = dict(
            shape={"q": list(qf.shape), "kv": list(kf.shape), "valid_lens": lens},
            max_abs_err=err,
            kernel_ms=time_ms(lambda: attn.flash_attention(qf, kf, vf, validf)),
            plain_ms=time_ms(lambda: attn.attention_reference(qf, kf, vf, validf)),
            library_ms=time_ms(lambda: sdpa(qt, kt, vt, is_causal=True)),
            bytes=nbytes, flops=4 * hd * H * pairs)
        flash_runs.append(run)
        del qt, kt, vt
    results["flash_attention"] = flash_runs[-1]
    for run in [results["paged_decode_attention"], results["paged_chunk_attention"]] + flash_runs:
        run["bound_ms"], run["bound_by"] = bound(run["bytes"], run["flops"])
    emit({"phase": "kernels", "tolerance": {"atol": TOL, "rtol": TOL},
          "decode": results["paged_decode_attention"],
          "chunk": results["paged_chunk_attention"],
          "flash": flash_runs})
    return results



def model_check(torch, dev) -> None:
    """A tiny f32 model, the same weights on the card (kernels) and on the
    CPU (plain versions): cold prefill, prefix-hit suffix prefill and decode
    logits agree within 1e-3 (f32 both sides; summation order differs)."""
    from mcp_context_forge_tpu_torch.tpu_local.kv import init_kv_state
    from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS
    from mcp_context_forge_tpu_torch.tpu_local.models import llama

    cfg = MODEL_CONFIGS["llama3-tiny"]
    params_cpu = llama.init_params(cfg, torch.Generator().manual_seed(0),
                                   torch.float32, "cpu")

    def to(tree, device):
        if isinstance(tree, dict):
            return {k: to(v, device) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, device) for v in tree]
        return tree.to(device)

    errs = {}
    outs = {}
    for device in ("cpu", dev):
        params = params_cpu if device == "cpu" else to(params_cpu, device)
        kv = init_kv_state(cfg, 16, 16, 2, 8, dtype=torch.float32, device=device)
        kv.block_tables.copy_(torch.tensor([[1, 2, 3, 4, 5, 6, 7, 8],
                                            [9, 10, 11, 12, 13, 14, 15, 0]],
                                           dtype=torch.int32))
        ids = torch.arange(2 * 96, dtype=torch.int64).reshape(2, 96) % cfg.vocab_size
        pos = torch.arange(64, dtype=torch.int32).repeat(2, 1)
        pos[1, 50:] = -1
        slots = torch.tensor([0, 1])
        a, _ = llama.prefill(params, cfg, ids[:, :64].to(device), pos.to(device),
                             kv, slots.to(device))
        hpos = torch.arange(64, 96, dtype=torch.int32).repeat(2, 1)
        hpos[1] = torch.arange(50, 82)
        b, _ = llama.prefill_with_history(params, cfg, ids[:, 64:].to(device),
                                          hpos.to(device), kv, slots.to(device))
        c, _ = llama.decode_step(params, cfg, ids[:, 0].to(device),
                                 torch.tensor([96, 82], dtype=torch.int32).to(device),
                                 kv, slots.to(device),
                                 torch.tensor([97, 83], dtype=torch.int32).to(device))
        valid = (pos >= 0)
        outs[str(device)] = (a[valid].cpu(), b.reshape(-1, b.shape[-1]).cpu(), c.cpu())
    cpu, card = outs["cpu"], outs[str(dev)]
    for name, x, y in zip(("prefill", "history", "decode"), card, cpu):
        check(torch.isfinite(x).all(), f"non-finite {name} logits on the card")
        torch.testing.assert_close(x, y, atol=1e-3, rtol=1e-3)
        errs[name] = float((x - y).abs().max())
    emit({"phase": "model", "config": cfg.name, "dtype": "float32",
          "max_abs_err": errs})


def engine_phase(torch, dev, modules):
    from mcp_context_forge_tpu_torch.tpu_local.engine import EngineConfig, TorchEngine
    from mcp_context_forge_tpu_torch.tpu_local.tpu_provider import TorchLocalProvider

    attn, paged = modules
    t0 = time.monotonic()
    engine = TorchEngine(EngineConfig(
        model="llama3-8b", dtype="bfloat16", device="cuda", max_batch=8,
        max_seq_len=2048, page_size=128, num_pages=512,
        prefill_buckets=(128, 512, 2048), prefill_max_batch=4, seed=0))
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    provider = TorchLocalProvider("tpu_local", engine)
    seen = []
    submit = engine.submit

    async def recording_submit(request):
        seen.append(request)
        return await submit(request)

    engine.submit = recording_submit
    system = ("You are the assistant of an MCP gateway. Use only the tools "
              "listed for this conversation and follow their JSON schemas exactly. "
              "Name the server that answered each tool call. Keep answers "
              "short and plain. Never invent a tool, a server or a result. "
              "When a tool fails, say which one failed and why, then stop. "
              "Ask before any call that writes, deletes or sends data. "
              "Prefer read-only tools when two tools can answer.")
    check(len(engine.tokenizer.encode(system)) >= 300,
          "the shared system prompt is under 300 tokens")

    def chat(user, system_prompt=None):
        messages = [{"role": "user", "content": user}]
        if system_prompt:
            messages.insert(0, {"role": "system", "content": system_prompt})
        return {"model": "llama3-8b", "max_tokens": 32, "temperature": 0,
                "messages": messages}

    long_doc = " ".join(f"line {i}: the tool returned status ok." for i in range(37))
    requests = [chat("Which tools can read files?", system),
                chat("Summarize the last failure.", system),
                chat("Summarize this log:\n" + long_doc),
                chat("Hello!"), chat("List three MCP servers."),
                chat("What is 2 + 2?")]

    async def run():
        await engine.start()
        try:
            for mod, name in ((attn, "flash_attention"),
                              (paged, "paged_chunk_attention"),
                              (paged, "paged_decode_attention")):
                getattr(mod, name).launches = 0
            torch.cuda.reset_peak_memory_stats()
            stats0 = dict(engine.stats.__dict__)
            t_start = time.monotonic()
            first = asyncio.ensure_future(provider.chat(requests[0]))
            while engine.allocator.cached_pages == 0:  # its prefix registered
                check(not first.done(), "the first request ended before its prefix registered")
                await asyncio.sleep(0.005)
            rest = [asyncio.ensure_future(provider.chat(r)) for r in requests[1:]]
            replies = await asyncio.wait_for(asyncio.gather(first, *rest), 600)
            wall = time.monotonic() - t_start
            counts = {"flash_attention": attn.flash_attention.launches,
                      "paged_chunk_attention": paged.paged_chunk_attention.launches,
                      "paged_decode_attention": paged.paged_decode_attention.launches}
            peak = torch.cuda.max_memory_allocated()
            served = list(seen)
            delta = {k: v - stats0[k] for k, v in engine.stats.__dict__.items()}
            for _ in range(2):
                await provider.chat(requests[3])
            return replies, wall, counts, peak, served, delta
        finally:
            await engine.stop()

    replies, wall, counts, peak, served, delta = asyncio.run(run())
    check(len(replies) == 6 and len(served) == 6, "not every request was served")
    for request in served:
        check(request.finish_reason in ("stop", "length"),
              f"a request ended with {request.finish_reason!r}")
        check(all(0 <= t < engine.model_config.vocab_size for t in request.generated),
              "a generated token id is outside the vocabulary")
    check(served[1].hist > 0 and engine.allocator.prefix_hits >= 1, "no prefix hit")
    check(served[2].bucket == 2048, f"the long prompt took bucket {served[2].bucket}")
    tokens_a, tokens_b = (seen[-2].generated, seen[-1].generated)
    check(tokens_a == tokens_b, "repeated greedy request changed its tokens")
    for name, n in counts.items():
        check(n > 0, f"{name} never launched on the main path")
    ttft = [(r.first_token_ts - r.created) * 1e3 for r in served]
    decode_tokens = sum(len(r.generated) - 1 for r in served)
    return counts, {
        "model": "llama3-8b", "weights": "random (seed 0)", "dtype": "bfloat16",
        "engine_build_s": build_s, "requests": len(served),
        "prompt_tokens": [len(r.prompt_ids) for r in served],
        "buckets": [r.bucket for r in served],
        "prefix_hit_tokens": [r.hist for r in served],
        "finish_reasons": [r.finish_reason for r in served],
        "completion_tokens": [len(r.generated) for r in served],
        "ttft_ms": ttft, "ttft_p50_ms": statistics.median(ttft),
        "decode_tokens": decode_tokens,
        "decode_tokens_per_s": decode_tokens / (delta["decode_ms_total"] / 1e3),
        "decode_steps": delta["decode_steps"],
        "decode_ms_total": delta["decode_ms_total"],
        "prefill_batches": delta["prefill_batches"],
        "prefill_ms_total": delta["prefill_ms_total"],
        "total_s": wall, "peak_memory_bytes": peak,
        "repeat_tokens_equal": True, "repeat_tokens": len(tokens_a),
        "launches": counts}


if __name__ == "__main__":
    sys.exit(main())
