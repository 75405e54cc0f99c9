"""Dropless grouped-GEMM MoE FFN: the same per-token function as the
expert scan (``parallel/moe.py moe_ffn_dense_mask``) at ~k/E of its FLOPs.

1. ``route_sorted_blocks``: flatten the T*k (token, expert) pairs, sort
   them by expert (stable), pad every expert's group to a multiple of the
   row-block Bt. The padded buffer has a static NB = ceil(T*k/Bt) + E
   blocks, each owned by ONE expert (``block_expert``). Computed on the
   device with no host sync.
2. ``expert_blocks`` / ``expert_blocks_q8``: each row-block through its
   expert's gated FFN, ``act(x@w1) * (x@w3) @ w2`` (int8 stacks: scales on
   the hidden per F column and on the output per D column). CPU tensors
   run the plain versions ``expert_blocks_ref`` / ``expert_blocks_q8_ref``
   (f32 inside, one expert at a time: gathering [NB, D, F] weights would be
   ~14 GB at Mixtral widths). CUDA tensors launch the hand-written kernel
   ``moe_route`` names: ``"tc"`` (``csrc/grouped_moe_tc.cu``, wgmma with a
   TMA ring; ``expert_blocks_tc``/``_tc_q8``) for bf16 activations at
   row-blocks of a multiple of 64 and widths of whole tiles, ``"wmma"``
   (``csrc/grouped_moe.cu``; ``expert_blocks_wmma``/``_wmma_q8``)
   otherwise. Each carries its own launch count; ``expert_blocks``/``_q8``
   only dispatch. Both kernels keep h to 16 bits of mantissa into the
   down-projection as bf16 hi + lo halves; ``expert_blocks_split_ref`` is
   the plain model of that arithmetic.
3. ``moe_ffn_grouped`` weights each row by its renormalized gate and
   combines each token's k rows deterministically: it gathers them through
   the inverse of the sort and adds them in slot order (a scatter-add with
   atomics would change bf16 sums from run to run).
"""

from __future__ import annotations

from typing import Any

import torch

from . import _build, count_launch
from ..parallel.moe import activation, router_probs, top_k_experts
from ..quantize import is_quant

ACT_CODES = {"silu": 0, "gelu": 1}


# --------------------------------------------------------------- routing

def route_sorted_blocks(probs: torch.Tensor, top_k: int, block: int
                        ) -> dict[str, torch.Tensor]:
    """Static-shape block-sparse routing plan from router probabilities
    [T, E].

    Returns:
      sorted_token  [NP] int32  flat token feeding each padded row
      row_valid     [NP] f32    1.0 for live rows, 0.0 for group padding
      gates         [NP] f32    renormalized gate of the (token, slot) pair
      block_expert  [NB] int32  owning expert of each row-block
      dest          [T, k] int64 padded row of each (token, slot) pair
      (NP = NB*block; NB = ceil(T*k/block) + E)
    """
    T, E = probs.shape
    N = T * top_k
    NB = -(-N // block) + E
    NP = NB * block
    device = probs.device

    top_idx = top_k_experts(probs, top_k)                         # [T, k]
    gates = probs.gather(1, top_idx)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)

    expert_flat = top_idx.reshape(N)
    token_flat = torch.arange(T, dtype=torch.int32,
                              device=device).repeat_interleave(top_k)
    gate_flat = gates.reshape(N)

    order = torch.argsort(expert_flat, stable=True)               # [N]
    sorted_expert = expert_flat[order]
    counts = torch.zeros(E, dtype=torch.int64, device=device).scatter_add_(
        0, sorted_expert, torch.ones_like(sorted_expert))        # [E]
    group_start = torch.cumsum(counts, 0) - counts
    padded_counts = (counts + block - 1) // block * block
    padded_end = torch.cumsum(padded_counts, 0)
    padded_start = padded_end - padded_counts
    rank = torch.arange(N, device=device) - group_start[sorted_expert]
    dest = padded_start[sorted_expert] + rank                     # [N] < NP

    sorted_token = torch.zeros(NP, dtype=torch.int32, device=device)
    sorted_token[dest] = token_flat[order]
    row_valid = torch.zeros(NP, dtype=torch.float32, device=device)
    row_valid[dest] = 1.0
    gates_padded = torch.zeros(NP, dtype=torch.float32, device=device)
    gates_padded[dest] = gate_flat[order]
    pair_dest = torch.empty(N, dtype=torch.int64, device=device)
    pair_dest[order] = dest

    # block b belongs to the expert whose padded range holds row b*block;
    # blocks past every group (pure padding) clamp to E-1
    block_starts = torch.arange(NB, device=device) * block
    block_expert = torch.clamp(
        torch.searchsorted(padded_end, block_starts, right=True),
        0, E - 1).to(torch.int32)
    return {"sorted_token": sorted_token, "row_valid": row_valid,
            "gates": gates_padded, "block_expert": block_expert,
            "dest": pair_dest.reshape(T, top_k)}


# --------------------------------------------------------- plain versions

def _blocks_of(block_expert: torch.Tensor, E: int):
    """(expert, block indices) for each expert that owns a block."""
    for e in range(E):
        blocks = torch.nonzero(block_expert == e).flatten()
        if blocks.numel():
            yield e, blocks


def expert_blocks_ref(x_pad: torch.Tensor, w1: torch.Tensor,
                      w3: torch.Tensor, w2: torch.Tensor,
                      block_expert: torch.Tensor,
                      act: str = "silu") -> torch.Tensor:
    """Plain version of the kernel: x_pad [NB, Bt, D], w1/w3 [E, D, F],
    w2 [E, F, D], block_expert [NB] -> [NB, Bt, D] in x's dtype, f32
    inside (as the Pallas body)."""
    NB, Bt, D = x_pad.shape
    out = torch.empty_like(x_pad)
    for e, blocks in _blocks_of(block_expert, w1.shape[0]):
        rows = x_pad[blocks].reshape(-1, D).float()
        h = activation(rows @ w1[e].float(), act) * (rows @ w3[e].float())
        out[blocks] = (h @ w2[e].float()).reshape(-1, Bt, D).to(x_pad.dtype)
    return out


def expert_blocks_q8_ref(x_pad: torch.Tensor, w1: dict, w3: dict, w2: dict,
                         block_expert: torch.Tensor,
                         act: str = "silu") -> torch.Tensor:
    """Plain version of the int8 kernel: {"q": int8 [E, D, F], "s": [E, F]}
    up stacks, {"q": int8 [E, F, D], "s": [E, D]} down stack; f32 inside.
    h = act((x@q1)*s1) * ((x@q3)*s3); out = (h @ q2) * s2."""
    NB, Bt, D = x_pad.shape
    out = torch.empty_like(x_pad)
    for e, blocks in _blocks_of(block_expert, w1["q"].shape[0]):
        rows = x_pad[blocks].reshape(-1, D).float()
        gate = (rows @ w1["q"][e].float()) * w1["s"][e].float()
        up = (rows @ w3["q"][e].float()) * w3["s"][e].float()
        h = activation(gate, act) * up
        y = (h @ w2["q"][e].float()) * w2["s"][e].float()
        out[blocks] = y.reshape(-1, Bt, D).to(x_pad.dtype)
    return out


def expert_blocks_split_ref(x_pad: torch.Tensor, w1, w3, w2,
                            block_expert: torch.Tensor,
                            act: str = "silu") -> torch.Tensor:
    """Plain model of the kernels' numerics over full-precision or int8
    stacks (``{"q", "s"}`` leaves): h in f32 as in ``expert_blocks_ref``,
    split into ``hi = bf16(h)`` and ``lo = bf16(h - hi)``, and the
    down-projection as ``hi @ w2 + lo @ w2`` in f32 (int8: times s2)."""
    NB, Bt, D = x_pad.shape
    q8 = isinstance(w1, dict)
    out = torch.empty_like(x_pad)
    for e, blocks in _blocks_of(block_expert, (w1["q"] if q8 else w1).shape[0]):
        rows = x_pad[blocks].reshape(-1, D).float()
        if q8:
            gate = (rows @ w1["q"][e].float()) * w1["s"][e].float()
            up = (rows @ w3["q"][e].float()) * w3["s"][e].float()
            down, s2 = w2["q"][e].float(), w2["s"][e].float()
        else:
            gate, up = rows @ w1[e].float(), rows @ w3[e].float()
            down, s2 = w2[e].float(), 1.0
        h = activation(gate, act) * up
        hi = h.to(torch.bfloat16)
        lo = (h - hi.float()).to(torch.bfloat16)
        y = (hi.float() @ down + lo.float() @ down) * s2
        out[blocks] = y.reshape(-1, Bt, D).to(x_pad.dtype)
    return out


# ---------------------------------------------------------------- kernels

MOE_TC_ROWS = 64    # a warpgroup's rows: row-blocks hold whole warpgroups
MOE_TC_D = 256      # the down-projection's output tile (two 128-column halves)
MOE_TC_F = 128      # the up-projection's output tile


def moe_route(dtype: torch.dtype, Bt: int, D: int, F: int) -> str:
    """Which grouped-expert kernel a CUDA call takes: ``"tc"`` (wgmma, TMA
    ring) for bf16 activations with Bt % 64 == 0, D % 256 == 0 and
    F % 128 == 0; ``"wmma"`` otherwise (f32, ``moe_block`` 8, narrow
    widths). A static choice, never a reaction to a failed build or
    launch."""
    return ("tc" if dtype == torch.bfloat16 and Bt % MOE_TC_ROWS == 0
            and D % MOE_TC_D == 0 and F % MOE_TC_F == 0 else "wmma")


def _check_geometry(name: str, x_pad: torch.Tensor, up: torch.Tensor,
                    down: torch.Tensor, block_expert: torch.Tensor) -> tuple:
    NB, Bt, D = x_pad.shape
    E, D_up, F = up.shape
    if D_up != D or tuple(down.shape) != (E, F, D):
        raise ValueError(f"{name}: want w1/w3 [E, {D}, F] and w2 [E, F, "
                         f"{D}], got {tuple(up.shape)} and {tuple(down.shape)}")
    if tuple(block_expert.shape) != (NB,):
        raise ValueError(f"{name}: block_expert must be [{NB}], got "
                         f"{tuple(block_expert.shape)}")
    if Bt % 8 or D % 8 or F % 8:
        raise ValueError(f"{name}: Bt, D and F must be multiples of 8, got "
                         f"{Bt}, {D}, {F}")
    return NB, Bt, D, E, F


def expert_blocks(x_pad: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                  w2: torch.Tensor, block_expert: torch.Tensor,
                  act: str = "silu") -> torch.Tensor:
    """[NB, Bt, D] row-blocks through their owning expert's FFN over
    full-precision stacks (x and the stacks share one dtype, bf16 or f32).
    CPU tensors run the plain version; CUDA tensors launch the kernel
    ``moe_route`` names (or raise)."""
    if x_pad.device.type == "cpu":
        return expert_blocks_ref(x_pad, w1, w3, w2, block_expert, act)
    kernel = (expert_blocks_tc if moe_route(x_pad.dtype, x_pad.shape[1],
                                            x_pad.shape[2], w1.shape[-1]) == "tc"
              else expert_blocks_wmma)
    return kernel(x_pad, w1, w3, w2, block_expert, act)


def expert_blocks_wmma(x_pad: torch.Tensor, w1: torch.Tensor,
                       w3: torch.Tensor, w2: torch.Tensor,
                       block_expert: torch.Tensor,
                       act: str = "silu") -> torch.Tensor:
    """The WMMA kernel over bf16/f32 stacks (CUDA tensors)."""
    name = "expert_blocks_wmma"
    NB, Bt, D, E, F = _check_geometry(name, x_pad, w1, w2, block_expert)
    if w3.shape != w1.shape:
        raise ValueError(f"{name}: w3 must match w1 {tuple(w1.shape)}")
    dtype = _build.check_inputs(
        name, {"x_pad": x_pad, "w1": w1, "w3": w3, "w2": w2},
        {"block_expert": block_expert})
    h = torch.empty((NB * Bt, F), dtype=torch.float32, device=x_pad.device)
    out = torch.empty_like(x_pad)
    fn = _build.kernel_fn("grouped_moe", "mcf_expert_blocks",
                          [_build.PTR] * 7 + [_build.INT] * 7 + [_build.PTR])
    rc = fn(x_pad.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
            block_expert.data_ptr(), h.data_ptr(), out.data_ptr(),
            NB, Bt, D, F, E, ACT_CODES[act], dtype,
            torch.cuda.current_stream(x_pad.device).cuda_stream)
    _build.check(rc, name)
    count_launch(expert_blocks_wmma)
    return out


def expert_blocks_q8(x_pad: torch.Tensor, w1: dict, w3: dict, w2: dict,
                     block_expert: torch.Tensor,
                     act: str = "silu") -> torch.Tensor:
    """The same over int8 stacks ({"q": int8, "s": scale} leaves, scales in
    x's dtype). CPU tensors run the plain version; CUDA tensors launch the
    kernel ``moe_route`` names (or raise)."""
    if x_pad.device.type == "cpu":
        return expert_blocks_q8_ref(x_pad, w1, w3, w2, block_expert, act)
    kernel = (expert_blocks_tc_q8
              if moe_route(x_pad.dtype, x_pad.shape[1], x_pad.shape[2],
                           w1["q"].shape[-1]) == "tc"
              else expert_blocks_wmma_q8)
    return kernel(x_pad, w1, w3, w2, block_expert, act)


def _check_q8(name: str, x_pad: torch.Tensor, w1: dict, w3: dict, w2: dict,
              block_expert: torch.Tensor) -> tuple:
    """Shapes of an int8 call; returns (NB, Bt, D, E, F) and the dtype
    code."""
    NB, Bt, D, E, F = _check_geometry(name, x_pad, w1["q"], w2["q"],
                                      block_expert)
    if (w3["q"].shape != w1["q"].shape or tuple(w1["s"].shape) != (E, F)
            or tuple(w3["s"].shape) != (E, F)
            or tuple(w2["s"].shape) != (E, D)):
        raise ValueError(f"{name}: want s1/s3 [{E}, {F}] and s2 [{E}, {D}]")
    dtype = _build.check_inputs(
        name, {"x_pad": x_pad, "s1": w1["s"], "s3": w3["s"], "s2": w2["s"]},
        {"block_expert": block_expert},
        int8={"q1": w1["q"], "q3": w3["q"], "q2": w2["q"]})
    return (NB, Bt, D, E, F), dtype


def expert_blocks_wmma_q8(x_pad: torch.Tensor, w1: dict, w3: dict, w2: dict,
                          block_expert: torch.Tensor,
                          act: str = "silu") -> torch.Tensor:
    """The WMMA kernel over int8 stacks (CUDA tensors)."""
    name = "expert_blocks_wmma_q8"
    (NB, Bt, D, E, F), dtype = _check_q8(name, x_pad, w1, w3, w2,
                                         block_expert)
    h = torch.empty((NB * Bt, F), dtype=torch.float32, device=x_pad.device)
    out = torch.empty_like(x_pad)
    fn = _build.kernel_fn("grouped_moe", "mcf_expert_blocks_q8",
                          [_build.PTR] * 10 + [_build.INT] * 7 + [_build.PTR])
    rc = fn(x_pad.data_ptr(), w1["q"].data_ptr(), w1["s"].data_ptr(),
            w3["q"].data_ptr(), w3["s"].data_ptr(), w2["q"].data_ptr(),
            w2["s"].data_ptr(), block_expert.data_ptr(), h.data_ptr(),
            out.data_ptr(), NB, Bt, D, F, E, ACT_CODES[act], dtype,
            torch.cuda.current_stream(x_pad.device).cuda_stream)
    _build.check(rc, name)
    count_launch(expert_blocks_wmma_q8)
    return out


def _check_tc(name: str, x_pad: torch.Tensor, F: int) -> None:
    NB, Bt, D = x_pad.shape
    if moe_route(x_pad.dtype, Bt, D, F) != "tc":
        raise ValueError(
            f"{name} takes bf16 activations with Bt % {MOE_TC_ROWS} == 0, "
            f"D % {MOE_TC_D} == 0 and F % {MOE_TC_F} == 0, got {x_pad.dtype} "
            f"at Bt {Bt}, D {D}, F {F}")


def _tc_launch(name: str, symbol: str, x_pad: torch.Tensor, ptrs: list,
               block_expert: torch.Tensor, F: int, E: int, act: str,
               phases: int = 3, h: torch.Tensor | None = None
               ) -> torch.Tensor:
    """One call of a tensor-core entry: phase A (``phases`` bit 1) writes
    h as bf16 hi and lo halves into the workspace ``h`` [2, NB*Bt, F] (the
    bytes of an f32 h), phase B (bit 2) reads them."""
    NB, Bt, D = x_pad.shape
    if h is None:
        h = torch.empty((2, NB * Bt, F), dtype=torch.bfloat16,
                        device=x_pad.device)
    if (tuple(h.shape) != (2, NB * Bt, F) or h.dtype != torch.bfloat16
            or h.device != x_pad.device or not h.is_contiguous()):
        raise ValueError(f"{name}: the workspace must be a contiguous "
                         f"[2, {NB * Bt}, {F}] bf16 tensor on {x_pad.device}")
    out = torch.empty_like(x_pad)
    fn = _build.kernel_fn("grouped_moe_tc", symbol,
                          [_build.PTR] * (len(ptrs) + 3) + [_build.INT] * 7
                          + [_build.PTR])
    rc = fn(*ptrs, block_expert.data_ptr(), h.data_ptr(), out.data_ptr(),
            NB, Bt, D, F, E, ACT_CODES[act], phases,
            torch.cuda.current_stream(x_pad.device).cuda_stream)
    _build.check(rc, name)
    return out


def expert_blocks_tc(x_pad: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                     w2: torch.Tensor, block_expert: torch.Tensor,
                     act: str = "silu", phases: int = 3,
                     h: torch.Tensor | None = None) -> torch.Tensor:
    """The tensor-core kernel over bf16 stacks (CUDA tensors). ``phases``
    and ``h`` run one phase alone over a caller's workspace (planted
    faults); the engine runs both."""
    name = "expert_blocks_tc"
    _check_tc(name, x_pad, w1.shape[-1])
    _, _, _, E, F = _check_geometry(name, x_pad, w1, w2, block_expert)
    if w3.shape != w1.shape:
        raise ValueError(f"{name}: w3 must match w1 {tuple(w1.shape)}")
    _build.check_inputs(name, {"x_pad": x_pad, "w1": w1, "w3": w3, "w2": w2},
                        {"block_expert": block_expert})
    out = _tc_launch(name, "mcf_expert_blocks_tc", x_pad,
                     [x_pad.data_ptr(), w1.data_ptr(), w3.data_ptr(),
                      w2.data_ptr()], block_expert, F, E, act, phases, h)
    count_launch(expert_blocks_tc)
    return out


def expert_blocks_tc_q8(x_pad: torch.Tensor, w1: dict, w3: dict, w2: dict,
                        block_expert: torch.Tensor, act: str = "silu",
                        phases: int = 3,
                        h: torch.Tensor | None = None) -> torch.Tensor:
    """The tensor-core kernel over int8 stacks with bf16 scales (CUDA
    tensors); ``phases`` and ``h`` as in ``expert_blocks_tc``."""
    name = "expert_blocks_tc_q8"
    _check_tc(name, x_pad, w1["q"].shape[-1])
    (_, _, _, E, F), _ = _check_q8(name, x_pad, w1, w3, w2, block_expert)
    out = _tc_launch(name, "mcf_expert_blocks_tc_q8", x_pad,
                     [x_pad.data_ptr(), w1["q"].data_ptr(),
                      w1["s"].data_ptr(), w3["q"].data_ptr(),
                      w3["s"].data_ptr(), w2["q"].data_ptr(),
                      w2["s"].data_ptr()], block_expert, F, E, act,
                     phases, h)
    count_launch(expert_blocks_tc_q8)
    return out


expert_blocks_tc.launches = 0
expert_blocks_tc_q8.launches = 0
expert_blocks_wmma.launches = 0
expert_blocks_wmma_q8.launches = 0


# ----------------------------------------------------------- public entry

def moe_ffn_grouped(params: dict[str, Any], x: torch.Tensor, config,
                    act: str = "silu", block: int = 128) -> torch.Tensor:
    """Dropless grouped MoE FFN, the same per-token function as
    ``moe_ffn_dense_mask``. x: [B, S, D] -> [B, S, D]. Full-precision or
    int8 stacks; the kernels on CUDA tensors, the plain versions on CPU
    tensors."""
    B, S, D = x.shape
    flat = x.reshape(-1, D)
    probs = router_probs(params["router"], flat)                  # [T, E]
    plan = route_sorted_blocks(probs, config.top_k, block)
    NB = plan["block_expert"].shape[0]

    x_pad = flat[plan["sorted_token"].long()]
    x_pad = (x_pad * plan["row_valid"][:, None].to(x.dtype)).reshape(
        NB, block, D)
    run = expert_blocks_q8 if is_quant(params["w1"]) else expert_blocks
    out_rows = run(x_pad, params["w1"], params["w3"], params["w2"],
                   plan["block_expert"], act).reshape(NB * block, D)
    weighted = out_rows * (plan["gates"] * plan["row_valid"])[:, None].to(
        x.dtype)
    # each token's k rows, added in slot order: deterministic
    picked = weighted[plan["dest"]]                               # [T, k, D]
    out = torch.zeros_like(flat)
    for slot in range(config.top_k):
        out = out + picked[:, slot]
    return out.reshape(B, S, D)


def grouped_flops(T: int, top_k: int, n_experts: int, dim: int,
                  hidden: int, block: int = 128) -> dict[str, float]:
    """FFN FLOPs: grouped vs dense-mask vs ideal (router excluded)."""
    per_row = 3 * 2 * dim * hidden          # w1, w3, w2 matmuls
    NB = -(-T * top_k // block) + n_experts
    return {
        "dense_mask": float(n_experts * T * per_row),
        "grouped": float(NB * block * per_row),
        "ideal": float(T * top_k * per_row),
    }
