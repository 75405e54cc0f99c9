"""The port's multi-GPU parallel layer on the CPU, over gloo groups of 2 and
4 ranks (``tests/torch_dist_worker.py``, spawned once per module and run
in the background), against the JAX package's functions on the 8-device
virtual mesh that ``tests/conftest.py`` sets up:

- ring and Ulysses attention (causal, non-causal, padding, GQA, the
  Ulysses -> ring fallback) against ``make_ring_attention`` /
  ``make_ulysses_attention`` / ``causal_attention``: atol 1e-5;
- ``build_pp_forward`` (llama3-test, qwen2-tiny with biases and a tied
  head): logits atol 1e-4;
- ``moe_ffn`` with experts split over the ranks: atol 1e-5, and
  ``_top_k_routing``'s dispatch tensor exactly (its combine tensor: the
  same nonzero slots, values within an ulp);
- ``shard_params``/``shard_tensor`` against ``addressable_shards`` for every
  logical name, the KV fallbacks and llama3-test's tree: exact;
- ``build_sharded_train_step`` at 1x2, 2x1, 2x2 and 1x4 (KV 2 at TP 4)
  against the port's unsharded step (loss rtol 1e-5, parameters within
  1e-2 x lr, with ``test_torch_train.py``'s exclusion of elements whose
  gradient lies within rounding of zero), and at 2x2 against JAX's
  ``build_sharded_train_step`` from its own ``jit_init``;
- every sharded entry point raising on a mesh or group of the wrong
  size."""

import os
import pickle
import socket
import subprocess
import sys
import time
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding

from mcp_context_forge_tpu.tpu_local import train as jtrain
from mcp_context_forge_tpu.tpu_local.models import MODEL_CONFIGS as JAX_CONFIGS
from mcp_context_forge_tpu.tpu_local.models.llama import init_params as jax_init
from mcp_context_forge_tpu.tpu_local.models.llama import params_logical as jax_logical
from mcp_context_forge_tpu.tpu_local.ops.attention import causal_attention as jax_causal
from mcp_context_forge_tpu.tpu_local.parallel import moe as jmoe
from mcp_context_forge_tpu.tpu_local.parallel import ring_attention as jring
from mcp_context_forge_tpu.tpu_local.parallel import sharding as jsharding
from mcp_context_forge_tpu.tpu_local.parallel.pipeline import build_pp_forward, stack_layers
from mcp_context_forge_tpu_torch.tpu_local.parallel import moe as tmoe
from mcp_context_forge_tpu_torch.tpu_local.parallel import sharding as tsharding
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dist_worker.py")
GROUP_TIMEOUT_S = 300
ADAM_EPS = 1e-8
LR = 1e-4          # build_sharded_train_step's default in both packages


def rng_normal(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def batches(seed: int, n: int = 3, B: int = 4, S: int = 16):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tokens = rng.integers(0, 512, (B, S)).astype(np.int32)
        mask = (rng.random((B, S)) > 0.2).astype(np.float32)
        out.append((tokens, np.roll(tokens, -1, axis=1), mask))
    return out


def jax_params(name: str, seed: int = 0):
    params = jax_init(JAX_CONFIGS[name], jax.random.PRNGKey(seed), dtype=jnp.float32)
    if JAX_CONFIGS[name].attn_bias:   # nonzero biases, so their use shows
        for i, layer in enumerate(params["layers"]):
            for j, b in enumerate(("bq", "bk", "bv")):
                layer[b] = layer[b] + 0.05 * (i + 1) * (j - 1)
    return jax.device_get(params)


def jmesh(shape, names):
    return Mesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape), names)


# ------------------------------------------------------------------ the cases

ATTN = dict(B=2, S=32, H=8, hd=16)


def seed_of(name: str) -> int:
    return zlib.crc32(name.encode()) % 1000


def attention_inputs(seed: int, kv: int, padded: bool):
    B, S, H, hd = ATTN["B"], ATTN["S"], ATTN["H"], ATTN["hd"]
    valid = np.ones((B, S), bool)
    if padded:
        valid[:, 20:] = False
    return dict(q=rng_normal(seed, (B, S, H, hd)), k=rng_normal(seed + 1, (B, S, kv, hd)),
                v=rng_normal(seed + 2, (B, S, kv, hd)), valid=valid)


def attention_cases(n: int) -> dict:
    """name -> (port impl, causal, kv heads, padded, JAX route)."""
    cases = {
        "ring_causal": ("ring_maker", True, 8, False, "ring"),
        "ring_noncausal": ("ring_maker", False, 8, False, "ring"),
        "ring_padding": ("ring_maker", True, 8, True, "ring"),
        "ring_gqa": ("ring_maker", True, 2, False, "ring"),
        "ulysses_causal": ("ulysses_maker", True, 8, False, "ulysses"),
        "ulysses_noncausal": ("ulysses_maker", False, 8, False, "ulysses"),
        "ulysses_padding": ("ulysses_maker", True, 8, True, "ulysses"),
        "causal_attention_ring": ("ring", True, 2, True, "dispatch"),
        "causal_attention_ulysses_gqa": ("ulysses", True, 2, False, "dispatch"),
        # one kv head: Ulysses cannot reshard it, the dispatcher takes the ring
        "causal_attention_ulysses_fallback": ("ulysses", True, 1, True, "dispatch"),
    }
    if n == 2:
        cases["ulysses_gqa"] = ("ulysses_maker", True, 2, False, "ulysses")
    return cases


PIPE = {2: [("llama3-test", 2, 4, 16), ("qwen2-tiny", 2, 2, 8)],
        4: [("qwen2-tiny", 2, 4, 8)]}                     # model, microbatches, B, S
MOE = {2: [dict(dim=32, n_experts=8, expert_hidden=64, top_k=2, capacity_factor=8.0),
           dict(dim=32, n_experts=8, expert_hidden=64, top_k=1, capacity_factor=8.0),
           dict(dim=64, n_experts=4, expert_hidden=96, top_k=2, capacity_factor=1.25)],
       4: [dict(dim=32, n_experts=8, expert_hidden=64, top_k=2, capacity_factor=8.0),
           dict(dim=32, n_experts=8, expert_hidden=64, top_k=2, capacity_factor=1.0),
           dict(dim=64, n_experts=4, expert_hidden=96, top_k=2, capacity_factor=1.25)]}
SHARD_MESHES = {2: [(1, 2), (2, 1)], 4: [(2, 2), (1, 4)]}
SHARD_SHAPES = {
    "replicated": (4, 6), "vocab_in": (16, 6), "vocab_out": (6, 16), "attn_qkv": (6, 16),
    "attn_out": (16, 6), "ffn_up": (6, 16), "ffn_down": (16, 6), "moe_up": (3, 6, 16),
    "moe_down": (3, 16, 6), "scale_moe_model": (3, 16), "scale_moe": (3, 6),
    "scale_model": (16,), "kv_pages": (2, 3, 4, 8, 5), "kv_scales": (2, 3, 8),
    "activations": (4, 3, 6), "decode_heads": (4, 3, 8, 5)}
KV_FALLBACK = (8, 2, 1)             # kv heads of the kv_pages/kv_scales fallback arrays
# (model, mesh) of the port-against-port train cases; 2x2 llama3-test is
# also run against JAX's own sharded step
TRAIN = {2: [("llama3-test", (1, 2)), ("llama3-test", (2, 1))],
         4: [("llama3-test", (2, 2)), ("llama3-test", (1, 4)), ("gemma-test", (2, 2)),
             ("qwen2-tiny", (2, 2)), ("mixtral-test", (2, 2))]}


def shard_arrays() -> dict:
    return {name: np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
            for name, shape in SHARD_SHAPES.items()}


def kv_arrays() -> dict:
    return {kv: (np.arange(2 * 3 * 4 * kv * 5, dtype=np.float32).reshape(2, 3, 4, kv, 5),
                 np.arange(2 * 3 * kv, dtype=np.float32).reshape(2, 3, kv))
            for kv in KV_FALLBACK}


def jax_sharded_run():
    """JAX's 2x2 sharded step from its own jit_init: the start it draws (as
    numpy), and a function that runs the three steps from it, returning the
    losses, the final params and the full gradient at each step's params."""
    cfg = JAX_CONFIGS["llama3-test"]
    step, init = jtrain.build_sharded_train_step(jmesh((2, 2), ("data", "model")), cfg)
    state = init(jax.random.PRNGKey(0))
    start = jax.device_get(state.params)

    def run():
        nonlocal state
        grad = jax.jit(jax.grad(lambda p, t, y, m: jtrain.loss_fn(p, cfg, t, y, m)))
        losses, grads = [], []
        for tokens, targets, mask in batches(7):
            grads.append(jax.device_get(grad(jax.device_get(state.params), tokens, targets,
                                             mask)))
            state, loss = step(state, tokens, targets, mask)
            losses.append(float(loss))
        return losses, jax.device_get(state.params), grads

    return start, run


def build_cases(n: int, jax_start) -> list:
    cases = []
    for name, (impl, causal, kv, padded, _) in attention_cases(n).items():
        cases.append((f"attn/{name}", "attention",
                      dict(n=n, impl=impl, causal=causal,
                           **attention_inputs(seed_of(name), kv, padded))))
    for model, microbatches, B, S in PIPE[n]:
        params = jax_params(model, seed=2)
        rng = np.random.default_rng(3)
        cases.append((f"pipe/{model}", "pipe", dict(
            model=model, n=n, microbatches=microbatches,
            stacked=jax.device_get(stack_layers(params, n_stages=n)),
            tokens=rng.integers(0, 512, (B, S)).astype(np.int32),
            positions=np.broadcast_to(np.arange(S), (B, S)).astype(np.int32))))
    for i, cfg in enumerate(MOE[n]):
        config = jmoe.MoEConfig(**cfg)
        params = jax.device_get(jmoe.init_moe_params(config, jax.random.PRNGKey(i)))
        cases.append((f"moe/{i}", "moe", dict(n=n, config=cfg, params=params,
                                              x=rng_normal(10 + i, (2, 12, cfg["dim"])))))
    for shape in SHARD_MESHES[n]:
        cases.append((f"shards/{shape[0]}x{shape[1]}", "shards", dict(
            shape=shape, arrays=shard_arrays(), kv=kv_arrays(),
            params=jax_params("llama3-test", seed=5))))
    for model, shape in TRAIN[n]:
        cases.append((f"train/{model}/{shape[0]}x{shape[1]}", "train", dict(
            model=model, shape=shape, lr=LR, against_port=True,
            params=jax_params(model, seed=6), batches=batches(8))))
    if n == 4:
        cases.append(("train/jax/2x2", "train", dict(
            model="llama3-test", shape=(2, 2), lr=LR, against_port=False,
            params=jax_start, batches=batches(7))))
    cases.append(("raises", "raises", {}))
    return cases


# ------------------------------------------------------------------ the groups

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Group:
    """One gloo group of ``world`` worker processes, started at once;
    ``result`` waits for them (bounded) and reads rank r's result."""

    def __init__(self, world: int, cases: list, tmp):
        self.world, self.tmp = world, tmp
        cases_path = tmp / f"cases{world}.pkl"
        with open(cases_path, "wb") as fh:
            pickle.dump(cases, fh)
        port = free_port()
        env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
        self.logs = [tmp / f"log{world}_{r}.txt" for r in range(world)]
        self.procs = []
        for r in range(world):
            with open(self.logs[r], "wb") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, WORKER, str(r), str(world), str(port), str(cases_path),
                     str(tmp / f"out{world}_{r}.pkl")], env=env, cwd=ROOT,
                    stdout=log, stderr=subprocess.STDOUT))
        self.deadline = time.monotonic() + GROUP_TIMEOUT_S
        self._results = None

    def wait(self) -> list:
        if self._results is None:
            for proc in self.procs:
                try:
                    proc.wait(timeout=max(1.0, self.deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    self.kill()
                    proc.wait()
            self._results = []
            for r in range(self.world):
                path = self.tmp / f"out{self.world}_{r}.pkl"
                if not path.exists():
                    log = self.logs[r].read_text(errors="replace")[-4000:]
                    pytest.fail(f"rank {r} of the {self.world}-rank group wrote no result "
                                f"(rc {self.procs[r].returncode}):\n{log}")
                with open(path, "rb") as fh:
                    self._results.append(pickle.load(fh))
        return self._results

    def result(self, name: str) -> list:
        """Every rank's value of case ``name``; fails on a rank's error."""
        values = []
        for r, results in enumerate(self.wait()):
            status, value = results[name]
            assert status == "ok", f"rank {r} of {self.world}, case {name}:\n{value}"
            values.append(value)
        return values

    def kill(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    started = {2: Group(2, build_cases(2, None), tmp)}
    start, run = jax_sharded_run()
    started[4] = Group(4, build_cases(4, start), tmp)
    started["jax_train"] = run
    try:
        yield started
    finally:
        for n in (2, 4):
            started[n].kill()
            for proc in started[n].procs:
                proc.wait(timeout=30)


# ------------------------------------------------------------------ attention

@pytest.mark.parametrize("n", (2, 4))
def test_ring_and_ulysses_match_jax(groups, n):
    for name, (impl, causal, kv, padded, route) in attention_cases(n).items():
        inp = attention_inputs(seed_of(name), kv, padded)
        mesh = jmesh((n,), ("model",))
        if route == "dispatch":
            want = jax_causal(inp["q"], inp["k"], inp["v"], inp["valid"], impl=impl,
                              mesh=mesh)
        else:
            maker = jring.make_ring_attention if route == "ring" else \
                jring.make_ulysses_attention
            want = maker(mesh, axis_name="model", causal=causal)(
                inp["q"], inp["k"], inp["v"], inp["valid"])
        for r, got in enumerate(groups[n].result(f"attn/{name}")):
            np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5,
                                       err_msg=f"{name}, rank {r} of {n}")


def test_reference_impl_is_attention_reference():
    from mcp_context_forge_tpu.tpu_local.ops.attention import attention_reference
    from mcp_context_forge_tpu_torch.tpu_local.ops.attention import causal_attention

    inp = attention_inputs(5, 2, True)
    got = causal_attention(*(torch.from_numpy(np.array(inp[x])) for x in
                             ("q", "k", "v", "valid")), impl="reference")
    want = attention_reference(inp["q"], inp["k"], inp["v"], inp["valid"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        causal_attention(*(torch.from_numpy(np.array(inp[x])) for x in
                           ("q", "k", "v", "valid")), impl="pallas_typo")


# ------------------------------------------------------------------- pipeline

@pytest.mark.parametrize("n", (2, 4))
def test_pipeline_forward_matches_jax(groups, n):
    for model, microbatches, B, S in PIPE[n]:
        params = jax_params(model, seed=2)
        rng = np.random.default_rng(3)
        tokens = rng.integers(0, 512, (B, S)).astype(np.int32)
        positions = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
        forward, shard_stacked = build_pp_forward(jmesh((n,), ("pipe",)), JAX_CONFIGS[model],
                                                  n_stages=n, microbatches=microbatches)
        want = np.asarray(forward(shard_stacked(stack_layers(params, n_stages=n)), tokens,
                                  positions))
        for r, got in enumerate(groups[n].result(f"pipe/{model}")):
            assert got["local_layers"] == JAX_CONFIGS[model].n_layers // n
            np.testing.assert_allclose(got["logits"], want, rtol=0, atol=1e-4,
                                       err_msg=f"{model}, rank {r} of {n}")


def test_stack_layers_matches_jax():
    from mcp_context_forge_tpu_torch.tpu_local.models.configs import MODEL_CONFIGS
    from mcp_context_forge_tpu_torch.tpu_local.models.convert import (
        params_from_jax, stacked_params_from_jax)
    from mcp_context_forge_tpu_torch.tpu_local.parallel.pipeline import stack_layers as tstack

    params = jax_params("qwen2-tiny")
    want = stacked_params_from_jax(jax.device_get(stack_layers(params, 2)),
                                   MODEL_CONFIGS["qwen2-tiny"], device="cpu")
    got = tstack(params_from_jax(params, MODEL_CONFIGS["qwen2-tiny"], device="cpu",
                                 dtype=torch.float32), 2)
    assert sorted(got["stages"]) == sorted(want["stages"])
    for name in want["stages"]:
        assert torch.equal(got["stages"][name], want["stages"][name]), name
    for name in ("embed", "final_norm", "lm_head"):
        assert torch.equal(got[name], want[name]), name
    with pytest.raises(ValueError):
        tstack(params_from_jax(params, MODEL_CONFIGS["qwen2-tiny"], device="cpu"), 3)


# ------------------------------------------------------------------------ MoE

@pytest.mark.parametrize("n", (2, 4))
def test_moe_ffn_matches_jax(groups, n):
    for i, cfg in enumerate(MOE[n]):
        config = jmoe.MoEConfig(**cfg)
        params = jmoe.init_moe_params(config, jax.random.PRNGKey(i))
        mesh = jmesh((n,), ("expert",))
        with mesh:
            want = np.asarray(jax.jit(lambda p, v: jmoe.moe_ffn(p, v, config))(
                jmoe.shard_moe_params(params, mesh), rng_normal(10 + i, (2, 12, cfg["dim"]))))
        for r, got in enumerate(groups[n].result(f"moe/{i}")):
            assert got["local_experts"] == cfg["n_experts"] // n
            np.testing.assert_allclose(got["out"], want, rtol=0, atol=1e-5,
                                       err_msg=f"config {i}, rank {r} of {n}")


@pytest.mark.parametrize("k,capacity", [(1, 3), (2, 4), (2, 30), (3, 2)])
def test_top_k_routing_dispatch_is_exact(k, capacity):
    logits = rng_normal(k * 100 + capacity, (24, 6))
    logits[::5, 1] = logits[::5, 3]          # ties: the lower expert wins in both
    want_dispatch, want_combine = jmoe._top_k_routing(jnp.asarray(logits), k, capacity)
    dispatch, combine = tmoe._top_k_routing(torch.from_numpy(logits), k, capacity)
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(want_dispatch))
    # the same slots hold the gates; their values round apart by an ulp
    # (XLA divides by the renormalizer through its reciprocal)
    np.testing.assert_array_equal(combine.numpy() != 0, np.asarray(want_combine) != 0)
    np.testing.assert_allclose(combine.numpy(), np.asarray(want_combine), rtol=3e-7, atol=0)


def test_moe_ffn_single_device_matches_jax():
    from mcp_context_forge_tpu_torch.tpu_local.models.convert import moe_params_from_jax

    for cfg in MOE[4]:
        config = jmoe.MoEConfig(**cfg)
        params = jmoe.init_moe_params(config, jax.random.PRNGKey(3))
        x = rng_normal(4, (2, 12, cfg["dim"]))
        want = np.asarray(jmoe.moe_ffn(params, x, config))
        got = tmoe.moe_ffn(moe_params_from_jax(jax.device_get(params), device="cpu"),
                           torch.from_numpy(x), tmoe.MoEConfig(**cfg))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


# ------------------------------------------------------------------- sharding

def jax_local(x: np.ndarray, spec, shape, rank: int) -> np.ndarray:
    """The block of ``x`` JAX places on the mesh's ``rank``-th device."""
    mesh = jmesh(shape, ("data", "model"))
    index = NamedSharding(mesh, spec).devices_indices_map(x.shape)[jax.devices()[rank]]
    return x[index]


@pytest.mark.parametrize("n", (2, 4))
def test_shard_params_are_jax_addressable_shards(groups, n):
    for shape in SHARD_MESHES[n]:
        mesh = jmesh(shape, ("data", "model"))
        got = groups[n].result(f"shards/{shape[0]}x{shape[1]}")
        for name, x in shard_arrays().items():
            placed = jax.device_put(x, jsharding.logical_to_sharding(name, mesh))
            for r in range(n):
                want = [s.data for s in placed.addressable_shards
                        if s.device == jax.devices()[r]][0]
                np.testing.assert_array_equal(got[r][name], np.asarray(want),
                                              err_msg=f"{name} on {shape}, rank {r}")
        for kv, (pages, scales) in kv_arrays().items():
            for what, x, fn in (("kv_pages", pages, jsharding.kv_pages_sharding),
                                ("kv_scales", scales, jsharding.kv_scales_sharding)):
                sharding = fn(mesh, kv)
                for r in range(n):
                    want = x[sharding.devices_indices_map(x.shape)[jax.devices()[r]]]
                    np.testing.assert_array_equal(got[r][f"{what}/{kv}"], want,
                                                  err_msg=f"{what} kv {kv} on {shape}")
        params = jax_params("llama3-test", seed=5)
        placed = jsharding.shard_params(params, jax_logical(JAX_CONFIGS["llama3-test"]), mesh)
        for r in range(n):
            want = [[s.data for s in leaf.addressable_shards if s.device == jax.devices()[r]][0]
                    for leaf in jax.tree.leaves(placed)]
            assert len(got[r]["params"]) == len(want)
            for g, w in zip(got[r]["params"], want):
                np.testing.assert_array_equal(g, np.asarray(w))


def test_logical_rules_cover_jax():
    assert set(tsharding.LOGICAL_RULES) == set(jsharding.LOGICAL_RULES)
    for name, spec in jsharding.LOGICAL_RULES.items():
        assert tsharding.LOGICAL_RULES[name] == tuple(spec), name


# ----------------------------------------------------------------- train step

def adam_check(got: list, want: list, got_grads: list, want_grads: list, lr: float):
    """(largest |got - want| over kept elements, excluded count, excluded
    past the bound): an element is excluded when at some step its nonzero
    reference gradient lies within 10 x eps of zero or within the step's
    gradient rounding of it (test_torch_train.py's rule)."""
    worst, excluded, outside = 0.0, 0, 0
    for i, (g, w) in enumerate(zip(got, want)):
        near = np.zeros(w.shape, bool)
        for step_got, step_want in zip(got_grads, want_grads):
            ref = step_want[i]
            delta = np.abs(step_got[i] - ref).max()
            near |= (ref != 0) & ((np.abs(ref) < 10 * ADAM_EPS)
                                  | ((np.abs(ref) + ADAM_EPS) ** 2 < 1e3 * ADAM_EPS * delta))
        err = np.abs(g - w)
        if (~near).any():
            worst = max(worst, float(err[~near].max()))
        excluded += int(near.sum())
        outside += int((err[near] > 1e-2 * lr).sum())
    return worst, excluded, outside


@pytest.mark.parametrize("n", (2, 4))
def test_sharded_train_step_matches_unsharded(groups, n):
    for model, shape in TRAIN[n]:
        name = f"train/{model}/{shape[0]}x{shape[1]}"
        for r, got in enumerate(groups[n].result(name)):
            np.testing.assert_allclose(got["losses"], got["ref_losses"], rtol=1e-5,
                                       err_msg=f"{name}, rank {r}")
            assert got["moments_sharded"], name
            for step, (g, w) in enumerate(zip(got["grads"], got["ref_grads"])):
                for i, (a, b) in enumerate(zip(g, w)):
                    assert np.abs(a - b).max() <= 1e-7 + 1e-4 * np.abs(b).max(), \
                        (name, r, step, i)
            worst, excluded, outside = adam_check(got["params"], got["ref_params"],
                                                  got["grads"], got["ref_grads"], LR)
            total = sum(p.size for p in got["params"])
            print(f"{name} rank {r}: worst {worst:.3g}, excluded {excluded} of {total}, "
                  f"of them past the bound {outside}")
            assert worst <= 1e-2 * LR, (name, r, worst)
            assert excluded <= 1e-2 * total, (name, r, excluded)


def test_sharded_train_step_matches_jax_sharded_step(groups):
    losses, final, grads = groups["jax_train"]()
    mesh = jmesh((2, 2), ("data", "model"))
    logical = jax.tree.leaves(jax_logical(JAX_CONFIGS["llama3-test"]))
    specs = [jsharding.LOGICAL_RULES[name] for name in logical]
    final_leaves = [np.asarray(x) for x in jax.tree.leaves(jax.device_get(final))]
    grad_leaves = [[np.asarray(x) for x in jax.tree.leaves(g)] for g in grads]
    for r, got in enumerate(groups[4].result("train/jax/2x2")):
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5, err_msg=f"rank {r}")
        want = [jax_local(x, spec, (2, 2), r) for x, spec in zip(final_leaves, specs)]
        want_grads = [[jax_local(x, spec, (2, 2), r) for x, spec in zip(step, specs)]
                      for step in grad_leaves]
        for step, (g, w) in enumerate(zip(got["grads"], want_grads)):
            for i, (a, b) in enumerate(zip(g, w)):
                assert np.abs(a - b).max() <= 1e-7 + 1e-4 * np.abs(b).max(), (r, step, i)
        worst, excluded, outside = adam_check(got["params"], want, got["grads"], want_grads,
                                              LR)
        total = sum(p.size for p in got["params"])
        print(f"against JAX, rank {r}: worst {worst:.3g}, excluded {excluded} of {total}, "
              f"of them past the bound {outside}")
        assert worst <= 1e-2 * LR and excluded <= 1e-2 * total, (r, worst, excluded)
    assert mesh.shape == {"data": 2, "model": 2}


# ------------------------------------------------------------------- raising

@pytest.mark.parametrize("n", (2, 4))
def test_sharded_entry_points_raise_on_wrong_groups(groups, n):
    for r, got in enumerate(groups[n].result("raises")):
        assert all(got.values()), (f"rank {r} of {n}: did not raise",
                                   [k for k, v in got.items() if v is None])


def test_entry_points_raise_without_a_group():
    import torch.distributed as dist

    from mcp_context_forge_tpu_torch.tpu_local.parallel.mesh import (
        axis_group, make_mesh, mesh_shape_from_string)

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError):
        make_mesh("1x1", "cpu")
    with pytest.raises(ValueError):
        axis_group(None, "model")
    assert mesh_shape_from_string("2x4", 8) == (2, 4)
    assert mesh_shape_from_string("", 8) == (1, 8)
    with pytest.raises(ValueError):
        mesh_shape_from_string("2x3", 8)
    with pytest.raises(ValueError):
        mesh_shape_from_string("8", 8)
