"""One rank of a gloo group for ``tests/test_torch_parallel.py``.

    python tests/torch_dist_worker.py RANK WORLD PORT CASES OUT

Joins a ``world``-rank gloo group on 127.0.0.1:PORT, runs every case of the
pickled list CASES (name, kind, inputs) in order and pickles {name: result}
to OUT (a result is ("ok", value) or ("error", traceback)). Imports torch
and the port only. A case that raises ends the run there, since the other
ranks may be inside a collective it left: later cases are reported as not
run, and the process exits 1."""

import os
import pickle
import sys
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mcp_context_forge_tpu_torch.tpu_local import train  # noqa: E402
from mcp_context_forge_tpu_torch.tpu_local.models.configs import MODEL_CONFIGS  # noqa: E402
from mcp_context_forge_tpu_torch.tpu_local.models.convert import (  # noqa: E402
    moe_params_from_jax, params_from_jax, stacked_params_from_jax)
from mcp_context_forge_tpu_torch.tpu_local.ops.attention import causal_attention  # noqa: E402
from mcp_context_forge_tpu_torch.tpu_local.parallel import (  # noqa: E402
    mesh as pmesh, moe, pipeline, ring_attention, sharding)

_MESHES: dict = {}


def mesh_of(shape: tuple, names: tuple):
    """One DeviceMesh per shape and axis names (each build makes groups)."""
    from torch.distributed.device_mesh import init_device_mesh

    key = (shape, names)
    if key not in _MESHES:
        _MESHES[key] = (pmesh.make_mesh(f"{shape[0]}x{shape[1]}", "cpu", names)
                        if len(shape) == 2 else
                        init_device_mesh("cpu", shape, mesh_dim_names=names))
    return _MESHES[key]


def t(a):
    return torch.from_numpy(np.array(a))


def attention(inp):
    mesh = mesh_of((1, inp["n"]), ("data", "model"))
    q, k, v, valid = (t(inp[x]) for x in ("q", "k", "v", "valid"))
    if inp["impl"] == "ring_maker":
        fn = ring_attention.make_ring_attention(mesh, causal=inp["causal"])
    elif inp["impl"] == "ulysses_maker":
        fn = ring_attention.make_ulysses_attention(mesh, causal=inp["causal"])
    else:
        return causal_attention(q, k, v, valid, impl=inp["impl"], mesh=mesh).numpy()
    return fn(q, k, v, valid).numpy()


def pipe(inp):
    name, n = inp["model"], inp["n"]
    mesh = mesh_of((n,), ("pipe",))
    config = MODEL_CONFIGS[name]
    stacked = stacked_params_from_jax(inp["stacked"], config, device="cpu")
    forward, shard_stacked = pipeline.build_pp_forward(mesh, config, n_stages=n,
                                                       microbatches=inp["microbatches"])
    local = shard_stacked(stacked)
    out = forward(local, t(inp["tokens"]), t(inp["positions"]))
    return {"logits": out.numpy(),
            "local_layers": int(local["stages"]["wq"].shape[0])}


def moe_case(inp):
    n = inp["n"]
    mesh = mesh_of((n,), ("expert",))
    config = moe.MoEConfig(**inp["config"])
    params = moe_params_from_jax(inp["params"], device="cpu")
    local = moe.shard_moe_params(params, mesh)
    out = moe.moe_ffn(local, t(inp["x"]), config, mesh=mesh)
    return {"out": out.numpy(), "local_experts": int(local["w1"].shape[0])}


def shards(inp):
    mesh = mesh_of(inp["shape"], ("data", "model"))
    out = {}
    for name, x in inp["arrays"].items():
        spec = sharding.LOGICAL_RULES[name]
        out[name] = sharding.shard_tensor(t(x), spec, mesh).numpy()
    for n_kv, (pages, scales) in inp["kv"].items():
        out[f"kv_pages/{n_kv}"] = sharding.shard_tensor(
            t(pages), sharding.kv_pages_spec(mesh, n_kv), mesh).numpy()
        out[f"kv_scales/{n_kv}"] = sharding.shard_tensor(
            t(scales), sharding.kv_scales_spec(mesh, n_kv), mesh).numpy()
    params = params_from_jax(inp["params"], MODEL_CONFIGS["llama3-test"], device="cpu",
                             dtype=torch.float32)
    from mcp_context_forge_tpu_torch.tpu_local.models.llama import params_logical
    local = sharding.shard_params(params, params_logical(MODEL_CONFIGS["llama3-test"]),
                                  mesh)
    out["params"] = [leaf.numpy() for leaf in train.leaves(local)]
    return out


def _grads(params) -> list:
    return [leaf.grad.detach().clone().numpy() for leaf in train.leaves(params)]


def train_case(inp):
    """Three steps of the sharded step; with ``against_port`` the port's
    unsharded step too, on the same start, its results sliced as this
    rank's shards."""
    name, shape, lr = inp["model"], inp["shape"], inp["lr"]
    mesh = mesh_of(shape, ("data", "model"))
    config = MODEL_CONFIGS[name]
    start = params_from_jax(inp["params"], config, device="cpu", dtype=torch.float32)
    step, init_state = train.build_sharded_train_step(mesh, config, lr=lr)
    state = init_state(start)
    out = {"losses": [], "grads": [], "ref_losses": [], "ref_grads": []}
    if inp["against_port"]:
        from mcp_context_forge_tpu_torch.tpu_local.models.llama import params_logical
        logical = params_logical(config)
        ref = train.init_train_state(
            params_from_jax(inp["params"], config, device="cpu", dtype=torch.float32),
            train.make_optimizer(lr))
    for tokens, targets, mask in inp["batches"]:
        state, loss = step(state, t(tokens), t(targets), t(mask))
        out["losses"].append(float(loss))
        out["grads"].append(_grads(state.params))
        if inp["against_port"]:
            ref, ref_loss = train.train_step(ref, config, t(tokens), t(targets), t(mask))
            out["ref_losses"].append(float(ref_loss))
            local = sharding.shard_params(_grad_tree(ref.params), logical, mesh)
            out["ref_grads"].append([g.numpy() for g in train.leaves(local)])
    out["params"] = [leaf.detach().numpy() for leaf in train.leaves(state.params)]
    if inp["against_port"]:
        local = sharding.shard_params(_detached(ref.params), logical, mesh)
        out["ref_params"] = [leaf.numpy() for leaf in train.leaves(local)]
    out["moments_sharded"] = all(
        state.optimizer.state[p]["exp_avg"].shape == p.shape
        and state.optimizer.state[p]["exp_avg_sq"].shape == p.shape
        for p in train.leaves(state.params))
    return out


def _grad_tree(tree):
    if isinstance(tree, dict):
        return {k: _grad_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_grad_tree(v) for v in tree]
    return tree.grad.detach().clone()


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_detached(v) for v in tree]
    return tree.detach().clone()


def raises(inp):
    """Each sharded entry point on a mesh or group of the wrong size:
    returns {check: the exception's type name, or None if it did not
    raise}."""
    world = dist.get_world_size()
    pipe_mesh = mesh_of((world,), ("pipe",))
    half = mesh_of((world // 2,), ("model",))          # ranks 0..world/2-1 only
    config = MODEL_CONFIGS["llama3-test"]
    checks = {
        "make_mesh": lambda: pmesh.make_mesh(f"{world}x{world}", "cpu"),
        "ring_on_sub_world": lambda: ring_attention.make_ring_attention(half),
        "ulysses_without_axis": lambda: ring_attention.make_ulysses_attention(pipe_mesh),
        "pp_stages": lambda: pipeline.build_pp_forward(pipe_mesh, config, world * 2, 1),
        "pp_on_sub_world": lambda: pipeline.build_pp_forward(half, config, world // 2, 1,
                                                             axis_name="model"),
        "moe_experts": lambda: moe.shard_moe_params(
            {"router": torch.zeros(4, 3), "w1": torch.zeros(world + 1, 4, 2),
             "w3": torch.zeros(world + 1, 4, 2), "w2": torch.zeros(world + 1, 2, 4)},
            mesh_of((world,), ("expert",))),
        "moe_ffn_local_count": lambda: moe.moe_ffn(
            {"router": torch.zeros(4, 2 * world), "w1": torch.zeros(3, 4, 2),
             "w3": torch.zeros(3, 4, 2), "w2": torch.zeros(3, 2, 4)},
            torch.zeros(1, 2, 4), moe.MoEConfig(4, 2 * world, 2),
            mesh=mesh_of((world,), ("expert",))),
        "train_without_data_axis": lambda: train.build_sharded_train_step(pipe_mesh, config),
        "train_on_sub_world": lambda: train.build_sharded_train_step(half, config),
        "causal_attention_ring_without_mesh": lambda: causal_attention(
            torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 2, 8),
            impl="ring"),
    }
    out = {}
    for check, fn in checks.items():
        try:
            fn()
            out[check] = None
        except (ValueError, RuntimeError) as exc:
            out[check] = type(exc).__name__
    return out


KINDS = {"attention": attention, "pipe": pipe, "moe": moe_case, "shards": shards,
         "train": train_case, "raises": raises}


def main(rank: int, world: int, port: int, cases_path: str, out_path: str) -> int:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    with open(cases_path, "rb") as fh:
        cases = pickle.load(fh)
    results, rc = {}, 0
    for name, kind, inputs in cases:
        if rc:
            results[name] = ("error", "not run: an earlier case failed")
            continue
        try:
            results[name] = ("ok", KINDS[kind](inputs))
        except Exception:
            results[name] = ("error", traceback.format_exc())
            rc = 1
    with open(out_path + ".tmp", "wb") as fh:
        pickle.dump(results, fh)
    os.replace(out_path + ".tmp", out_path)
    if not rc:
        dist.barrier()
        dist.destroy_process_group()
    return rc


if __name__ == "__main__":
    rank, world, port = (int(x) for x in sys.argv[1:4])
    sys.exit(main(rank, world, port, sys.argv[4], sys.argv[5]))
