"""The port's training path against the JAX package's, on the CPU in f32:
``forward_logits``/``loss_fn`` (logits rtol = atol = 1e-5, loss rtol 1e-6),
gradients per leaf against ``jax.grad`` (max |port - JAX| <= 1e-7 + 1e-4 x
the leaf's largest |gradient|: elementwise, f32 sums taken in another
order leave ~1e-6 on the smallest elements of gemma-test's leaves), three
AdamW steps against ``optax.adamw`` (parameters within 1e-2 x lr), and the MoE
aux loss (the tiny checkpoint's trainer: ``test_torch_tiny_checkpoint.py``).

Adam moves an element by about lr whatever its gradient's size, so where a
gradient sits within rounding of zero the two packages may move it
differently: an element is excluded from the parameter bound, and counted
and named, when at some step its (nonzero) gradient g lies within 10 x eps
of zero, or so near it that the step's gradient rounding on its leaf
(delta, the largest |port - JAX| there) can move Adam's step
g / (|g| + eps) by a tenth of the bound: (|g| + eps)^2 < 1e3 x eps x delta."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_context_forge_tpu.tpu_local import train as jtrain
from mcp_context_forge_tpu.tpu_local.models import MODEL_CONFIGS as JAX_CONFIGS
from mcp_context_forge_tpu.tpu_local.models.llama import init_params as jax_init
from mcp_context_forge_tpu_torch.tpu_local import train as ttrain
from mcp_context_forge_tpu_torch.tpu_local.models.configs import MODEL_CONFIGS
from mcp_context_forge_tpu_torch.tpu_local.models.convert import params_from_jax
from mcp_context_forge_tpu_torch.tpu_local.models.llama import init_params
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

ADAM_EPS = 1e-8
MODELS = ("llama3-test", "gemma-test", "qwen2-tiny", "mixtral-test")


def batch(seed: int, B: int = 2, S: int = 16, vocab: int = 512):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    return tokens, np.roll(tokens, -1, axis=1), mask


def jax_params(name: str, seed: int = 0):
    params = jax_init(JAX_CONFIGS[name], jax.random.PRNGKey(seed), dtype=jnp.float32)
    if JAX_CONFIGS[name].attn_bias:   # zero biases would hide their gradients' use
        for i, layer in enumerate(params["layers"]):
            for j, b in enumerate(("bq", "bk", "bv")):
                layer[b] = layer[b] + 0.01 * (i + 1) * (j + 1)
    return params


def port_params(np_tree, name: str):
    return params_from_jax(np_tree, MODEL_CONFIGS[name], device="cpu", dtype=torch.float32)


def torch_batch(tokens, targets, mask):
    return torch.tensor(tokens), torch.tensor(targets), torch.tensor(mask)


def paired(port_tree, ref_tree, path=""):
    """(path, port leaf, reference leaf as numpy) over two trees."""
    if isinstance(port_tree, dict):
        for key in port_tree:
            yield from paired(port_tree[key], ref_tree[key], f"{path}/{key}")
    elif isinstance(port_tree, list):
        for i, (a, b) in enumerate(zip(port_tree, ref_tree)):
            yield from paired(a, b, f"{path}/{i}")
    else:
        yield path, port_tree, np.asarray(ref_tree)


def port_grads(params, config, tokens, targets, mask):
    for leaf in ttrain.leaves(params):
        leaf.requires_grad_(True)
        leaf.grad = None
    loss = ttrain.loss_fn(params, config, tokens, targets, mask)
    loss.backward()
    return loss.detach()


@functools.lru_cache(maxsize=None)
def jax_reference(name: str):
    """JAX's logits, aux loss, loss and gradients for ``name`` on one batch
    (each a single jitted program)."""
    jp, cfg = jax_params(name), JAX_CONFIGS[name]
    tokens, targets, mask = batch(1)
    forward = jax.jit(lambda p, t: jtrain.forward_logits(p, cfg, t, return_aux=True))
    logits, aux = forward(jp, tokens) if cfg.n_experts else (
        jax.jit(lambda p, t: jtrain.forward_logits(p, cfg, t))(jp, tokens), None)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t, y, m: jtrain.loss_fn(p, cfg, t, y, m)))(jp, tokens, targets, mask)
    return dict(params=jax.device_get(jp), batch=(tokens, targets, mask),
                logits=np.asarray(logits), aux=None if aux is None else float(aux),
                loss=float(loss), grads=jax.device_get(grads))


@pytest.mark.parametrize("name", MODELS)
def test_forward_and_loss_match_jax(name):
    ref = jax_reference(name)
    config = MODEL_CONFIGS[name]
    pp = port_params(ref["params"], name)
    tb = torch_batch(*ref["batch"])
    with torch.no_grad():
        if config.n_experts:
            got, aux = ttrain.forward_logits(pp, config, tb[0], return_aux=True)
            np.testing.assert_allclose(float(aux), ref["aux"], rtol=1e-6)
        else:
            got = ttrain.forward_logits(pp, config, tb[0])
        loss = ttrain.loss_fn(pp, config, *tb)
    np.testing.assert_allclose(got.numpy(), ref["logits"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-6)


@pytest.mark.parametrize("name", MODELS)
def test_gradients_match_jax_grad(name):
    ref = jax_reference(name)
    pp = port_params(ref["params"], name)
    loss = port_grads(pp, MODEL_CONFIGS[name], *torch_batch(*ref["batch"]))
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-6)
    n_leaves = 0
    for path, leaf, want in paired(pp, ref["grads"]):
        err = np.abs(leaf.grad.numpy() - want).max()
        assert err <= 1e-7 + 1e-4 * np.abs(want).max(), (path, err, np.abs(want).max())
        assert np.abs(want).max() > 0, path   # every leaf takes part
        n_leaves += 1
    assert n_leaves == len(ttrain.leaves(pp))


@pytest.mark.parametrize("name", ("llama3-test", "gemma-test", "mixtral-test"))
def test_three_adamw_steps_match_optax(name):
    lr = 1e-3
    jconfig, config = JAX_CONFIGS[name], MODEL_CONFIGS[name]
    jp = jax_params(name, seed=3)
    pp = port_params(jax.device_get(jp), name)
    optimizer = jtrain.make_optimizer(lr)
    jstate = jtrain.TrainState(jp, optimizer.init(jp), jnp.zeros((), jnp.int32))
    jstep = jax.jit(lambda s, t, y, m: jtrain.train_step(s, jconfig, optimizer, t, y, m))
    jgrad = jax.jit(jax.grad(lambda p, t, y, m: jtrain.loss_fn(p, jconfig, t, y, m)))
    state = ttrain.init_train_state(pp, ttrain.make_optimizer(lr))
    near_zero = {}
    for step in range(3):
        tokens, targets, mask = batch(10 + step)
        grads = jax.device_get(jgrad(jstate.params, tokens, targets, mask))
        jstate, jloss = jstep(jstate, tokens, targets, mask)
        state, loss = ttrain.train_step(state, config, *torch_batch(tokens, targets, mask))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
        for path, leaf, g in paired(state.params, grads):   # .grad: this step's
            delta = np.abs(leaf.grad.numpy() - g).max()
            assert delta <= 1e-7 + 1e-4 * np.abs(g).max(), (step, path, delta)
            tiny = (g != 0) & ((np.abs(g) < 10 * ADAM_EPS)
                               | ((np.abs(g) + ADAM_EPS) ** 2 < 1e3 * ADAM_EPS * delta))
            near_zero[path] = near_zero.get(path, np.zeros_like(tiny)) | tiny
    assert state.step == 3
    excluded, outside = {}, {}
    for path, leaf, ref in paired(state.params, jax.device_get(jstate.params)):
        keep = ~near_zero[path]
        err = np.abs(leaf.detach().numpy() - ref)
        assert not keep.any() or err[keep].max() <= 1e-2 * lr, (path, err[keep].max())
        if (~keep).any():
            excluded[path] = int((~keep).sum())
            outside[path] = int((err[~keep] > 1e-2 * lr).sum())
    print(f"{name}: elements excluded for a gradient within rounding of zero, by "
          f"leaf: {excluded or 'none'}; of them past the bound: {outside or 'none'}")
    total = sum(leaf.numel() for leaf in ttrain.leaves(state.params))
    assert sum(excluded.values()) <= 1e-2 * total, excluded


def test_adamw_rule_is_optax_adamw():
    """One step on a hand-made gradient: decay on every leaf, decoupled,
    eps outside the square root."""
    lr, wd = 1e-2, 0.1
    p0 = np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4)
    g = np.array([[1e-3, -2, 0, 5e-9], [3, -1e-6, 0.5, 2], [-4, 1, 1e-4, -3e-8]],
                 np.float32)
    import optax
    opt = optax.adamw(lr, weight_decay=wd)
    updates, _ = opt.update(jnp.asarray(g), opt.init(jnp.asarray(p0)), jnp.asarray(p0))
    want = np.asarray(optax.apply_updates(jnp.asarray(p0), updates))
    p = torch.tensor(p0, requires_grad=True)
    optimizer = ttrain.make_optimizer(lr, wd)([p])
    p.grad = torch.tensor(g)
    optimizer.step()
    # a few ulps of the update's rounding; decay applied twice would be off
    # by lr x wd x |p| (up to 1e-3 here)
    np.testing.assert_allclose(p.detach().numpy(), want, rtol=0, atol=1e-4 * lr)


def test_moe_aux_loss_trains_against_collapse():
    """A collapsed router scores worse than a balanced one, and the aux term
    is in the objective: weight 0.5 moves the loss by 0.5 x aux."""
    cfg = MODEL_CONFIGS["mixtral-test"]
    gen = torch.Generator().manual_seed(37)
    params = init_params(cfg, gen, dtype=torch.float32, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen)
    with torch.no_grad():
        _, aux = ttrain.forward_logits(params, cfg, tokens, return_aux=True)
        assert 0.9 < float(aux) < cfg.n_experts + 0.1
        collapsed = {**params, "layers": [dict(layer) for layer in params["layers"]]}
        for layer in collapsed["layers"]:
            router = torch.zeros_like(layer["router"])
            router[:, 0] = 10.0
            layer["router"] = router
        _, aux_collapsed = ttrain.forward_logits(collapsed, cfg, tokens, return_aux=True)
        assert float(aux_collapsed) > float(aux)
        targets = torch.roll(tokens, -1, dims=1)
        mask = torch.ones(tokens.shape)
        off = ttrain.loss_fn(params, cfg, tokens, targets, mask, moe_aux_weight=0.0)
        on = ttrain.loss_fn(params, cfg, tokens, targets, mask, moe_aux_weight=0.5)
    np.testing.assert_allclose(float(on - off), 0.5 * float(aux), rtol=1e-4)


def test_grouped_moe_training_follows_jax_grad():
    """``grouped`` (plain on the CPU) gives the dense scan's loss and
    gradients, as ``jax.grad`` of the JAX package's XLA grouped path does;
    ``grouped_pallas`` raises under autograd, as ``jax.grad`` of its Pallas
    kernel does, and still runs without gradients."""
    import dataclasses

    name = "mixtral-test"
    jp = jax_params(name)
    tokens, targets, mask = batch(4, B=2, S=8)
    tb = torch_batch(tokens, targets, mask)
    grouped = dataclasses.replace(MODEL_CONFIGS[name], moe_impl="grouped", moe_block=8)
    dense_params, grouped_params = port_params(jax.device_get(jp), name), \
        port_params(jax.device_get(jp), name)
    dense_loss = port_grads(dense_params, MODEL_CONFIGS[name], *tb)
    grouped_loss = port_grads(grouped_params, grouped, *tb)
    np.testing.assert_allclose(float(grouped_loss), float(dense_loss), rtol=1e-6)
    for leaf, ref in zip(ttrain.leaves(grouped_params), ttrain.leaves(dense_params)):
        err = (leaf.grad - ref.grad).abs().max()
        assert err <= 1e-7 + 1e-4 * ref.grad.abs().max(), (tuple(leaf.shape), err)
    pallas = dataclasses.replace(grouped, moe_impl="grouped_pallas")
    with pytest.raises(NotImplementedError):
        ttrain.loss_fn(grouped_params, pallas, *tb)
    jpallas = dataclasses.replace(JAX_CONFIGS[name], moe_impl="grouped_pallas", moe_block=8)
    with pytest.raises(NotImplementedError):   # raised while tracing
        jax.jit(jax.grad(jtrain.loss_fn), static_argnums=1)(jp, jpallas, tokens, targets,
                                                            mask)
    with torch.no_grad():
        assert torch.isfinite(ttrain.loss_fn(grouped_params, pallas, *tb))


def test_kernel_wrappers_refuse_autograd():
    """A hand-written kernel writes through raw pointers: its wrapper
    refuses tensors that autograd would need a backward for."""
    from mcp_context_forge_tpu_torch.tpu_local.ops import _build

    q = torch.zeros(8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        _build.check_inputs("flash_attention_mma", {"q": q}, {})
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        _build.check_inputs("flash_attention_mma", {"q": q}, {})
