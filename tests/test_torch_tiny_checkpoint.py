"""The port's tiny-checkpoint tool (``mcp_context_forge_tpu_torch.tools.
tiny_checkpoint``) against the JAX package's, on the CPU: the corpus and
tokenizer, ``train_model`` for 20 steps from the same start (loss rtol
1e-5), the port's 400-step checkpoint through both packages'
``load_hf_llama`` (bit for bit) and its greedy answers, ``save_hf``'s
tensors against ``safetensors.numpy.load_file`` of JAX's writer on the same
params, the byte adapter the card trains with, and the command line
refusing without ``tokenizers``."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_context_forge_tpu.tpu_local.models import MODEL_CONFIGS as JAX_CONFIGS
from mcp_context_forge_tpu.tpu_local.models.llama import init_params as jax_init
from mcp_context_forge_tpu_torch.tpu_local import train as ttrain
from mcp_context_forge_tpu_torch.tpu_local.models.configs import MODEL_CONFIGS
from mcp_context_forge_tpu_torch.tpu_local.models.convert import params_from_jax
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)


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


def port_params(np_tree):
    return params_from_jax(np_tree, MODEL_CONFIGS["llama3-test"], device="cpu",
                           dtype=torch.float32)


@pytest.fixture(scope="module")
def bpe(tmp_path_factory):
    from mcp_context_forge_tpu_torch.tools.tiny_checkpoint import build_tokenizer
    return build_tokenizer(str(tmp_path_factory.mktemp("tok")))


@pytest.fixture(scope="module")
def port_checkpoint(tmp_path_factory, bpe):
    """The port's 400-step checkpoint on the BPE corpus, in HF layout."""
    from mcp_context_forge_tpu_torch.tools import tiny_checkpoint as tc

    out = str(tmp_path_factory.mktemp("port-ckpt"))
    bpe.save(os.path.join(out, "tokenizer.json"))
    params, loss = tc.train_model(bpe, steps=400, seq_len=tc.covering_seq_len(bpe),
                                  device="cpu")
    tc.save_hf(out, params, loss)
    return out, params, loss


def test_tokenizer_corpus_matches_jax(bpe):
    from mcp_context_forge_tpu.tools import tiny_checkpoint as jtc
    from mcp_context_forge_tpu_torch.tools import tiny_checkpoint as tc

    assert tc.CORPUS == jtc.CORPUS and tc.SPECIALS == jtc.SPECIALS
    assert tc._FACTS == jtc._FACTS
    assert tc.covering_seq_len(bpe) == 64   # the BPE rows fit JAX's width


def test_train_model_matches_jax_for_20_steps(bpe):
    from mcp_context_forge_tpu.tools import tiny_checkpoint as jtc
    from mcp_context_forge_tpu_torch.tools import tiny_checkpoint as tc

    jp, jloss = jtc.train_model(bpe, steps=20)
    start = jax_init(JAX_CONFIGS["llama3-test"], jax.random.PRNGKey(42), dtype=jnp.float32)
    params, loss = tc.train_model(bpe, steps=20, seq_len=64, device="cpu",
                                  params=port_params(jax.device_get(start)))
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    worst = max(np.abs(leaf.numpy() - ref).max()
                for _, leaf, ref in paired(params, jax.device_get(jp)))
    # 20 Adam steps of lr 3e-3: one element's near-zero gradient may flip
    # its direction once (a move of up to 2 lr)
    assert worst <= 2 * 3e-3, worst


def test_port_checkpoint_loads_through_both_loaders(port_checkpoint):
    from mcp_context_forge_tpu.tpu_local.checkpoint import load_hf_llama as jax_load
    from mcp_context_forge_tpu.tpu_local.models.llama import params_logical
    from mcp_context_forge_tpu_torch.tpu_local.checkpoint import load_hf_llama

    out, params, loss = port_checkpoint
    assert loss < 0.5, f"memorization failed (loss {loss:.3f})"
    config = MODEL_CONFIGS["llama3-test"]
    loaded = load_hf_llama(out, config, device="cpu", dtype=torch.float32)
    for path, leaf, ref in paired(loaded, params):
        assert torch.equal(leaf, torch.as_tensor(ref)), path
    device = jax.devices()[0]
    shardings = jax.tree.map(lambda _: jax.sharding.SingleDeviceSharding(device),
                             params_logical(JAX_CONFIGS["llama3-test"]))
    jloaded = jax_load(out, JAX_CONFIGS["llama3-test"], shardings, jnp.float32)
    for path, leaf, ref in paired(params, jax.device_get(jloaded)):
        np.testing.assert_array_equal(leaf.numpy(), ref, err_msg=path)


def test_port_checkpoint_memorized_the_facts(port_checkpoint):
    from mcp_context_forge_tpu_torch.tools.tiny_checkpoint import _FACTS
    from mcp_context_forge_tpu_torch.tpu_local.tokenizer import load_tokenizer

    out, params, _ = port_checkpoint
    tok = load_tokenizer(out)
    config = MODEL_CONFIGS["llama3-test"]
    for prompt, answer in _FACTS:
        ids = tok.encode(prompt)
        for _ in range(len(tok.encode(answer, add_bos=False))):
            with torch.no_grad():
                logits = ttrain.forward_logits(params, config, torch.tensor([ids]))
            ids.append(int(logits[0, -1].argmax()))
        assert tok.decode(ids).endswith(answer), (prompt, tok.decode(ids))


def test_save_hf_tensors_equal_jax_writer(tmp_path, port_checkpoint):
    from safetensors.numpy import load_file

    from mcp_context_forge_tpu.tools import tiny_checkpoint as jtc
    from mcp_context_forge_tpu_torch.tools import tiny_checkpoint as tc

    _, params, loss = port_checkpoint
    np_tree = jax.tree.map(lambda t: t.numpy(), params)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jtc.save_hf(str(tmp_path / "jax"), np_tree, loss)
    tc.save_hf(str(tmp_path / "port"), params, loss)
    want = load_file(str(tmp_path / "jax" / "model.safetensors"))
    got = load_file(str(tmp_path / "port" / "model.safetensors"))
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert (tmp_path / "port" / "config.json").read_text() == \
        (tmp_path / "jax" / "config.json").read_text()


def test_byte_adapter_rows_fit_the_model():
    from mcp_context_forge_tpu_torch.tools import tiny_checkpoint as tc

    adapter = tc.ByteTokenizerAdapter()
    seq_len = tc.covering_seq_len(adapter)
    tokens, targets, mask = tc.corpus_batch(adapter, seq_len)
    longest = "the capital of france is paris. " * 9
    assert seq_len == len(longest) and seq_len < MODEL_CONFIGS["llama3-test"].max_seq_len
    assert int(mask.sum(axis=1).max()) == seq_len        # the longest row whole
    assert adapter.token_to_id("<|eot_id|>") == 261
    assert adapter.encode("<|eot_id|>ab").ids == [261, 97, 98]


def test_cli_refuses_without_tokenizers(tmp_path):
    code = ("import sys, runpy\n"
            "sys.modules['tokenizers'] = None\n"
            "sys.argv = ['tiny_checkpoint', sys.argv[1], '--device', 'cpu']\n"
            "runpy.run_module('mcp_context_forge_tpu_torch.tools.tiny_checkpoint',"
            " run_name='__main__')\n")
    out = tmp_path / "ckpt"
    proc = subprocess.run([sys.executable, "-c", code, str(out)], capture_output=True,
                          text=True, timeout=120,
                          cwd=os.path.dirname(os.path.dirname(__file__)))
    assert proc.returncode == 2, proc.stderr
    assert "'tokenizers' package is not installed" in proc.stderr
    assert not (out / "model.safetensors").exists()
