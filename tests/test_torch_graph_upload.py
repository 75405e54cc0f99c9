"""``decode_graphs.upload_graph``: the driver call that uploads a captured
decode graph, so that a server's first replay pays no upload. The card
runs it after every capture (``chip_smoke.py``'s ``engine_llama3_8b_ops``
holds that first replay's device time to a warm replay's); here the
driver library is a stand-in that records the call."""

from __future__ import annotations

import ctypes
from types import SimpleNamespace

import pytest

from mcp_context_forge_tpu_torch.tpu_local import decode_graphs


class FakeDriver:
    def __init__(self, result: int):
        self.result = result
        self.calls = []

    def cuGraphUpload(self, graph_exec, stream):   # noqa: N802 (the driver's name)
        self.calls.append((graph_exec.value, stream.value))
        return self.result


def fake_graph():
    return (SimpleNamespace(raw_cuda_graph_exec=lambda: 0x5EC),
            SimpleNamespace(cuda_stream=0x57A))


@pytest.mark.parametrize("result", [0, 700])
def test_upload_graph_passes_the_executable_and_stream(monkeypatch, result):
    driver = FakeDriver(result)
    opened = []

    def cdll(name):
        opened.append(name)
        return driver

    monkeypatch.setattr(ctypes, "CDLL", cdll)
    graph, stream = fake_graph()
    if result == 0:
        decode_graphs.upload_graph(graph, stream)
    else:
        with pytest.raises(RuntimeError, match="CUresult 700"):
            decode_graphs.upload_graph(graph, stream)
    assert opened == ["libcuda.so.1"]
    assert driver.calls == [(0x5EC, 0x57A)]
