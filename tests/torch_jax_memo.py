"""A memo of the XLA executables the JAX reference compiles, for the port's
parity tests (``tests/test_torch_*.py``), which build many ``TPUEngine``s
and run many reference functions on the CPU, and so compile the same
programs again and again: every engine jits its own bound methods, and
JAX's own caches key on the function object, so a second engine of the
same config compiles every program anew. XLA's compile is most of those
files' time.

``jax_compile_memo`` (autouse, module-scoped: a test module imports it by
name) routes ``jax._src.compiler.backend_compile_and_load`` through a
dict keyed by the program's text, its compile options and its devices,
so an identical program is compiled once per process. The executable is
the one XLA built for that very program, so results are unchanged. It is
installed only while a module that imports it runs: the JAX package's
own tests, which run in the same worker processes, compile as they always
do. JAX still records its compile event around each lookup, so counts of
compiles are unchanged too.

While such a module runs, torch also runs on one thread: the test workers
share the box's cores (six of them on eight, in the tier-1 run), and the
tiny models' ops gain nothing from more threads, which each worker would
otherwise start per core."""

import hashlib

import pytest
import torch
from jax._src import compiler

_ORIGINAL = compiler.backend_compile_and_load
_MEMO: dict = {}
# executables kept per process; past this the memo starts again (a worker
# runs many modules, and each executable holds its code in memory)
_MAX_ENTRIES = 2048


def _memoized(backend, module, executable_devices, options, host_callbacks):
    if host_callbacks:
        return _ORIGINAL(backend, module, executable_devices, options, host_callbacks)
    key = (hashlib.sha256(str(module).encode()).digest(), options.SerializeAsString(),
           tuple(d.id for d in executable_devices), id(backend))
    executable = _MEMO.get(key)
    if executable is None:
        if len(_MEMO) >= _MAX_ENTRIES:
            _MEMO.clear()
        executable = _MEMO[key] = _ORIGINAL(backend, module, executable_devices, options,
                                            host_callbacks)
    return executable


@pytest.fixture(scope="module", autouse=True)
def jax_compile_memo():
    threads = torch.get_num_threads()
    compiler.backend_compile_and_load = _memoized
    torch.set_num_threads(1)
    try:
        yield
    finally:
        compiler.backend_compile_and_load = _ORIGINAL
        torch.set_num_threads(threads)
