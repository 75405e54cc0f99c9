"""``ops/_build.py``: processes that share a build directory build a kernel
library once. Two processes asking for the same library at the same time
run the compiler once between them (the other waits on the directory's
lock and then loads what the first built). A stub stands in for ``nvcc``:
it records each run, sleeps so that the two requests overlap, and writes
the output file."""

import os
import stat
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CHILD = textwrap.dedent("""
    import sys
    from pathlib import Path
    from mcp_context_forge_tpu_torch.tpu_local.ops import _build
    _build.BUILD_DIR = Path(sys.argv[1])
    logs = _build.build(("flash_attention_mma",))
    print(_build.library_path("flash_attention_mma").read_text(), logs["flash_attention_mma"])
""")


def test_two_processes_build_one_library_once(tmp_path):
    cuda = tmp_path / "cuda"
    (cuda / "bin").mkdir(parents=True)
    runs = tmp_path / "runs"
    nvcc = cuda / "bin" / "nvcc"
    nvcc.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import sys, time
        with open({str(runs)!r}, "a") as f:
            f.write("run\\n")
        time.sleep(1.0)
        out = sys.argv[sys.argv.index("-o") + 1]
        with open(out, "w") as f:
            f.write("library")
        print("ptxas info : 0 bytes spill stores")
    """))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    env = {**os.environ, "CUDA_HOME": str(cuda), "PYTHONPATH": str(ROOT)}
    build_dir = tmp_path / "kernels"
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(build_dir)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=60) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [err for _, err in outs]
    assert runs.read_text().count("run") == 1
    # both read the one library and its compiler log
    assert [out.split() for out, _ in outs] == [["library", "ptxas", "info", ":", "0",
                                                "bytes", "spill", "stores"]] * 2
    assert len(list(build_dir.glob("*.so"))) == 1 and not list(build_dir.glob("*.tmp"))
