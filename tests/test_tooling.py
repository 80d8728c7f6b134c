"""Repository tooling: the compile-cache location rule, the trace
reduction of tools/profile_step.py, and the absence of any kernel
interpreter path in the package."""
import pathlib
from collections import namedtuple

from collide.core.utils import compile_cache_dir

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_compile_cache_follows_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache_dir() == str(tmp_path)


def test_compile_cache_defaults_inside_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache_dir() == str(REPO / ".jax_cache")
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


Plane = namedtuple("Plane", "name lines")
Line = namedtuple("Line", "name events")
Event = namedtuple("Event", "name start_ns duration_ns")


def test_trace_reduction_reads_gpu_op_lines():
    """Only /device:GPU planes count, and on them only the "XLA Ops" line
    (module spans would double-count their ops)."""
    from tools.profile_step import device_events, reduce_events
    planes = [
        Plane("/host:CPU", [Line("python", [Event("host", 0, 500)])]),
        Plane("/device:GPU:0", [
            Line("XLA Modules", [Event("jit_step", 0, 100)]),
            Line("XLA Ops", [Event("fusion.1", 0, 30),
                             Event("gather.2", 40, 20),
                             Event("fusion.1", 70, 10)])]),
    ]
    ev = device_events(planes)
    assert {e[0] for e in ev} == {"XLA Ops"}
    by_op, busy, span = reduce_events(ev)
    assert by_op == {"fusion.1": 40.0, "gather.2": 20.0}
    assert busy == 60.0 and span == 80.0


def test_trace_reduction_merges_overlapping_streams():
    """Without an ops line, stream lines are used and busy time is the
    union of their intervals, not the sum."""
    from tools.profile_step import device_events, reduce_events
    planes = [Plane("/device:GPU:0", [
        Line("Stream #1", [Event("a", 0, 50)]),
        Line("Stream #2", [Event("b", 25, 50), Event("c", 200, 10)]),
    ])]
    _, busy, span = reduce_events(device_events(planes))
    assert busy == 85.0 and span == 210.0


def test_package_has_no_kernel_interpreter_path():
    """No Pallas kernel or interpreter switch remains in the package."""
    # spelled in pieces so this file does not match its own search
    needles = ("pal" + "las", "inter" + "pret=", "plt" + "pu")
    hits = []
    for path in (REPO / "collide").rglob("*.py"):
        text = path.read_text()
        for needle in needles:
            if needle in text:
                hits.append((path.name, needle))
    assert hits == []
