"""Driver contract: bench.py must print ONE JSON line with the required
keys, and __graft_entry__ must expose entry()/dryrun_multichip."""
import os
import subprocess
import sys


def test_bench_help_and_contract_keys():
    # --help proves argparse wiring without a device run
    r = subprocess.run([sys.executable, "bench.py", "--help"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0
    for flag in ("--steps", "--chunk", "--full"):
        assert flag in r.stdout


def test_graft_entry_surface():
    import __graft_entry__ as g
    assert callable(g.entry)
    assert callable(g.dryrun_multichip)
    fn, args = g.entry()
    assert callable(fn) and len(args) == 2


def test_bench_refuses_cpu():
    """A measurement with no GPU behind it fails instead of reporting CPU
    numbers under a device metric."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "bench.py", "--steps", "1",
                        "--chunk", "1"], capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"value"' not in r.stdout
