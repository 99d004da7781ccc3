"""Examples smoke coverage.

The reference's executable-script culture (SURVEY section 4.2) is mirrored
by ``examples/01-15``; this runs EVERY example headless in a subprocess with
``UAV_FAST_EXAMPLES=1`` (the examples route workload sizes through
``utils.examples.scaled``), pinned to the CPU backend the same way
``conftest.py`` pins the suite.
"""

import glob
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(REPO, "examples", "[0-9]*.py")))

_BOOTSTRAP = (
    "import jax, runpy, sys; "
    "jax.config.update('jax_platforms', 'cpu'); "
    "runpy.run_path(sys.argv[1], run_name='__main__')"
)


def test_examples_discovered():
    assert len(EXAMPLES) == 15, EXAMPLES


@pytest.mark.slow
@pytest.mark.parametrize(
    "path", EXAMPLES, ids=[os.path.basename(p)[:2] for p in EXAMPLES]
)
def test_example_runs_headless(path):
    env = dict(os.environ)
    env["UAV_FAST_EXAMPLES"] = "1"
    env["MPLBACKEND"] = "Agg"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    flags = env.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        # 04/06 shard over the device mesh; give the subprocess 8 like CI
        env["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    res = subprocess.run(
        [sys.executable, "-c", _BOOTSTRAP, path],
        capture_output=True, text=True, timeout=900, env=env, cwd=REPO,
    )
    assert res.returncode == 0, (
        f"{os.path.basename(path)} failed\n--- stdout ---\n"
        f"{res.stdout[-2000:]}\n--- stderr ---\n{res.stderr[-4000:]}"
    )
    assert res.stdout.strip(), "example printed nothing"
