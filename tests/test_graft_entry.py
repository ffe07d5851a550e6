"""Driver entry points: entry() traces and dryrun_multichip in a subprocess
(fresh process so the CPU platform + virtual devices can be configured)."""

import os
import subprocess
import sys

import jax
import pytest


def test_entry_returns_jittable():
    from __graft_entry__ import entry

    fn, args = entry()
    out = jax.jit(fn)(*args)
    accum, rays = out
    assert accum.shape == (64 * 48, 3)
    assert float(rays) > 0


@pytest.mark.skipif(os.environ.get("VKRT_SKIP_SUBPROC") == "1",
                    reason="subprocess test disabled")
def test_dryrun_multichip_subprocess():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("JAX_PLATFORM_NAME", None)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    out = subprocess.run(
        [sys.executable, "-c",
         "from __graft_entry__ import dryrun_multichip; "
         "dryrun_multichip(8, interpret_kernel=True)"],
        capture_output=True, text=True, timeout=600, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "dryrun_multichip OK" in out.stdout
