"""Multi-process (jax.distributed) execution tests.

The reference is strictly single-process/single-GPU; multi-host data
parallelism over rays is this rebuild's §2.8 mandate (SURVEY.md §7
stage 7).  These tests run the REAL jax.distributed path — coordinator,
gloo collectives, process-spanning mesh — as two local CPU processes,
which is the one multi-host axis testable without a cluster.  In-process
8-virtual-device sharding (tests/test_sharding.py) cannot exercise
process-spanning meshes; this does.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "run_multihost.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _write_scene(tmp_path):
    from cudavolumerenderer_tpu.scene import procedural

    raw = str(tmp_path / "blob.raw")
    procedural.write_raw_uchar(raw, procedural.blob_volume())
    return raw


def _launch(raw, port, pid, nproc, out, tmp_path, extra=()):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env.pop("XLA_FLAGS", None)  # script sets its own device count
    return subprocess.Popen(
        [sys.executable, SCRIPT, raw, "--platform", "cpu",
         "--host-devices", "2", "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", str(nproc), "--process-id", str(pid),
         "-r", "32", "-i", "4", "-o", out, *extra],
        env=env, cwd=str(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )


@pytest.mark.slow
def test_two_process_render_matches_single_process(tmp_path):
    raw = _write_scene(tmp_path)
    port = _free_port()
    out2 = str(tmp_path / "two")
    procs = [
        _launch(raw, port, pid, 2, out2, tmp_path) for pid in (0, 1)
    ]
    logs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-2000:]
    assert "rendered" in logs[0]

    # single process, same 4 global devices
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env.pop("XLA_FLAGS", None)
    out1 = str(tmp_path / "one")
    r = subprocess.run(
        [sys.executable, SCRIPT, raw, "--platform", "cpu",
         "--host-devices", "4", "-r", "32", "-i", "4", "-o", out1],
        env=env, cwd=str(tmp_path), capture_output=True, timeout=600,
    )
    assert r.returncode == 0, r.stdout.decode()[-2000:]

    from cudavolumerenderer_tpu.utils.image import load_hdr

    a = load_hdr(out2 + ".hdr")
    b = load_hdr(out1 + ".hdr")
    # shard-invariant by construction (path-id keyed RNG): the image
    # must not depend on how devices are split across processes
    np.testing.assert_array_equal(a, b)
