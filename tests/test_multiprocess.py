"""2-process distributed sweep: the collective drain must produce the
same merged EdgeSet on every process, identical to a single-device run.

This is the multi-host execution test SURVEY §7.9 calls for: two real
OS processes, each owning 2 virtual CPU devices, joined with
``jax.distributed.initialize`` over localhost — the sharded sweep's
``all_gather`` drain and ``pmax`` colmax merge run over a 4-device
2-process global mesh.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_sharded_sweep(tmp_path):
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = (
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        + os.pathsep + env.get("PYTHONPATH", "")
    )
    env.pop("JAX_PLATFORMS", None)
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "multiproc_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, f"127.0.0.1:{port}", "2", str(i),
             str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed worker timed out")
        outs.append(out.decode(errors="replace"))
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{outs[i]}"

    # both processes must see the identical merged edge set
    a = np.load(tmp_path / "proc0.npz")
    b = np.load(tmp_path / "proc1.npz")
    for k in ("ipos", "jpos", "mi", "mi_wog", "colmax"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert len(a["ipos"]) > 0

    # and identical to a plain single-device sweep of the same data
    from spydrpick_jax.core.alignment import Alignment
    from spydrpick_jax.engine.solver import EngineConfig, MIEngine

    rng = np.random.default_rng(7)
    S, L = 24, 96
    codes = rng.integers(0, 5, size=(S, L)).astype(np.uint8)
    al = Alignment(
        codes=codes,
        sample_names=[f"s{i}" for i in range(S)],
        id_string="multiproc",
        translation=np.arange(L, dtype=np.int64),
        n_original_positions=L,
        weights=rng.random(S) + 0.5,
    )
    engine = MIEngine(al, EngineConfig(tile=16, edge_capacity=512))
    ref = engine.sweep(0.01).sort_desc()
    np.testing.assert_array_equal(a["ipos"], ref.ipos)
    np.testing.assert_array_equal(a["jpos"], ref.jpos)
    np.testing.assert_allclose(a["mi"], ref.mi, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(a["colmax"], ref.colmax, rtol=1e-6, atol=1e-9)

    # the cross-process 2-D (rows x samples) sweep: identical on both
    # processes, equal to the reference at psum accumulation-order
    # level.  Compare keyed by (i, j) — desc-MI ordering may legally
    # flip near-ties, since sample-sharded crosstables (incl. the
    # sharded overflow re-extraction) accumulate in a different order
    # than the single-device dot.
    np.testing.assert_array_equal(a["ipos2"], b["ipos2"])
    np.testing.assert_array_equal(a["mi2"], b["mi2"])
    k2 = np.lexsort((a["jpos2"], a["ipos2"]))
    kr = np.lexsort((ref.jpos, ref.ipos))
    np.testing.assert_array_equal(a["ipos2"][k2], ref.ipos[kr])
    np.testing.assert_array_equal(a["jpos2"][k2], ref.jpos[kr])
    np.testing.assert_allclose(a["mi2"][k2], ref.mi[kr], rtol=1e-4, atol=1e-6)
