"""bench.py smoke: the benchmark must not rot while engine options
churn.  Runs bench.py on the CPU at a tiny shape and validates the JSON
result line."""

import json
import os
import subprocess
import sys


def test_bench_inner_smoke(tmp_path):
    env = dict(
        os.environ,
        BENCH_SAMPLES="40",
        BENCH_LOCI="512",
        BENCH_TILE="64",
        BENCH_DEPTH="2",
        BENCH_ONEHOT="codes",
        JAX_PLATFORMS="cpu",
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-u", os.path.join(root, "bench.py")],
        env=env, capture_output=True, text=True, timeout=600, cwd=root,
    )
    assert out.returncode in (0, None), out.stdout + out.stderr
    result_lines = [l for l in out.stdout.splitlines() if l.startswith("{")]
    assert result_lines, out.stdout
    res = json.loads(result_lines[-1])
    assert res["metric"] == "mi_column_pairs_per_s"
    assert res["value"] > 0
    assert res["unit"] == "column-pairs/s/chip"
    assert "vs_baseline" in res
    assert res["config"]["edges"] > 0
    # every result names the device it ran on
    dev = res["config"]["device"]
    assert dev["platform"] == "cpu" and dev["count"] >= 1 and dev["kind"]
    # end-to-end phase breakdown (tournament/sweep/aracne/writers)
    e2e = res["config"]["end_to_end_s"]
    for k in ("preprocess_s", "threshold_s", "sweep_s", "aracne_s",
              "write_s", "total_s"):
        assert k in e2e, e2e
    assert e2e["edges"] > 0
