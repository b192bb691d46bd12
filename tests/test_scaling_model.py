"""Sharded-sweep scaling-model regression: the compiled step/drain
programs contain EXACTLY the collectives the model charges for (per
step: the counts/lines/offsets all-gathers; per drain: the store
gathers and one colmax pmax), and the dispatch-step count matches
ceil(items / (n_dev * G)).

Reference parallel shape being modelled: tbb::parallel_reduce over
block-rows with join-merged thread state (SpydrPick.hpp:143,
mi.hpp:336-361) — here per-step counts all-gathers + one end-of-sweep
gather/pmax drain."""

import re

import numpy as np
import pytest

import jax
from jax.sharding import PartitionSpec as P

from spydrpick_jax.engine.solver import EngineConfig, MIEngine
from spydrpick_jax.parallel.mesh import (
    make_drain,
    make_mesh,
    make_sharded_group_step,
    sharded_sweep,
)

from tests.conftest import random_alignment

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs the 8-virtual-device CPU mesh"
)


def _counts(txt: str) -> tuple[int, int]:
    """(#all_gather ops, #all_reduce ops) in lowered StableHLO text."""
    return (len(re.findall(r"stablehlo\.all_gather", txt)),
            len(re.findall(r"stablehlo\.all_reduce", txt)))


def _engine(wog_fetch):
    al = random_alignment(n_samples=48, n_loci=1024, seed=5, gap_frac=0.1)
    al.weights = np.random.default_rng(1).random(48) * 0.9 + 0.1
    return MIEngine(al, EngineConfig(tile=128, wog_fetch=wog_fetch,
                                     rows_per_dispatch=2,
                                     edge_capacity=8192))  # KL = 64 lines


def _store_args(mesh, st, n_dev, cap=64, lazy=True):
    sh = jax.sharding.NamedSharding(mesh, P("rows"))
    mk = lambda shape, dt: jax.device_put(np.zeros(shape, dt), sh)
    LN = st.store_lanes
    return (mk((n_dev, cap, LN), np.float32),
            mk((n_dev, 1 if lazy else cap, LN), np.float32),
            mk((n_dev, cap, LN), np.int32),
            mk((n_dev, cap, LN), np.int32),
            mk((n_dev, st.Lp), np.float32))


def test_drain_collective_counts_match_model():
    """Lazy drain: 3 all-gathers (mi/ip/jp prefixes) + 1 all-reduce
    (colmax pmax); full drain adds the wog gather (4 + 1).  Any extra
    collective is a model regression (and a payload regression on ICI)."""
    n_dev = 4
    for wog_fetch, want_ag in (("outliers", 3), ("full", 4)):
        eng = _engine(wog_fetch)
        mesh = make_mesh(n_devices=n_dev)
        drain = make_drain(mesh, eng.statics, 8)
        args = _store_args(mesh, eng.statics, n_dev,
                           lazy=eng.statics.wog_lazy)
        ag, ar = _counts(drain.lower(*args).as_text())
        assert (ag, ar) == (want_ag, 1), (wog_fetch, ag, ar)


def test_step_collective_counts_match_model():
    """The per-step program's only collectives are the three tiny
    bookkeeping all-gathers (counts, lines, offsets — ~hundreds of
    bytes); the edge payload must NOT be collected per step."""
    n_dev = 4
    eng = _engine("outliers")
    st = eng.statics
    mesh = make_mesh(n_devices=n_dev)
    step = make_sharded_group_step(mesh, st)
    G = 2
    sh = jax.sharding.NamedSharding(mesh, P("rows"))
    rep = jax.sharding.NamedSharding(mesh, P())
    data = jax.tree.map(
        lambda x: jax.device_put(np.asarray(x), rep), eng.data)
    starts = jax.device_put(np.full((n_dev, G), -1, np.int32), sh)
    mi_s, wog_s, ip_s, jp_s, colmax = _store_args(mesh, st, n_dev, lazy=True)
    offset = jax.device_put(np.zeros(n_dev, np.int32), sh)
    total = jax.device_put(np.zeros(n_dev, np.int32), sh)
    txt = step.lower(data, starts, np.float32(0.05), colmax, mi_s, wog_s,
                     ip_s, jp_s, offset, total).as_text()
    ag, ar = _counts(txt)
    assert (ag, ar) == (3, 0), (ag, ar)


def test_step_count_matches_model():
    """timings['steps'] == ceil(items / (n_dev * G)) — the serial-term
    multiplier of the Amdahl model (each step costs one counts
    round-trip + host bookkeeping)."""
    eng = _engine("outliers")  # L=1024, tile=128 -> 8 block-row items
    for n_dev in (2, 4):
        mesh = make_mesh(n_devices=n_dev)
        tm: dict = {}
        edges = sharded_sweep(eng, 0.05, mesh=mesh, timings=tm)
        G = eng.config.rows_per_dispatch
        items = 8
        assert tm["n_dev"] == n_dev
        assert tm["steps"] == -(-items // (n_dev * G)), tm
        assert edges.n_edges > 0
