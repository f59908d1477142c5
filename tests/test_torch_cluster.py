"""The port's cluster replay against the JAX package's.

Logical legs: the port's ``run_cluster_trace`` (copies of
``serving/cluster/`` over the copied control plane) must write the JAX
package's trace line for line, on the fixed fleet (seeds 0-2) and on the
elastic one (seed 0, two decode replicas and one prefill replica, as the
reference CLI runs it). Physical legs: every replica a shadow-clocked
``TorchModelBackend`` on the CPU over one shared ``Model``; the trace must
equal the logical one byte for byte, with ``Cluster.check`` after every
step, every staging and COW check bit-exact, and host copies that really
cross replicas. Both packages run in one interpreter: block hashing uses
Python's ``hash``. Tolerance: none — traces and reports compare as bytes.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro.sim import replay as jax_replay
from repro_torch.sim import replay

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing
# the cores (tiny eager ops then spend their time spinning)
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
COMMITTED = ROOT / "experiments" / "replay"

# the reference CLI's arguments (``--cluster`` / ``--cluster --autoscale``
# at its defaults: --programs 6 raised to 10 and 16, --replicas 3)
LEGS = {
    "cluster": dict(programs="cluster_programs", n=10, replicas=3),
    "elastic": dict(programs="elastic_programs", n=16, replicas=2,
                    prefill_replicas=1, scaling=True),
}


def _leg(mod, leg: str, seed: int = 0, **kw):
    spec = LEGS[leg]
    progs = getattr(mod, spec["programs"])(seed, n=spec["n"])
    extra = {}
    if spec.get("scaling"):
        extra = dict(scaling=mod.elastic_scaling_config(),
                     prefill_replicas=spec["prefill_replicas"])
    return mod.run_cluster_trace(progs, mod.ReplayConfig(),
                                 spec["replicas"], **extra, **kw)


@pytest.mark.parametrize("leg,seed", [("cluster", 0), ("cluster", 1),
                                      ("cluster", 2), ("elastic", 0)])
def test_logical_trace_matches_jax(leg, seed):
    lines_j, viol_j, _ = _leg(jax_replay, leg, seed)
    lines_p, viol_p, cluster = _leg(replay, leg, seed)
    assert lines_p == lines_j and len(lines_p) > 0
    assert viol_p == viol_j == []
    assert cluster.stats.migrations > 0


@pytest.mark.parametrize("leg", ["cluster", "elastic"])
def test_seed0_trace_matches_committed_artifact(leg):
    """The committed ``{cluster,elastic}_trace_seed0.jsonl`` predate the
    ``reason`` key that migrate records carry since the attribution PR;
    with it dropped, the port's seed-0 trace equals them line for line,
    and every migrate record of the port has one."""
    lines, _, _ = _leg(replay, leg)
    committed = (COMMITTED / f"{leg}_trace_seed0.jsonl").read_text()
    records = [json.loads(line) for line in lines]
    migrates = [r for r in records if r["ev"] == "migrate"]
    assert migrates and all("reason" in r for r in migrates)
    for r in migrates:
        del r["reason"]
    assert "\n".join(json.dumps(r, sort_keys=True) for r in records) + \
        "\n" == committed


@pytest.mark.parametrize("leg", ["cluster", "elastic"])
def test_replay_report_matches_jax(leg):
    spec = LEGS[leg]
    reports = []
    for mod in (jax_replay, replay):
        kw = dict(scaling=mod.elastic_scaling_config(),
                  prefill_replicas=spec["prefill_replicas"]) \
            if spec.get("scaling") else {}
        progs = getattr(mod, spec["programs"])(0, n=spec["n"])
        reports.append(mod.run_cluster_replay(
            progs, mod.ReplayConfig(), spec["replicas"], **kw).to_json())
    assert reports[1] == reports[0] and reports[1]["ok"]


def _physical_leg(leg: str, seed: int = 0):
    """Logical and physical legs of the port, the physical one with the
    telemetry plane attached. ``run_cluster_trace`` asserts after every
    physical step that ``Cluster.check`` passes (conservation, pools,
    page refcounts) and that each replica's host copies are a subset of
    its tier store's entries."""
    lines_l, _, _ = _leg(replay, leg, seed)
    lines_p, viol_p, cluster = _leg(replay, leg, seed, telemetry=True,
                                    physical=True, device="cpu")
    return lines_l, lines_p, viol_p, cluster


@pytest.mark.parametrize("leg,seed", [("cluster", 0), ("cluster", 1),
                                      ("cluster", 2), ("elastic", 0)])
def test_physical_trace_matches_logical(leg, seed):
    lines_l, lines_p, viol_p, cluster = _physical_leg(leg, seed)
    assert lines_p == lines_l
    assert viol_p == []
    cluster.check(cluster.clock.now)
    fleet = cluster.all_engines()
    model = fleet[0].backend.inner.model
    assert all(e.backend.inner.model is model and e.backend.inner.seed == 0
               for e in fleet)
    per = replay.physical_stats(cluster)
    for eid, r in per.items():
        assert r["staging_failures"] == 0 and r["cow_failures"] == 0, eid
        assert r["shortfall_tokens"] == 0, eid
        assert r["stage_out_events"] == r["demotions"], eid
        assert r["restore_events"] == r["restores"], eid
        assert r["cow_split_events"] == r["cow_splits"], eid
    assert sum(r["staging_checks"] for r in per.values()) > 0
    assert cluster.stats.migrations > 0
    # a migrated program's host copy is restored on its destination
    migrated = {(r["pid"], r["src"], r["dst"])
                for r in map(json.loads, lines_p) if r["ev"] == "migrate"}
    cross = replay.cross_replica_restores(cluster.obs)
    assert cross and set(cross) <= migrated
    if leg == "elastic":
        assert cluster.stats.scale_ups >= 1
        assert cluster.stats.prefill_handoffs >= 1
        assert per["pf0"]["demotions"] >= cluster.stats.prefill_handoffs


def test_physical_leg_refuses_a_stray_host_copy(monkeypatch):
    """A backend that keeps a host copy after restoring it holds KV its
    tier store no longer accounts for: the physical leg stops at once."""
    from repro_torch.serving.backend import TorchModelBackend
    restore = TorchModelBackend.restore_program

    def restore_keeping_the_copy(self, pid, tokens=None):
        entry = self.host_caches.get(pid)
        restore(self, pid, tokens)
        if entry is not None:
            self.host_caches[pid] = entry

    monkeypatch.setattr(TorchModelBackend, "restore_program",
                        restore_keeping_the_copy)
    with pytest.raises(AssertionError, match="r[0-9]"):
        _leg(replay, "cluster", physical=True, device="cpu")


def test_physical_replay_report():
    progs = replay.cluster_programs(0, n=10)
    report = replay.run_cluster_replay(progs, physical=True, device="cpu")
    assert report.ok and report.deterministic, report.describe()
    st = report.stats
    assert st["staging_checks"] > 0 and st["staging_failures"] == 0
    assert st["shortfall_tokens"] == 0
    assert st["restores"] == sum(r["restores"]
                                 for r in st["replicas"].values())
    assert "bit-exact" in report.describe()
    logical = replay.run_cluster_replay(progs).to_json()
    assert {k: v for k, v in report.to_json()["stats"].items()
            if k in logical["stats"]} == logical["stats"]


def test_report_fails_on_a_bad_staging_check():
    report = replay.ClusterReplayReport(
        deterministic=True, conservation_violations=0, steps=1,
        migrations=1, first_divergence=None,
        stats={"staging_checks": 2, "staging_failures": 1,
               "cow_checks": 0, "cow_failures": 0})
    assert not report.ok
    assert "1/2 staging checks NOT bit-exact" in report.describe()


def test_trace_roundtrip_matches_jax(tmp_path):
    """``record_trace`` writes the JAX package's bytes (the committed
    ``trace_seed0.jsonl``), and ``load_trace`` rebuilds the programs."""
    progs = replay.seeded_programs(0)
    replay.record_trace(progs, tmp_path / "port.jsonl")
    jax_replay.record_trace(jax_replay.seeded_programs(0),
                            tmp_path / "jax.jsonl")
    text = (tmp_path / "port.jsonl").read_text()
    assert text == (tmp_path / "jax.jsonl").read_text()
    assert text == (COMMITTED / "trace_seed0.jsonl").read_text()
    back = replay.load_trace(tmp_path / "port.jsonl")
    replay.record_trace(back, tmp_path / "again.jsonl")
    assert (tmp_path / "again.jsonl").read_text() == text


def test_differential_report_matches_committed_verdict():
    """The port's ``run_differential`` on the CPU gives the JAX physical
    leg's verdict for seed 0, key for key."""
    report = replay.run_differential(
        replay.load_trace(COMMITTED / "trace_seed0.jsonl"), device="cpu")
    committed = json.loads((COMMITTED / "verdict_seed0.json").read_text())
    assert report.to_json() == committed
    assert report.describe().startswith("MATCH")


@pytest.mark.parametrize("flags", [
    ["--cluster"], ["--cluster", "--physical"],
    ["--cluster", "--autoscale", "--physical"]])
def test_cli_cluster_modes(tmp_path, flags):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.sim.replay", "--device", "cpu",
         *flags, "--seeds", "0", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "MATCH" in res.stdout
    tag = "elastic" if "--autoscale" in flags else "cluster"
    verdict = json.loads(
        (tmp_path / f"{tag}_verdict_seed0.json").read_text())
    assert verdict["ok"]
    assert ("staging_checks" in verdict["stats"]) == ("--physical" in flags)
    assert (tmp_path / f"{tag}_trace_seed0.jsonl").read_text().count(
        "\n") == verdict["steps"]
