"""The port's telemetry plane (copies of ``repro.obs``) and its paged
runtime's tier events, against the JAX package's.

Exports compare as bytes. The one difference a verbatim copy brings is
the exporter's ``otherData.generator`` string, ``repro.obs`` in the JAX
package and ``repro_torch.obs`` here (the copy rule reads ``repro.`` as
``repro_torch.``), so the JAX bytes are read under that rule before they
are compared (:func:`as_port`). Both packages run in one interpreter:
block hashing uses Python's ``hash``.
"""
import json
import pathlib
import re
import urllib.request

import pytest
import torch

from repro.obs import Telemetry as JaxTelemetry
from repro.obs import export as jax_export
from repro.obs.server import ObsServer as JaxObsServer
from repro.sim import replay as jax_replay
from repro_torch.configs import get_config
from repro_torch.obs import Telemetry
from repro_torch.obs import export
from repro_torch.obs.server import ObsServer
from repro_torch.serving.backend import TorchModelBackend
from repro_torch.sim import replay

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing
# the cores (tiny eager ops then spend their time spinning)
torch.set_num_threads(1)

VERDICTS = pathlib.Path(__file__).resolve().parents[1] / "experiments" / \
    "replay"


def as_port(text: str) -> str:
    return re.sub(r"\brepro\.", "repro_torch.", text)


def _jax_export(seed: int, physical: bool, **kw) -> str:
    tel = JaxTelemetry()
    jax_replay.run_engine(jax_replay.seeded_programs(seed, **kw),
                          jax_replay.ReplayConfig(), physical=physical,
                          telemetry=tel)
    return as_port(jax_export.dumps(jax_export.to_chrome(tel.trace)))


def without_runtime_events(tel) -> list[tuple]:
    """The raw trace events with the paged runtime's removed."""
    runtime = set(map(id, replay.runtime_events(tel)))
    return [ev for ev in tel.trace.events if id(ev) not in runtime]


def _port_leg(seed: int, physical: bool, **kw):
    tel = Telemetry()
    log, eng = replay.run_engine(replay.seeded_programs(seed, **kw),
                                 replay.ReplayConfig(), "cpu",
                                 physical=physical, telemetry=tel)
    return tel, log, eng


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_logical_export_matches_jax(seed):
    tel, _, _ = _port_leg(seed, physical=False)
    assert export.dumps(export.to_chrome(tel.trace)) == \
        _jax_export(seed, physical=False)
    assert not replay.runtime_events(tel)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_physical_export_is_logical_plus_runtime_events(seed):
    """The physical leg's export with the runtime's stage-out, restore and
    COW-split instants removed is the JAX logical leg's, byte for byte;
    the instants count as the JAX physical leg's verdict records, and
    each carries Python ints on the engine's clock."""
    tel, _, eng = _port_leg(seed, physical=True)
    assert export.dumps(export.to_chrome(
        without_runtime_events(tel))) == \
        _jax_export(seed, physical=False)
    stats = json.loads(
        (VERDICTS / f"verdict_seed{seed}.json").read_text())["stats"]
    events = replay.runtime_events(tel)
    counts = {name: sum(ev[3] == name for ev in events)
              for name in replay.RUNTIME_EVENTS}
    assert counts == {"stage_out": stats["demotions_physical"],
                      "restore": stats["restores"],
                      "cow_split": stats["cow_splits"]}
    backend = eng.backend.inner
    assert counts["cow_split"] == backend.runtime.cow_splits > 0
    assert tel.cow_splits.values == {(eng.engine_id,):
                                     float(counts["cow_split"])}
    for _, ts, replica, name, cat, args in events:
        assert replica == eng.engine_id and cat == "tier"
        assert 0 <= ts <= eng.clock
        keys = ("src_page", "dst_page") if name == "cow_split" else \
            ("pages", "length")
        assert set(args) == {"program", *keys}
        assert all(type(args[k]) is int for k in keys)


def test_physical_export_matches_jax_physical():
    """The JAX physical leg (its Pallas kernels in interpret mode) and the
    port's, both with the plane attached: the whole export, runtime
    events included, byte for byte."""
    tel, _, _ = _port_leg(0, physical=True, n=4)
    assert export.dumps(export.to_chrome(tel.trace)) == \
        _jax_export(0, physical=True, n=4)
    assert {ev[3] for ev in replay.runtime_events(tel)} == \
        set(replay.RUNTIME_EVENTS)


@pytest.mark.parametrize("physical", [False, True])
def test_attached_plane_changes_no_decision(physical):
    log_off, eng = replay.run_engine(
        replay.seeded_programs(0, n=3), replay.ReplayConfig(), "cpu",
        physical=physical)
    assert eng.obs is None and eng.scheduler.obs is None
    if physical:
        assert eng.backend.inner.runtime.obs is None
    tel, log_on, eng_on = _port_leg(0, physical, n=3)
    assert log_on == log_off
    assert tel.trace.events
    if physical:
        assert eng_on.backend.inner.runtime.obs is tel


def test_runtime_without_a_plane_emits_nothing():
    cfg = get_config("qwen2-1.5b", smoke=True)
    backend = TorchModelBackend(cfg, max_len=64, page_size=8, n_pages=16,
                                device="cpu")
    rt = backend.runtime
    rt.prefill(backend.model, "a", torch.arange(12))
    backend.offload_program("a")
    backend.restore_program("a")
    assert rt.obs is None and backend.demotions == backend.restores == 1
    tel = Telemetry()
    rt.obs, rt.obs_replica, rt.obs_clock = tel, "r7", lambda: 2.5
    backend.offload_program("a")
    backend.restore_program("a")
    assert [(ev[1], ev[2], ev[3], ev[5]) for ev in tel.trace.events] == [
        (2.5, "r7", "stage_out", {"program": "a", "pages": 2, "length": 12}),
        (2.5, "r7", "restore", {"program": "a", "pages": 2, "length": 12})]


@pytest.mark.parametrize("demo", ["run_telemetry_demo", "run_regret_demo",
                                  "run_attribution_demo"])
def test_demo_artifacts_match_jax(demo, tmp_path):
    """Each demo of the port writes the JAX demo's artifacts for seed 0:
    the same files, the same bytes (the verdicts' artifact paths aside,
    which name each run's own directory)."""
    vj = getattr(jax_replay, demo)(0, tmp_path / "jax")
    vp = getattr(replay, demo)(0, tmp_path / "port")
    assert vp["ok"] and vj["ok"]
    names = sorted(f.name for f in (tmp_path / "jax").iterdir())
    assert names == sorted(f.name for f in (tmp_path / "port").iterdir())
    for name in names:
        a = (tmp_path / "jax" / name).read_text()
        b = (tmp_path / "port" / name).read_text()
        if name == "verdict.json":
            a, b = json.loads(a), json.loads(b)
            for v, root in ((a, "jax"), (b, "port")):
                v["artifacts"] = {k: pathlib.Path(p).relative_to(
                    tmp_path / root).as_posix()
                    for k, p in v["artifacts"].items()}
            assert b == a, name
        else:
            assert b == as_port(a), name


def _get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=10) as r:
        assert r.status == 200
        return r.read()


def test_obs_server_serves_the_port_plane():
    """The port's ObsServer on an ephemeral localhost port, as the
    reference tests bind theirs: its /metrics and full /traces equal the
    JAX server's for the same logical run, and its /healthz counts the
    physical plane's events (runtime instants included)."""
    jax_tel = JaxTelemetry()
    jax_replay.run_engine(jax_replay.seeded_programs(0, n=4, twins=False),
                          jax_replay.ReplayConfig(), physical=False,
                          telemetry=jax_tel)
    tel, _, _ = _port_leg(0, physical=False, n=4, twins=False)
    bodies = []
    for server in (JaxObsServer(jax_tel), ObsServer(tel)):
        srv = server.start()
        try:
            bodies.append([_get(srv.url(path)).decode()
                           for path in ("/metrics", "/traces?full=1")])
        finally:
            srv.stop()
    assert bodies[1] == [as_port(b) for b in bodies[0]]
    assert bodies[1][0] == tel.metrics.exposition()
    phys, _, _ = _port_leg(0, physical=True, n=4)
    srv = ObsServer(phys).start()
    try:
        health = json.loads(_get(srv.url("/healthz")))
        doc = json.loads(_get(srv.url("/traces?full=1")))
    finally:
        srv.stop()
    assert health["status"] == "ok"
    assert health["trace_events"] == len(phys.trace.events)
    assert export.validate(doc) == []
    assert {e["name"] for e in doc["traceEvents"]
            if e.get("cat") == "tier"} >= set(replay.RUNTIME_EVENTS)
