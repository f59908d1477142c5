"""Queue-1 item 8's profile fit, off the card: the port's
``ShadowClockBackend.calibrate`` (its copy of ``calibrate_hardware``)
fits ``mfu`` and ``decode_eff`` to a shadow-clocked leg's measured step
times exactly as the JAX package's ``calibrate_hardware`` does on the
same samples (to 1e-12: the same least-squares solve on the same
numbers), and ``chip_smoke.calibration``, which logs the fit of phase 3a
on the card, summarizes it with its residuals."""
import dataclasses
import math
import pathlib
import sys

import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.serving import profiler as jax_profiler
from repro_torch.sim import replay

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing
# the cores (tiny eager ops then spend their time spinning)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def leg():
    """One seeded physical leg on the CPU (qwen2-1.5b smoke, the shadow
    clock): its ShadowClockBackend holds one StepSample a step."""
    rc = replay.ReplayConfig()
    _, eng = replay.run_engine(replay.seeded_programs(0), rc, device="cpu")
    assert len(eng.backend.samples) > 10
    return rc, eng.backend


def _jax_fit(rc, shadow):
    samples = [jax_profiler.StepSample(**dataclasses.asdict(s))
               for s in shadow.samples]
    prof = jax_profiler.build_profile(jax_get_config(rc.arch, smoke=True), 1)
    hw = jax_profiler.HardwareProfile(**dataclasses.asdict(shadow.cost.hw))
    return jax_profiler.calibrate_hardware(samples, prof, hw)


def test_calibrate_matches_the_jax_package(leg):
    rc, shadow = leg
    fit = shadow.calibrate()
    want = _jax_fit(rc, shadow)
    assert fit.mfu == pytest.approx(want.mfu, rel=0, abs=1e-12)
    assert fit.decode_eff == pytest.approx(want.decode_eff, rel=0, abs=1e-12)
    # the fit moved off the profile's defaults: CPU steps are nothing
    # like the analytic clock's
    assert (fit.mfu, fit.decode_eff) != (shadow.cost.hw.mfu,
                                         shadow.cost.hw.decode_eff)


def test_chip_smoke_calibration_report(leg):
    _, shadow = leg
    report = chip_smoke.calibration(shadow, shadow.cost.hw)
    fit = shadow.calibrate()
    assert report["samples"] == len(shadow.samples)
    assert report["fitted"]["mfu"] == round(fit.mfu, 9)
    assert report["fitted"]["decode_eff"] == round(fit.decode_eff, 9)
    assert report["gap_s"]["fitted"] <= report["gap_s"]["input"]
    assert "residuals" not in report
    kinds = report["residual_s_by_kind"]
    assert sum(k["steps"] for k in kinds.values()) == len(shadow.samples)
    assert set(kinds) <= {"prefill", "decode", "mixed"}
    assert len(report["largest_residuals"]) == 5
    top = [abs(r["residual_s"]) for r in report["largest_residuals"]]
    assert top == sorted(top, reverse=True)
    assert all(math.isfinite(v) for k in kinds.values()
               for v in (k["median"], k["min"], k["max"]))
