"""``chip_smoke.py`` off the card: it refuses to run without CUDA, its
datasheet table and workload are what its docstrings say, and its two
serve legs run end to end on the CPU at smoke width (the card runs them
at full qwen2-1.5b width)."""
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing
# the cores (tiny eager ops then spend their time spinning)
torch.set_num_threads(1)


def test_refuses_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main()
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("name,hbm_bw", [
    ("NVIDIA H100 80GB HBM3", 3.35e12), ("NVIDIA H100 PCIe", 2.0e12),
    ("NVIDIA H100 NVL", 3.9e12), ("NVIDIA H200", 4.8e12)])
def test_datasheet_matches_card_name(name, hbm_bw):
    assert chip_smoke.card_datasheet(name)["hbm_bw"] == hbm_bw
    hw = chip_smoke.hardware_profile(name)
    assert hw.name == name and hw.hbm_bw == hbm_bw


def test_unknown_card_has_no_bound():
    with pytest.raises(RuntimeError):
        chip_smoke.card_datasheet("Some Other GPU")


def test_bound_takes_the_larger_time():
    sheet = chip_smoke.card_datasheet("NVIDIA H100 80GB HBM3")
    ms, by = chip_smoke.bound_ms(3.35e9, 0, sheet, "bf16")
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = chip_smoke.bound_ms(0, 67e9, sheet, "fp32")
    assert by == "operations" and ms == pytest.approx(1.0)


def test_agent_programs():
    progs = chip_smoke.agent_programs()
    assert len(progs) == 8
    assert all(2 <= p.num_turns <= 3 for p in progs)
    assert max(p.total_tokens() for p in progs) <= 2300
    assert sum(p.shared_prefix_id is not None for p in progs) == 8
    tools = {t.tool for p in progs for t in p.turns if t.tool}
    assert {"ls", "pytest"} <= tools


@pytest.fixture(scope="module")
def smoke():
    cfg = get_config("qwen2-1.5b", smoke=True)
    hw = chip_smoke.hardware_profile("NVIDIA H100 80GB HBM3")
    return cfg, hw, Model(cfg, device="cpu")


def test_serve_differential_on_cpu(smoke):
    eng, steps = chip_smoke.serve_differential(*smoke, "cpu")
    st = chip_smoke.mechanism_stats(eng)
    assert steps > 0
    assert all(p.finish_time >= 0 for p in eng.programs.values())
    assert st["staging_ok"] and st["copy_ok"] and st["cow_splits"] > 0
    assert st["shortfall_tokens"] == 0


def test_serve_measured_on_cpu(smoke):
    eng, summary, n = chip_smoke.serve_measured(*smoke, "cpu")
    st = chip_smoke.mechanism_stats(eng)
    assert summary.n_programs == n == 8
    assert st["staging_ok"] and st["copy_ok"]
    eng.backend.runtime.check(eng.backend.prefix_index)
