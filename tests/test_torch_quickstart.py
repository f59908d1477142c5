"""``examples/quickstart_torch.py``, the port's quickstart: stablelm-3b
smoke served through ``TorchModelBackend`` and the unchanged ``Engine``
with the JAX quickstart's workload. It runs on the GPU by default, raises
without one, and on the CPU when asked finishes every program."""
import importlib.util
import pathlib

import pytest
import torch

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing
# the cores (tiny eager ops then spend their time spinning)
torch.set_num_threads(1)

PATH = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
    "quickstart_torch.py"


def _load():
    spec = importlib.util.spec_from_file_location("quickstart_torch", PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_finishes_every_program_on_the_cpu(capsys):
    summary, eng, programs = _load().main(device="cpu")
    assert summary.n_programs == len(programs) == 4
    assert all(p.finish_time >= 0 for p in eng.programs.values())
    assert eng.backend.decode_tokens_computed > 0
    assert eng.backend.runtime.k_pages.device.type == "cpu"
    out = capsys.readouterr().out
    assert "generation on cpu" in out and "done: 4 programs" in out


def test_quickstart_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _load().main()
