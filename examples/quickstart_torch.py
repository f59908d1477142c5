"""Quickstart on PyTorch: REAL end-to-end agent serving through the port.

A small transformer (stablelm-3b smoke) actually generates tokens through
the Continuum engine (continuous batching + chunked prefill + TTL
pinning) with its KV in the port's paged runtime; tool calls pause
programs and their KV pages are pinned with computed TTLs, so returning
turns skip prefill. On a GPU (the default) every decode step and page
move runs the hand-written CUDA kernels; ``--device cpu`` runs their
plain PyTorch versions. Run:

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.ttl import TTLConfig  # noqa: E402
from repro_torch.serving.backend import TorchModelBackend  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.serving.profiler import HardwareProfile  # noqa: E402
from repro_torch.sim.runner import run_workload  # noqa: E402
from repro_torch.sim.workload import (WorkloadSpec,  # noqa: E402
                                      generate_programs)


def main(device: str = "cuda"):
    """Serve four agent programs on ``device``; returns (summary, engine,
    programs)."""
    cfg = get_config("stablelm-3b", smoke=True)         # ~1M params
    backend = TorchModelBackend(cfg, seed=0, max_len=512, device=device)

    # a small, quick agent workload (short contexts fit the smoke model)
    spec = WorkloadSpec(
        name="demo", mean_turns=3, std_turns=1, tool_mean_s=0.3,
        tool_std_s=0.3, tokens_mean=360, tokens_std=60, output_frac=0.2,
        max_context=512,
        tools=(("ls", 0.5, 0.05, 0.4), ("pytest", 0.5, 0.3, 0.6)))
    programs = generate_programs(spec, n=4, rate_jps=2.0, seed=0)

    ecfg = EngineConfig(policy="continuum", chips=1, max_batch=8,
                        chunk_size=128, kv_budget_bytes=2e6,
                        ttl=TTLConfig(cold_start_k=0, exp_unit_mean=0.2))
    eng = Engine(cfg, ecfg, HardwareProfile(), backend=backend)

    print(f"serving {len(programs)} agent programs "
          f"({sum(p.num_turns for p in programs)} turns) with REAL "
          f"generation on {backend.device} ...")
    s = run_workload(programs, [eng], max_seconds=3600)
    st = eng.scheduler.stats
    total_prompt = sum(p.context_len_at(i) for p in programs
                       for i in range(p.num_turns))
    print(f"done: {s.n_programs} programs, avg JCT {s.avg_jct:.2f}s "
          f"(wall-clock, real model steps)")
    print(f"TTL: {st.pins} pins, {st.ttl_hits} hits, {st.ttl_expiries} "
          f"expiries")
    print(f"prefill tokens actually computed: "
          f"{backend.prefill_tokens_computed} / {total_prompt} naive "
          f"(saved {1 - backend.prefill_tokens_computed / total_prompt:.0%} "
          f"via TTL pinning + cache continuity)")
    print(f"decode tokens generated: {backend.decode_tokens_computed}")
    return s, eng, programs


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    main(ap.parse_args().device)
