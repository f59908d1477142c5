"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's records in ``experiments/dryrun/``: the three ``--smoke`` cells
(2 x 4 mesh, smoke configs, cut shapes) counted on the meta device under
torch's fake process group, the count extended from one and two units of
depth and microbatches against the whole step's, and one full-width cell
on the 16 x 16 mesh. The fake group is process-wide, so the cells run in
a subprocess."""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models.transformer import model_specs

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
RECORDS = ROOT / "experiments" / "dryrun"
SMOKE = (("qwen2-1.5b", "decode_32k"), ("qwen2-1.5b", "prefill_32k"),
         ("glm4-9b", "train_4k"))
#: XLA's output size counts the output tuple's table, a pointer (8 bytes)
#: an output buffer; the port counts the buffers alone
POINTER = 8
#: (arch, shape, layers, microbatches) of smoke configs deep enough that
#: ``_count`` extends: qwen2 (one layer a unit), gemma2 (a local/global
#: pair), zamba2 (a shared-attention group), moonshot (a leading dense
#: layer before the units)
EXTENDED = (("qwen2-1.5b", "train_4k", 4, 4),
            ("gemma2-9b", "prefill_32k", 6, 1),
            ("zamba2-2.7b", "decode_32k", 6, 1),
            ("moonshot-v1-16b-a3b", "prefill_32k", 4, 1))

SCRIPT = textwrap.dedent("""
    import dataclasses, json, pathlib, sys, warnings
    warnings.filterwarnings("ignore")
    import torch
    torch.set_num_threads(1)
    from repro_torch.dist.roofline import count_step
    from repro_torch.launch.dryrun import _count, cell, run_cell
    from repro_torch.models.steps import build_step
    out = sys.argv[1]
    for arch, shape in (("qwen2-1.5b", "decode_32k"),
                        ("qwen2-1.5b", "prefill_32k"),
                        ("glm4-9b", "train_4k")):
        run_cell(arch, shape, smoke=True, out_dir=out)
    extended = {}
    for arch, shape_name, layers, mbs in json.loads(sys.argv[2]):
        cfg, shape, mesh, _ = cell(arch, shape_name, smoke=True)
        cfg = dataclasses.replace(cfg, num_layers=layers,
                                  train_microbatches=mbs)
        step = build_step(cfg, mesh, shape, device="meta")
        inputs = step.make_inputs()
        ext, how = _count(cfg, mesh, shape, step, inputs)
        whole = count_step(step, inputs)
        extended[arch] = {"how": how, "extended": dataclasses.astuple(ext),
                          "whole": dataclasses.astuple(whole)}
    (pathlib.Path(out) / "extended.txt").write_text(json.dumps(extended))
    run_cell("qwen2-1.5b", "decode_32k", out_dir=out)
""")


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_torch")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(out),
                           json.dumps(EXTENDED)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    recs = {p.stem: json.loads(p.read_text()) for p in out.glob("*.json")}
    recs["extended"] = json.loads((out / "extended.txt").read_text())
    return recs


def _outputs(arch: str, kind: str) -> int:
    """Output buffers of the reference's step: the next tokens and the
    cache's k and v, or the params, both moments, the count and three
    metrics."""
    if kind == "train":
        return 3 * len(model_specs(get_config(arch, smoke=True))) + 1 + 3
    return 3


@pytest.mark.parametrize("arch,shape", SMOKE)
def test_smoke_cell_against_reference_record(records, arch, shape):
    """``argument_bytes`` equal to the reference's to the byte (params,
    optimizer state and caches as placed, ids at int32); output bytes
    equal once XLA's tuple table is counted; FLOPs a device within 2x
    of XLA's (the counter counts products only, at local shapes); the
    collectives DTensor issues counted."""
    got = records[f"{arch}_{shape}_2x4smoke"]
    want = json.loads((RECORDS / f"{arch}_{shape}_2x4smoke.json").read_text())
    assert got["chips"] == want["chips"] == 8 and got["mesh"] == "2x4smoke"
    assert (got["seq_len"], got["global_batch"]) == (want["seq_len"],
                                                     want["global_batch"])
    assert got["argument_bytes"] == want["argument_bytes"]
    assert got["output_bytes"] + POINTER * _outputs(arch, got["kind"]) \
        == want["output_bytes"]
    assert 0.5 <= got["flops_per_device"] / want["flops_per_device"] <= 2.0
    assert got["coll_bytes"] > 0 and got["bytes_accessed_per_device"] > 0
    assert got["counted"].startswith("exact")
    assert set(got["not_counted"]) == {"compile_s", "temp_bytes",
                                       "alias_bytes", "peak_bytes_estimate",
                                       "hlo_path"}


@pytest.mark.parametrize("arch,shape,layers,mbs", EXTENDED)
def test_extended_count_equals_the_whole_step(records, arch, shape, layers,
                                              mbs):
    """The count extended from 1 and 2 units of depth (and 1 and 2
    microbatches) equals the whole step's, FLOPs, bytes and collective
    bytes each, exactly."""
    got = records["extended"][arch]
    assert got["how"].startswith("extended") and \
        f"to {layers} layers" in got["how"], got["how"]
    assert all(x > 0 for x in got["whole"]), got
    assert got["extended"] == got["whole"], got


def test_full_width_cell_on_the_production_mesh(records):
    """qwen2-1.5b x decode_32k at full width on 16 x 16: finite, positive
    per-device counts, the 28 layers extended from 1 and 2."""
    got = records["qwen2-1.5b_decode_32k_16x16"]
    assert got["chips"] == 256 and not got["smoke"]
    for key in ("flops_per_device", "bytes_accessed_per_device",
                "coll_bytes", "argument_bytes", "output_bytes"):
        assert 0 < got[key] < float("inf"), (key, got)
    assert "28 layers" in got["counted"]
