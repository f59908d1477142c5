"""The port's serve entry point (``python -m repro_torch.launch.serve``, a
copy of the reference's on the virtual-clock simulation backend) prints
what the reference's prints for the same arguments; and the port's
``repro_torch.dist`` package exposes its two modules, as the reference's
does."""
import json
import sys

import pytest
import torch

from repro.launch import serve as jax_serve
from repro_torch.launch import serve

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing
# the cores (tiny eager ops then spend their time spinning)
torch.set_num_threads(1)


def _printed(main, argv, monkeypatch, capsys) -> dict:
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    assert main() == 0
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("extra", [[], ["--cluster"], ["--engines", "2"]])
def test_serve_prints_the_references_summary(extra, monkeypatch, capsys):
    """Six SWE-Bench programs, seed 0: the same summary (JCTs, TTL pins
    and hits, the cluster's and the host tier's counts), key for key; the
    summary has no wall-clock field."""
    argv = ["-n", "6", "--seed", "0"] + extra
    got = _printed(serve.main, argv, monkeypatch, capsys)
    want = _printed(jax_serve.main, argv, monkeypatch, capsys)
    assert got == want
    assert got["n_programs"] == 6 and got["ttl"]["pins"] > 0
    assert ("cluster" in got) == ("--cluster" in extra)


def test_dist_package_exposes_its_modules():
    import repro_torch.dist as dist
    from repro_torch.dist import roofline, sharding
    assert dist.roofline is roofline and dist.sharding is sharding
    doc = " ".join(dist.__doc__.split())
    assert "DeviceMesh" in doc and "on the meta device" in doc
