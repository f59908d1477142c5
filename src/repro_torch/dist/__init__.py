"""Distributed substrate: logical-axis sharding rules on torch's
``DeviceMesh`` / ``DTensor``, and the step counter behind the roofline
cost source.

- :mod:`repro_torch.dist.sharding` maps the *logical* axis names carried
  by parameter specs and activation ``constrain`` calls onto the mesh's
  dimensions (the reference's rules, with its divisibility and
  duplicate-axis safety), and runs each product on the local pieces in
  the caller's placements.
- :mod:`repro_torch.dist.roofline` counts a built step's FLOPs, HBM bytes
  and collective bytes by running it under a dispatch mode, on the meta
  device (torch ops, not compiled HLO text, which the port never has):
  the measured input of ``CostModel.from_roofline``.
"""
from repro_torch.dist import roofline, sharding  # noqa: F401
