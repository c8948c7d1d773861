"""Device/cluster model for the workflow runtime.

A "device" is the scheduling unit the paper places stages on.  In the
TPU adaptation a device is a mesh slice (e.g. one v5e pod or sub-slice);
in the benchmark runtime it is a simulated accelerator with a runtime
proxy profile (the paper's own evaluation methodology, Appendix C.1).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Device:
    did: int
    name: str = ""
    memory_gb: float = 24.0
    speed: float = 1.0             # runtime multiplier (heterogeneity): cost/speed
    # β_{i,j} transfer coefficient is cluster-level; per-device scale here
    transfer_scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class Cluster:
    devices: tuple[Device, ...]
    # β seconds per 1k tokens moved between distinct devices
    transfer_coef: float = 0.06
    # within-host discount pairs could refine β; keep a single coefficient
    # (the paper uses "a constant edge-transfer coefficient", C.1)

    @property
    def n(self) -> int:
        return len(self.devices)

    def beta(self, src: int, dst: int) -> float:
        if src == dst or src < 0:
            return 0.0
        return (self.transfer_coef
                * self.devices[src].transfer_scale
                * self.devices[dst].transfer_scale)

    def ids(self) -> list[int]:
        return [d.did for d in self.devices]


def homogeneous_cluster(n: int = 8, memory_gb: float = 24.0,
                        transfer_coef: float = 0.06) -> Cluster:
    """The paper's main setting: 8 identical GPUs."""
    return Cluster(tuple(Device(i, f"dev{i}", memory_gb) for i in range(n)),
                   transfer_coef=transfer_coef)


def heterogeneous_cluster(n: int = 8, transfer_coef: float = 0.06) -> Cluster:
    """Mixed-speed variant (for Helix-style heterogeneity stress)."""
    devs = []
    for i in range(n):
        speed = 1.0 if i % 2 == 0 else 0.7
        devs.append(Device(i, f"dev{i}", 24.0 if i % 2 == 0 else 16.0,
                           speed=speed))
    return Cluster(tuple(devs), transfer_coef=transfer_coef)
