"""Execution-state construction for the serving engine.

Holds only :func:`fresh_state` for now; the event-driven scheduler and the
executor adapters of the JAX package (``repro.core.scheduler``,
``repro.core.executor``) are not on the serving path and are not ported
yet.
"""
from __future__ import annotations

from repro_torch.core.state import ExecutionState
from repro_torch.core.workflow import DEFAULT_PROFILES

__all__ = ["fresh_state"]


def fresh_state(cluster, profiles=None) -> ExecutionState:
    """Empty execution state over ``cluster`` (cold devices, t=0),
    with the paper's default model profiles unless overridden."""
    return ExecutionState(cluster=cluster,
                          profiles=dict(profiles or DEFAULT_PROFILES))
