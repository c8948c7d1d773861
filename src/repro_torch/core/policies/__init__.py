"""Scheduling policies: the protocol, lifecycle mixin, registry, and
every in-repo implementation.

The :class:`Policy` protocol and the ``@register_policy`` registry
live in :mod:`repro_torch.core.policies.base`; importing this package
imports the FATE policy and the five baselines, which registers them
as a side effect.  ``ALL_POLICIES`` is the registry itself, kept under
its historical name for back-compat with callers that treated it as a
plain dict.
"""
from repro_torch.core.policies.base import (POLICY_REGISTRY, BasePolicy,
                                      Policy, make_policy,
                                      register_policy,
                                      registered_policies)
from repro_torch.core.policies.fate import FATEPolicy
from repro_torch.core.policies.baselines import (HEFTPolicy, HaloPolicy,
                                           HelixPolicy, KVFlowPolicy,
                                           RoundRobinPolicy)

#: Back-compat alias of the live registry (was a hand-written literal).
ALL_POLICIES = POLICY_REGISTRY

__all__ = [
    "ALL_POLICIES", "BasePolicy", "FATEPolicy", "HEFTPolicy",
    "HaloPolicy", "HelixPolicy", "KVFlowPolicy", "POLICY_REGISTRY",
    "Policy", "RoundRobinPolicy", "make_policy", "register_policy",
    "registered_policies",
]
