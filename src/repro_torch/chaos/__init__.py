"""Deterministic fault injection for the serving stack.

The gateway's recovery paths (replica failover, lease redelivery, journal
adoption, poison quarantine, brownout) are only trustworthy if something
actually *fires* the faults they claim to survive. This package is that
something: a seeded `FaultPlan` names faults at exact step/dispatch
indices, and a `FaultInjector` arms them by wrapping the gateway/replica
seam — production code carries no injection hooks.
"""
from repro_torch.chaos.faults import (FAULT_KINDS, FaultPlan, FaultSpec,
                                      parse_plan)
from repro_torch.chaos.inject import ChaosReplicaCrash, FaultInjector

__all__ = ["FAULT_KINDS", "FaultPlan", "FaultSpec", "parse_plan",
           "ChaosReplicaCrash", "FaultInjector"]
