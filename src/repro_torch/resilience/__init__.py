"""Fault injection + failure-domain hardening for the serving engine (a
copy of ``repro.resilience``).

``FaultInjector`` (seeded, scheduleable fault plans threaded through the
page pool, the step dispatch and the scheduler clock) plus the
records the engine's failure domains run on: per-sequence checkpoints,
structured failure reasons, and the typed faults the degradation ladder
catches.  Attach with ``Engine.set_fault_injector``.

Only injected device errors and ``FloatingPointError`` (plus the
sampler's non-finite check) enter the ladder: a real CUDA error
propagates (see ``DEVICE_FAULTS``).
"""
from repro_torch.resilience.failure import (
    FAIL_DEVICE,
    FAIL_HOST_IO,
    FAIL_SAMPLER,
    Checkpoint,
    FailureInfo,
)
from repro_torch.resilience.inject import (
    DEVICE_FAULTS,
    SITES,
    FaultInjector,
    FaultSpec,
    HostIOError,
    InjectedDeviceError,
    InjectedFault,
    default_storm,
    dump_plan,
    load_plan,
)

__all__ = [
    "Checkpoint",
    "DEVICE_FAULTS",
    "FAIL_DEVICE",
    "FAIL_HOST_IO",
    "FAIL_SAMPLER",
    "FailureInfo",
    "FaultInjector",
    "FaultSpec",
    "HostIOError",
    "InjectedDeviceError",
    "InjectedFault",
    "SITES",
    "default_storm",
    "dump_plan",
    "load_plan",
]
