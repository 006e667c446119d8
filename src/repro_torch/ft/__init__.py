"""Fault tolerance: live serving policies + deterministic chaos harness
(PyTorch port of ``repro.ft``).

``failures`` holds the primitives (injection schedules, retry-from-
checkpoint, straggler timing); ``integrity`` the answer-validation layer
(detect wrong answers, don't serve them); ``supervisor`` wires both
around the serving engine as the :class:`EngineSupervisor` wave policy
the dynamic batcher delegates to.
"""
from repro_torch.ft.failures import (FailureInjector, InjectedFailure,
                                     StepTimer, run_with_retries)
from repro_torch.ft.integrity import (INTEGRITY_MODES, IntegrityConfig,
                                      IntegrityError, check_level_rows,
                                      check_popcount_sequence)
from repro_torch.ft.supervisor import (DETERMINISTIC, FAULT_KINDS, TRANSIENT,
                                       EngineSupervisor, FaultPlan,
                                       FaultyEngine, KernelFault,
                                       PoisonedRoot, RequestQuarantined,
                                       RootOutcome, ServingError,
                                       SupervisedWave, WaveAbandoned,
                                       WaveTimeout, classify_fault,
                                       find_tunable_engine, is_kernel_fault,
                                       supports_budget_override)

__all__ = [
    "FailureInjector", "InjectedFailure", "StepTimer", "run_with_retries",
    "EngineSupervisor", "SupervisedWave", "RootOutcome",
    "FaultPlan", "FaultyEngine", "FAULT_KINDS",
    "ServingError", "KernelFault", "WaveTimeout", "WaveAbandoned",
    "RequestQuarantined", "PoisonedRoot",
    "TRANSIENT", "DETERMINISTIC", "classify_fault", "is_kernel_fault",
    "find_tunable_engine", "supports_budget_override",
    "INTEGRITY_MODES", "IntegrityConfig", "IntegrityError",
    "check_level_rows", "check_popcount_sequence",
]
