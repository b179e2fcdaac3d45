"""Emerald core on PyTorch: workflow, partitioner, MDSS, migration, runtime.

A copy of ``repro.core`` whose tiers are torch devices: ``local`` is the
host CPU and ``cloud`` one NVIDIA H100 (see :mod:`repro_torch.core.tiers`).
"""
from repro_torch.core.workflow import Step, Workflow, WorkflowError, remotable  # noqa: F401
from repro_torch.core.partitioner import (MigrationPoint, PartitionError,  # noqa: F401
                                          PartitionedWorkflow, partition)
from repro_torch.core.mdss import (MDSS, MDSSTransferError, NamespacedMDSS,  # noqa: F401
                                   Transport, namespace_of, nbytes_of)
from repro_torch.core.migration import MigrationManager, StepFailure  # noqa: F401
from repro_torch.core.runtime import (AdmissionRefused, EmeraldRuntime,  # noqa: F401
                                      Event, RunCancelled, RunHandle,
                                      RuntimeClosed, WorkflowFailure)
from repro_torch.core.executor import EmeraldExecutor  # noqa: F401
from repro_torch.core.cost_model import CostModel, StepStats  # noqa: F401
from repro_torch.core.scheduler import (AnnotatePolicy, CostModelPolicy,  # noqa: F401
                                        FairShare, LocalityPolicy, NeverPolicy,
                                        PlacementDecision, critical_path_lengths,
                                        make_policy)
from repro_torch.core.tiers import Tier, default_tiers  # noqa: F401
