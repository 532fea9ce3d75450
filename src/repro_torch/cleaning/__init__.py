"""repro_torch.cleaning — the label-cleaning loop as session, phases, a
scheduler and a service (module for module with `repro.cleaning`).

  session    — `CleaningSession`: round counter, budget ledger, label state,
               DeltaGrad trajectory, Increm-INFL provenance, per-round
               generators; checkpoint save/restore.
  phases     — `InflSelector`, `BaselineSelector`, `SimulatedAnnotator`
               (with `predict`, what the pipelined scheduler speculates on),
               `DeltaGradConstructor`, `RetrainConstructor`.
  scheduler  — `RoundScheduler`, blocking or pipelined (speculating on
               INFL's suggested labels inside the annotation latency,
               checked against the votes), with checkpoint hooks, and the
               early-termination policies.
  service    — `CleaningService`: submit / poll / cancel many sessions over
               one shared `Backend` and device.

The supervisor waits until it is ported (ROADMAP.md).
"""
from repro_torch.cleaning.phases import (
    AnnotationTask,
    Annotator,
    BaselineSelector,
    Constructor,
    ConstructorResult,
    DeltaGradConstructor,
    InflSelector,
    RetrainConstructor,
    RoundSelection,
    Selector,
    SimulatedAnnotator,
    make_constructor,
    make_selector,
)
from repro_torch.cleaning.scheduler import (
    MarginalF1PerLabel,
    Patience,
    RoundScheduler,
    TargetF1,
    TerminationPolicy,
    make_scheduler,
    make_termination,
)
from repro_torch.cleaning.service import CleaningService, JobInfo, prepare_session
from repro_torch.cleaning.session import BudgetLedger, CleaningSession, round_generators

__all__ = [
    "AnnotationTask", "Annotator", "BaselineSelector", "BudgetLedger", "CleaningService",
    "CleaningSession", "Constructor", "ConstructorResult", "DeltaGradConstructor",
    "InflSelector", "JobInfo", "MarginalF1PerLabel", "Patience", "RetrainConstructor",
    "RoundScheduler", "RoundSelection", "Selector", "SimulatedAnnotator", "TargetF1",
    "TerminationPolicy", "make_constructor", "make_scheduler", "make_selector",
    "make_termination", "prepare_session", "round_generators",
]
