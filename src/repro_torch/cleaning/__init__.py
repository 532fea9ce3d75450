"""repro_torch.cleaning — the label-cleaning loop as session, phases and a
blocking scheduler (module for module with `repro.cleaning`).

  session    — `CleaningSession`: round counter, budget ledger, label state,
               DeltaGrad trajectory, Increm-INFL provenance, per-round
               generators; checkpoint save/restore.
  phases     — `InflSelector`, `BaselineSelector`, `SimulatedAnnotator`,
               `DeltaGradConstructor`, `RetrainConstructor`.
  scheduler  — the blocking `RoundScheduler` (with checkpoint hooks) and the
               early-termination policies.

The service, the supervisor and pipelined speculation wait until they are
ported (ROADMAP.md).
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
from repro_torch.cleaning.session import BudgetLedger, CleaningSession, round_generators

__all__ = [
    "AnnotationTask", "Annotator", "BaselineSelector", "BudgetLedger", "CleaningSession",
    "Constructor", "ConstructorResult", "DeltaGradConstructor", "InflSelector",
    "MarginalF1PerLabel", "Patience", "RetrainConstructor", "RoundScheduler", "RoundSelection",
    "Selector", "SimulatedAnnotator", "TargetF1", "TerminationPolicy", "make_constructor",
    "make_scheduler", "make_selector", "make_termination", "round_generators",
]
