"""Exception triage: exit reasons and the refuse / repair / recover /
propagate map.

Reference: `Node/Exit.hs:63` (`ExitReason` / `toExitReason`) and
`Node/RethrowPolicy.hs` (`consensusRethrowPolicy`); the JAX package's
node/exit.py is the port's reference. Every failure the store and the
replay can raise falls in one DISPOSITION, which the recovery
supervisor (obs/recovery.py) consults:

    REFUSE     another process holds the DB lock, the DB belongs to
               another chain, a quarantine copy cannot be made, a
               serving tenant submits a malformed suffix: the caller
               asked for something the system must not do.
    REPAIR     on-disk corruption that the open-with-repair scan owns
               (storage/immutable.py); never absorbed by the per-window
               ladder.
    RECOVER    transient device, runtime and I/O faults, and the chaos
               taxonomy (transient by contract): the ladder may absorb
               them. A failed kernel launch (`ops/pk/kernels._raise_on`)
               and a CUDA error raised by torch are RuntimeErrors.
    PROPAGATE  verdicts and programming errors: recovery must never
               mask a wrong program as a flaky device. A window the
               staging does not take (`NotStagedError`, a
               NotImplementedError and so a RuntimeError) has a row of
               its own here: re-running it cannot change the answer.
"""

from __future__ import annotations

from enum import Enum


class ExitReason(Enum):
    """Node/Exit.hs:63 ExitReason."""

    SUCCESS = 0
    GENERIC = 1
    CONFIG_ERROR = 2
    DB_CORRUPTION = 3
    NETWORK_ERROR = 4


class Disposition(Enum):
    REFUSE = "refuse"
    REPAIR = "repair"
    RECOVER = "recover"
    PROPAGATE = "propagate"


# One row a failure class, keyed by class name and looked up along the
# exception's MRO, so that a subclass takes its family's row unless it
# has its own. Only the classes the port raises have rows.
DISPOSITIONS: dict[str, Disposition] = {
    "DbLocked": Disposition.REFUSE,
    "DbMarkerMismatch": Disposition.REFUSE,
    "QuarantineError": Disposition.REFUSE,
    "AdmissionRefused": Disposition.REFUSE,  # a malformed serve submission
    "ImmutableDBError": Disposition.REPAIR,
    "MalformedBlock": Disposition.REPAIR,  # native_scan: unparseable block bytes
    "ChaosError": Disposition.RECOVER,  # the whole injected-fault taxonomy
    "OSError": Disposition.RECOVER,
    "MemoryError": Disposition.RECOVER,
    "RuntimeError": Disposition.RECOVER,  # failed launches, CUDA errors
    "NotStagedError": Disposition.PROPAGATE,  # the staging's answer, not a fault
    "PraosValidationError": Disposition.PROPAGATE,  # + every subclass
}


def to_exit_reason(exc: BaseException) -> ExitReason:
    """toExitReason (Node/Exit.hs:100)."""
    from ..storage.guard import DbLocked, DbMarkerMismatch
    from ..storage.immutable import ImmutableDBError
    from ..storage.repair import QuarantineError

    if isinstance(exc, (DbLocked, DbMarkerMismatch, QuarantineError)):
        return ExitReason.CONFIG_ERROR
    if isinstance(exc, ImmutableDBError):
        return ExitReason.DB_CORRUPTION
    if isinstance(exc, OSError):
        return ExitReason.NETWORK_ERROR
    return ExitReason.GENERIC


def triage(exc: BaseException) -> Disposition:
    """The most derived classified class of `exc` decides; a class with
    no classified ancestor (AssertionError, TypeError, ...) PROPAGATEs."""
    for klass in type(exc).__mro__:
        d = DISPOSITIONS.get(klass.__name__)
        if d is not None:
            return d
    return Disposition.PROPAGATE
