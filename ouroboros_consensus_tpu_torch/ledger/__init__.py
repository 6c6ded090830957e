"""The ledger core: the abstract interface, header validation, the
extended state, the header-state history and the mock UTxO ledger (the
port's copies of the JAX package's ledger/ modules of the same names)."""

from .abstract import Forecast, Ledger, LedgerError, OutsideForecastRange
from .extended import ExtLedger, ExtLedgerState, TickedExtLedgerState
from .header_validation import (
    AnnTip,
    HeaderEnvelopeError,
    HeaderState,
    TickedHeaderState,
    revalidate_header,
    tick_header_state,
    validate_envelope,
    validate_header,
)
