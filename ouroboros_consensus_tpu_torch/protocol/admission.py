"""Admission for the serving plane: the door that refuses malformed
candidate suffixes, and the lane cap of each shape's next window.

The JAX package's protocol/admission.py is the port's reference. The
serving scheduler (node/serve.py) fills shared packed windows from the
lanes pending across tenants; each distinct (proof format, body length)
is one `WindowShape`, and a window holds one shape.

Malformed submissions are refused at the door (`AdmissionRefused`,
disposition REFUSE in node/exit.DISPOSITIONS): an empty suffix, a
suffix mixing proof formats (a window stages one uniform proof column),
a suffix mixing body lengths, or non-increasing slots (a candidate
suffix is a chain). The refusal strings are the reference's, letter for
letter.

The reference prices a cold shape's compile and caps it to a warm-up
rung ladder (`costmodel.choose_rung`, `preflight`, `price`), because XLA
compiles while traffic is served. The port builds its kernels with
`nvcc` before a run and compiles nothing while serving, so it has no
ladder: every device shape is admitted at full size (mode "warm"), and
the host plane's windows are mode "host". A decision's price and
device-resources rows are None until the port has a resources plane.

Single-writer discipline: one scheduler thread owns a policy instance
(node/serve.py's pump loop); the class keeps no locks by design."""

from __future__ import annotations

from dataclasses import dataclass

from .batch import bucket_size

PLANES = ("device", "host")


class AdmissionRefused(Exception):
    """A submission the serving plane rejects at the door (a malformed
    suffix, never a capacity decision). Disposition REFUSE: the tenant's
    input is wrong and retrying the identical submission cannot
    succeed."""

    def __init__(self, tenant_id: str, reason: str):
        self.tenant_id = tenant_id
        self.reason = reason
        super().__init__(f"tenant {tenant_id}: {reason}")


@dataclass(frozen=True)
class WindowShape:
    """What selects a window's staged layout: the proof format and the
    KES-signed body width."""

    proof_len: int  # 80 draft-03 | 128 batch-compatible
    body_len: int  # KES-signed body bytes (packed layout body column)


@dataclass(frozen=True)
class AdmissionDecision:
    """How many lanes a shape may fill in the next shared window, and
    why."""

    mode: str  # "warm" (the device plane) | "host"
    lane_cap: int  # max lanes of this shape in the next window
    bucket: int  # the padded bucket the cap dispatches as
    predicted_wall_s: float | None  # no resources plane yet: None
    device_resources: dict | None  # no resources plane yet: None


def shape_of(tenant_id: str, hvs) -> WindowShape:
    """Validate one candidate suffix at the door and derive its shape.
    Raises AdmissionRefused on the malformed cases the packed stage
    cannot window (the caller scatters the refusal back to the tenant
    without touching any other tenant's traffic)."""
    if not len(hvs):
        raise AdmissionRefused(tenant_id, "empty candidate suffix")
    plen = len(hvs[0].vrf_proof)
    blen = len(hvs[0].signed_bytes)
    prev_slot = None
    for hv in hvs:
        if len(hv.vrf_proof) != plen:
            raise AdmissionRefused(
                tenant_id,
                f"suffix mixes proof formats ({plen} and "
                f"{len(hv.vrf_proof)} bytes) — one window stages one "
                "uniform proof column",
            )
        if len(hv.signed_bytes) != blen:
            raise AdmissionRefused(
                tenant_id,
                "suffix mixes body lengths — packed staging needs "
                "rectangular columns",
            )
        if prev_slot is not None and hv.slot <= prev_slot:
            raise AdmissionRefused(
                tenant_id,
                f"non-increasing slot {hv.slot} after {prev_slot} — a "
                "candidate suffix is a chain",
            )
        prev_slot = hv.slot
    return WindowShape(proof_len=plen, body_len=blen)


class AdmissionPolicy:
    """The lane caps of one service's plane: `admit(shape, requested)`
    admits the requested lanes at full size, as mode "warm" on the
    device plane and "host" on the host plane, and counts the decision
    in `decisions`."""

    def __init__(self, plane: str = "device"):
        if plane not in PLANES:
            raise ValueError(f"unknown serving plane {plane!r} (know {', '.join(PLANES)})")
        self.plane = plane
        self.decisions: dict[str, int] = {"warm": 0, "host": 0}

    def admit(self, shape: WindowShape, requested: int) -> AdmissionDecision:
        requested = max(1, int(requested))
        mode = "warm" if self.plane == "device" else "host"
        self.decisions[mode] += 1
        return AdmissionDecision(mode, requested, bucket_size(requested), None, None)
