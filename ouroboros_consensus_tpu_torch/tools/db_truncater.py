"""db-truncater: truncate an ImmutableDB after a slot, or repair it to
its last valid block.

Reference: `Cardano.Tools.DBTruncater` (Tools/DBTruncater/Run.hs
`truncate`); the JAX package's tools/db_truncater.py is the port's
reference, CLI included:

    python -m ouroboros_consensus_tpu_torch.tools.db_truncater --db DB \
        [--truncate-after-slot N | --to-last-valid [--dry-run] [--quarantine-dir D]]

    --truncate-after-slot N  keep the blocks with slot <= N (omitted, and
                             no --to-last-valid: wipe the chain)
    --to-last-valid          the deep open with repair (storage/open.py):
                             torn tails cut, lagging or corrupt indexes
                             rebuilt, stranded chunks dropped, every
                             snipped byte quarantined
    --dry-run                the same scan, read-only: what would be cut
    --quarantine-dir D       where snipped bytes go (default
                             <db>/immutable/quarantine)

Both speak the store's crash protocol (storage/guard.py): the lock is
held for the work, and a completed repair or truncation writes the
clean-shutdown marker back.
"""

from __future__ import annotations

import os

from ..block.abstract import Point
from ..storage.immutable import ImmutableDB


def _refuse_virgin(db_path: str, fs=None) -> None:
    """A writer's open of a path with no store would make one and report
    success: a mistyped --db refuses before any side effect."""
    from ..utils.fs import REAL_FS

    vfs = fs if fs is not None else REAL_FS
    if not vfs.exists(os.path.join(db_path, "immutable")):
        raise FileNotFoundError(
            f"no store at {db_path} (refusing to create one — check --db)"
        )


def truncate(db_path: str, after_slot: int | None) -> int:
    """Truncate the DB at `db_path` to blocks with slot <= after_slot
    (None wipes it). Returns the number of blocks remaining.

    Mutates the store, so it speaks the crash protocol like repair():
    writer lock held for the rewind (a concurrent forge/analysis
    refuses with DbLocked), marker checked, clean-shutdown marker
    rewritten only on an orderly finish. A DIRTY open (missing clean-
    shutdown marker) escalates to the full integrity walk WITH repair
    first — stamping the marker back after a most-recent-chunk open
    would bless rot in older chunks the rewind never looked at."""
    from ..storage import guard as guard_mod
    from ..storage.open import open_repair_store

    _refuse_virgin(db_path)
    with guard_mod.StoreGuard(db_path, writer=True) as guard:
        if guard.opened_dirty:
            imm = open_repair_store(db_path)
        else:
            imm = ImmutableDB(os.path.join(db_path, "immutable"), repair=True)
        if after_slot is None:
            imm.truncate_after(None)
        else:
            # find the last block at or before the slot
            target = None
            for n in imm._chunks:
                for e in imm._entries[n]:
                    if e.slot <= after_slot:
                        target = Point(e.slot, e.hash_)
            imm.truncate_after(target)
        imm.flush()
        return imm.n_blocks()


def repair(db_path: str, dry_run: bool = False,
           quarantine_dir: str | None = None, fs=None,
           network_magic: int | None = None) -> dict:
    """--to-last-valid: the open-with-repair scan. Opens the store
    under the crash protocol (lock; marker check; writer mode unless
    dry-run) with the full integrity walk and on-disk repair, and
    returns a report:

        {"blocks": <remaining>, "applied": <not dry_run>,
         "opened_dirty": <clean marker was absent>,
         "actions": {action: count}, "repairs": [row, ...]}

    ``dry_run=True`` runs the IDENTICAL scan read-only: the report
    lists every action the repair would take (applied=False), and the
    store — chunks, indices and markers — is byte-untouched (only the
    advisory lock file may be created; flock needs a file to lock)."""
    from ..storage import guard as guard_mod
    from ..storage.open import open_repair_store

    _refuse_virgin(db_path, fs=fs)
    guard = guard_mod.StoreGuard(
        db_path, network_magic=network_magic, fs=fs, writer=not dry_run
    )
    guard.open()
    try:
        imm = open_repair_store(
            db_path, fs=fs, quarantine_dir=quarantine_dir,
            repair=not dry_run,
        )
        if not dry_run:
            imm.flush()
            # regenerate sidecars the repair walk invalidated: any
            # rewritten/truncated chunk had its stale seal quarantined,
            # so re-seal from the now-consistent bytes (write-once —
            # chunks whose seal survived are skipped)
            from ..storage import sidecar as sidecar_mod

            # walked=True: everything that survives --to-last-valid sits
            # at or below the validated truncation point — the repair
            # walk that chose it covered every surviving blob
            sidecar_mod.backfill_store(imm, walked=True)
        from ..storage import repair as repair_mod

        # applied_only=False: a dry-run's report IS its would-repair rows
        actions = repair_mod.count_actions(imm.repairs, applied_only=False)
        report = {
            "blocks": imm.n_blocks(),
            "applied": not dry_run,
            "opened_dirty": guard.opened_dirty,
            "actions": actions,
            "repairs": list(imm.repairs),
        }
    except BaseException:
        guard.close(clean=False)
        raise
    # a completed repair leaves a consistent store: mark it clean (a
    # dry-run was a reader and never touched the markers)
    guard.close(clean=True)
    return report


def main(argv=None) -> None:
    import argparse
    import json

    p = argparse.ArgumentParser(prog="db_truncater", description=__doc__)
    p.add_argument("--db", required=True, help="chain DB directory")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument(
        "--truncate-after-slot", type=int, default=None,
        help="keep blocks with slot <= N (omit with no --to-last-valid "
             "to wipe)",
    )
    mode.add_argument(
        "--to-last-valid", action="store_true",
        help="repair mode: full integrity walk, truncate to the last "
             "valid block on disk (snipped bytes quarantined)",
    )
    p.add_argument("--dry-run", action="store_true",
                   help="with --to-last-valid: report what would be "
                        "snipped; the store is not touched")
    p.add_argument("--quarantine-dir", default=None,
                   help="where snipped bytes go (default "
                        "<db>/immutable/quarantine)")
    a = p.parse_args(argv)
    if a.dry_run and not a.to_last_valid:
        p.error("--dry-run only applies to --to-last-valid")
    if a.quarantine_dir and not a.to_last_valid:
        p.error("--quarantine-dir only applies to --to-last-valid")
    if a.to_last_valid:
        rep = repair(a.db, dry_run=a.dry_run,
                     quarantine_dir=a.quarantine_dir)
        print(json.dumps(rep))
        verb = "would repair" if a.dry_run else "repaired"
        acts = ", ".join(f"{k}={v}"
                         for k, v in sorted(rep["actions"].items()))
        print(f"{verb}: {acts or 'nothing'}; "
              f"{rep['blocks']} valid blocks remain")
        return
    n = truncate(a.db, a.truncate_after_slot)
    print(f"truncated; {n} blocks remain")


if __name__ == "__main__":
    main()
