"""Write-ahead event journal + snapshot store for the durable
control plane.

The :class:`~repro_torch.core.scheduler.Scheduler` is a deterministic state
machine: given the same config, cluster, submissions, and fault plan,
every ``step()`` regenerates the same typed event batch.  Durability
therefore needs only two artifacts, both owned by this module:

* **The journal** — an :class:`EventJournal` directory of JSONL
  segment files (``events-00000.jsonl``, ...).  After each ``step()``
  the scheduler appends the batch's events (one
  ``SchedulerEvent.to_dict()`` document per line, tagged with its
  absolute stream index ``"i"``) before the step is considered
  committed.  Appends are contiguity-checked, optionally
  ``fsync``-ed per batch, and rotate to a fresh segment past
  ``rotate_bytes``.
* **Snapshots** — versioned JSON checkpoints of the full scheduler
  state (:meth:`~repro_torch.core.scheduler.Scheduler.snapshot`), stored
  alongside the segments as ``snapshot-<n_total>.json`` and pruned to
  the most recent few.

Crash recovery (:meth:`~repro_torch.core.scheduler.Scheduler.restore`) loads
the latest snapshot and *re-steps* the scheduler, verifying each
regenerated event against the journal tail — replay is regeneration
plus an equality audit, not blind event application.  A torn final
line (the process died mid-append) is expected: it is detected,
logged, and truncated when the journal is reopened for writing, and
reads simply stop before it.  Corruption anywhere *else* raises
:class:`JournalError` — a torn tail is the only damage a crash can
legally inflict.

See ``docs/RECOVERY.md`` for the on-disk format and the recovery
semantics contract.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Iterator, Optional


class JournalError(RuntimeError):
    """A journal structural violation: non-contiguous append, mid-file
    corruption, or a journal that is behind the snapshot it should
    extend."""


def _segment_index(path: Path) -> int:
    """Numeric index of an ``events-NNNNN.jsonl`` segment path."""
    return int(path.stem.split("-", 1)[1])


class EventJournal:
    """Append-only write-ahead log of scheduler events, plus the
    snapshot store, in one directory.

    Layout::

        <dir>/events-00000.jsonl     # one event per line, oldest first
        <dir>/events-00001.jsonl     # opened when the previous segment
        ...                          #   passed ``rotate_bytes``
        <dir>/snapshot-00000042.json # Scheduler.snapshot() at event 42

    Every line is ``SchedulerEvent.to_dict()`` plus ``"i"``, the
    event's absolute position on the scheduler's event stream
    (``EventLog.n_total`` order).  :attr:`next_index` is the position
    the next appended event must carry — :meth:`append_batch` refuses
    gaps, so the journal is always a contiguous prefix of the stream.

    Opening an existing directory scans it, truncates a torn final
    line if the previous writer died mid-append (recorded on
    :attr:`recovered_torn_tail`), and resumes at the right index.
    ``fsync=True`` flushes every batch to stable storage before
    :meth:`append_batch` returns (the durable-by-default mode;
    leaving it off trades the last batch for speed).
    """

    def __init__(self, path, *, fsync: bool = False,
                 rotate_bytes: Optional[int] = None):
        self.dir = Path(path)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.fsync = fsync
        self.rotate_bytes = rotate_bytes
        self.next_index = 0
        self.recovered_torn_tail = False
        segs = self._segments()
        if segs:
            self._truncate_torn_tail(segs[-1])
            for _ in self.read():
                pass                     # validates + sets next_index
        else:
            (self.dir / "events-00000.jsonl").touch()

    # -- segments --------------------------------------------------------
    def _segments(self) -> list[Path]:
        """Existing segment paths, oldest first."""
        return sorted(self.dir.glob("events-*.jsonl"),
                      key=_segment_index)

    def _truncate_torn_tail(self, seg: Path) -> None:
        """Drop a torn (non-JSON or unterminated) final line from the
        last segment so appends resume on a clean boundary."""
        raw = seg.read_bytes()
        if not raw:
            return
        cut = len(raw)
        if not raw.endswith(b"\n"):
            cut = raw.rfind(b"\n") + 1   # 0 when no newline at all
        else:
            last = raw.rstrip(b"\n").rsplit(b"\n", 1)[-1]
            try:
                doc = json.loads(last)
                if not isinstance(doc, dict) or "i" not in doc:
                    raise ValueError("not an event record")
            except ValueError:
                cut = len(raw.rstrip(b"\n")) - len(last)
        if cut < len(raw):
            seg.write_bytes(raw[:cut])
            self.recovered_torn_tail = True

    # -- writes ----------------------------------------------------------
    def append_batch(self, events, start_index: int) -> None:
        """Append ``events`` (a sequence of ``SchedulerEvent``) whose
        first element has absolute stream index ``start_index``.

        Raises :class:`JournalError` when ``start_index`` does not
        equal :attr:`next_index` — the caller lost events (e.g. a ring
        buffer evicted un-journaled entries) and the journal would no
        longer be a contiguous prefix of the stream.
        """
        if start_index != self.next_index:
            raise JournalError(
                f"non-contiguous append: journal expects index "
                f"{self.next_index}, got {start_index}")
        if not events:
            return
        seg = self._segments()[-1]
        if (self.rotate_bytes is not None
                and seg.stat().st_size >= self.rotate_bytes):
            seg = self.dir / f"events-{_segment_index(seg) + 1:05d}.jsonl"
        lines = []
        for off, ev in enumerate(events):
            doc = ev.to_dict()
            doc["i"] = start_index + off
            lines.append(json.dumps(doc, sort_keys=True))
        with seg.open("a", encoding="utf-8") as fh:
            fh.write("\n".join(lines) + "\n")
            fh.flush()
            if self.fsync:
                os.fsync(fh.fileno())
        self.next_index = start_index + len(events)

    # -- reads -----------------------------------------------------------
    def read(self, start: int = 0) -> Iterator[tuple]:
        """Yield ``(index, event)`` for every journaled event with
        absolute index ``>= start``, oldest first.

        Validates contiguity as it goes and leaves :attr:`next_index`
        at one past the last valid entry.  A torn final line in the
        final segment ends iteration silently (the crash case);
        damage anywhere else raises :class:`JournalError`.
        """
        from repro_torch.core.scheduler import SchedulerEvent
        segs = self._segments()
        expect: Optional[int] = None
        for si, seg in enumerate(segs):
            last_seg = si == len(segs) - 1
            lines = seg.read_text(encoding="utf-8").splitlines()
            for li, line in enumerate(lines):
                if not line.strip():
                    continue
                try:
                    doc = json.loads(line)
                    idx = int(doc["i"])
                    ev = SchedulerEvent.from_dict(doc)
                except (ValueError, KeyError, TypeError) as exc:
                    if last_seg and li == len(lines) - 1:
                        return           # torn tail: stop cleanly
                    raise JournalError(
                        f"{seg.name}:{li + 1}: corrupt journal entry "
                        f"({exc})") from exc
                if expect is not None and idx != expect:
                    raise JournalError(
                        f"{seg.name}:{li + 1}: event index {idx} "
                        f"breaks contiguity (expected {expect})")
                expect = idx + 1
                self.next_index = expect
                if idx >= start:
                    yield idx, ev

    def entries(self, start: int = 0) -> list:
        """Materialized :meth:`read` — ``[(index, event), ...]``."""
        return list(self.read(start))

    def __len__(self) -> int:
        return self.next_index

    # -- snapshots -------------------------------------------------------
    def write_snapshot(self, doc: dict, *, keep: int = 2) -> Path:
        """Persist one ``Scheduler.snapshot()`` document, pruning all
        but the newest ``keep`` snapshots; returns the written path.

        The filename embeds the snapshot's event-stream position so
        :meth:`latest_snapshot` can pick the newest without parsing,
        and so a snapshot is only meaningful alongside the journal
        that extends it.
        """
        n = int(doc.get("events", {}).get("n_total", 0))
        path = self.dir / f"snapshot-{n:08d}.json"
        tmp = path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(doc, sort_keys=True), encoding="utf-8")
        os.replace(tmp, path)            # atomic publish
        snaps = self._snapshots()
        for old in snaps[:-keep] if keep > 0 else []:
            old.unlink()
        return path

    def _snapshots(self) -> list[Path]:
        return sorted(self.dir.glob("snapshot-*.json"))

    def latest_snapshot(self) -> Optional[dict]:
        """The most recent snapshot document (``None`` when no
        snapshot has been written yet)."""
        snaps = self._snapshots()
        if not snaps:
            return None
        return json.loads(snaps[-1].read_text(encoding="utf-8"))

    def __repr__(self) -> str:
        return (f"EventJournal({str(self.dir)!r}, "
                f"next_index={self.next_index})")
