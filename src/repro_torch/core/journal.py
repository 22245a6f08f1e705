"""Mutation journal — the invalidation protocol between the dynamic index
and its device snapshots (paper §8.2).

The dynamic ``QuakeIndex`` is a host-side structure; searches are served
from dense device-resident ``IndexSnapshot``s.  The journal records what
changed:

  * ``record(dirty=...)``        — content changes confined to known level-0
                                   partitions (insert / delete / refine);
                                   consumers patch exactly those rows.
  * ``record(structural=True)``  — the partition directory itself changed
                                   (split / merge / level add-remove);
                                   consumers must rebuild.
  * ``record()``                 — a mutation that does not touch the base
                                   level; bumps the clock, dirties nothing.

``version`` is a monotonic clock; ``delta_since(v)`` folds every entry
after ``v`` into one :class:`Delta`.  Entries are trimmed beyond
``max_entries`` — a consumer older than the trim floor gets ``None``
(= rebuild), so the journal stays bounded.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Iterable, Optional, Set

__all__ = ["Delta", "JournalEntry", "MutationJournal"]


@dataclass(frozen=True)
class JournalEntry:
    version: int                 # clock value after this mutation
    dirty: frozenset             # level-0 partition ids with content changes
    structural: bool             # partition directory changed
    reason: str = ""             # "insert" | "delete" | "split" | ...


@dataclass
class Delta:
    """Folded view of every journal entry after some consumer version."""
    dirty: Set[int] = field(default_factory=set)
    structural: bool = False

    @property
    def empty(self) -> bool:
        return not self.dirty and not self.structural


class MutationJournal:
    """Bounded log of index mutations, folded on demand per consumer."""

    def __init__(self, max_entries: int = 4096):
        self.version = 0           # monotonic mutation clock
        self.max_entries = max_entries
        self._entries: Deque[JournalEntry] = deque()
        self._floor = 0            # deltas from versions < _floor are lost
        self.overflowed = False    # ever trimmed?
        self.overflow_count = 0    # entries trimmed so far

    def record(self, dirty: Optional[Iterable[int]] = None,
               structural: bool = False, reason: str = "") -> int:
        """Log one mutation; returns the new version."""
        self.version += 1
        dset = frozenset(int(j) for j in dirty) if dirty is not None \
            else frozenset()
        self._entries.append(JournalEntry(
            version=self.version, dirty=dset,
            structural=structural, reason=reason))
        while len(self._entries) > self.max_entries:
            self._floor = self._entries.popleft().version
            self.overflowed = True
            self.overflow_count += 1
        return self.version

    def delta_since(self, version: int) -> Optional[Delta]:
        """Fold entries after ``version`` into one Delta: empty when the
        consumer is current, ``None`` when the gap is no longer
        reconstructible (the caller rebuilds)."""
        if version >= self.version:
            return Delta()
        if version < self._floor:
            return None
        d = Delta()
        for e in self._entries:
            if e.version <= version:
                continue
            d.dirty |= e.dirty
            d.structural |= e.structural
        return d

    def entries_since(self, version: int) -> list:
        """Raw entries after ``version`` (introspection / logging)."""
        return [e for e in self._entries if e.version > version]
