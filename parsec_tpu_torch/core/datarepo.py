"""Data repositories.

Reference: parsec/datarepo.{c,h} (343 LoC). A repo is a hash table of
entries holding a completed task's output data, keyed by the producer task
key. The usage-limit + retain protocol (design comment datarepo.h:26-75)
lets producers and consumers race safely: the producer sets the usage limit
to the number of consumers; each consumer take decrements it; the entry is
freed when both sides are done.

In this runtime the common path attaches produced values directly to the
pending successor (taskpool.activate_dep), so repos serve (a) multi-consumer
data retention with deterministic reclamation and (b) lookups by task key
(e.g. reshape, DTD flush, profiling).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional


class DataRepoEntry:
    __slots__ = ("key", "data", "usage_limit", "usage_count", "retained", "repo")

    def __init__(self, repo: "DataRepo", key, nb_flows: int):
        self.repo = repo
        self.key = key
        self.data: list = [None] * nb_flows
        self.usage_limit = 0        # set by producer: number of consumes
        self.usage_count = 0        # consumes so far
        self.retained = 1           # producer's retain; released on set_usage

    def get(self, flow_index: int) -> Any:
        obs = DataRepo.observer
        if obs is not None:
            obs("get", self.repo, self.key, flow_index)
        return self.data[flow_index]

    def set(self, flow_index: int, value: Any) -> None:
        obs = DataRepo.observer
        if obs is not None:
            obs("set", self.repo, self.key, flow_index)
        self.data[flow_index] = value


class DataRepo:
    """Hash table of :class:`DataRepoEntry` (datarepo.c analog)."""

    #: process-wide access observer ``fn(op, repo, key, flow_index)`` —
    #: installed by the dfsan race sanitizer (analysis/dfsan.py) so repo
    #: entry fills/takes on the release path are stamped too; None keeps
    #: the accessors at one attribute read of overhead
    observer = None

    def __init__(self, nb_flows: int = 1):
        self.nb_flows = nb_flows
        self._entries: Dict[Any, DataRepoEntry] = {}
        self._lock = threading.Lock()

    def lookup_or_create(self, key) -> DataRepoEntry:
        """data_repo_lookup_entry_and_create analog: returns a retained
        entry for the producer to fill."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                ent = DataRepoEntry(self, key, self.nb_flows)
                self._entries[key] = ent
            else:
                ent.retained += 1
            return ent

    def lookup(self, key) -> Optional[DataRepoEntry]:
        with self._lock:
            return self._entries.get(key)

    def entry_addto_usage_limit(self, key, delta: int) -> None:
        """data_repo_entry_addto_usage_limit analog: the producer declares
        how many consumers will take from this entry; also drops the
        producer's retain."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                return
            ent.usage_limit += delta
            ent.retained -= 1
            self._maybe_free_locked(ent)

    def entry_used_once(self, key) -> None:
        """data_repo_entry_used_once analog: one consumer is done."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                return
            ent.usage_count += 1
            self._maybe_free_locked(ent)

    def _maybe_free_locked(self, ent: DataRepoEntry) -> None:
        if ent.retained <= 0 and ent.usage_count >= ent.usage_limit:
            self._entries.pop(ent.key, None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
