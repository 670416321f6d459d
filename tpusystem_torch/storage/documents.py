"""Zero-dependency JSON document store (the TinyDB seam, rebuilt): the port
of :mod:`tpusystem.storage.documents`.

The reference's adapters sit on TinyDB tables
(``examples/tinysys/tinysys/adapters/*.py``); this environment ships no
TinyDB, and the framework should not depend on one — the store is ~100
lines: named tables of JSON documents with insert/search/update/remove,
each document addressed by a monotonically increasing integer id.

Durability: every mutation rewrites the file atomically (temp file +
``os.replace``), so a preempted worker never leaves a torn database —
relevant because checkpoint-resume decisions read these rows
(SURVEY.md §3.5). For metric streams at scale prefer batched writes
(``Table.insert_many``).
"""

from __future__ import annotations

import json
import os
import pathlib
import threading
from collections.abc import Callable, Iterable
from typing import Any

Document = dict[str, Any]
Predicate = Callable[[Document], bool]


def where(**fields: Any) -> Predicate:
    """Predicate matching documents whose fields equal the given values."""
    def match(doc: Document) -> bool:
        return all(doc.get(key) == value for key, value in fields.items())
    return match


class Table:
    """One named collection of documents inside a :class:`DocumentStore`."""

    def __init__(self, store: 'DocumentStore', name: str) -> None:
        self._store = store
        self.name = name

    def _data(self) -> dict[str, Document]:
        return self._store._tables.setdefault(self.name, {})

    def insert(self, document: Document) -> int:
        """Insert a document; returns its id."""
        return self.insert_many([document])[0]

    def insert_many(self, documents: Iterable[Document]) -> list[int]:
        with self._store._lock:
            table = self._data()
            ids = []
            for document in documents:
                identifier = self._store._next_id(self.name)
                table[str(identifier)] = dict(document)
                ids.append(identifier)
            self._store._flush()
            return ids

    def search(self, predicate: Predicate) -> list[Document]:
        with self._store._lock:
            return [dict(doc) for doc in self._data().values() if predicate(doc)]

    def get(self, predicate: Predicate) -> Document | None:
        found = self.search(predicate)
        return found[0] if found else None

    def all(self) -> list[Document]:
        with self._store._lock:
            return [dict(doc) for doc in self._data().values()]

    def update_last(self, changes: Document, predicate: Predicate) -> int:
        """Apply field changes to the *latest* matching document only (the
        one with the highest id); returns 1 if a document matched, else 0."""
        with self._store._lock:
            matched = [key for key, doc in self._data().items()
                       if predicate(doc)]
            if not matched:
                return 0
            last = max(matched, key=int)
            self._data()[last].update(changes)
            self._store._flush()
            return 1

    def update(self, changes: Document, predicate: Predicate) -> int:
        """Apply field changes to matching documents; returns match count."""
        with self._store._lock:
            count = 0
            for doc in self._data().values():
                if predicate(doc):
                    doc.update(changes)
                    count += 1
            if count:
                self._store._flush()
            return count

    def remove(self, predicate: Predicate) -> int:
        with self._store._lock:
            table = self._data()
            doomed = [key for key, doc in table.items() if predicate(doc)]
            for key in doomed:
                del table[key]
            if doomed:
                self._store._flush()
            return len(doomed)

    def clear(self) -> None:
        with self._store._lock:
            self._data().clear()
            self._store._flush()

    def __len__(self) -> int:
        with self._store._lock:
            return len(self._data())


class DocumentStore:
    """A JSON file of named tables; safe for concurrent in-process use."""

    def __init__(self, path: str | os.PathLike) -> None:
        self.path = pathlib.Path(path)
        self._lock = threading.RLock()
        self._tables: dict[str, dict[str, Document]] = {}
        self._counters: dict[str, int] = {}
        if self.path.exists():
            with open(self.path) as handle:
                payload = json.load(handle)
            self._tables = payload.get('tables', {})
            self._counters = payload.get('counters', {})

    def table(self, name: str) -> Table:
        return Table(self, name)

    def _next_id(self, table: str) -> int:
        nxt = self._counters.get(table, 0) + 1
        self._counters[table] = nxt
        return nxt

    def _flush(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        scratch = self.path.with_suffix(self.path.suffix + '.tmp')
        with open(scratch, 'w') as handle:
            json.dump({'tables': self._tables, 'counters': self._counters}, handle)
        os.replace(scratch, self.path)

    def close(self) -> None:
        with self._lock:
            self._flush()
