"""The comparison that decides ``correct``: exact integer trussness."""

from __future__ import annotations

import numpy as np


class Tally:
    """Counts of wrong, missing and unanswered answers over a run."""

    def __init__(self):
        self.wrong = 0          # edges whose trussness differs
        self.missing = 0        # edges absent from an answer (or extra)
        self.unanswered = 0     # answers that never came or raised
        self.answers = 0

    def rows(self, answer, truth: np.ndarray) -> None:
        """Judge one answer aligned to the same rows as ``truth``."""
        self.answers += 1
        if answer is None:
            self.unanswered += 1
            return
        answer = np.asarray(answer).reshape(-1)
        k = min(answer.size, truth.size)
        self.missing += abs(int(answer.size) - int(truth.size))
        self.wrong += int((answer[:k].astype(np.int64)
                           != truth[:k].astype(np.int64)).sum())

    def compared(self) -> dict:
        """The numbers compared, each beside its limit: the counts of
        faults at most 0, the answers checked at least 1."""
        return {"wrong_trussness": {"value": self.wrong, "limit": 0},
                "missing_edges": {"value": self.missing, "limit": 0},
                "unanswered": {"value": self.unanswered, "limit": 0},
                "answers_checked": {"value": self.answers, "limit": 1,
                                    "at_least": True}}


def holds(c: dict) -> bool:
    """Whether one compared number keeps to its limit."""
    if c.get("at_least"):
        return c["value"] >= c["limit"]
    return c["value"] <= c["limit"]
