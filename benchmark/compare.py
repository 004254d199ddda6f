"""The comparison that decides ``correct``.

The program's answer for a read is its row (read id and call) and the
combined probabilities behind it.  The reference gives each read end's
window probabilities; the combining rule and the calling rules of
``deepbinner_tpu_torch/ops/calling.py`` at commit
402717dbde1c47220f6674dc523b70c64264754a are written again here.  Those
rules make discrete choices (the best window, its neighbour, a score
against a threshold), and two float32 computations of the same read can
fall on either side of a choice whose deciding values lie within rounding
of each other.  So every choice whose values lie within ``TIE`` of each
other is taken both ways, and a read's answer is judged against the
nearest of the outcomes that gives.  A read's call is wrong when it is
none of them, and its probabilities are as far off as they are from the
nearest outcome.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Sequence, Tuple

import numpy as np

# Deciding values closer than this count as tied (far above the 1e-6 by
# which float32 computations of one window's probabilities differ, far
# below the gaps between the calling thresholds).
TIE = 1e-3


def combined_outcomes(probs: np.ndarray, mask: np.ndarray,
                      rule: str) -> List[np.ndarray]:
    """Every combined ``(C,)`` row one read end can take: the best window
    (the strongest barcode evidence among the valid windows), averaged
    under ``"neighbour"`` with its stronger valid neighbour; class 0 when
    no window is valid."""
    classes = probs.shape[1]
    if not mask.any():
        none = np.zeros(classes, np.float32)
        none[0] = 1.0
        return [none]
    strength = np.where(mask, probs[:, 1:].max(axis=1), -1.0)
    last = probs.shape[0] - 1
    out = []
    for best in np.nonzero(mask & (strength >= strength.max() - TIE))[0]:
        if rule == "best":
            out.append(probs[best])
            continue
        left, right = max(best - 1, 0), min(best + 1, last)
        gap = strength[left] - strength[right]
        choices = ([left] if gap > TIE else [right] if gap < -TIE
                   else [left, right])
        for neighbour in choices:
            if strength[neighbour] < 0:  # a masked window: keep the best
                neighbour = best
            out.append(np.float32(0.5) * (probs[best] + probs[neighbour]))
    return out


def calls_of(row: np.ndarray, min_score: float, score_diff: float) -> FrozenSet[int]:
    """Every call one combined row can give: the best barcode where it
    reaches ``min_score`` and beats the runner-up by ``score_diff``, else
    0 (none)."""
    barcodes = row[1:]
    top = np.sort(barcodes)[::-1]
    top1, top2 = float(top[0]), float(top[1])
    calls = set()

    def outcomes(value: float, threshold: float) -> Tuple[bool, ...]:
        if abs(value - threshold) <= TIE:
            return (True, False)
        return (value >= threshold,)

    for reaches in outcomes(top1, min_score):
        for beats in outcomes(top1 - top2, score_diff):
            if reaches and beats and top1 > 0.0:
                calls.update(int(b) + 1 for b in
                             np.nonzero(barcodes >= top1 - TIE)[0])
            else:
                calls.add(0)
    return frozenset(calls)


def reconcile(start: int, end: int, require_both: bool) -> int:
    """The dual-model call: either end (two called ends that disagree give
    none), or with ``require_both`` only two agreeing ends."""
    if require_both:
        return start if start == end and start != 0 else 0
    if start != 0 and end != 0 and start != end:
        return 0
    return start if start != 0 else end


def decide(probs: np.ndarray, mask: np.ndarray, calling: dict
           ) -> Tuple[np.ndarray, int]:
    """One read end's combined row and call as a program makes them: the
    first of tied windows, the left of tied neighbours, no other outcome
    (what the control, the reference in the program's place, answers)."""
    outcomes = combined_outcomes_strict(probs, mask, calling["combine"])
    barcodes = outcomes[1:]
    top = np.sort(barcodes)[::-1]
    confident = (top[0] > 0.0 and top[0] >= calling["min_score"]
                 and top[0] - top[1] >= calling["score_diff"])
    return outcomes, int(np.argmax(barcodes)) + 1 if confident else 0


def combined_outcomes_strict(probs: np.ndarray, mask: np.ndarray,
                             rule: str) -> np.ndarray:
    if not mask.any():
        none = np.zeros(probs.shape[1], np.float32)
        none[0] = 1.0
        return none
    strength = np.where(mask, probs[:, 1:].max(axis=1), -1.0)
    best = int(np.argmax(strength))
    if rule == "best":
        return probs[best]
    left, right = max(best - 1, 0), min(best + 1, probs.shape[0] - 1)
    neighbour = left if strength[left] >= strength[right] else right
    if strength[neighbour] < 0:
        neighbour = best
    return np.float32(0.5) * (probs[best] + probs[neighbour])


class Expected:
    """The reference's outcomes for every read of a corpus."""

    def __init__(self, ends: Sequence[Tuple[np.ndarray, np.ndarray]],
                 calling: dict) -> None:
        rule = calling["combine"]
        self.dual = len(ends) == 2
        # Per end, per read: the combined rows it can take.
        self.rows: List[List[np.ndarray]] = []
        per_end_calls: List[List[FrozenSet[int]]] = []
        for probs, masks in ends:
            rows, calls = [], []
            for p, m in zip(probs, masks):
                outcomes = np.stack(combined_outcomes(p, m, rule))
                rows.append(outcomes)
                calls.append(frozenset().union(*(
                    calls_of(o, calling["min_score"], calling["score_diff"])
                    for o in outcomes)))
            self.rows.append(rows)
            per_end_calls.append(calls)
        if self.dual:
            self.calls = [frozenset(reconcile(s, e, calling["require_both"])
                                    for s in starts for e in ends_)
                          for starts, ends_ in zip(*per_end_calls)]
        else:
            self.calls = per_end_calls[0]

    def judge(self, reads: np.ndarray, calls: np.ndarray,
              start_probs: np.ndarray, end_probs: np.ndarray) -> Dict[str, float]:
        """Judge the program's rows: ``reads`` indexes each row's read in
        the corpus.  Returns the widest gap of a combined probability from
        the nearest outcome, and the rows whose call is no outcome."""
        gap = 0.0
        order = np.argsort(reads, kind="stable")
        present, first = np.unique(reads[order], return_index=True)
        bounds = np.append(first, order.size)
        programs = [start_probs] + ([end_probs] if self.dual else [])
        for end, got in enumerate(programs):
            got = got[order]
            for k, read in enumerate(present):
                rows = got[bounds[k]:bounds[k + 1]]
                # (rows, outcomes, C) → each row's distance to its nearest
                far = np.abs(rows[:, None, :]
                             - self.rows[end][read][None, :, :]).max(axis=2)
                gap = max(gap, float(far.min(axis=1).max()))
        wrong = sum(int(c) not in self.calls[r] for r, c in zip(reads, calls))
        return {"prob_gap": gap, "calls_differing": wrong}
