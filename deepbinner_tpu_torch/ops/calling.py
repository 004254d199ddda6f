"""Window-probability combination and barcode-calling rules, on the device.

Counterpart of ``deepbinner_tpu/ops/calling.py``; the rules and their
reasons are documented there.  Every reduction is a fixed-order torch op
and every argmax keeps the first index on ties, as ``jnp.argmax`` does.
"""

from __future__ import annotations

import dataclasses

import torch

from deepbinner_tpu_torch import NUM_CLASSES


@dataclasses.dataclass(frozen=True)
class CallingConfig:
    """Static calling-rule parameters (CLI flags in the reference)."""

    min_score: float = 0.5    # best barcode probability must reach this
    score_diff: float = 0.5   # margin over the runner-up barcode
    require_both: bool = False  # dual-model: both ends must agree (vs either)
    combine: str = "neighbour"  # window combine rule: "neighbour" or "best"


def combine_window_probs(
    probs: torch.Tensor, window_mask: torch.Tensor, rule: str = "neighbour"
) -> torch.Tensor:
    """Combine ``(B, W, C)`` window probabilities into ``(B, C)`` per read.

    "best": the window with the strongest barcode evidence
    (``max_{c≥1} p[w, c]``).  "neighbour": that window averaged with its
    stronger valid neighbour; edge windows keep their full evidence.  Rows
    with no valid window get probability 1 on class 0 ("none").
    """
    if rule not in ("neighbour", "best"):
        raise ValueError(f"unknown combine rule {rule!r}")
    _batch, num_windows, _classes = probs.shape
    barcode_strength = torch.where(
        window_mask, probs[:, :, 1:].amax(dim=-1),
        torch.full((), -1.0, dtype=probs.dtype, device=probs.device),
    )
    best_window = barcode_strength.argmax(dim=-1)

    def row(idx: torch.Tensor) -> torch.Tensor:
        index = idx[:, None, None].expand(-1, 1, probs.shape[2])
        return torch.gather(probs, 1, index)[:, 0, :]

    if rule == "best":
        combined = row(best_window)
    else:
        left = torch.clamp(best_window - 1, 0, num_windows - 1)
        right = torch.clamp(best_window + 1, 0, num_windows - 1)

        def strength_at(idx: torch.Tensor) -> torch.Tensor:
            return torch.gather(barcode_strength, 1, idx[:, None])[:, 0]

        neighbour = torch.where(strength_at(left) >= strength_at(right),
                                left, right)
        # A masked (or clipped-onto-self) neighbour falls back to the best
        # window itself: padding-window probabilities would be garbage.
        neighbour = torch.where(strength_at(neighbour) >= 0.0, neighbour,
                                best_window)
        combined = 0.5 * (row(best_window) + row(neighbour))
    any_valid = window_mask.any(dim=1, keepdim=True)
    # Built on the device: ``none_row[0] = 1.0`` would copy a host scalar to
    # the card, which waits for the card's queue to drain.
    none_row = (torch.arange(NUM_CLASSES, device=probs.device) == 0).to(
        probs.dtype)
    return torch.where(any_valid, combined, none_row[None, :])


def call_one_end(probs: torch.Tensor, cfg: CallingConfig) -> torch.Tensor:
    """``(B, C)`` combined probabilities → int32 ``(B,)`` call (0 = none).

    The best barcode must reach ``min_score``, beat the runner-up by
    ``score_diff``, and be above zero.
    """
    barcode_probs = probs[:, 1:]
    best_barcode = (barcode_probs.argmax(dim=-1) + 1).to(torch.int32)
    order = torch.sort(barcode_probs, dim=-1).values
    top1 = order[:, -1]
    top2 = order[:, -2]
    confident = ((top1 > 0.0) & (top1 >= cfg.min_score)
                 & (top1 - top2 >= cfg.score_diff))
    return torch.where(confident, best_barcode, torch.zeros_like(best_barcode))


def reconcile_calls(start_call: torch.Tensor, end_call: torch.Tensor,
                    cfg: CallingConfig) -> torch.Tensor:
    """Merge start-model and end-model calls (EXP-NBD103 dual-model mode).

    either (default): agreeing calls stand; one called end wins; two called
    ends that disagree → none.  require_both: both ends must agree.
    """
    zero = torch.zeros_like(start_call)
    agree = start_call == end_call
    if cfg.require_both:
        return torch.where(agree & (start_call != 0), start_call, zero)
    both_called = (start_call != 0) & (end_call != 0)
    either = torch.where(start_call != 0, start_call, end_call)
    return torch.where(both_called & ~agree, zero, either).to(torch.int32)
