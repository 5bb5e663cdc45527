"""The comparison that decides `correct`: the program's result of a batch
against the reference's, as counts of what differs (each limit is 0).

Lanes are compared by their valid anchors in slot order, not slot by
slot, so a lane layout that packs anchors differently compares equal
when it holds the same anchors, scores and links; a predecessor is
compared as the rank of its slot among the lane's valid slots.

- anchors_differ: anchors of lanes whose valid-anchor counts differ (the
  larger count), plus anchors of the other lanes with any field differing
- scores_differ: anchors of equal-count lanes whose f32 score bits differ
- prev_differ: anchors of equal-count lanes whose predecessor differs
- flags_differ: lanes whose dup, inexact, mult_ovf or lane_ovf differ,
  rows whose row_ovf differs, and the batch's overflow flag
- counts_differ: |n_q_filtered - reference| + |n_t_filtered - reference|
"""
from __future__ import annotations

import torch

NAMES = ("anchors_differ", "scores_differ", "prev_differ", "flags_differ",
         "counts_differ")


def _prev_rank(prev: torch.Tensor, gvalid: torch.Tensor) -> torch.Tensor:
    rank = gvalid.long().cumsum(dim=1) - 1
    p = prev.long()
    return torch.where(p >= 0, rank.gather(1, p.clamp(min=0, max=prev.shape[1]
                                                       - 1)), -1)


def compare(got: dict, want: dict) -> dict:
    """Counts of NAMES for one batch (got: the program's step result,
    want: reference.step's)."""
    gv, wv = got["gvalid"], want["gvalid"].to(got["gvalid"].device)
    dev = gv.device
    want = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
            for k, v in want.items()}
    cg, cw = gv.sum(dim=1), wv.sum(dim=1)
    same = cg == cw
    out = dict.fromkeys(NAMES, 0)
    out["anchors_differ"] = int(torch.maximum(cg, cw)[~same].sum())
    mg, mw = gv & same[:, None], wv & same[:, None]
    a_g = (got["anchors"] & 0xFFFFFFFF)[mg]
    a_w = (want["anchors"] & 0xFFFFFFFF)[mw]
    out["anchors_differ"] += int((a_g != a_w).any(dim=1).sum())
    s_g = got["scores"].float()[mg].view(torch.int32)
    s_w = want["scores"].float()[mw].view(torch.int32)
    out["scores_differ"] = int((s_g != s_w).sum())
    p_g = _prev_rank(got["prev"], gv)[mg]
    p_w = _prev_rank(want["prev"], wv)[mw]
    out["prev_differ"] = int((p_g != p_w).sum())
    flags = 0
    for name in ("dup", "inexact", "mult_ovf", "lane_ovf", "row_ovf"):
        flags += int((got[name].bool() != want[name].bool()).sum())
    flags += int(bool(got["overflow"]) != bool(want["overflow"]))
    out["flags_differ"] = flags
    out["counts_differ"] = (abs(int(got["n_q_filtered"])
                                - int(want["n_q_filtered"]))
                            + abs(int(got["n_t_filtered"])
                                  - int(want["n_t_filtered"])))
    return out
