"""The numbers that decide ``correct``: what the program produced against
what the reference works out from the same inputs.

Serving: :func:`scored_detections` scores the program's served detections
by the reference's decodes of the same images.  Training:
:func:`leaf_errors` takes, leaf by leaf, the norm of the difference
between the program's tensor and the reference's, and
:func:`worst_leaf_gap` the gap between their norms, each relative to the
larger of that leaf's reference norm and the median leaf's.
"""

from __future__ import annotations

import numpy as np


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of every box of ``a [n, 4]`` with every box of ``b [m, 4]``."""
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(br - tl, 0.0, None), axis=-1)
    area = lambda x: (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])  # noqa: E731
    return inter / np.maximum(area(a)[:, None] + area(b)[None, :] - inter,
                              1e-9)


def scored_detections(pairs, iou_min: float = 0.7) -> dict:
    """The reference's scores of the program's served detections.

    ``pairs``: ``(got, want)`` a served image: ``got`` the program's
    output (``boxes``, ``scores``, ``labels``, ``valid``), ``want`` the
    reference's, with ``cand_boxes [R, C, 4]``, ``cand_scores [R, C]`` and
    ``cand_valid [R]``: every decode of every proposal for every class and
    its score, before the threshold and the NMS.  A served detection is
    *found* where a valid proposal's decode for its class overlaps it by
    ``iou_min`` or more, and then scored by the best-overlapping decode's
    reference score.  ``iou_min`` is the RPN's NMS threshold: where
    rounding lets a near-duplicate anchor win that NMS, the two overlap by
    more than it, and their decodes nearly so.  Pooled over the images:

    * ``score_gap``: mean ``|s_program - s_reference|`` over found
      detections;
    * ``unfound_share``: the share of the served score mass not found;
    * ``count_gap``: ``|N_program - N_reference| / N_reference``, the
      served detections against the reference's own;
    * ``miss_share``, the number compared: the served score mass the
      reference does not back (the mass not found, and each found
      detection's ``|s_program - s_reference|``) plus the gap between the
      served mass and the reference's own, over the larger of the two
      masses.  A served answer altered, or taken from another image, is
      not found or scored apart; answers left out leave the served mass
      short of the reference's.
    """
    gaps, unfound, mass, ref_mass = [], 0.0, 0.0, 0.0
    n_p = n_r = 0
    for got, want in pairs:
        v = got["valid"].astype(bool)
        n_p += int(v.sum())
        n_r += int(want["valid"].astype(bool).sum())
        ref_mass += float(want["scores"][want["valid"].astype(bool)].sum())
        ok = want["cand_valid"].astype(bool)
        for box, s, lab in zip(got["boxes"][v], got["scores"][v],
                               got["labels"][v]):
            mass += float(s)
            c = int(lab) - 1
            cb = want["cand_boxes"][ok, c].astype(np.float64)
            if not len(cb):
                unfound += float(s)
                continue
            iou = _iou(box[None].astype(np.float64), cb)[0]
            j = int(np.argmax(iou))
            if iou[j] < iou_min:
                unfound += float(s)
                continue
            gaps.append(abs(float(s) - float(want["cand_scores"][ok, c][j])))
    top = max(mass, ref_mass)
    bad = unfound + float(np.sum(gaps)) + abs(mass - ref_mass)
    return {"score_gap": float(np.mean(gaps)) if gaps else 0.0,
            "unfound_share": unfound / mass if mass else 0.0,
            "count_gap": abs(n_p - n_r) / n_r if n_r else float(n_p > 0),
            "miss_share": bad / top if top else 0.0,
            "found": len(gaps), "served": n_p, "reference": n_r}


def worst_leaf_gap(got: dict, want: dict, names=None) -> tuple:
    """``(gap, leaf)``: the largest ``|got[n] - want[n]| / max(want[n],
    median)`` over the leaves ``names`` (default: all of ``want``), where
    ``median`` is the median of ``want`` over those leaves; a leaf
    ``got`` lacks reads 0."""
    names = list(want if names is None else names)
    med = float(np.median([want[n] for n in names]))
    gaps = {n: abs(got.get(n, 0.0) - want[n]) / max(want[n], med, 1e-30)
            for n in names}
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def leaf_norms(tensors: dict) -> dict:
    """``{name: float}``: each leaf's norm."""
    return {n: float(t.double().norm()) for n, t in tensors.items()}


def leaf_errors(got: dict, want: dict, names) -> dict:
    """``{name: ||got[n] - want[n]|| / max(||want[n]||, median)}`` over the
    leaves ``names``, ``median`` the median of ``||want[n]||`` over them:
    each leaf's error element by element, so a wrong direction shows
    where the norms agree.  A leaf ``got`` lacks reads as zero."""
    norms = {n: float(want[n].double().norm()) for n in names}
    med = float(np.median(list(norms.values())))
    out = {}
    for n in names:
        g = got.get(n)
        diff = norms[n] if g is None else float(
            (g.double() - want[n].double()).norm())
        out[n] = diff / max(norms[n], med, 1e-30)
    return out


def moving_leaves(grad_norms: dict, rel: float = 1e-3) -> list:
    """Leaves whose reference gradient is at least ``rel`` times the median
    leaf's: the others (a key's bias under softmax, say) move under AdamW
    by round-off alone."""
    med = float(np.median(list(grad_norms.values())))
    return [n for n, g in grad_norms.items() if g >= rel * med]
