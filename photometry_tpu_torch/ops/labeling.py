"""
Connected components and seeded segmentation, on torch tensors.

Port of ``photometry_tpu/ops/labeling.py``: the same fixed-point label
propagation, with each ``lax.while_loop`` as a Python loop that stops when
no label changed (one host sync per iteration on the card).

Batch layout as in the reference: every function takes (H, W) plus any
trailing batch dims; spatial neighbours are the first two axes.  The
neighbour scan order (``offs``) is the reference's exactly — it decides the
outcome of exact float ties in the watershed (PARITY.md).
"""

from __future__ import annotations

import torch

__all__ = ["label_components", "watershed_segment", "dbscan_labels"]

_NEG = -3.4e38
_CROSS = [(0, 1), (2, 1), (1, 0), (1, 2)]
_DIAG = [(0, 0), (0, 2), (2, 0), (2, 2)]


def _pad_spatial(x: torch.Tensor, value) -> torch.Tensor:
    """Pad the first two (spatial) axes by 1; trailing batch dims untouched."""
    H, W = x.shape[:2]
    p = torch.full((H + 2, W + 2) + tuple(x.shape[2:]), value, dtype=x.dtype,
                   device=x.device)
    p[1:H + 1, 1:W + 1] = x
    return p


def _neighbor_min(lab, mask, connectivity: int = 2):
    """Min of labels over the 3x3 (or cross) neighborhood, inf outside mask."""
    H, W = lab.shape[:2]
    big = torch.where(mask, lab, torch.inf)
    p = _pad_spatial(big, torch.inf)
    offs = _CROSS + [(1, 1)] + (_DIAG if connectivity == 2 else [])
    out = torch.full_like(big, torch.inf)
    for dy, dx in offs:
        out = torch.minimum(out, p[dy:dy + H, dx:dx + W])
    return out


def label_components(mask: torch.Tensor, connectivity: int = 2,
                     max_iters: int = 4096) -> torch.Tensor:
    """Label connected components of a boolean mask (trailing dims = batch).

    Returns int32 labels: 0 for background, 1..n for components, ordered by
    each component's smallest flat pixel index (deterministic).
    """
    mask = mask.to(torch.bool)
    H, W = mask.shape[:2]
    tail = tuple(mask.shape[2:])
    idx = torch.arange(H * W, dtype=torch.float32, device=mask.device)
    lab = torch.where(mask, idx.reshape((H, W) + (1,) * len(tail)), torch.inf)
    for _ in range(max_iters):
        new = torch.where(mask, torch.minimum(lab, _neighbor_min(lab, mask, connectivity)),
                          torch.inf)
        changed = bool((new != lab).any())
        lab = new
        if not changed:
            break

    # Relabel to contiguous 1..n per image (0 = background).  The root of
    # each component is the pixel whose flat index equals its label value.
    flat = lab.reshape((H * W,) + tail)
    mflat = mask.reshape(flat.shape)
    is_root = mflat & (flat == idx.reshape((H * W,) + (1,) * len(tail)))
    comp_rank = torch.cumsum(is_root.to(torch.int32), dim=0)
    root_idx = torch.where(torch.isinf(flat), 0.0, flat).long()
    ranks = torch.take_along_dim(comp_rank, root_idx, dim=0)
    labels = torch.where(mflat, ranks, 0)
    return labels.reshape(mask.shape).to(torch.int32)


def dbscan_labels(mask: torch.Tensor, min_samples: int = 4,
                  max_iters: int = 4096) -> torch.Tensor:
    """Exact DBSCAN(eps=sqrt(2), min_samples) on a pixel grid (trailing dims = batch).

    Core points have >= ``min_samples`` mask pixels in their 3x3 block;
    clusters are the 8-connected components of the core points; border
    points join the smallest-labelled adjacent cluster; the rest is noise
    (label 0).  Returns int32 labels.
    """
    mask = mask.to(torch.bool)
    H, W = mask.shape[:2]
    p = _pad_spatial(mask.to(torch.float32), 0.0)
    cnt = torch.zeros(mask.shape, dtype=torch.float32, device=mask.device)
    for dy in range(3):
        for dx in range(3):
            cnt = cnt + p[dy:dy + H, dx:dx + W]
    core = mask & (cnt >= min_samples)
    lab_core = label_components(core, connectivity=2, max_iters=max_iters)
    nb = _neighbor_min(lab_core.to(torch.float32), core)
    border = mask & ~core & torch.isfinite(nb)
    return torch.where(core, lab_core,
                       torch.where(border, nb, 0.0).to(torch.int32))


def _neighbor_best(priority, labels, connectivity: int = 2):
    """For each pixel: (best neighbor priority, its label) among labeled nbrs."""
    H, W = priority.shape[:2]
    pr = torch.where(labels > 0, priority, _NEG)
    p_pr = _pad_spatial(pr, _NEG)
    p_lb = _pad_spatial(labels, 0)
    offs = _CROSS + (_DIAG if connectivity == 2 else [])
    best_pr = torch.full_like(pr, _NEG)
    best_lb = torch.zeros_like(labels)
    for dy, dx in offs:
        npr = p_pr[dy:dy + H, dx:dx + W]
        nlb = p_lb[dy:dy + H, dx:dx + W]
        take = npr > best_pr
        best_pr = torch.where(take, npr, best_pr)
        best_lb = torch.where(take, nlb, best_lb)
    return best_pr, best_lb


def watershed_segment(elevation: torch.Tensor, markers: torch.Tensor,
                      mask: torch.Tensor, connectivity: int = 2,
                      max_iters: int = 4096) -> torch.Tensor:
    """Marker-seeded segmentation of ``mask`` guided by an elevation image
    (trailing dims = batch; higher elevation = closer to a peak).

    Same three stages as the reference (photometry_tpu/ops/labeling.py
    watershed_segment): maximin pop priorities by value iteration, labels
    flowing down the argmax-priority parent forest (first-scanned neighbour
    wins ties), then a greedy mop-up of tie-cycle leftovers.  Returns int32
    labels (0 outside mask / unreached).
    """
    elevation = elevation.to(torch.float32)
    mask = mask.to(torch.bool)
    labels = torch.where(mask, markers.to(torch.int32), 0)
    H, W = elevation.shape[:2]
    offs = _CROSS + (_DIAG if connectivity == 2 else [])

    def nbr_max(v):
        p = _pad_spatial(v, _NEG)
        best = torch.full_like(v, _NEG)
        for dy, dx in offs:
            best = torch.maximum(best, p[dy:dy + H, dx:dx + W])
        return best

    # ---- Stage 1: pop priorities (maximin value iteration) ----
    elev_m = torch.where(mask, elevation, _NEG)
    v = torch.where(labels > 0, elev_m, _NEG)
    for _ in range(max_iters):
        new = torch.maximum(v, torch.where(mask, torch.minimum(elev_m, nbr_max(v)), _NEG))
        changed = bool((new > v).any())
        v = new
        if not changed:
            break
    v = torch.where(mask, v, _NEG)

    # ---- Stage 2: labels flow down the argmax-v parent forest ----
    p_v = _pad_spatial(v, _NEG)
    best_v = torch.full_like(v, _NEG)
    parent = []   # static: per offset, does this neighbour win the scan?
    for dy, dx in offs:
        nv = p_v[dy:dy + H, dx:dx + W]
        take = nv > best_v          # strict: first-scanned wins v ties
        best_v = torch.where(take, nv, best_v)
        parent.append(take)
    for _ in range(max_iters):
        p_lb = _pad_spatial(labels, 0)
        best_lb = torch.zeros_like(labels)
        for (dy, dx), take in zip(offs, parent):
            best_lb = torch.where(take, p_lb[dy:dy + H, dx:dx + W], best_lb)
        new = torch.where(mask & (labels == 0) & (best_lb > 0), best_lb, labels)
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break

    # ---- Stage 3: greedy mop-up for tie-cycle leftovers ----
    for _ in range(max_iters):
        _, nb_lb = _neighbor_best(elevation, labels, connectivity)
        new = torch.where(mask & (labels == 0) & (nb_lb > 0), nb_lb, labels)
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    return labels
