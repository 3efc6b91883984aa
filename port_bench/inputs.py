"""The one general generator: every input a cell gets, made from ``--seed``
and the parameters of its traffic file.

Nothing here knows a cell.  A traffic file names its driver and gives the
numbers this module turns into inputs: images (made on the device, in a few
large calls) and a resident training set with COCO-shaped boxes.  The same seed gives the same inputs; different seeds
give the same sizes, so that seeds move the content and order of the
work and not its amount.
"""

from __future__ import annotations

import math

import numpy as np
import torch

def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for one purpose (``keys``) of a run's ``seed``; any
    whole ``seed`` >= 0, however large."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *keys])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, *keys))


def device_generator(seed: int, device, *keys: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *keys))


def images_u8(n: int, h: int, w: int, gen: torch.Generator,
              chunk: int = 256) -> torch.Tensor:
    """``[n, h, w, 3]`` uint8 images on ``gen``'s device: smooth colour
    fields (noise at an eighth of the size, upsampled bilinearly) with
    pixel noise on top, so that maps and proposals see edges and texture.
    Drawn ``chunk`` images a call."""
    dev = gen.device
    out = torch.empty((n, h, w, 3), dtype=torch.uint8, device=dev)
    for i in range(0, n, chunk):
        m = min(chunk, n - i)
        low = torch.randn((m, 3, max(h // 8, 1), max(w // 8, 1)),
                          generator=gen, device=dev)
        x = torch.nn.functional.interpolate(low, size=(h, w), mode="bilinear",
                                            align_corners=False)
        x = x * 48.0 + 128.0 + 16.0 * torch.randn((m, 3, h, w), generator=gen,
                                                  device=dev)
        out[i:i + m] = x.clamp(0.0, 255.0).round().to(torch.uint8).permute(
            0, 2, 3, 1)
    return out


def gt_boxes(n: int, spec: dict, h: int, w: int, num_classes: int,
             g_max: int, seed: int):
    """COCO-shaped ground truth for ``n`` images: ``boxes [n, g_max, 4]``
    f32 xyxy, ``labels [n, g_max]`` int32 (0-based), ``valid [n, g_max]``
    bool.

    ``spec``: ``mean_instances`` (instances an image, 1 + a geometric
    tail, capped at ``g_max``), ``area_shares`` (small / medium / large by
    COCO's 32^2 and 96^2 pixel areas), ``side_px`` (the square-root areas
    each class draws from, uniform), ``aspect`` (the range of h / w,
    log-uniform)."""
    r = rng(seed, 2)
    extra = r.geometric(1.0 / spec["mean_instances"], size=n) - 1
    counts = np.minimum(1 + extra, g_max)
    shares = np.asarray(spec["area_shares"], np.float64)
    k = int(counts.sum())
    cls = r.choice(len(shares), size=k, p=shares / shares.sum())
    lo = np.asarray([s[0] for s in spec["side_px"]], np.float64)[cls]
    hi = np.asarray([s[1] for s in spec["side_px"]], np.float64)[cls]
    side = r.uniform(lo, hi)
    a_lo, a_hi = spec["aspect"]
    ar = np.exp(r.uniform(math.log(a_lo), math.log(a_hi), size=k))
    bw = np.minimum(side / np.sqrt(ar), w)
    bh = np.minimum(side * np.sqrt(ar), h)
    x1 = r.uniform(0.0, w - bw)
    y1 = r.uniform(0.0, h - bh)
    flat = np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.float32)
    boxes = np.zeros((n, g_max, 4), np.float32)
    labels = np.zeros((n, g_max), np.int32)
    valid = np.zeros((n, g_max), bool)
    slot = np.arange(g_max)[None, :] < counts[:, None]
    boxes[slot] = flat
    labels[slot] = r.integers(0, num_classes, size=k)
    valid[slot] = True
    return boxes, labels, valid
