"""Training augmentation on the card, for decode-only batches.

The port's copy of the JAX package's ``data/device_transforms.py``.  With
``Config.device_augment`` the host only decodes and resizes
(``DetectionDataset(decode_only=True)``) and the augmentation chain runs
on the device inside the train step, batched over images:

* photometric distortion: brightness, contrast, saturation and a hue mix,
  each behind its own coin, with the host chain's ranges
  (``data/transforms.py``);
* a horizontal flip with the boxes flipped too, and Mask R-CNN's polygon
  vertices (``x -> w - x``, as the box corners move);
* scale jitter: the reference's ``ScaleJitter -> Resize`` round trip leaves
  the boxes where they were, so only the pixels change, resampled through a
  random intermediate scale of ``SCALES`` (polygons stay too).  The round trip along one axis is
  a fixed linear map, ``M_s = R(m -> n) @ R(n -> m)``, so it is two matrix
  products an image (:func:`_jitter_matrices`).

It is plain PyTorch, as the JAX package's is plain jnp outside any Pallas
kernel.  The randomness is split from the arithmetic so that the two can be
held against the JAX package separately: :func:`draw_augment` draws every
image's coins and factors from a ``torch.Generator``, :func:`apply_augment`
applies a given record of draws, and :func:`augment_batch` composes them.
The record holds, for each image, what the JAX package draws from its key
tree: six photometric coins, four uniforms (brightness, contrast,
saturation, hue delta), the flip coin and the jitter index.

The chain mixes rows (the jitter resamples them), so with image rows over
a mesh's model axis (``parallel/spatial.py``) it runs on each data index's
whole images, drawn from the data index's generator: every rank of a model
group augments the same images alike, and the model then takes the rank's
rows (``nets/trainer.py:train_step``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

SCALES = (0.8, 0.9, 1.0, 1.1, 1.2)   # ScaleJitter(0.8, 1.2) discretised

# the photometric draws, in the columns of the record's ``coins`` and
# ``uniforms``: the JAX key (``ks[i]`` of ``_photometric``) each one matches
COINS = ("brightness", "contrast_late", "contrast", "saturation", "hue",
         "contrast_again")            # ks[0], ks[2], ks[3], ks[6], ks[8], ks[9]
UNIFORMS = {"brightness": (0.875, 1.125), "contrast": (0.5, 1.5),
            "saturation": (0.5, 1.5), "hue": (-0.05, 0.05)}
#                                     # ks[1], ks[4] (both contrasts), ks[5], ks[7]
_GRAY = (0.299, 0.587, 0.114)


def draw_augment(n: int, generator: Optional[torch.Generator] = None,
                 scale_jitter: bool = True, device=None) -> Dict[str, torch.Tensor]:
    """Every draw of a batch of ``n`` images, from ``generator`` (None: the
    default generator of ``device``), in one call on the generator's device.

    Returns ``coins [n, 6]`` bool (the columns of :data:`COINS`), ``uniforms
    [n, 4]`` f32 in the ranges of :data:`UNIFORMS`, in its order, ``flip
    [n]`` bool and ``jitter [n]`` int64, an index into :data:`SCALES` (0
    when ``scale_jitter`` is off).
    """
    dev = generator.device if generator is not None else torch.device(
        device or "cpu")
    u = torch.rand((n, 12), generator=generator, device=dev)
    # scalar arithmetic only: a tensor made from host values would copy to
    # the card and wait for its queue, inside the train loop
    uniforms = torch.stack([lo + u[:, 6 + i] * (hi - lo)
                            for i, (lo, hi) in enumerate(UNIFORMS.values())],
                           dim=1)
    jitter = torch.clamp((u[:, 11] * len(SCALES)).to(torch.int64),
                         max=len(SCALES) - 1)
    return {"coins": u[:, :6] < 0.5, "uniforms": uniforms,
            "flip": u[:, 10] < 0.5,
            "jitter": jitter if scale_jitter else torch.zeros_like(jitter)}


def _photometric(img: torch.Tensor, coins: torch.Tensor,
                 uniforms: torch.Tensor) -> torch.Tensor:
    """``img [B, H, W, 3]`` f32 -> the same, clipped to [0, 1].  The early
    and the late contrast share one factor, and only one of them can apply
    (``contrast_late`` picks which), as in the JAX package."""
    c = coins[:, :, None, None, None]                      # [B, 6, 1, 1, 1]
    u = uniforms[:, :, None, None, None]                   # [B, 4, 1, 1, 1]
    late = c[:, 1]

    def contrast(x):
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        return (x - mean) * u[:, 1] + mean

    img = torch.where(c[:, 0], img * u[:, 0], img)
    img = torch.where(~late & c[:, 2], contrast(img), img)
    gray = (img[..., 0] * _GRAY[0] + img[..., 1] * _GRAY[1]
            + img[..., 2] * _GRAY[2])
    f = u[:, 2]
    img = torch.where(c[:, 3], img * f + gray[..., None] * (1.0 - f), img)
    delta = torch.abs(u[:, 3])
    shifted = torch.roll(img, 1, dims=-1)
    img = torch.where(c[:, 4], img * (1.0 - delta) + shifted * delta, img)
    img = torch.where(late & c[:, 5], contrast(img), img)
    return torch.clamp(img, 0.0, 1.0)


def _hflip(img: torch.Tensor, boxes: torch.Tensor, flip: torch.Tensor):
    """Flip the images whose coin is set, and their boxes: ``w - x2, y1,
    w - x1, y2`` on every row, padding rows included; validity untouched."""
    w = img.shape[2]
    img = torch.where(flip[:, None, None, None], torch.flip(img, dims=(2,)),
                      img)
    flipped = torch.stack([w - boxes[..., 2], boxes[..., 1],
                           w - boxes[..., 0], boxes[..., 3]], dim=-1)
    return img, torch.where(flip[:, None, None], flipped, boxes)


def _hflip_polys(polys: torch.Tensor, flip: torch.Tensor, w: int):
    """The vertices ``[B, G, V, 2]`` of the flipped images at ``w - x, y``
    (the ring's orientation reverses, which the even-odd rule ignores)."""
    flipped = torch.stack([w - polys[..., 0], polys[..., 1]], dim=-1)
    return torch.where(flip[:, None, None, None], flipped, polys)


def _resize_matrix(n: int, m: int) -> torch.Tensor:
    """``R(n -> m)``, ``[m, n]`` f32: the antialiased linear resize of one
    axis, read off by resizing the identity.  PyTorch's antialiased bilinear
    resize uses the triangle kernel of ``jax.image.resize(..., "linear",
    antialias=True)`` (widened by ``n / m`` when shrinking, each output's
    weights normalised) and evaluates it in f32 as JAX does: the round trip
    agrees with JAX's within 1.8e-7 at n = 600, where the same kernel in
    float64 is 5e-5 away from JAX's f32 sample positions."""
    eye = torch.eye(n, dtype=torch.float32)[None, None]
    return torch.nn.functional.interpolate(
        eye, size=(m, n), mode="bilinear", align_corners=False,
        antialias=True)[0, 0]


_BUILT: Dict[tuple, torch.Tensor] = {}


def _jitter_matrices(n: int, scales: Tuple[float, ...] = SCALES,
                     device="cpu") -> torch.Tensor:
    """``[S, n, n]`` f32: for each scale ``s`` of ``scales``, the round trip
    ``M_s = R(m -> n) @ R(n -> m)`` through ``m = max(int(n * s), 8)``
    pixels along one axis (the identity where ``m == n``), built on the
    host (the product in float64) and copied to ``device`` once; cached per
    ``(n, scales, device)``."""
    key = (n, tuple(scales), str(torch.device(device)))
    if key not in _BUILT:
        mats = []
        for s in scales:
            m = max(int(n * s), 8)
            mats.append(torch.eye(n, dtype=torch.float64) if m == n else
                        _resize_matrix(m, n).double()
                        @ _resize_matrix(n, m).double())
        _BUILT[key] = torch.stack(mats).to(torch.float32).to(device)
    return _BUILT[key]


def _scale_jitter(img: torch.Tensor, jitter: torch.Tensor) -> torch.Tensor:
    """Resample each image through its intermediate scale: rows, then
    columns, one matrix product each (f32; the result is not clipped)."""
    b, h, w, c = img.shape
    mh = _jitter_matrices(h, SCALES, img.device)[jitter]         # [B, h, h]
    mw = _jitter_matrices(w, SCALES, img.device)[jitter]         # [B, w, w]
    t = torch.matmul(mh, img.reshape(b, h, w * c))               # [B, h, w*c]
    t = t.reshape(b, h, w, c).transpose(1, 2).reshape(b, w, h * c)
    out = torch.matmul(mw, t)                                    # [B, w, h*c]
    return out.reshape(b, w, h, c).transpose(1, 2).contiguous()


def apply_augment(images: torch.Tensor, boxes: torch.Tensor,
                  draws: Dict[str, torch.Tensor], scale_jitter: bool = True,
                  polys: Optional[torch.Tensor] = None) -> Tuple:
    """Apply a record of :func:`draw_augment` to ``images [B, H, W, 3]``
    (float in [0, 1]) and ``boxes [B, G, 4]``: photometric distortion
    (clipped to [0, 1]), the flip, then, with ``scale_jitter``, the
    resample.  Returns ``(images f32, boxes)``, and the flipped ``polys
    [B, G, V, 2]`` third where they are given."""
    img = _photometric(images.to(torch.float32), draws["coins"],
                       draws["uniforms"])
    w = img.shape[2]
    img, boxes = _hflip(img, boxes, draws["flip"])
    if scale_jitter:
        img = _scale_jitter(img, draws["jitter"])
    if polys is None:
        return img, boxes
    return img, boxes, _hflip_polys(polys, draws["flip"], w)


def augment_batch(images: torch.Tensor, boxes: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  scale_jitter: bool = True,
                  polys: Optional[torch.Tensor] = None) -> Tuple:
    """The training augmentation of a batch on its own device, the draws
    from ``generator`` (None: the device's default generator); ``polys``
    as :func:`apply_augment`."""
    draws = draw_augment(images.shape[0], generator, scale_jitter,
                         images.device)
    return apply_augment(images, boxes, draws, scale_jitter, polys)
