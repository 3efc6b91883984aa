"""Reference ``.pth`` checkpoints in and out of the port's modules.

The port's counterpart of the JAX package's ``utils/torch_import.py``.  The
reference's checkpoint contract is ``weights/FasterRCNNTrainer_{best,last}.pth``
holding ``{'model_state_dict': ..., 'optimizer_state_dict': ...}``; its
model keys are

* HarDNet: the backbone is an ``nn.ModuleList`` ``base`` whose indices
  depend on the arch (parameter-free MaxPool, ReLU and Dropout entries
  still take an index, :func:`_extractor_layout`), under ``feat_extra.``
  in a trainer's dict; the heads are ``rpn.{loc,score}`` and
  ``head.{cls_loc,score}``;
* ResNet / ResNeXt (the reference's and torchvision's ImageNet dicts):
  ``conv1``, ``bn1``, ``layer{L}.{B}.{conv,bn}{i}`` and
  ``layer{L}.{B}.downsample.{0,1}``, with a PReLU slope ``relu.weight``
  per block in the reference's dicts and none in torchvision's.

The port's parameters are already in torch's layouts (``[O, I/g, kh, kw]``
convs, ``[out, in]`` dense layers, a PReLU's ``[1]`` slope) and its batch
norms carry torch's names, so the mapping is one of names and indices: no
value is transposed.  A converted dict is keyed by the port's own
``state_dict`` names (``extractor.stem0.conv.weight``, ...) and overlays
the model's dict with checks: a key the converter needs and the dict
lacks, a key the model does not have, a shape that does not match, or a
backbone parameter or statistic left unfilled raises, naming the key.
Ignored, as in the JAX package: ``num_batches_tracked``, ``fc.*``, stages
beyond ``blocks_num``, and every key the converter does not read.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from two_stage_object_detection_tpu_torch.models.hardnet import _ARCH

_BN = ("weight", "bias", "running_mean", "running_var")


def _extractor_layout(arch: int, depth_wise: bool = True):
    """``(port name, kind, reference base index)`` for every layer with
    parameters; kind: ``"convlayer"`` (conv + norm), ``"dwconvlayer"``
    (dwconv + norm), ``"block"`` (a HarDBlock), ``"conv2d"`` (a bare conv
    with bias).  Returns ``(entries, n_layers)``."""
    _, _, _, _, n_layers, down_samp = _ARCH[arch]
    entries = []
    idx = 0
    entries.append(("stem0", "convlayer", idx)); idx += 1
    entries.append(("stem1", "convlayer", idx)); idx += 1
    if depth_wise:
        entries.append(("stem2", "dwconvlayer", idx))
    idx += 1                                   # DWConv or MaxPool slot
    for i in range(len(n_layers)):
        entries.append((f"block{i}", "block", idx)); idx += 1
        if i == len(n_layers) - 1 and arch == 85:
            idx += 1                           # Dropout slot
        entries.append((f"transition{i}", "convlayer", idx)); idx += 1
        if down_samp[i] == 1:
            if depth_wise:
                entries.append((f"down{i}", "dwconvlayer", idx))
            idx += 1                           # DWConv or MaxPool slot
    entries.append(("tail0", "conv2d", idx)); idx += 1
    idx += 1                                   # ReLU slot
    entries.append(("tail1", "conv2d", idx)); idx += 1
    entries.append(("tail2", "conv2d", idx)); idx += 1
    return entries, n_layers


def _layer_keys(kind: str):
    """``(port suffix, reference suffix)`` pairs of one layer of ``kind``."""
    if kind == "conv2d":
        return [("weight", "weight"), ("bias", "bias")]
    conv = "conv" if kind == "convlayer" else "dwconv"
    return [(f"{conv}.weight", f"{conv}.weight")] + [
        (f"norm.{k}", f"norm.{k}") for k in _BN]


def _extractor_keys(arch: int, depth_wise: bool = True):
    """``(port key below the extractor, reference key below base.)`` of
    every HarDNet backbone tensor, in the reference's order."""
    entries, n_layers = _extractor_layout(arch, depth_wise)
    pairs = []
    block_i = 0
    for name, kind, idx in entries:
        if kind != "block":
            pairs += [(f"{name}.{p}", f"{idx}.{r}") for p, r in
                      _layer_keys(kind)]
            continue
        for t in range(n_layers[block_i]):
            port, ref = f"{name}.layer{t}", f"{idx}.layers.{t}"
            if depth_wise:   # CombConvLayer: a ConvLayer then a DWConvLayer
                pairs += [(f"{port}.layer1.{p}", f"{ref}.layer1.{r}")
                          for p, r in _layer_keys("convlayer")]
                pairs += [(f"{port}.layer2.{p}", f"{ref}.layer2.{r}")
                          for p, r in _layer_keys("dwconvlayer")]
            else:
                pairs += [(f"{port}.{p}", f"{ref}.{r}")
                          for p, r in _layer_keys("convlayer")]
        block_i += 1
    return pairs


_HEADS = [(f"rpn_head.{m}.{k}", f"rpn.{m}.{k}")
          for m in ("loc", "score") for k in ("weight", "bias")] + [
          (f"roi_head.{m}.{k}", f"head.{m}.{k}")
          for m in ("cls_loc", "score") for k in ("weight", "bias")]


def _take(sd: Mapping, key: str) -> torch.Tensor:
    if key not in sd:
        raise KeyError(f"torch state dict is missing '{key}' (have "
                       f"{len(sd)} keys; wrong arch or depth_wise?)")
    v = sd[key]
    t = v.detach() if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.asarray(v))
    return t.to("cpu", torch.float32)


def convert_extractor(sd: Mapping, arch: int = 39, depth_wise: bool = True,
                      prefix: str = "base") -> Dict[str, torch.Tensor]:
    """The HarDNet backbone of a reference dict: ``{key below the port's
    extractor: float32 tensor}`` (``stem0.conv.weight``, ...)."""
    return {port: _take(sd, f"{prefix}.{ref}")
            for port, ref in _extractor_keys(arch, depth_wise)}


def convert_state_dict(sd: Mapping, arch: int = 39, depth_wise: bool = True
                       ) -> Dict[str, torch.Tensor]:
    """A reference HarDNet state dict -> the port's ``FasterRCNN`` keys.

    Accepts a trainer's dict (``feat_extra.base...``, ``rpn...``,
    ``head...``) or a bare backbone dict (``base...``); the heads come
    along where the dict has them.  Returns ``{port key: float32 tensor}``,
    the parameters and the batch-norm statistics in one dict.
    """
    prefix = ("feat_extra.base" if any(k.startswith("feat_extra.") for k in sd)
              else "base")
    out = {f"extractor.{k}": v for k, v in
           convert_extractor(sd, arch, depth_wise, prefix).items()}
    for head in ("rpn.loc.weight", "head.cls_loc.weight"):
        if head in sd:
            top = head.split(".")[0]
            out.update({port: _take(sd, ref) for port, ref in _HEADS
                        if ref.startswith(top + ".")})
    return out


def _merge_check(model: torch.nn.Module, new: Mapping[str, torch.Tensor],
                 complete: str = "extractor.") -> Dict[str, torch.Tensor]:
    """``model``'s state dict with ``new`` laid over it, each value cast to
    the target's dtype.  Raises ``KeyError`` for a key the model does not
    have and for a parameter or statistic under ``complete`` that ``new``
    leaves unfilled, ``ValueError`` for a shape mismatch."""
    target = model.state_dict()
    out = dict(target)
    for k, v in new.items():
        if k not in target:
            raise KeyError(f"unexpected key {k!r}: the port's model has no "
                           "such parameter or statistic")
        if tuple(v.shape) != tuple(target[k].shape):
            raise ValueError(f"shape mismatch at {k!r}: torch "
                             f"{tuple(v.shape)} vs the port's "
                             f"{tuple(target[k].shape)}")
        out[k] = v.to(target[k].dtype)
    unfilled = [k for k in target if k.startswith(complete) and k not in new]
    if unfilled:
        raise KeyError(f"{len(unfilled)} port variables have no counterpart "
                       f"in the torch state dict: {unfilled[:8]}")
    return out


def _model_of(state) -> torch.nn.Module:
    """The model of a :class:`~..nets.trainer.TrainState`, or the module
    itself."""
    return state if isinstance(state, torch.nn.Module) else state.model


def _read(path_or_sd) -> Mapping:
    """A state dict from a ``.pth`` path (``model_state_dict`` when the file
    holds a trainer checkpoint) or as given."""
    if not isinstance(path_or_sd, (str, bytes, bytearray)) and not hasattr(
            path_or_sd, "__fspath__"):
        return path_or_sd
    raw = torch.load(path_or_sd, map_location="cpu", weights_only=True)
    return raw.get("model_state_dict", raw) if isinstance(raw, dict) else raw


def _load(state, new: Mapping[str, torch.Tensor]):
    model = _model_of(state)
    merged = _merge_check(model, new)
    with torch.no_grad():
        model.load_state_dict(merged)
    return state


def load_torch_checkpoint(path, state, arch: int = 39,
                          depth_wise: bool = True):
    """Load a reference HarDNet ``.pth`` (or a raw state dict file) into
    ``state`` (a ``TrainState`` or a ``FasterRCNN``), in place, on the
    device it lies on (the card by default).

    The reference's ``pre_train=True`` (``train/train.py:60-72``): weights
    and batch-norm statistics only; the optimiser is not touched, so a
    fresh state keeps a fresh one.  Returns ``state``.
    """
    return _load(state, convert_state_dict(_read(path), arch, depth_wise))


# ------------------------------------------------------------------ export
def export_state_dict(state, arch: int = 39, depth_wise: bool = True
                      ) -> Dict[str, torch.Tensor]:
    """The port's HarDNet ``FasterRCNN`` -> the reference's state dict.

    ``state``: a ``FasterRCNN`` or a ``TrainState`` in one process (a
    tensor-parallel state's split heads would come out as slices: gather
    them first, ``utils/checkpoint.py`` does).  The inverse of
    :func:`convert_state_dict` with trainer-level keys
    (``feat_extra.base...``, ``rpn...``, ``head...``), as the reference's
    ``load_state_dict`` expects; batch-norm ``num_batches_tracked`` counters
    are not emitted (load with ``strict=False``).  Values are float32 CPU
    tensors, ready for ``torch.save``.
    """
    sd = _model_of(state).state_dict()
    out = {f"feat_extra.base.{ref}": sd[f"extractor.{port}"]
           for port, ref in _extractor_keys(arch, depth_wise)}
    for port, ref in _HEADS:
        if port in sd:
            out[ref] = sd[port]
    return {k: v.detach().to("cpu", torch.float32).clone()
            for k, v in out.items()}


# ------------------------------------------------------- resnet backbones
def _prelu(sd: Mapping, key: str) -> torch.Tensor:
    """A block's PReLU slope: the reference's resnets carry one
    (``models/resnet.py:11,54``); torchvision's use plain ReLU, which is
    PReLU with slope 0, so an absent slope imports as 0 (and still
    trains)."""
    return _take(sd, key).reshape(1) if key in sd else torch.zeros(1)


def convert_resnet_state_dict(sd: Mapping, block: str = "bottleneck",
                              blocks_num=(3, 4, 6)
                              ) -> Dict[str, torch.Tensor]:
    """A torch ResNet / ResNeXt state dict -> ``{key below the port's
    extractor: float32 tensor}``.

    Accepts the reference's ``models/resnet.py`` checkpoints (a PReLU slope
    a block) and torchvision's ImageNet ones (the same keys without the
    slopes, imported as 0).  Classifier keys (``fc.*``) and stages beyond
    ``blocks_num`` are ignored: the stride-16 trunk takes ``(3, 4, 6)``;
    the FPN flagship's pyramid trunk needs ``layer4`` and takes
    ``blocks_num=(3, 4, 6, 3)``.
    """
    out = {"conv1.weight": _take(sd, "conv1.weight"),
           "relu.weight": _prelu(sd, "relu.weight")}
    out.update({f"bn1.{k}": _take(sd, f"bn1.{k}") for k in _BN})
    n_convs = 2 if block == "basic" else 3
    for li, n in enumerate(blocks_num):
        for bi in range(n):
            ref, port = f"layer{li + 1}.{bi}", f"layer{li + 1}_{bi}"
            for ci in range(1, n_convs + 1):
                out[f"{port}.conv{ci}.weight"] = _take(
                    sd, f"{ref}.conv{ci}.weight")
                out.update({f"{port}.bn{ci}.{k}": _take(sd, f"{ref}.bn{ci}.{k}")
                            for k in _BN})
            if f"{ref}.downsample.0.weight" in sd:
                out[f"{port}.ds_conv.weight"] = _take(
                    sd, f"{ref}.downsample.0.weight")
                out.update({f"{port}.ds_norm.{k}": _take(
                    sd, f"{ref}.downsample.1.{k}") for k in _BN})
            out[f"{port}.relu.weight"] = _prelu(sd, f"{ref}.relu.weight")
    return out


def load_resnet_backbone(path_or_sd, state, block: str = "bottleneck",
                         blocks_num=(3, 4, 6)):
    """Initialise the ResNet trunk of ``state`` (a ``TrainState`` or a
    ``FasterRCNN``) from a torch checkpoint, in place.

    ``path_or_sd``: a ``.pth`` path or a state dict, e.g. torchvision's
    ``resnet50(weights=...).state_dict()`` for ImageNet pretraining.  Only
    the trunk is touched; the neck and heads keep their values.  Every
    trunk parameter and statistic must come from the dict: the FPN
    flagship passes ``blocks_num=(3, 4, 6, 3)`` for its ``layer4``.
    Returns ``state``.
    """
    new = convert_resnet_state_dict(_read(path_or_sd), block, blocks_num)
    return _load(state, {f"extractor.{k}": v for k, v in new.items()})

