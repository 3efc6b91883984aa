"""PyTorch port, the host data pipeline against the JAX package's: for the
same files, seed and epoch, ``load_coco`` (with ``ratio``),
``DetectionDataset.get`` in every mode, ``epoch_order`` and the ``Loader``'s
batches (thread and process workers) are equal bit for bit, and
``generate_synthetic_coco`` writes the same bytes.

The data are the committed real JPEGs (``tests/data/real_coco``) and a
synthetic PNG root, at small input sizes.  Both packages decode and resize
through ``native/preprocess.cpp`` (each through its own build of it) or, where
either cannot load it, through the same PIL calls
(``tests/torch_native.py:same_native_path``).
"""

import filecmp
import os

import numpy as np
import pytest
import torch

from tests.torch_native import same_native_path
from two_stage_object_detection_tpu.data import coco as j_coco
from two_stage_object_detection_tpu.data import native as j_native
from two_stage_object_detection_tpu.data import pipeline as j_pipeline
from two_stage_object_detection_tpu.data import synthetic as j_synthetic
from two_stage_object_detection_tpu_torch.data import (
    coco, native, pipeline, synthetic)

REAL = os.path.join(os.path.dirname(__file__), "data", "real_coco")
REAL_ANN = os.path.join(REAL, "annotations", "instances_train2017.json")
REAL_IMG = os.path.join(REAL, "train2017")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """The same synthetic root written by both packages: ``(port, jax)``,
    each ``(annotation path, image dir)``."""
    out = []
    for gen in (synthetic.generate_synthetic_coco,
                j_synthetic.generate_synthetic_coco):
        root = str(tmp_path_factory.mktemp("synth"))
        out.append(gen(root, num_images=6, num_classes=3,
                       image_size=(48, 64), seed=5))
    return out


def _same(a, b, where=""):
    """Bitwise equality of nested dicts / lists / arrays / scalars."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), where
        for k in a:
            _same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, torch.Tensor):
        _same(a.numpy(), b, where)
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b), where
    else:
        assert a == b, where


@pytest.mark.parametrize("fmt", ["png", "jpg"])
def test_generate_synthetic_coco_writes_the_same_files(tmp_path, fmt):
    roots = [str(tmp_path / "port"), str(tmp_path / "jax")]
    for gen, root in zip((synthetic.generate_synthetic_coco,
                          j_synthetic.generate_synthetic_coco), roots):
        ann, img_dir = gen(root, split="val2017", num_images=4,
                           num_classes=3, image_size=(40, 56), seed=2,
                           fmt=fmt)
    files = sorted(os.listdir(os.path.join(roots[1], "val2017")))
    assert len(files) == 4
    assert sorted(os.listdir(os.path.join(roots[0], "val2017"))) == files
    for rel in ["annotations/instances_val2017.json"] + [
            f"val2017/{f}" for f in files]:
        assert filecmp.cmp(os.path.join(roots[0], rel),
                           os.path.join(roots[1], rel), shallow=False), rel


@pytest.mark.parametrize("ratio,seed", [(1.0, 0), (0.5, 3), (0.5, None),
                                        (0.34, 7)])
def test_load_coco_matches_jax(synth, ratio, seed):
    (ann, img_dir), _ = synth
    for path, images in ((ann, img_dir), (REAL_ANN, REAL_IMG)):
        got = coco.load_coco(path, images, ratio=ratio, seed=seed)
        want = j_coco.load_coco(path, images, ratio=ratio, seed=seed)
        assert len(got) == len(want) > 0 and got.num_classes == want.num_classes
        _same(got.records, want.records)
        for name in ("class_index_to_name", "class_index_to_category_id",
                     "category_id_to_class_index"):
            assert getattr(got, name) == getattr(want, name)


MODES = {
    "train": dict(train=True),
    "train_u8": dict(train=True, uint8_images=True),
    "train_cache": dict(train=True, cache=True),
    "eval": dict(train=False),
    "decode_only": dict(train=False, decode_only=True),
    "decode_only_u8_cache": dict(train=False, decode_only=True,
                                 uint8_images=True, cache=True),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_dataset_get_matches_jax(synth, mode, monkeypatch):
    """Every sample of both roots, epochs 0 and 1 (a cached dataset answers
    the second epoch from its cache), at a 64x80 input; both packages
    decode through their native library, or both through PIL where one of
    them cannot load it (:func:`same_native_path`)."""
    same_native_path(monkeypatch)
    (ann, img_dir), _ = synth
    for path, images, size in ((ann, img_dir, (64, 80)),
                               (REAL_ANN, REAL_IMG, (96, 80))):
        kw = dict(input_size=size, max_gt=5, seed=4, **MODES[mode])
        got = pipeline.DetectionDataset(coco.load_coco(path, images), **kw)
        want = j_pipeline.DetectionDataset(j_coco.load_coco(path, images),
                                           **kw)
        for epoch in (0, 1):
            for i in range(len(want)):
                _same(got.get(i, epoch), want.get(i, epoch),
                      f"{mode} sample {i} epoch {epoch}")
        assert (got._cache is None) == (want._cache is None)


@pytest.mark.parametrize("args", [
    (10, 0, 0, True), (10, 3, 5, True), (10, 3, 5, False), (7, 1, 3, True, 2, 1),
    (2, 0, 3, False, 4, 3), (3, 2, 1, True, 1, 0, 8)])
def test_epoch_order_matches_jax(args):
    _same(pipeline.epoch_order(*args), j_pipeline.epoch_order(*args))


@pytest.mark.parametrize("worker_mode", ["thread", "process"])
def test_loader_batches_match_jax(synth, worker_mode, monkeypatch):
    """Two shuffled epochs of augmented batches, the loader's epoch clock
    advancing as each epoch is drained; both packages on the same decode
    path (:func:`same_native_path`)."""
    same_native_path(monkeypatch)
    (ann, img_dir), _ = synth
    kw = dict(input_size=(48, 48), max_gt=5, train=True, seed=1)
    ds = pipeline.DetectionDataset(coco.load_coco(ann, img_dir), **kw)
    jds = j_pipeline.DetectionDataset(j_coco.load_coco(ann, img_dir), **kw)
    lkw = dict(batch_size=2, shuffle=True, num_workers=2, seed=9,
               worker_mode=worker_mode)
    got_loader = pipeline.Loader(ds, **lkw)
    want_loader = j_pipeline.Loader(jds, **lkw)
    try:
        assert len(got_loader) == len(want_loader) == 3
        for epoch in range(2):
            got, want = list(got_loader), list(want_loader)
            assert len(got) == 3 and got_loader.epoch == epoch + 1
            _same(got, want, f"epoch {epoch}")
    finally:
        got_loader.close()
        want_loader.close()


def test_loader_device_put_gives_the_same_tensors(synth):
    """``DevicePut`` on the CPU: the host batches as tensors, unchanged;
    and a producer-side error reaches the consumer."""
    (ann, img_dir), _ = synth
    ds = pipeline.DetectionDataset(coco.load_coco(ann, img_dir),
                                   input_size=(32, 32), max_gt=5, train=False)
    plain = list(pipeline.Loader(ds, 3, shuffle=False, num_workers=1))
    put = pipeline.DevicePut("cpu")
    placed = list(pipeline.Loader(ds, 3, shuffle=False, num_workers=1,
                                  device_put=put))
    assert all(isinstance(v, torch.Tensor) for b in placed for v in b.values())
    _same(placed, plain)
    ds.index.records[4]["image_path"] += ".missing"
    with pytest.raises(FileNotFoundError):
        list(pipeline.Loader(ds, 3, shuffle=False, num_workers=1,
                             persistent_workers=False))


@pytest.mark.parametrize("size", [(64, 80), (300, 200)])
def test_resize_normalize_matches_jax(size, monkeypatch):
    """``resize_normalize`` of a u8 image, down and up, within 1e-6 of the
    JAX package's when both native libraries load
    (:func:`same_native_path`); where one does not, both answer None."""
    both = same_native_path(monkeypatch)
    img = (np.random.RandomState(7).rand(97, 131, 3) * 255).astype(np.uint8)
    got = native.resize_normalize(img, size)
    want = j_native.resize_normalize(img, size)
    if not both:
        assert got is None and want is None
        return
    assert got.dtype == np.float32 and got.shape == (*size, 3)
    assert 0.0 <= got.min() and got.max() <= 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
