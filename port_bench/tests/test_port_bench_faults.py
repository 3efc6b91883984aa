"""A run with the timed path broken underneath comes out not correct, and
the control reads above a sound run.

Each test drives a whole run of a cell on the CPU at the tiny sizes of
``bench_tiny`` (the harness's look for a card skipped), with the cell's own
limits, and breaks the program where it produces its answer: a served
answer altered, half of a batch left out (served: every other image of a
bucket gets no detection; trained: the loss the mean over the first
half), a training step that leaves the state unchanged.  One card, so no
exchange between chips to leave out.
"""

import pytest
import torch

from bench_tiny import ROOT, SECONDS, TINY, TRAFFIC, tiny_run
from port_bench import control
from two_stage_object_detection_tpu_torch.nets import detector, trainer

SERVE = ("hardnet39.serve.u8_bulk64",)
TRAIN = ("fpn_r50.train.resident16",)


@pytest.fixture
def root():
    return ROOT


def _run(name, root):
    run, driver = tiny_run(name, root=root)
    return driver.drive(run)


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_sound_run_is_correct(name, root):
    assert _run(name, root)["correct"]


@pytest.mark.parametrize("name", SERVE)
def test_altered_answer_is_not_correct(name, root, monkeypatch):
    real = detector.FasterRCNN.detect

    def wrong_label(self, *a, **k):
        boxes, scores, labels, valid = real(self, *a, **k)
        return boxes, scores, labels % self.cfg.num_classes + 1, valid

    monkeypatch.setattr(detector.FasterRCNN, "detect", wrong_label)
    assert not _run(name, root)["correct"]


@pytest.mark.parametrize("name", SERVE)
def test_half_the_served_batch_left_out_is_not_correct(name, root,
                                                       monkeypatch):
    real = detector.FasterRCNN.predict

    def half(self, images, *a, **k):
        boxes, scores, labels, valid = real(self, images, *a, **k)
        dropped = torch.arange(images.shape[0], device=images.device) % 2 == 1
        return (boxes, scores, labels, valid & ~dropped[:, None])

    monkeypatch.setattr(detector.FasterRCNN, "predict", half)
    assert not _run(name, root)["correct"]


@pytest.mark.parametrize("name", TRAIN)
def test_step_that_leaves_the_state_unchanged_is_not_correct(name, root,
                                                             monkeypatch):
    real = trainer.make_optimizer

    def frozen(*a, **k):
        opt, lr = real(*a, **k)
        opt.step = lambda *_a, **_k: None
        return opt, lr

    monkeypatch.setattr(trainer, "make_optimizer", frozen)
    assert not _run(name, root)["correct"]


@pytest.mark.parametrize("name", TRAIN)
def test_half_the_batch_left_out_of_the_step_is_not_correct(name, root,
                                                           monkeypatch):
    real = detector.FasterRCNN.train_forward

    def half(self, images, boxes, labels, valid, *a, **k):
        h = images.shape[0] // 2
        return real(self, images[:h], boxes[:h], labels[:h], valid[:h],
                    *a, **k)

    monkeypatch.setattr(detector.FasterRCNN, "train_forward", half)
    assert not _run(name, root)["correct"]


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_control_reads_above_a_sound_run(name, root):
    run, driver = tiny_run(name, root=root)
    sound = driver.drive(run)["checks"]
    kind = run.traffic["driver"]
    ctl = control.run_control(root, name, [5], SECONDS[kind], "cpu",
                              overrides=TINY, traffic=TRAFFIC[kind])[5]["fp8"]
    assert any(ctl[k] > 3 * sound[k]["value"] and ctl[k] > 0 for k in sound)
