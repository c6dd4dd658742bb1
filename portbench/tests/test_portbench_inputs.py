"""The episode and weight generators: the same seed gives the same
inputs, seeds differ, and the label layout is the episodic one."""

import json
import os

import numpy as np
import torch

from conftest import ROOT, tiny_cell
from portbench import harness, inputs

T = {"way": 5, "shot": 2, "queries": 3, "seq_len": 4, "frame_px": 40,
     "pool": 3}


def test_same_seed_same_episodes():
    a = inputs.make_episodes(T, 10, 2 ** 31 + 77, "cpu")
    b = inputs.make_episodes(T, 10, 2 ** 31 + 77, "cpu")
    c = inputs.make_episodes(T, 10, 2 ** 31 + 78, "cpu")
    for x, y in zip(a, b):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    assert not np.array_equal(a[0]["support_images"], c[0]["support_images"])


def test_label_layout():
    for ep in inputs.make_episodes(T, 10, 5, "cpu"):
        assert ep["support_images"].shape == (10, 4, 40, 40, 3)
        assert ep["target_images"].shape == (15, 4, 40, 40, 3)
        assert ep["support_images"].dtype == np.uint8
        assert len(set(ep["batch_class_list"].tolist())) == 5
        assert sorted(np.bincount(ep["support_labels"]).tolist()) == [2] * 5
        assert sorted(np.bincount(ep["target_labels"]).tolist()) == [3] * 5
        classes = ep["batch_class_list"]
        np.testing.assert_array_equal(classes[ep["support_labels"]],
                                      ep["real_support_labels"])
        np.testing.assert_array_equal(classes[ep["target_labels"]],
                                      ep["real_target_labels"])
        assert ep["real_target_labels"].max() < 10


def test_classes_look_different():
    ep = inputs.make_episodes(T, 10, 9, "cpu")[0]
    by = {}
    for v, c in zip(ep["support_images"], ep["support_labels"]):
        by.setdefault(int(c), []).append(v.astype(np.float64).mean(axis=(0, 1, 2)))
    means = np.array([np.mean(by[c], axis=0) for c in sorted(by)])
    assert np.ptp(means, axis=0).max() > 10


def test_weights_from_the_seed():
    conf = tiny_cell("rn50-eval", "test-tiny-rn").config
    a = inputs.make_weights(conf, 3, "cpu")
    b = inputs.make_weights(conf, 3, "cpu")
    c = inputs.make_weights(conf, 4, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["visual.conv1.weight"], c["visual.conv1.weight"])
    assert torch.equal(a["visual.bn1.running_var"], torch.ones(4))
    w = a["visual.layer1.0.conv2.weight"]
    assert abs(float(w.std()) * (8 * 9) ** 0.5 - 1) < 0.2


def test_seeds_beyond_32_bits():
    assert inputs.seed_of(2 ** 40 + 3, "x") != inputs.seed_of(3, "x")
    assert 0 <= inputs.seed_of(2 ** 31 + 1, "frames") < 2 ** 63


def test_traffic_files_name_their_entry():
    for name in ("eval-uncached-e32", "train-tpb16"):
        with open(os.path.join(ROOT, "portbench", "traffic",
                               f"{name}.json")) as f:
            t = json.load(f)
        ent = harness.entry(t["entry"])
        for attr in ("RATE", "SPLIT", "FAULTS", "layout", "setup", "window",
                     "segment", "rate", "diagnostics", "check", "control"):
            assert hasattr(ent, attr), (t["entry"], attr)
