"""The port's training data against the JAX package's, byte for byte:
``utils/synthetic.py::cluttered_scene``, the dataset writers of
``training/synth_data.py`` (and ``tools/make_dataset_torch.py``) against
``tools/download_dataset.py``'s, and ``training/data.py::YoloDataset``
batches with every augmentation on, the decode cache on and off, and
through the prefetch thread.
"""

from __future__ import annotations

import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rtmodt_tpu.training.data import AugConfig as JaxAugConfig
from rtmodt_tpu.training.data import YoloDataset as JaxYoloDataset
from rtmodt_tpu.utils.synthetic import cluttered_scene as jax_cluttered_scene
from rtmodt_tpu_torch.training import synth_data
from rtmodt_tpu_torch.training.data import AugConfig, YoloDataset
from rtmodt_tpu_torch.utils.synthetic import cluttered_scene
from tests.test_torch_port_threads import child_env, torch_threads  # noqa: F401 (autouse)
from tools import download_dataset as ref_tool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUG_ALL = dict(mosaic=1.0, mixup=0.5, copy_paste=0.5, fliplr=0.5, flipud=0.5, hsv_h=0.015,
               hsv_s=0.7, hsv_v=0.4, degrees=5.0, scale=0.5, shear=2.0, translate=0.1)


def same_tree(a: str, b: str, root_a: str, root_b: str) -> int:
    """Assert two written datasets hold the same files with the same bytes
    (``dataset.yaml`` names its own root); returns the files compared."""
    files_a = sorted(os.path.relpath(os.path.join(d, f), a)
                     for d, _, fs in os.walk(a) for f in fs)
    files_b = sorted(os.path.relpath(os.path.join(d, f), b)
                     for d, _, fs in os.walk(b) for f in fs)
    assert files_a == files_b and files_a
    for rel in files_a:
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel == "dataset.yaml":
            with open(pa) as fa, open(pb) as fb:
                assert fa.read().replace(root_a, "ROOT") == fb.read().replace(root_b, "ROOT")
        else:
            assert filecmp.cmp(pa, pb, shallow=False), rel
    return len(files_a)


@pytest.mark.parametrize("idx,seed,hw", [(0, 0, (512, 512)), (7, 3, (320, 480)),
                                         (123, 11, (256, 256))])
def test_cluttered_scene_bit_equal(idx, seed, hw):
    got = cluttered_scene(idx, *hw, seed=seed)
    want = jax_cluttered_scene(idx, *hw, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_make_synthetic_rich_with_dense_frames(tmp_path):
    a, b = str(tmp_path / "port"), str(tmp_path / "ref")
    synth_data.make_synthetic_rich(a, 5, 3, 192, 256, 8, seed=1, dense_frac=0.2)
    ref_tool.make_synthetic_rich(b, 5, 3, 192, 256, 8, seed=1, dense_frac=0.2)
    assert same_tree(a, b, os.path.abspath(a), os.path.abspath(b)) == 1 + 8 + 8 + 1


def test_make_synthetic_and_dense_mot(tmp_path):
    a, b = str(tmp_path / "port"), str(tmp_path / "ref")
    synth_data.make_synthetic(a, 4, 3, 160, 224, 3, seed=2)
    ref_tool.make_synthetic(b, 4, 3, 160, 224, 3, seed=2)
    same_tree(a, b, os.path.abspath(a), os.path.abspath(b))
    a, b = str(tmp_path / "port_mot"), str(tmp_path / "ref_mot")
    synth_data.make_dense_mot(a, 4, 180, 320, 12, seed=4)
    ref_tool.make_dense_mot(b, 4, 180, 320, 12, seed=4)
    same_tree(a, b, a, b)


def test_make_dataset_cli(tmp_path):
    """``tools/make_dataset_torch.py`` writes the reference's set under the
    reference's directory name."""
    proc = subprocess.run([sys.executable, "tools/make_dataset_torch.py", "--root",
                           str(tmp_path / "p"), "--classes", "4", "--n-train", "3",
                           "--n-val", "2", "--height", "128", "--width", "160"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env=child_env())
    assert proc.returncode == 0, proc.stderr
    ref_tool.make_synthetic_rich(str(tmp_path / "r" / "synthetic_rich"), 3, 2, 128, 160, 4, 0)
    a, b = str(tmp_path / "p" / "synthetic_rich"), str(tmp_path / "r" / "synthetic_rich")
    same_tree(a, b, os.path.abspath(a), os.path.abspath(b))


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ds") / "rich")
    synth_data.make_synthetic_rich(root, 6, 2, 160, 224, 8, seed=0)
    return root


def _batches_equal(got, want):
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("cache", [True, False])
@pytest.mark.parametrize("aug", ["all", "no_mosaic"])
def test_make_batch_bit_equal(dataset_root, cache, aug):
    kw = dict(AUG_ALL, mosaic=0.0) if aug == "no_mosaic" else AUG_ALL
    port = YoloDataset(dataset_root, "train", 96, 16, augment=True, aug=AugConfig(**kw),
                       seed=5, cache_images=cache)
    ref = JaxYoloDataset(dataset_root, "train", 96, 16, augment=True, aug=JaxAugConfig(**kw),
                         seed=5, cache_images=cache)
    for _ in range(3):
        got, want = port.make_batch(3), ref.make_batch(3)
        assert got.images.dtype == torch.uint8
        _batches_equal(got, want)
    assert int(got.gt_mask.sum()) > 0


def test_prefetched_batches_bit_equal(dataset_root):
    port = YoloDataset(dataset_root, "train", 96, 16, aug=AugConfig(**AUG_ALL), seed=9)
    ref = JaxYoloDataset(dataset_root, "train", 96, 16, aug=JaxAugConfig(**AUG_ALL), seed=9)
    gp, gr = port.batches(2), ref.batches(2)
    try:
        for _ in range(3):
            _batches_equal(next(gp), next(gr))
    finally:
        gp.close()
        gr.close()
