"""The port's training data pipeline (its copies of the JAX package's
editimage dataset, MaskCreator, transforms and image listing, the compact
collate and the serial loader) gives arrays identical to the JAX package's
from the same seed."""

import argparse

import numpy as np
import pytest
from PIL import Image

from sketchedit_tpu import data as j_data
from sketchedit_tpu.data import editimage as j_edit
from sketchedit_tpu.data import image_folder as j_folder
from sketchedit_tpu.data import mask_creator as j_mc
from sketchedit_tpu_torch import data as t_data
from sketchedit_tpu_torch.data import editimage as t_edit
from sketchedit_tpu_torch.data import image_folder as t_folder
from sketchedit_tpu_torch.data import mask_creator as t_mc


@pytest.fixture
def images(tmp_path):
    d = tmp_path / "imgs"
    (d / "sub").mkdir(parents=True)
    rs = np.random.RandomState(0)
    for i, (h, w) in enumerate(((40, 48), (48, 40), (36, 36), (50, 44))):
        arr = (rs.rand(h, w, 3) * 255).astype(np.uint8)
        arr[h // 4:h // 2, :] = 255            # edges for Canny to find
        Image.fromarray(arr).save(d / ("sub" if i == 3 else "") / f"{i}.png")
    return d


@pytest.fixture
def shapes(tmp_path):
    """Two object silhouettes and their list file, for object_mask."""
    d = tmp_path / "shapes"
    d.mkdir()
    for i in range(2):
        m = np.zeros((30, 20 + 10 * i), np.uint8)
        m[5:25, 4:16 + 5 * i] = 255
        Image.fromarray(m).save(d / f"s{i}.png")
    lst = tmp_path / "shapes.txt"
    lst.write_text("s0.png\ns1.png\n")
    return str(lst), str(d)


def _opt(images, mode, **kw):
    base = dict(train_image_dir=str(images), train_image_list=None,
                preprocess_mode=mode, load_size=40, crop_size=32,
                aspect_ratio=1.0, isTrain=True, no_flip=False, canny_low=100,
                canny_high=200, decode_cache_mb=1, not_om=False, cjit=None,
                path_objectshape_list=None, path_objectshape_base=None,
                max_dataset_size=None, batchSize=2, serial_batches=False,
                dataset_mode="editimage")
    base.update(kw)
    return argparse.Namespace(**base)


def _assert_items_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("mode,kw", [
    ("resize_and_crop", {}),
    ("scale_width_and_crop", {"cjit": 0.3}),
    ("scale_shortside_and_crop", {"not_om": True}),
])
def test_editimage_items_identical(images, shapes, mode, kw):
    opt = _opt(images, mode, path_objectshape_list=shapes[0],
               path_objectshape_base=shapes[1], **kw)
    j_ds, t_ds = j_edit.EditImageDataset(), t_edit.EditImageDataset()
    j_ds.initialize(opt, seed=3)
    t_ds.initialize(opt, seed=3)
    assert len(t_ds) == len(j_ds) == 4
    for _ in range(2):                      # the second pass hits the cache
        for i in range(len(j_ds)):
            _assert_items_equal(t_ds[i], j_ds[i])
    j_ds.reseed((0, 1, 2))
    t_ds.reseed((0, 1, 2))
    _assert_items_equal(t_ds[1], j_ds[1])


def test_mask_creator_identical(shapes):
    j = j_mc.MaskCreator(*shapes, rng=np.random.default_rng(9))
    t = t_mc.MaskCreator(*shapes, rng=np.random.default_rng(9))
    for _ in range(3):
        np.testing.assert_array_equal(t.stroke_mask(48, 40, max_length=20),
                                      j.stroke_mask(48, 40, max_length=20))
        np.testing.assert_array_equal(t.rectangle_mask(48, 40, 8, 16),
                                      j.rectangle_mask(48, 40, 8, 16))
        np.testing.assert_array_equal(t.object_mask(48, 40),
                                      j.object_mask(48, 40))
        np.testing.assert_array_equal(t_mc.external_mask(t, 32, 32),
                                      j_mc.external_mask(j, 32, 32))
    for a, b in zip(t.object_shadow(32, 32), j.object_shadow(32, 32)):
        np.testing.assert_array_equal(a, b)
    m = np.zeros((12, 12))
    m[3:8, 4:9] = 1
    np.testing.assert_array_equal(t_mc.spatial_discount(m),
                                  j_mc.spatial_discount(m))


def test_make_dataset_identical(images):
    assert (t_folder.make_dataset(str(images))
            == j_folder.make_dataset(str(images)))
    assert len(t_folder.make_dataset(str(images), max_dataset_size=2)) == 2


@pytest.mark.parametrize("compact", [True, False])
def test_collate_identical(images, compact):
    opt = _opt(images, "resize_and_crop")
    ds = t_edit.EditImageDataset()
    ds.initialize(opt)
    samples = [ds[i] for i in range(3)]
    want = j_data._collate(samples, 4, compact=compact)
    got = t_data.collate(samples, 4, compact=compact)
    _assert_items_equal(got, want)
    assert got["valid"] == 3
    assert (got["image"].dtype == np.uint8) == compact
    assert ("gt" in got) == (not compact)


def test_loader_batches_identical_over_epochs(images):
    opt = _opt(images, "resize_and_crop")
    j_ds, t_ds = j_edit.EditImageDataset(), t_edit.EditImageDataset()
    j_ds.initialize(opt)
    t_ds.initialize(opt)
    j_loader = j_data.DataLoader(j_ds, 2, shuffle=True, num_workers=0,
                                 drop_last=True, seed=4, compact=True)
    t_loader = t_data.DataLoader(t_ds, 2, shuffle=True, drop_last=True,
                                 seed=4, compact=True)
    assert len(t_loader) == len(j_loader) == 2
    for _ in range(2):
        got, want = list(t_loader), list(j_loader)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            _assert_items_equal(g, w)


def test_create_dataloader_train_and_test_modes(images):
    opt = _opt(images, "resize_and_crop")
    loader = t_data.create_dataloader(opt)
    assert loader.compact and loader.drop_last and loader.shuffle
    batch = next(iter(loader))
    assert batch["image"].dtype == np.uint8 and batch["mask"].dtype == bool
    with pytest.raises(ValueError, match="unknown dataset_mode"):
        t_data.find_dataset_using_name("nosuch")
