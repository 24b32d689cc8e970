"""Recursive image-file discovery with an optional files.list cache
(reference data/image_folder.py:21-59); a copy of
``sketchedit_tpu/data/image_folder.py``."""

from __future__ import annotations

import os

IMG_EXTENSIONS = (
    '.jpg', '.JPG', '.jpeg', '.JPEG', '.png', '.PNG', '.ppm', '.PPM',
    '.bmp', '.BMP', '.tiff', '.webp',
)


def is_image_file(filename: str) -> bool:
    return filename.endswith(IMG_EXTENSIONS)


def make_dataset(directory, recursive: bool = True, read_cache: bool = False,
                 write_cache: bool = False, max_dataset_size: int | None = None):
    images = []

    cache = os.path.join(directory, 'files.list')
    if read_cache and os.path.isfile(cache):
        with open(cache) as f:
            images = [line.strip() for line in f if line.strip()]
        return images[:max_dataset_size]

    assert os.path.isdir(directory), f'{directory} is not a valid directory'
    for root, _dirs, fnames in sorted(os.walk(directory)):
        for fname in sorted(fnames):
            if is_image_file(fname):
                images.append(os.path.join(root, fname))
        if not recursive:
            break

    if write_cache:
        with open(cache, 'w') as f:
            f.write('\n'.join(images))
    return images[:max_dataset_size]


class ImageFolder:
    """Generic image-directory dataset (reference image_folder.py:66-93):
    recursive listing + per-item PIL load, optional transform."""

    def __init__(self, root, transform=None, return_paths=False):
        imgs = make_dataset(root)
        if not imgs:
            raise RuntimeError(
                f"Found 0 images in: {root}\n"
                f"Supported extensions: {','.join(IMG_EXTENSIONS)}")
        self.root = root
        self.imgs = imgs
        self.transform = transform
        self.return_paths = return_paths

    def __getitem__(self, index):
        from PIL import Image
        path = self.imgs[index]
        img = Image.open(path).convert('RGB')
        if self.transform is not None:
            img = self.transform(img)
        if self.return_paths:
            return img, path
        return img

    def __len__(self):
        return len(self.imgs)
