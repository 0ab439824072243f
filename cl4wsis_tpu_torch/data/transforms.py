"""Paired (image, label) augmentation in numpy and Pillow (a copy of
``cl4wsis_tpu/data/transforms.py``).

Re-design of reference ``dataset/transform.py`` (the subset the main path
uses, ``dataset/__init__.py:13-27``): RandomResizedCrop(crop, scale=(0.5,2))
+ RandomHorizontalFlip + Normalize for training; Resize(short side) for
eval. Labels ride as a (H, W, K) uint8 stack (seg + instance ids) and are
resampled with NEAREST. Output is HWC float32 numpy; the trainer moves it
to the card. Every transform draws from the `np.random.RandomState` it is
given, in the JAX package's order, and resamples with Pillow (BILINEAR,
NEAREST, BICUBIC, ``rotate``) as the JAX package does, so one seed gives
the same pixels in both packages.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from PIL import Image

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _to_pil(img: np.ndarray) -> Image.Image:
    return Image.fromarray(img)


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, img, lbl, rng: np.random.RandomState):
        for t in self.transforms:
            img, lbl = t(img, lbl, rng)
        return img, lbl


class RandomResizedCrop:
    """torchvision-style: random area scale + aspect, 10 tries then center
    fallback (reference ``dataset/transform.py`` RandomResizedCrop)."""

    def __init__(self, size: int, scale: Tuple[float, float] = (0.5, 2.0),
                 ratio: Tuple[float, float] = (3 / 4, 4 / 3)):
        self.size = size
        self.scale = scale
        self.ratio = ratio

    def __call__(self, img: Image.Image, lbl: Image.Image, rng):
        w, h = img.size
        area = h * w
        for _ in range(10):
            target_area = rng.uniform(*self.scale) * area
            log_ratio = np.log(self.ratio)
            aspect = np.exp(rng.uniform(log_ratio[0], log_ratio[1]))
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                i = rng.randint(0, h - ch + 1)
                j = rng.randint(0, w - cw + 1)
                break
        else:
            cw = min(w, h)
            ch = cw
            i = (h - ch) // 2
            j = (w - cw) // 2
        img = img.crop((j, i, j + cw, i + ch)).resize(
            (self.size, self.size), Image.BILINEAR)
        lbl = lbl.crop((j, i, j + cw, i + ch)).resize(
            (self.size, self.size), Image.NEAREST)
        return img, lbl


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, img, lbl, rng):
        if rng.rand() < self.p:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
            lbl = lbl.transpose(Image.FLIP_LEFT_RIGHT)
        return img, lbl


class Resize:
    """Resize short side to `size` keeping aspect (torchvision semantics)."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, img, lbl, rng):
        w, h = img.size
        if w < h:
            ow, oh = self.size, int(self.size * h / w)
        else:
            ow, oh = int(self.size * w / h), self.size
        return (img.resize((ow, oh), Image.BILINEAR),
                lbl.resize((ow, oh), Image.NEAREST))


class ResizeExact:
    def __init__(self, size: Tuple[int, int]):
        self.size = size  # (h, w)

    def __call__(self, img, lbl, rng):
        h, w = self.size
        return (img.resize((w, h), Image.BILINEAR),
                lbl.resize((w, h), Image.NEAREST))


def normalize_image(img: Image.Image) -> np.ndarray:
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def train_transform(crop_size: int) -> Compose:
    return Compose([RandomResizedCrop(crop_size, (0.5, 2.0)),
                    RandomHorizontalFlip()])


def val_transform(crop_size_val: Optional[int]) -> Compose:
    return Compose([Resize(crop_size_val)] if crop_size_val else [])


class RandomVerticalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, img, lbl, rng):
        if rng.rand() < self.p:
            img = img.transpose(Image.FLIP_TOP_BOTTOM)
            lbl = lbl.transpose(Image.FLIP_TOP_BOTTOM)
        return img, lbl


class RandomScale:
    """Scale by a random factor in [lo, hi] (reference transform.py)."""

    def __init__(self, scale_range: Tuple[float, float] = (0.5, 2.0)):
        self.scale_range = scale_range

    def __call__(self, img, lbl, rng):
        s = rng.uniform(*self.scale_range)
        w, h = img.size
        size = (max(1, int(w * s)), max(1, int(h * s)))
        return (img.resize(size, Image.BILINEAR),
                lbl.resize(size, Image.NEAREST))


class CenterCrop:
    def __init__(self, size: int):
        self.size = size

    def __call__(self, img, lbl, rng):
        w, h = img.size
        j = max(0, (w - self.size) // 2)
        i = max(0, (h - self.size) // 2)
        box = (j, i, j + min(self.size, w), i + min(self.size, h))
        return img.crop(box), lbl.crop(box)


class PadCenterCrop:
    """Pad (image with 0, label with `fill`) to at least `size`, then center
    crop — the reference's PadCrop behavior for small images."""

    def __init__(self, size: int, fill: int = 255):
        self.size = size
        self.fill = fill

    def __call__(self, img, lbl, rng):
        w, h = img.size
        pw, ph = max(0, self.size - w), max(0, self.size - h)
        if pw or ph:
            ia = np.asarray(img)
            la = np.asarray(lbl)
            pad_img = ((ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2))
            ia = np.pad(ia, pad_img + ((0, 0),) if ia.ndim == 3 else pad_img)
            if la.ndim == 3:
                la = np.pad(la, pad_img + ((0, 0),), constant_values=self.fill)
            else:
                la = np.pad(la, pad_img, constant_values=self.fill)
            img, lbl = Image.fromarray(ia), Image.fromarray(la)
        return CenterCrop(self.size)(img, lbl, rng)


class RandomCrop:
    def __init__(self, size: int):
        self.size = size

    def __call__(self, img, lbl, rng):
        w, h = img.size
        if w < self.size or h < self.size:
            img, lbl = PadCenterCrop(self.size)(img, lbl, rng)
            w, h = img.size
        j = rng.randint(0, w - self.size + 1)
        i = rng.randint(0, h - self.size + 1)
        box = (j, i, j + self.size, i + self.size)
        return img.crop(box), lbl.crop(box)


class RandomRotation:
    """Rotate by a random angle; label rotated NEAREST with `fill`."""

    def __init__(self, degrees: float = 10.0, fill: int = 255):
        self.degrees = degrees
        self.fill = fill

    def __call__(self, img, lbl, rng):
        angle = rng.uniform(-self.degrees, self.degrees)
        img = img.rotate(angle, resample=Image.BILINEAR)
        lbl = lbl.rotate(angle, resample=Image.NEAREST, fillcolor=self.fill)
        return img, lbl


class ColorJitter:
    """Brightness/contrast/saturation jitter on the image only."""

    def __init__(self, brightness: float = 0.3, contrast: float = 0.3,
                 saturation: float = 0.3):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation

    def __call__(self, img, lbl, rng):
        from PIL import ImageEnhance
        for attr, enh in [("brightness", ImageEnhance.Brightness),
                          ("contrast", ImageEnhance.Contrast),
                          ("saturation", ImageEnhance.Color)]:
            amt = getattr(self, attr)
            if amt > 0:
                img = enh(img).enhance(rng.uniform(1 - amt, 1 + amt))
        return img, lbl


class Pad:
    """Pad both image and label on all sides (reference transform.py:173-223).

    `padding` is an int, (lr, tb) pair, or (l, t, r, b) 4-tuple; `fill` is
    the constant value; `mode` one of constant/edge/reflect/symmetric."""

    def __init__(self, padding, fill: int = 0, mode: str = "constant"):
        if isinstance(padding, int):
            padding = (padding, padding, padding, padding)
        elif len(padding) == 2:
            padding = (padding[0], padding[1], padding[0], padding[1])
        self.padding = tuple(padding)  # (l, t, r, b)
        self.fill = fill
        assert mode in ("constant", "edge", "reflect", "symmetric")
        self.mode = mode

    def _pad(self, arr: np.ndarray) -> np.ndarray:
        l, t, r, b = self.padding
        spec = ((t, b), (l, r)) + ((0, 0),) * (arr.ndim - 2)
        if self.mode == "constant":
            return np.pad(arr, spec, constant_values=self.fill)
        return np.pad(arr, spec, mode=self.mode)

    def __call__(self, img, lbl, rng):
        return (Image.fromarray(self._pad(np.asarray(img))),
                Image.fromarray(self._pad(np.asarray(lbl))))


class Lambda:
    """Apply a user function to both image and label (reference :225-243)."""

    def __init__(self, fn):
        assert callable(fn)
        self.fn = fn

    def __call__(self, img, lbl, rng):
        return self.fn(img), self.fn(lbl)


class CustomRandomResizeLong:
    """Resize so the LONG side is uniform in [min_long, max_long]
    (reference transform.py:772-792)."""

    def __init__(self, min_long: int, max_long: int):
        self.min_long = min_long
        self.max_long = max_long

    def __call__(self, img, lbl, rng):
        target = rng.randint(self.min_long, self.max_long + 1)
        w, h = img.size
        if w < h:
            shape = (int(round(w * target / h)), target)
        else:
            shape = (target, int(round(h * target / w)))
        img = img.resize(shape, Image.BICUBIC)
        lbl = lbl.resize(shape, Image.NEAREST)
        return img, lbl


class CustomRandomCrop:
    """Random crop into a zero-filled `cropsize` square container; images
    smaller than the crop are randomly placed inside it (reference
    transform.py:795-831, array-domain)."""

    def __init__(self, cropsize: int):
        self.cropsize = cropsize

    def _offsets(self, extent: int, rng) -> Tuple[int, int]:
        space = extent - self.cropsize
        if space > 0:
            return 0, rng.randint(0, space + 1)
        return rng.randint(0, -space + 1), 0

    def __call__(self, img, lbl, rng):
        ia = np.asarray(img)
        la = np.asarray(lbl)
        h, w = ia.shape[:2]
        ch, cw = min(self.cropsize, h), min(self.cropsize, w)
        cont_top, img_top = self._offsets(h, rng)
        cont_left, img_left = self._offsets(w, rng)
        ic = np.zeros((self.cropsize, self.cropsize) + ia.shape[2:], ia.dtype)
        lc = np.zeros((self.cropsize, self.cropsize) + la.shape[2:], la.dtype)
        ic[cont_top:cont_top + ch, cont_left:cont_left + cw] = \
            ia[img_top:img_top + ch, img_left:img_left + cw]
        lc[cont_top:cont_top + ch, cont_left:cont_left + cw] = \
            la[img_top:img_top + ch, img_left:img_left + cw]
        return Image.fromarray(ic), Image.fromarray(lc)
