"""Host-side (numpy) transforms of a sample dict: the resizes the evaluation
datasets use and the training augmentations (reference:
rmvd/data/transforms.py:20-412), the JAX package's ``data/transforms.py``.

A sample has CHW float32 images in 0..255 and lists over views. The random
transforms draw from the global ``np.random`` in the JAX package's order, so
that with the same seed they give its samples bit for bit. ``ColorJitter``
is torchvision's jitter (brightness, contrast, saturation and hue in random
order on the stacked views) in numpy.
"""

from __future__ import annotations

import math

import numpy as np

from ..utils.geometry import compute_depth_range, transform_from_rot_trans
from ..utils.image import resize_bilinear, resize_nearest


class Bernoulli:
    def __init__(self, prob):
        self.prob = prob

    def sample(self, size=1):
        return np.random.binomial(n=1, p=self.prob, size=size)


class UniformBernoulli:
    """Gated uniform sampler, optionally exponentiated

    (reference: transforms.py:21-36)."""

    def __init__(self, mean, spread, prob=1.0, exp=False):
        self.mean = mean
        self.spread = spread
        self.prob = prob
        self.exp = exp

    def sample(self, size=1):
        gate = Bernoulli(self.prob).sample(size if not self.exp else 1)
        val = np.random.uniform(self.mean - self.spread, self.mean + self.spread, size)
        return gate * (np.exp(val) if self.exp else val)


def _resize_image_chw(image, size, order=1):
    if order == 0:
        return resize_nearest(image, size)
    return resize_bilinear(image, size)


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, sample):
        for t in self.transforms:
            sample = t(sample)
        return sample


class ResizeInputs:
    """Resize images + rescale intrinsics (reference: transforms.py:40-74)."""

    def __init__(self, size, interpolation_order=1):
        self._height, self._width = size
        self._order = interpolation_order

    def __call__(self, sample):
        image = sample["images"][0]
        orig_ht, orig_wd = image.shape[-2:]
        ht, wd = self._height, self._width

        if "images" in sample and sample["images"] is not None:
            sample["images"] = [
                _resize_image_chw(img, (ht, wd), self._order) for img in sample["images"]
            ]

        if "intrinsics" in sample and sample["intrinsics"] is not None:
            scale_arr = np.array(
                [[wd / orig_wd] * 3, [ht / orig_ht] * 3, [1.0] * 3], dtype=np.float32
            )
            sample["intrinsics"] = [K * scale_arr for K in sample["intrinsics"]]

        return sample


class UpscaleInputsToNextMultipleOf:
    """(reference: transforms.py:77-98)"""

    def __init__(self, factor, interpolation_order=1):
        self._factor = factor
        self._order = interpolation_order

    def __call__(self, sample):
        image = sample["images"][0]
        orig_ht, orig_wd = image.shape[-2:]
        ht = int(math.ceil(orig_ht / self._factor) * self._factor)
        wd = int(math.ceil(orig_wd / self._factor) * self._factor)
        if (ht, wd) == (orig_ht, orig_wd):
            return sample
        return ResizeInputs(size=(ht, wd), interpolation_order=self._order)(sample)


class ResizeTargets:
    """Order-0 depth/invdepth resize + depth_range recompute

    (reference: transforms.py:101-133)."""

    def __init__(self, size, interpolation_order=0):
        self._height, self._width = size
        self._order = interpolation_order

    def __call__(self, sample):
        size = (self._height, self._width)
        for key in ("depth", "invdepth"):
            if key in sample and sample[key] is not None:
                sample[key] = _resize_image_chw(sample[key], size, self._order).astype(
                    np.float32
                )
        if "depth_range" in sample and sample["depth_range"] is not None:
            sample["depth_range"] = compute_depth_range(
                depth=sample.get("depth"), invdepth=sample.get("invdepth")
            )
        return sample


class SpatialAugmentation:
    """Random scale/stretch/crop with intrinsics shift

    (reference: transforms.py:136-254)."""

    def __init__(self, size, p, stretch_p=0.0, max_stretch=0.2):
        self._height, self._width = size
        self._p = p
        self._stretch_p = stretch_p
        self._max_stretch = max_stretch

    def __call__(self, sample):
        images = sample["images"]
        cht, cwd = self._height, self._width
        ht, wd = images[0].shape[-2:]

        if np.random.rand() >= self._p:
            return sample

        min_scale = np.maximum((cht + 8) / float(ht), (cwd + 8) / float(wd))

        def draw_scale():
            return (
                UniformBernoulli(mean=0.2, spread=0.4, exp=True).sample(1)[0]
                * UniformBernoulli(mean=0.0, spread=0.3, exp=True).sample(1)[0]
            )

        scale = draw_scale()
        for _ in range(5):
            if scale < 1.2 and np.random.rand() < 0.9:
                scale = draw_scale()
            else:
                break

        scale_x = scale_y = scale
        if np.random.rand() < self._stretch_p:
            scale_x *= 2 ** np.random.uniform(-self._max_stretch, self._max_stretch)
            scale_y *= 2 ** np.random.uniform(-self._max_stretch, self._max_stretch)

        scale_x = np.clip(scale_x, min_scale, None)
        scale_y = np.clip(scale_y, min_scale, None)

        sht = int(round(ht * scale_y))
        swd = int(round(wd * scale_x))

        if "images" in sample and sample["images"] is not None:
            sample["images"] = [
                _resize_image_chw(img, (sht, swd), order=1) for img in sample["images"]
            ]

        if "intrinsics" in sample and sample["intrinsics"] is not None:
            scale_arr = np.array(
                [[swd / wd] * 3, [sht / ht] * 3, [1.0] * 3], dtype=np.float32
            )
            sample["intrinsics"] = [K * scale_arr for K in sample["intrinsics"]]

        for key in ("depth", "invdepth"):
            if key in sample and sample[key] is not None:
                sample[key] = _resize_image_chw(sample[key], (sht, swd), order=0)

        y0 = np.random.randint(0, sht - cht)
        x0 = np.random.randint(0, swd - cwd)

        if "images" in sample and sample["images"] is not None:
            sample["images"] = [
                img[:, y0 : y0 + cht, x0 : x0 + cwd] for img in sample["images"]
            ]
        if "intrinsics" in sample and sample["intrinsics"] is not None:
            shift_arr = np.array(
                [[0, 0, -x0], [0, 0, -y0], [0.0] * 3], dtype=np.float32
            )
            sample["intrinsics"] = [K + shift_arr for K in sample["intrinsics"]]
        for key in ("depth", "invdepth"):
            if key in sample and sample[key] is not None:
                sample[key] = sample[key][:, y0 : y0 + cht, x0 : x0 + cwd]

        if "depth_range" in sample and sample["depth_range"] is not None:
            sample["depth_range"] = compute_depth_range(
                depth=sample.get("depth"), invdepth=sample.get("invdepth")
            )

        return sample


# --- numpy color jitter ---------------------------------------------------


def _rgb_to_hsv(img):
    """img: (..., 3) in [0, 1]; returns h, s, v arrays."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = np.max(img, axis=-1)
    minc = np.min(img, axis=-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        rc = (maxc - r) / np.maximum(delta, 1e-12)
        gc = (maxc - g) / np.maximum(delta, 1e-12)
        bc = (maxc - b) / np.maximum(delta, 1e-12)
    h = np.where(
        maxc == r, bc - gc, np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc)
    )
    h = np.where(delta == 0, 0.0, h)
    h = (h / 6.0) % 1.0
    return h, s, v


def _hsv_to_rgb(h, s, v):
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    out = np.zeros(h.shape + (3,), dtype=h.dtype)
    conds = [i == k for k in range(6)]
    rgb = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]
    for cond, (rr, gg, bb) in zip(conds, rgb):
        out[..., 0] = np.where(cond, rr, out[..., 0])
        out[..., 1] = np.where(cond, gg, out[..., 1])
        out[..., 2] = np.where(cond, bb, out[..., 2])
    return out


class ColorJitter:
    """torchvision-style jitter applied to the vertically stacked views so

    all views get identical color changes (reference: transforms.py:257-273).
    Factor ranges follow torchvision ColorJitter semantics: scalars mean
    [max(0, 1-v), 1+v] (hue: [-v, v]); tuples are used directly."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        self.brightness = self._range(brightness)
        self.contrast = self._range(contrast)
        self.saturation = self._range(saturation)
        self.hue = self._range(hue, center=0, bound=0.5)

    @staticmethod
    def _range(value, center=1, bound=None):
        if value is None:
            return None
        if isinstance(value, (tuple, list)):
            return tuple(value)
        if value == 0:
            return None
        if center == 0:
            v = min(value, bound) if bound else value
            return (-v, v)
        return (max(0.0, center - value), center + value)

    def __call__(self, sample):
        images = sample["images"]
        num = len(images)
        stack = np.concatenate(
            [np.transpose(img, (1, 2, 0)) for img in images], axis=0
        )  # (H*num, W, 3), float 0..255
        stack = stack.astype(np.uint8).astype(np.float32) / 255.0

        ops = []
        if self.brightness:
            f = np.random.uniform(*self.brightness)
            ops.append(lambda im, f=f: np.clip(im * f, 0, 1))
        if self.contrast:
            f = np.random.uniform(*self.contrast)

            def contrast(im, f=f):
                # torchvision: blend with mean of grayscale
                gray = im @ np.array([0.299, 0.587, 0.114], dtype=np.float32)
                mean = gray.mean()
                return np.clip(im * f + (1 - f) * mean, 0, 1)

            ops.append(contrast)
        if self.saturation:
            f = np.random.uniform(*self.saturation)

            def saturate(im, f=f):
                gray = (im @ np.array([0.299, 0.587, 0.114], dtype=np.float32))[..., None]
                return np.clip(im * f + (1 - f) * gray, 0, 1)

            ops.append(saturate)
        if self.hue:
            f = np.random.uniform(*self.hue)

            def hue_shift(im, f=f):
                h, s, v = _rgb_to_hsv(im)
                return _hsv_to_rgb((h + f) % 1.0, s, v)

            ops.append(hue_shift)

        np.random.shuffle(ops)
        for op in ops:
            stack = op(stack)

        stack = (stack * 255.0).astype(np.float32)
        split = np.split(stack, num, axis=0)
        sample["images"] = [np.transpose(im, (2, 0, 1)) for im in split]
        return sample


class NormalizeImagesToMinMax:
    """(reference: transforms.py:276-290)"""

    def __init__(self, min_val, max_val):
        self._min = min_val
        self._max = max_val

    def __call__(self, sample):
        sample["images"] = [
            (img / 255.0) * (self._max - self._min) + self._min
            for img in sample["images"]
        ]
        return sample


class NormalizeImagesByShiftAndScale:
    """(reference: transforms.py:293-316)"""

    def __init__(self, shift, scale):
        self._shift = np.asarray(shift, dtype=np.float32)
        self._scale = np.asarray(scale, dtype=np.float32)

    def __call__(self, sample):
        out = []
        for img in sample["images"]:
            if img.ndim == 3:  # CHW
                out.append((img - self._shift[:, None, None]) / self._scale[:, None, None])
            else:  # NCHW
                out.append(
                    (img - self._shift[None, :, None, None]) / self._scale[None, :, None, None]
                )
        sample["images"] = [im.astype(np.float32) for im in out]
        return sample


class Eraser:
    """Erase random rectangles in source views with the mean color

    (reference: transforms.py:319-352)."""

    def __init__(self, bounds, p):
        self._bounds = bounds
        self._p = p

    def __call__(self, sample):
        images = sample["images"]
        keyview_idx = int(np.asarray(sample["keyview_idx"]).reshape(-1)[0])
        for src_idx in (i for i in range(len(images)) if i != keyview_idx):
            if np.random.rand() >= self._p:
                continue
            img = images[src_idx]
            mean_color = np.mean(img.reshape(3, -1), axis=-1)
            ht, wd = img.shape[-2:]
            for _ in range(np.random.randint(1, 3)):
                dx = np.random.randint(self._bounds[0], self._bounds[1])
                dy = np.random.randint(self._bounds[0], self._bounds[1])
                x0 = np.random.randint(0, wd)
                y0 = np.random.randint(0, ht)
                min_x, max_x = max(0, x0 - dx // 2), min(wd - 1, x0 + dx // 2)
                min_y, max_y = max(0, y0 - dy // 2), min(ht - 1, y0 + dy // 2)
                img[:, min_y:max_y, min_x:max_x] = mean_color[:, None, None]
            images[src_idx] = img
        sample["images"] = images
        return sample


class Scale3DFixed:
    """Rescale scene scale: pose translations, depth, invdepth, depth_range

    (reference: transforms.py:355-380)."""

    def __init__(self, scale, p):
        self._scale = scale
        self._p = p

    def __call__(self, sample):
        if np.random.rand() >= self._p:
            return sample
        sf = self._scale
        poses = sample["poses"]
        for idx, pose in enumerate(poses):
            poses[idx] = transform_from_rot_trans(pose[:3, :3], pose[:3, 3] * sf)
        sample["poses"] = poses
        sample["depth"] = sample["depth"] * sf
        sample["invdepth"] = sample["invdepth"] / sf
        dr = sample["depth_range"]
        sample["depth_range"] = (dr[0] * sf, dr[1] * sf)
        return sample


class MaskDepthByMinMax:
    """(reference: transforms.py:383-400)"""

    def __init__(self, min_depth, max_depth):
        self._min = min_depth
        self._max = max_depth

    def __call__(self, sample):
        depth = sample["depth"]
        invdepth = sample["invdepth"]
        mask = ((depth >= self._min) & (depth <= self._max)).astype(np.float32)
        sample["depth"] = depth * mask
        sample["invdepth"] = invdepth * mask
        sample["depth_range"] = compute_depth_range(depth=sample["depth"])
        return sample


class NormalizeIntrinsics:
    """(reference: transforms.py:403-412)"""

    def __call__(self, sample):
        ht, wd = sample["images"][0].shape[-2:]
        if "intrinsics" in sample and sample["intrinsics"] is not None:
            scale_arr = np.array(
                [[1 / wd] * 3, [1 / ht] * 3, [1.0] * 3], dtype=np.float32
            )
            sample["intrinsics"] = [K * scale_arr for K in sample["intrinsics"]]
        return sample
