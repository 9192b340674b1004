"""Visualisation: turbo-colormapped 2D arrays and image rendering.

The JAX package's ``utils/vis.py`` in the port (reference: rmvd/utils/vis.py),
numpy and PIL only, with a turbo lookup table as the default colormap (no
matplotlib):

- ``vis`` dispatcher (ref :184-216): 2D arrays -> colormapped maps, CHW
  images -> PIL, with batch handling for 3D/4D inputs.
- ``vis_2d_array`` / ``vis_image`` (ref :236-281, :466-515) with
  ``full_batch`` (False / True / "cols" / "rows") and ``batch_labels``.
- value clipping with auto mean +- 2*std thresholds, invalid-value
  marking, text / label / value-range overlays (ref :284-463).
- ``cat_images_colwise`` / ``cat_images_rowwise`` (ref :164-181),
  ``add_text_to_img`` (ref :657-791), ``invalidate_np_array`` (ref
  :794-859), ``check_vis`` (ref :219-233), and ``colormap_2d``, the raw
  colormapped array that the training engine's image events and the viewer
  use.

Torch tensors (on any device) and numpy arrays are accepted.
"""

from __future__ import annotations

import numpy as np


def _turbo_table():
    """Polynomial approximation of the turbo colormap (Google AI blog, 2019).

    Returns a (256, 3) uint8 lookup table.
    """
    x = np.linspace(0.0, 1.0, 256)
    r = np.polyval([59.28, -152.94, 128.55, -42.66, 4.61, 0.135], x)
    g = np.polyval([-14.0, 4.8, 25.9, -42.4, 25.0, 0.09], x)
    b = np.polyval([-89.9, 252.5, -254.3, 105.3, -5.0, 0.28], x)
    rgb = np.stack([r, g, b], axis=-1)
    return (np.clip(rgb, 0, 1) * 255).astype(np.uint8)


_TURBO = _turbo_table()
_DEFAULT_CMAP = "turbo"

# human-readable names of the colormap endpoints, used in the value-range
# overlay text (reference: _cmap_min_str/_cmap_max_str, vis.py:52-83)
_CMAP_ENDPOINT_NAMES = {"turbo": ("blue", "red"), "gray": ("black", "white")}


def _make_np(arr):
    """Accept numpy arrays and torch tensors (reference: make_np via tensor2numpy)."""
    if isinstance(arr, np.ndarray):
        return arr
    if hasattr(arr, "detach"):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def _apply_cmap(idx_u8, cmap_name):
    if cmap_name == "gray":
        return np.stack([idx_u8] * 3, axis=-1)
    return _TURBO[idx_u8]


def invalidate_np_array(
    arr,
    clipping=False,
    upper_clipping_thresh=None,
    lower_clipping_thresh=None,
    invalid_values=None,
):
    """Zero non-finite values, clipped values and listed invalid values.

    Returns (arr, invalid_mask, invalid_values_mask, clipping_mask,
    upper_clipping_mask, lower_clipping_mask, upper_thresh, lower_thresh)
    — same contract as the reference (rmvd/utils/vis.py:794-859), with
    auto thresholds at mean +- 2*std of the valid values.
    """
    arr = np.asarray(arr, dtype=np.float32).copy()
    invalid_values_mask = ~np.isfinite(arr)
    if invalid_values is not None:
        invalid_values_mask |= np.isin(arr, invalid_values)

    if clipping:
        if upper_clipping_thresh is None or lower_clipping_thresh is None:
            valid = arr[~invalid_values_mask]
            all_invalid = valid.size == 0
            mean = float(np.mean(valid)) if not all_invalid else np.nan
            std = float(np.std(valid)) if not all_invalid else np.nan
            if upper_clipping_thresh is None:
                upper_clipping_thresh = (
                    min(float(np.max(valid)), mean + 2 * std) if not all_invalid else np.nan
                )
            if lower_clipping_thresh is None:
                lower_clipping_thresh = (
                    max(float(np.min(valid)), mean - 2 * std) if not all_invalid else np.nan
                )
        with np.errstate(invalid="ignore"):
            upper_clipping_mask = (arr > upper_clipping_thresh) & ~invalid_values_mask
            lower_clipping_mask = (arr < lower_clipping_thresh) & ~invalid_values_mask
        clipping_mask = upper_clipping_mask | lower_clipping_mask
    else:
        clipping_mask = np.zeros_like(arr, dtype=bool)
        upper_clipping_mask = clipping_mask
        lower_clipping_mask = clipping_mask

    invalid_mask = invalid_values_mask | clipping_mask
    arr[invalid_mask] = 0
    return (
        arr,
        invalid_mask,
        invalid_values_mask,
        clipping_mask,
        upper_clipping_mask,
        lower_clipping_mask,
        upper_clipping_thresh,
        lower_clipping_thresh,
    )


def _normalize_to_255(arr, invalid_mask, clipping, lo_thresh, hi_thresh):
    """Scale valid values into [0, 255]; returns (scaled, min/max stats)."""
    valid = arr[~invalid_mask]
    if valid.size == 0:
        return np.zeros_like(arr), 0.0, 0.0, 0.0, 0.0, True
    arr_min, arr_max = float(np.min(valid)), float(np.max(valid))
    if not clipping:
        min_value, max_value = arr_min, arr_max
    else:
        min_value, max_value = float(lo_thresh), float(hi_thresh)
    is_constant = max_value == min_value
    out = arr.astype(np.float32, copy=True)
    if is_constant:
        out = out * 0 if min_value == 0 else (out / min_value) * 255.0
    else:
        out = (out - min_value) / (max_value - min_value) * 255.0
    return out, min_value, max_value, arr_min, arr_max, is_constant


def add_text_to_img(img, text, xy_lefttop=None, xy_leftbottom=None):
    """Draw text lines onto a PIL image.

    ``text``: str, or list of (line, color) pairs / plain lines — drawn top
    to bottom from ``xy_lefttop`` or bottom-up from ``xy_leftbottom``
    (reference: rmvd/utils/vis.py:657-791).
    """
    from PIL import ImageDraw

    if text is None:
        return img
    if isinstance(text, str):
        text = [(text, "white")]
    lines = [(t, "white") if isinstance(t, str) else tuple(t) for t in text]
    draw = ImageDraw.Draw(img)
    line_h = 11
    if xy_lefttop is not None:
        x, y = xy_lefttop
        for line, color in lines:
            draw.text((x, y), line, fill=color)
            y += line_h
    else:
        x, y = xy_leftbottom if xy_leftbottom is not None else (5, 5)
        y = img.height - y - line_h * len(lines)
        for line, color in lines:
            draw.text((x, y), line, fill=color)
            y += line_h
    return img


def _get_draw_text(text, label, text_off, image_range_text, image_range_text_off):
    lines = []
    if label is not None:
        lines.append((str(label), "yellow"))
    if text is not None and not text_off:
        if isinstance(text, str):
            lines.append((text, "white"))
        else:
            lines.extend((t, "white") if isinstance(t, str) else tuple(t) for t in text)
    if not image_range_text_off:
        lines.append((image_range_text, "white"))
    return lines or None


def _to_out_format(img, out_format, out_action):
    out_format = {"type": "PIL", "mode": "RGB"} if out_format is None else dict(out_format)
    mode = out_format.get("mode", "RGB")
    if img.mode != mode:
        img = img.convert(mode)
    if out_format.get("type") == "np":
        out = np.array(img, dtype=out_format.get("dtype", "uint8"))
    else:
        out = img
    if out_action is not None and out_action.get("type") == "show":
        img.show()
    return out


def _vis_single_2d_array(
    arr,
    colorize=True,
    clipping=False,
    upper_clipping_thresh=None,
    lower_clipping_thresh=None,
    mark_clipping=False,
    clipping_color=None,
    invalid_values=None,
    mark_invalid=False,
    invalid_color=None,
    text=None,
    label=None,
    cmap=None,
    image_range_text_off=False,
    image_range_colors_off=False,
    text_off=False,
    out_format=None,
    out_action=None,
):
    """Render one 2D array (reference: rmvd/utils/vis.py:284-463)."""
    from PIL import Image

    assert arr.ndim == 2, f"single 2d array must be 2D, got shape {arr.shape}"
    cmap_name = _DEFAULT_CMAP if cmap is None else cmap

    (
        arr,
        invalid_mask,
        invalid_values_mask,
        clipping_mask,
        upper_clipping_mask,
        lower_clipping_mask,
        hi,
        lo,
    ) = invalidate_np_array(
        arr, clipping, upper_clipping_thresh, lower_clipping_thresh, invalid_values
    )
    scaled, min_value, max_value, arr_min, arr_max, is_constant = _normalize_to_255(
        arr, invalid_mask, clipping, lo, hi
    )

    idx = np.clip(scaled, 0, 255).astype(np.uint8)
    rgb = _apply_cmap(idx, cmap_name if colorize else "gray")

    if mark_invalid:
        default_invalid = [0, 0, 0] if colorize else [2, 10, 30]
        rgb[invalid_values_mask] = (
            np.array(default_invalid) if invalid_color is None else invalid_color
        )
    if clipping:
        if mark_clipping:
            default_clip = [255, 255, 255] if colorize else [67, 50, 54]
            rgb[clipping_mask] = (
                np.array(default_clip) if clipping_color is None else clipping_color
            )
        else:
            rgb[upper_clipping_mask] = _apply_cmap(np.uint8(255), cmap_name if colorize else "gray")
            rgb[lower_clipping_mask] = _apply_cmap(np.uint8(0), cmap_name if colorize else "gray")

    img = Image.fromarray(rgb, mode="RGB")

    lo_name, hi_name = _CMAP_ENDPOINT_NAMES.get(
        cmap_name if colorize else "gray", ("min", "max")
    )
    if is_constant:
        image_range_text = "Image: Constant: %0.3f" % min_value
    elif image_range_colors_off:
        image_range_text = "Min: %0.3f Max: %0.3f" % (arr_min, arr_max)
    else:
        image_range_text = "Min (%s): %0.3f Max (%s): %0.3f" % (
            lo_name,
            arr_min,
            hi_name,
            arr_max,
        )
    draw_text = _get_draw_text(text, label, text_off, image_range_text, image_range_text_off)
    img = add_text_to_img(img, draw_text, xy_leftbottom=(5, 5))
    return _to_out_format(img, out_format, out_action)


def _vis_single_image(
    img,
    clipping=False,
    upper_clipping_thresh=None,
    lower_clipping_thresh=None,
    mark_clipping=False,
    clipping_color=None,
    invalid_values=None,
    mark_invalid=False,
    invalid_color=None,
    text=None,
    label=None,
    image_range_text_off=False,
    image_range_colors_off=False,
    text_off=False,
    out_format=None,
    out_action=None,
):
    """Render one CHW image (reference: rmvd/utils/vis.py:518-654)."""
    from PIL import Image

    assert img.ndim == 3, f"single image must be CHW, got shape {img.shape}"
    img = img.astype(np.float32).transpose(1, 2, 0)

    (
        img,
        invalid_mask,
        invalid_values_mask,
        clipping_mask,
        upper_clipping_mask,
        lower_clipping_mask,
        hi,
        lo,
    ) = invalidate_np_array(
        img, clipping, upper_clipping_thresh, lower_clipping_thresh, invalid_values
    )
    scaled, min_value, max_value, arr_min, arr_max, is_constant = _normalize_to_255(
        img, invalid_mask, clipping, lo, hi
    )
    rgb = np.clip(scaled, 0, 255).astype(np.uint8)

    if mark_invalid:
        rgb[np.any(invalid_values_mask, axis=2)] = (
            np.array([0, 0, 0]) if invalid_color is None else invalid_color
        )
    if clipping and mark_clipping:
        rgb[np.any(clipping_mask, axis=2)] = (
            np.array([255, 255, 255]) if clipping_color is None else clipping_color
        )

    pil = Image.fromarray(rgb, mode="RGB")
    image_range_text = (
        "Image: Constant: %0.3f" % min_value
        if is_constant
        else "Min: %0.3f Max: %0.3f" % (arr_min, arr_max)
    )
    draw_text = _get_draw_text(text, label, text_off, image_range_text, image_range_text_off)
    pil = add_text_to_img(pil, draw_text, xy_leftbottom=(5, 5))
    return _to_out_format(pil, out_format, out_action)


def _equalize_sizes(imgs):
    """Pad PIL images to a common size (reference: vis.py:141-161)."""
    from PIL import Image

    w = max(i.width for i in imgs)
    h = max(i.height for i in imgs)
    out = []
    for i in imgs:
        if i.width == w and i.height == h:
            out.append(i)
        else:
            canvas = Image.new(i.mode, (w, h))
            canvas.paste(i, (0, 0))
            out.append(canvas)
    return out


def cat_images_colwise(imgs):
    """Concatenate PIL images side by side (reference: vis.py:164-171)."""
    from PIL import Image

    imgs = _equalize_sizes(imgs)
    out = Image.new(imgs[0].mode, (sum(i.width for i in imgs), imgs[0].height))
    x = 0
    for i in imgs:
        out.paste(i, (x, 0))
        x += i.width
    return out


def cat_images_rowwise(imgs):
    """Concatenate PIL images top to bottom (reference: vis.py:174-181)."""
    from PIL import Image

    imgs = _equalize_sizes(imgs)
    out = Image.new(imgs[0].mode, (imgs[0].width, sum(i.height for i in imgs)))
    y = 0
    for i in imgs:
        out.paste(i, (0, y))
        y += i.height
    return out


def _vis_batch(arr, single_fn, full_batch, batch_labels, **kwargs):
    if full_batch:
        imgs = []
        for idx, ele in enumerate(arr):
            if batch_labels is not None:
                assert "label" not in kwargs, "batch_labels and label are exclusive"
                imgs.append(single_fn(ele, label=batch_labels[idx], **kwargs))
            else:
                imgs.append(single_fn(ele, **kwargs))
        return cat_images_rowwise(imgs) if full_batch == "rows" else cat_images_colwise(imgs)
    return single_fn(arr[0], **kwargs)


def vis_2d_array(arr, full_batch=False, batch_labels=None, **kwargs):
    """Visualize a 2D array / batch of 2D arrays (reference: vis.py:236-281).

    ``full_batch``: False = first sample only; True/"cols" = concatenate
    side by side; "rows" = concatenate top to bottom.
    """
    arr = _make_np(arr)
    assert 2 <= arr.ndim <= 4, f"2d array must have 2-4 dims, got {arr.shape}"
    if arr.ndim == 4:
        assert arr.shape[1] == 1, f"4D 2d-array batch must have 1 channel, got {arr.shape}"
        arr = arr[:, 0]
    if arr.ndim == 2:
        if not full_batch:
            return _vis_single_2d_array(arr, **kwargs)
        arr = arr[None]
    return _vis_batch(arr, _vis_single_2d_array, full_batch, batch_labels, **kwargs)


def vis_image(img, full_batch=False, batch_labels=None, **kwargs):
    """Visualize a CHW image / NCHW batch (reference: vis.py:466-515)."""
    img = _make_np(img)
    assert 3 <= img.ndim <= 4, f"image must have 3 or 4 dims, got {img.shape}"
    if img.ndim == 3:
        assert img.shape[0] == 3, f"CHW image must have 3 channels, got {img.shape}"
        if not full_batch:
            return _vis_single_image(img, **kwargs)
        img = img[None]
    else:
        assert img.shape[1] == 3, f"NCHW image must have 3 channels, got {img.shape}"
    return _vis_batch(img, _vis_single_image, full_batch, batch_labels, **kwargs)


def vis(arr, **kwargs):
    """Visualize a 2D array or image, with batch handling.

    Dispatch (reference: rmvd/utils/vis.py:184-216):
    - 2 dims: 2d array
    - 3 dims, 3 channels first: image; otherwise batch of 2d arrays
    - 4 dims, 3 channels second: batch of images; 1 channel: batch of 2d
      arrays.
    Returns a PIL image (or numpy, with out_format={'type': 'np'}).
    """
    arr = _make_np(arr)
    if arr.ndim == 2:
        return vis_2d_array(arr, **kwargs)
    if arr.ndim == 3:
        if arr.shape[0] == 3:
            return vis_image(arr, **kwargs)
        return vis_2d_array(arr, **kwargs)
    if arr.ndim == 4:
        if arr.shape[1] == 3:
            return vis_image(arr, **kwargs)
        assert arr.shape[1] == 1, f"cannot visualize an array of shape {arr.shape}"
        return vis_2d_array(arr, **kwargs)
    raise ValueError(f"cannot visualize an array of shape {arr.shape}")


def check_vis(arr):
    """True if ``vis`` can render this array (reference: vis.py:219-233)."""
    arr = _make_np(arr)
    if arr.ndim in (2, 3):
        return True
    if arr.ndim == 4:
        return arr.shape[1] in (1, 3)
    return False


def colormap_2d(arr, mark_invalid=True, clip_range=None):
    """Raw turbo-colormapped uint8 RGB array (no text overlay) — the fast

    path used by the training engine's image events and the viewer."""
    arr = np.asarray(_make_np(arr), dtype=np.float32)
    if arr.ndim == 3 and arr.shape[0] == 1:
        arr = arr[0]
    valid = np.isfinite(arr)
    if mark_invalid:
        valid &= arr != 0
    vals = arr[valid]
    if clip_range is not None:
        lo, hi = clip_range
    elif vals.size:
        lo, hi = float(np.min(vals)), float(np.max(vals))
    else:
        lo, hi = 0.0, 1.0
    denom = (hi - lo) if hi > lo else 1.0
    norm = np.clip((arr - lo) / denom, 0, 1)
    rgb = _TURBO[(norm * 255).astype(np.uint8)]
    rgb[~valid] = 0
    return rgb
