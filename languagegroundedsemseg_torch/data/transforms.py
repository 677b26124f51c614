"""Host-side point-cloud augmentations.

Counterpart of ``languagegroundedsemseg_tpu/data/transforms.py`` (:19-273),
numpy and scipy as there.

Behavioral mirror of reference lib/transforms.py:22-283 with explicit
numpy Generators instead of global random state (preserves distributions,
not sequences — SURVEY.md §7 hard part 7). Each transform is
``t(rng, coords, feats, labels) -> (coords, feats, labels)``; correspondence
arrays (paired views) are handled by the caller.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import scipy.interpolate
import scipy.ndimage


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, rng, coords, feats, labels):
        for t in self.transforms:
            coords, feats, labels = t(rng, coords, feats, labels)
        return coords, feats, labels


# ---- feature (color) transforms -------------------------------------------


class ChromaticTranslation:
    """Random global color shift: 255 * 2 * ratio * U(-0.5, 0.5) per channel,
    applied with p=0.95 (reference :22-39)."""

    def __init__(self, trans_range_ratio=0.10):
        self.ratio = trans_range_ratio

    def __call__(self, rng, coords, feats, labels):
        if rng.random() < 0.95:
            tr = (rng.random((1, 3)) - 0.5) * 255 * 2 * self.ratio
            feats = feats.copy()
            feats[:, :3] = np.clip(tr + feats[:, :3], 0, 255)
        return coords, feats, labels


class ChromaticAutoContrast:
    """Blend toward per-cloud min/max contrast stretch with p=0.2
    (reference :42-68)."""

    def __init__(self, randomize_blend_factor=True, blend_factor=0.5):
        self.randomize = randomize_blend_factor
        self.blend = blend_factor

    def __call__(self, rng, coords, feats, labels):
        if rng.random() < 0.2:
            lo = feats[:, :3].min(0, keepdims=True)
            hi = feats[:, :3].max(0, keepdims=True)
            if hi.max() <= 1:
                return coords, feats, labels
            scale = 255 / np.maximum(hi - lo, 1e-6)
            stretched = (feats[:, :3] - lo) * scale
            blend = rng.random() if self.randomize else self.blend
            feats = feats.copy()
            feats[:, :3] = (1 - blend) * feats[:, :3] + blend * stretched
        return coords, feats, labels


class ChromaticJitter:
    """Per-point gaussian color noise (std * 255), p=0.95 (reference :71-84)."""

    def __init__(self, std=0.05):
        self.std = std

    def __call__(self, rng, coords, feats, labels):
        if rng.random() < 0.95:
            noise = rng.standard_normal((feats.shape[0], 3)) * self.std * 255
            feats = feats.copy()
            feats[:, :3] = np.clip(noise + feats[:, :3], 0, 255)
        return coords, feats, labels


class ChromaticScale:
    def __init__(self, scale_factor=1.0):
        self.scale = scale_factor

    def __call__(self, rng, coords, feats, labels):
        feats = feats.copy()
        feats[:, :3] = feats[:, :3] * self.scale
        return coords, feats, labels


def rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """Vectorized colorsys conversion, rgb in [0,255] -> h,s in [0,1], v in
    [0,255] (reference :104-127)."""
    rgb = rgb.astype(np.float64)
    hsv = np.zeros_like(rgb)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.max(-1)
    minc = rgb.min(-1)
    hsv[..., 2] = maxc
    delta = maxc - minc
    mask = delta > 0
    hsv[mask, 1] = delta[mask] / maxc[mask]
    with np.errstate(divide="ignore", invalid="ignore"):
        rc = np.where(mask, (maxc - r) / delta, 0.0)
        gc = np.where(mask, (maxc - g) / delta, 0.0)
        bc = np.where(mask, (maxc - b) / delta, 0.0)
    h = np.select([r == maxc, g == maxc], [bc - gc, 2.0 + rc - bc], default=4.0 + gc - rc)
    hsv[..., 0] = (h / 6.0) % 1.0
    return hsv


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = (h * 6.0).astype(int)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i % 6
    conds = [s == 0.0, i == 1, i == 2, i == 3, i == 4, i == 5]
    rgb = np.empty_like(hsv)
    rgb[..., 0] = np.select(conds, [v, q, p, p, t, v], default=v)
    rgb[..., 1] = np.select(conds, [v, v, v, q, p, p], default=t)
    rgb[..., 2] = np.select(conds, [v, p, t, v, v, q], default=p)
    return rgb


class HueSaturationTranslation:
    """Global random hue rotation + saturation scale (reference :102-166)."""

    def __init__(self, hue_max=0.5, saturation_max=0.2):
        self.hue_max = hue_max
        self.sat_max = saturation_max

    def __call__(self, rng, coords, feats, labels):
        hsv = rgb_to_hsv(feats[:, :3])
        hue_val = (rng.random() - 0.5) * 2 * self.hue_max
        sat_ratio = 1 + (rng.random() - 0.5) * 2 * self.sat_max
        hsv[..., 0] = np.remainder(hue_val + hsv[..., 0] + 1, 1)
        hsv[..., 1] = np.clip(sat_ratio * hsv[..., 1], 0, 1)
        feats = feats.copy()
        feats[:, :3] = np.clip(hsv_to_rgb(hsv), 0, 255)
        return coords, feats, labels


# ---- coordinate transforms -------------------------------------------------


class RandomDropout:
    """Drop a random subset of points with probability dropout_ratio
    (reference :172-195 — the same ratio gates application and sets the keep
    fraction, mirrored intentionally)."""

    def __init__(self, dropout_ratio=0.2):
        self.ratio = dropout_ratio

    def __call__(self, rng, coords, feats, labels):
        if rng.random() < self.ratio:
            n = len(coords)
            keep = rng.choice(n, int(n * (1 - self.ratio)), replace=False)
            coords, feats, labels = coords[keep], feats[keep], labels[keep]
        return coords, feats, labels


class RandomHorizontalFlip:
    """Mirror each non-upright axis with p=0.5 (gate p=0.95, reference
    :198-220)."""

    def __init__(self, upright_axis: str = "z", is_temporal: bool = False):
        d = 4 if is_temporal else 3
        up = {"x": 0, "y": 1, "z": 2}[upright_axis.lower()]
        self.horz_axes = sorted(set(range(d)) - {up})

    def __call__(self, rng, coords, feats, labels):
        if rng.random() < 0.95:
            coords = coords.copy()
            for ax in self.horz_axes:
                if rng.random() < 0.5:
                    coords[:, ax] = coords[:, ax].max() - coords[:, ax]
        return coords, feats, labels


class InstanceAugmentation:
    """Targeted per-instance hue/brightness shifts and scalings for tail
    categories, writing the attribute id into the label's second column
    (reference lib/transforms.py:288-384). Attribute ids: 1-4 hue
    (red/green/blue/yellow), 5 dark, 6 bright, 7 up-scale, 8 down-scale."""

    COLOR_SHIFTS = ["Red", "Green", "Blue", "Yellow", "Dark", "Bright"]
    HUES = {"Red": 0.0, "Yellow": 60 / 360.0, "Green": 120 / 360.0, "Blue": 240 / 360.0}
    WHITE_SCALE = 2.0
    SIZE_SHIFTS = (0.5, 1.5)

    def shift_hue(self, colors, h_out):
        hsv = rgb_to_hsv(colors / 255.0)
        hsv[..., 0] = h_out
        return hsv_to_rgb(hsv) * 255.0

    def shift_color(self, rng, coords, feats, labels):
        direction = self.COLOR_SHIFTS[rng.integers(len(self.COLOR_SHIFTS))]
        feats = feats.copy()
        labels = labels.copy()
        if direction in self.HUES:
            feats[:, :3] = self.shift_hue(feats[:, :3], self.HUES[direction])
            labels[:, 1] = 1 + ["Red", "Green", "Blue", "Yellow"].index(direction)
        elif direction == "Dark":
            feats[:, :3] = (feats[:, :3] / self.WHITE_SCALE).astype(int)
            labels[:, 1] = 5
        else:  # Bright
            feats[:, :3] = (255 - (255 - feats[:, :3]) / self.WHITE_SCALE).astype(int)
            labels[:, 1] = 6
        return coords, feats, labels

    def shift_scale(self, rng, coords, feats, labels, scene_scale):
        coords = coords.astype(np.float64).copy()
        labels = labels.copy()
        ext = coords.max(0) - coords.min(0)
        up = rng.uniform(0.0, 2.0) > 1.0
        if up:
            hi = min(self.SIZE_SHIFTS[1], float((scene_scale / np.maximum(ext, 1e-6)).min()))
            s = rng.uniform(1.0, max(hi, 1.0))
            labels[:, 1] = 7
        else:
            s = rng.uniform(self.SIZE_SHIFTS[0], 1.0)
            labels[:, 1] = 8
        center = np.array(
            [
                (coords[:, 0].min() + coords[:, 0].max()) / 2.0,
                (coords[:, 1].min() + coords[:, 1].max()) / 2.0,
                coords[:, 2].min(),
            ]
        )
        coords = coords * s + center * (1 - s)
        return coords, feats, labels


class ElasticDistortion:
    """Smoothed gaussian displacement field, trilinearly interpolated at the
    points (reference :223-270): noise grid at `granularity` spacing, blurred
    3x3x3 box filter twice per axis, scaled by `magnitude`. Gate p=0.95."""

    def __init__(self, distortion_params: Optional[Sequence[Tuple[float, float]]]):
        self.params = distortion_params

    @staticmethod
    def distort(rng, coords, granularity, magnitude):
        blurs = [
            np.ones((3, 1, 1, 1), np.float32) / 3,
            np.ones((1, 3, 1, 1), np.float32) / 3,
            np.ones((1, 1, 3, 1), np.float32) / 3,
        ]
        cmin = coords.min(0)
        dim = ((coords - cmin).max(0) // granularity).astype(int) + 3
        noise = rng.standard_normal(size=(*dim, 3)).astype(np.float32)
        for _ in range(2):
            for b in blurs:
                noise = scipy.ndimage.convolve(noise, b, mode="constant", cval=0)
        ax = [
            np.linspace(d_min, d_max, d)
            for d_min, d_max, d in zip(cmin - granularity, cmin + granularity * (dim - 2), dim)
        ]
        interp = scipy.interpolate.RegularGridInterpolator(
            ax, noise, bounds_error=False, fill_value=0
        )
        return coords + interp(coords) * magnitude

    def __call__(self, rng, coords, feats, labels):
        if self.params is not None and rng.random() < 0.95:
            for granularity, magnitude in self.params:
                coords = self.distort(rng, coords, granularity, magnitude)
        return coords, feats, labels
