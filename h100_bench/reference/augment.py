"""Dual-view augmentation for the reference, float32 on the device.

A frozen copy of the program's augmentation as it stands when the benchmark
was written (crop, flip, folded colour jitter, rotation by three FFT shears;
mask and tile shuffle on the positive view; eval: centre crop, /255,
normalize): the same draws from the same generator in the same order, so the
reference augments exactly as the program does, without importing it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# colour-jitter op codes
BRIGHTNESS, CONTRAST, SATURATION, HUE = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """The augmentation's settings (the program's defaults)."""

    input_size: int = 448
    resize_size: int = 600
    hflip_prob: float = 0.5
    brightness: float = 0.2
    contrast: float = 0.2
    saturation: float = 0.2
    hue: float = 0.1
    rotation_degrees: float = 10.0
    mask_ratio: Tuple[float, float] = (0.15, 0.45)
    grid_size: int = 4
    mask_value: float = 0.0
    mean: Tuple[float, float, float] = IMAGENET_MEAN
    std: Tuple[float, float, float] = IMAGENET_STD


def _uniform(shape, lo, hi, generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return lo + (hi - lo) * u


def _randint_below(high: torch.Tensor, generator) -> torch.Tensor:
    """Uniform integers in [0, high[i]) per sample, high an int64 tensor."""
    u = torch.rand(high.shape, generator=generator, device=high.device, dtype=torch.float32)
    return torch.minimum((u * high).long(), high - 1)


def _rows(v: torch.Tensor) -> torch.Tensor:
    """[B] -> [B, 1, 1, 1], to broadcast against NHWC images."""
    return v[:, None, None, None]


# ----------------------------------------------------------------------------
# crop, flip, normalize
# ----------------------------------------------------------------------------


def center_crop(img: torch.Tensor, out_size: int) -> torch.Tensor:
    """[..., S, S, C] -> [..., out, out, C], offset (S - out) // 2."""
    s = img.shape[-3]
    off = (s - out_size) // 2
    return img[..., off : off + out_size, off : off + out_size, :]


def draw_crop(batch: int, size: int, out_size: int, generator, device):
    """Uniform offsets (y0, x0) in [0, size - out_size], int64 [B] each."""
    high = torch.full((batch,), size - out_size + 1, dtype=torch.int64, device=device)
    return _randint_below(high, generator), _randint_below(high, generator)


def apply_crop(img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor, out_size: int):
    """[B, S, S, C] -> [B, out, out, C], sample b cut at (y0[b], x0[b])."""
    b = img.shape[0]
    ar = torch.arange(out_size, device=img.device)
    rows = (y0[:, None] + ar)[:, :, None]
    cols = (x0[:, None] + ar)[:, None, :]
    return img[torch.arange(b, device=img.device)[:, None, None], rows, cols]


def draw_hflip(batch: int, prob: float, generator, device) -> torch.Tensor:
    return torch.rand(batch, generator=generator, device=device) < prob


def apply_hflip(img: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    return torch.where(_rows(flip), img.flip(2), img)


def normalize(img: torch.Tensor, cfg: AugmentConfig) -> torch.Tensor:
    mean = torch.tensor(cfg.mean, dtype=img.dtype, device=img.device)
    std = torch.tensor(cfg.std, dtype=img.dtype, device=img.device)
    return (img - mean) / std


# ----------------------------------------------------------------------------
# colour jitter (images [B, H, W, 3] float32 in [0, 1])
# ----------------------------------------------------------------------------


def _grayscale(img: torch.Tensor) -> torch.Tensor:
    w = torch.tensor([0.299, 0.587, 0.114], dtype=img.dtype, device=img.device)
    return torch.sum(img * w, dim=-1, keepdim=True)


def _rgb_to_hsv(img: torch.Tensor):
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / maxc.clamp(min=1e-8), torch.zeros_like(maxc))
    safe = delta.clamp(min=1e-8)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0), torch.zeros_like(h))
    return h, s, maxc


def _hsv_to_rgb(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.long(), 6)

    def pick(options):
        out = options[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, options[k], out)
        return out

    return torch.stack([pick([v, q, p, p, t, v]), pick([t, v, v, q, p, p]),
                        pick([p, p, t, v, v, q])], dim=-1)


def adjust_hue(img: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Rotate the hue of [B, H, W, 3] by ``shift`` [B] (fractions of a turn)."""
    h, s, v = _rgb_to_hsv(img)
    h = torch.remainder(h + shift[:, None, None], 1.0)
    return _hsv_to_rgb(h, s, v).clamp(0.0, 1.0)


def enabled_jitter_ops(cfg: AugmentConfig) -> Tuple[int, ...]:
    """Op codes the config switches on, in their listing order."""
    strengths = (cfg.brightness, cfg.contrast, cfg.saturation, cfg.hue)
    return tuple(code for code, s in enumerate(strengths) if s > 0)


def draw_color_jitter(batch: int, cfg: AugmentConfig, generator, device):
    """Per-sample ColorJitter parameters in a per-sample random op order.

    Returns ``(codes, factors)``, both ``[B, n]`` over the ``n`` enabled ops,
    already permuted: slot k of sample b applies op ``codes[b, k]`` with
    ``factors[b, k]``.  Brightness / contrast / saturation factors are
    U[max(0, 1-x), 1+x], the hue shift U[-h, h].
    """
    ops = enabled_jitter_ops(cfg)
    if not ops:
        empty = torch.zeros(batch, 0, device=device)
        return empty.long(), empty
    cols = []
    for code in ops:
        if code == HUE:
            cols.append(_uniform((batch,), -cfg.hue, cfg.hue, generator, device))
        else:
            x = (cfg.brightness, cfg.contrast, cfg.saturation)[code]
            cols.append(_uniform((batch,), max(0.0, 1 - x), 1 + x, generator, device))
    factors = torch.stack(cols, dim=1)
    perm = torch.argsort(torch.rand(batch, len(ops), generator=generator, device=device), dim=1)
    codes = torch.tensor(ops, device=device, dtype=torch.int64)[perm]
    return codes, torch.gather(factors, 1, perm)


def fold_color_jitter(codes: torch.Tensor, factors: torch.Tensor):
    """Fold the op sequence into two affine segments around the hue slot.

    Brightness, contrast and saturation are affine in the image,
    ``out = a img + b gray(img) + g mean(gray(img))``, and compose into scalar
    coefficients.  Returns ``(pre, post)``, each a tuple ``(a, b, g)`` of
    ``[B]`` tensors: the segment before the hue op and the one after it.
    Without a hue op everything lands in ``post`` and ``pre`` is the identity.
    """
    batch = codes.shape[0]
    one = torch.ones(batch, dtype=torch.float32, device=codes.device)
    zero = torch.zeros_like(one)
    ident = (one, zero, zero)
    seg, pre = ident, ident
    for slot in range(codes.shape[1]):
        code, f = codes[:, slot], factors[:, slot]
        a, b, g = seg
        branches = (
            (f * a, f * b, f * g),                                # brightness
            (f * a, f * b, f * g + (1 - f) * (a + b + g)),        # contrast
            (f * a, f * b + (1 - f) * (a + b), g),                # saturation
            (a, b, g),                                            # hue: handled apart
        )
        new_seg = tuple(
            torch.where(code == BRIGHTNESS, branches[0][k],
                        torch.where(code == CONTRAST, branches[1][k],
                                    torch.where(code == SATURATION, branches[2][k],
                                                branches[3][k])))
            for k in range(3)
        )
        is_hue = code == HUE
        pre = tuple(torch.where(is_hue, s, p) for s, p in zip(seg, pre))
        seg = tuple(torch.where(is_hue, i, n) for i, n in zip(ident, new_seg))
    return pre, seg


def _affine_segment(img: torch.Tensor, coeffs) -> torch.Tensor:
    a, b, g = coeffs
    gray = _grayscale(img)
    mean = gray.mean(dim=(1, 2, 3), keepdim=True)
    return (_rows(a) * img + _rows(b) * gray + _rows(g) * mean).clamp(0.0, 1.0)


def apply_color_jitter(img: torch.Tensor, codes: torch.Tensor, factors: torch.Tensor,
                       hue_on: Optional[bool] = None):
    """Apply the drawn ops in their per-sample order: one affine segment, the
    hue rotation in its slot, one more affine segment.  The [0, 1] clamp lands
    once per segment.  Every row of ``codes`` permutes
    the same op set; ``hue_on`` says whether hue is in it (None: read it off
    ``codes``, which waits for the device)."""
    if codes.shape[1] == 0:
        return img
    pre, post = fold_color_jitter(codes, factors)
    is_hue = codes == HUE
    if hue_on is None:
        hue_on = bool(is_hue[0].any())
    if not hue_on:
        return _affine_segment(img, post)
    shift = torch.sum(torch.where(is_hue, factors, torch.zeros_like(factors)), dim=1)
    return _affine_segment(adjust_hue(_affine_segment(img, pre), shift), post)


# ----------------------------------------------------------------------------
# rotation by three FFT shears
# ----------------------------------------------------------------------------


def _fft_shift_last(x: torch.Tensor, shifts: torch.Tensor, pad: int,
                    n: Optional[int] = None) -> torch.Tensor:
    """Per-row sub-pixel translation along the last axis by the FFT shift
    theorem: ``out[..., r, j] = x[..., r, j - shifts[..., r]]`` with sinc
    interpolation.  x [B, C, R, W], shifts [B, R].  Zero padding by ``pad`` on
    the left and up to the (even) transform length ``n`` on the right keeps
    the circular wrap out of the image."""
    w = x.shape[-1]
    if n is None:
        n = w + 2 * pad + ((w + 2 * pad) % 2)
    xp = torch.nn.functional.pad(x, (pad, n - w - pad))
    f = torch.fft.rfft(xp, dim=-1)
    k = torch.arange(f.shape[-1], device=x.device, dtype=torch.float32)
    theta = (-2.0 * math.pi / n) * shifts[..., None].float() * k  # [B, R, nf]
    phase = torch.polar(torch.ones_like(theta), theta)
    out = torch.fft.irfft(f * phase[:, None], n=n, dim=-1)
    return out[..., pad : pad + w]


def rotation_pad(size: int, max_abs_deg: Optional[float]) -> int:
    """Zero padding that keeps a shear's circular wrap out of a ``size``-wide
    image, for angles up to ``max_abs_deg`` (None: the 0.35 x size fallback)."""
    if max_abs_deg is None:
        return max(16, int(0.35 * size))
    r = abs(max_abs_deg) * math.pi / 180.0
    frac = max(math.tan(r / 2.0), math.sin(r))
    return max(8, int(math.ceil(frac * size / 2.0)) + 4)


def draw_rotation(batch: int, degrees: float, generator, device) -> torch.Tensor:
    return _uniform((batch,), -degrees, degrees, generator, device)


def apply_rotate(img: torch.Tensor, angle_deg: torch.Tensor,
                 max_abs_deg: Optional[float] = None) -> torch.Tensor:
    """Rotate [B, H, W, C] about the centre by ``angle_deg`` [B] degrees:
    R(theta) = Shear_x(-tan(theta/2)) Shear_y(sin theta) Shear_x(-tan(theta/2)),
    each shear a batch of per-row FFT translations.  The output is clipped to
    each sample's input range against ringing overshoot."""
    h, w = img.shape[1], img.shape[2]
    theta = angle_deg.float() * (math.pi / 180.0)
    a = -torch.tan(theta / 2.0)
    b = torch.sin(theta)
    rows = torch.arange(h, device=img.device, dtype=torch.float32) - (h - 1) / 2.0
    cols = torch.arange(w, device=img.device, dtype=torch.float32) - (w - 1) / 2.0
    pad = rotation_pad(max(h, w), max_abs_deg)
    lo = img.amin(dim=(1, 2, 3), keepdim=True)
    hi = img.amax(dim=(1, 2, 3), keepdim=True)
    x = img.permute(0, 3, 1, 2)  # [B, C, H, W]
    x = _fft_shift_last(x, a[:, None] * rows, pad)
    x = x.transpose(2, 3)  # [B, C, W, H]
    x = _fft_shift_last(x, b[:, None] * cols, pad)
    x = x.transpose(2, 3)
    x = _fft_shift_last(x, a[:, None] * rows, pad)
    return torch.maximum(torch.minimum(x.permute(0, 2, 3, 1), hi), lo)


# ----------------------------------------------------------------------------
# positive-view ops: rectangular mask, tile shuffle
# ----------------------------------------------------------------------------


def draw_rect_mask(batch: int, h: int, w: int, ratio_range, generator, device):
    """Area ratio U[lo, hi]; mask side floor(dim sqrt(ratio)); uniform
    position.  Returns int64 [B] tensors (y0, x0, mask_h, mask_w)."""
    ratio = _uniform((batch,), ratio_range[0], ratio_range[1], generator, device)
    mask_h = torch.floor(h * torch.sqrt(ratio)).long()
    mask_w = torch.floor(w * torch.sqrt(ratio)).long()
    y0 = _randint_below(torch.clamp(h - mask_h, min=1) + 1, generator)
    x0 = _randint_below(torch.clamp(w - mask_w, min=1) + 1, generator)
    return y0, x0, mask_h, mask_w


def apply_rect_mask(img: torch.Tensor, y0, x0, mask_h, mask_w, mask_value: float = 0.0):
    h, w = img.shape[1], img.shape[2]
    yy = torch.arange(h, device=img.device)[None, :, None]
    xx = torch.arange(w, device=img.device)[None, None, :]
    y0, x0 = y0[:, None, None], x0[:, None, None]
    inside = ((yy >= y0) & (yy < y0 + mask_h[:, None, None])
              & (xx >= x0) & (xx < x0 + mask_w[:, None, None]))
    return torch.where(inside[..., None], torch.full_like(img, mask_value), img)


def draw_grid_shuffle(batch: int, grid_size: int, generator, device) -> torch.Tensor:
    """A uniform random permutation of the s*s tiles per sample, [B, s*s]."""
    return torch.argsort(torch.rand(batch, grid_size * grid_size, generator=generator,
                                    device=device), dim=1)


def apply_grid_shuffle(img: torch.Tensor, perm: torch.Tensor, grid_size: int) -> torch.Tensor:
    """Output tile k of sample b is input tile ``perm[b, k]`` of the s x s grid;
    a remainder strip (sizes not divisible by s) stays in place."""
    s = grid_size
    b, h, w, c = img.shape
    gh, gw = h // s, w // s
    tiles = img[:, : gh * s, : gw * s].reshape(b, s, gh, s, gw, c)
    tiles = tiles.permute(0, 1, 3, 2, 4, 5).reshape(b, s * s, gh, gw, c)
    idx = perm[:, :, None, None, None].expand(b, s * s, gh, gw, c)
    out = torch.gather(tiles, 1, idx).reshape(b, s, s, gh, gw, c)
    out = out.permute(0, 1, 3, 2, 4, 5).reshape(b, s * gh, s * gw, c)
    if s * gh == h and s * gw == w:
        return out
    full = img.clone()
    full[:, : s * gh, : s * gw] = out
    return full


# ----------------------------------------------------------------------------
# the dual-view pipelines
# ----------------------------------------------------------------------------


def draw_base_params(batch: int, size: int, cfg: AugmentConfig, generator, device) -> Dict:
    """Parameters of one base chain (crop, flip, jitter, rotation)."""
    y0, x0 = draw_crop(batch, size, cfg.input_size, generator, device)
    codes, factors = draw_color_jitter(batch, cfg, generator, device)
    params = {"crop_y": y0, "crop_x": x0,
              "flip": draw_hflip(batch, cfg.hflip_prob, generator, device),
              "jitter_codes": codes, "jitter_factors": factors}
    if cfg.rotation_degrees > 0:
        params["angle"] = draw_rotation(batch, cfg.rotation_degrees, generator, device)
    return params


def apply_base_augment(images_u8: torch.Tensor, params: Dict, cfg: AugmentConfig):
    """uint8 [B, S, S, 3] -> float32 [B, I, I, 3] in [0, 1]: RandomCrop ->
    HFlip -> ColorJitter -> RandomRotation.  The crop is taken on the bytes,
    before the conversion to float: the same values, fewer bytes moved."""
    img = apply_crop(images_u8, params["crop_y"], params["crop_x"], cfg.input_size)
    img = img.float() / 255.0
    img = apply_hflip(img, params["flip"])
    img = apply_color_jitter(img, params["jitter_codes"], params["jitter_factors"],
                             hue_on=HUE in enabled_jitter_ops(cfg))
    if "angle" in params:
        img = apply_rotate(img, params["angle"], max_abs_deg=cfg.rotation_degrees)
    return img


def draw_positive_params(batch: int, cfg: AugmentConfig, generator, device) -> Dict:
    y0, x0, mh, mw = draw_rect_mask(batch, cfg.input_size, cfg.input_size, cfg.mask_ratio,
                                    generator, device)
    return {"mask": (y0, x0, mh, mw),
            "perm": draw_grid_shuffle(batch, cfg.grid_size, generator, device)}


def apply_positive_augment(img: torch.Tensor, params: Dict, cfg: AugmentConfig):
    img = apply_rect_mask(img, *params["mask"], mask_value=cfg.mask_value)
    return apply_grid_shuffle(img, params["perm"], cfg.grid_size)


def dual_view_train_batch(images_u8: torch.Tensor, generator: torch.Generator,
                          cfg: AugmentConfig):
    """uint8 [B, S, S, 3] -> (anchor, positive) float32 normalized [B, I, I, 3]:
    two independent base chains, then mask and tile shuffle on the positive."""
    b, s, dev = images_u8.shape[0], images_u8.shape[1], images_u8.device
    anchor = apply_base_augment(images_u8, draw_base_params(b, s, cfg, generator, dev), cfg)
    positive = apply_base_augment(images_u8, draw_base_params(b, s, cfg, generator, dev), cfg)
    positive = apply_positive_augment(positive, draw_positive_params(b, cfg, generator, dev), cfg)
    return normalize(anchor, cfg), normalize(positive, cfg)


def dual_view_eval_batch(images_u8: torch.Tensor, cfg: AugmentConfig):
    """uint8 [B, S, S, 3] -> (anchor, positive) float32 [B, I, I, 3], positive
    is anchor.  The crop is taken before the conversion to float, which gives
    the same values as converting first and moves fewer bytes."""
    img = center_crop(images_u8, cfg.input_size).float() / 255.0
    anchor = normalize(img, cfg)
    return anchor, anchor
