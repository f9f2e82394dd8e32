"""The port's dual-view augmentation against the JAX package's.

Each ``apply_*`` function gets the parameters that ``jax.random`` draws inside
the JAX op (the test repeats the op's key splits and passes the numbers
across) and must reproduce the JAX op's pixels: 1e-6 absolute for the copies
and selects, 2e-6 for colour jitter (a few fp32 multiplies in another order),
2e-4 for the rotation (three FFT shears against the JAX package's
matmul-DFT shears, whose own accuracy is ~1e-4 on 0..1 images).  The
``draw_*`` functions are checked by distribution over 4096 samples, since the
two frameworks' random streams cannot be matched.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ego_moment_cle_vit_tpu.data import augment as ja
from ego_moment_cle_vit_tpu_torch.data import augment as ta

# the test workers share the cores, and these sizes are tiny: one intra-op thread
# per worker keeps torch's thread pools from contending with each other
torch.set_num_threads(1)

S, I = 40, 32
CFG = dict(input_size=I, resize_size=S)
N_DRAWS = 4096


def _images(seed=0, b=3):
    return np.random.default_rng(seed).integers(0, 256, (b, S, S, 3), dtype=np.uint8)


def _float_images(seed=0, b=3, size=I):
    return np.random.default_rng(seed).random((b, size, size, 3)).astype(np.float32)


def _keys(seed, b):
    return jax.random.split(jax.random.PRNGKey(seed), b)


def _jitter_params(key, cfg):
    """The numbers ``ja.color_jitter`` draws from ``key``, in the port's form."""
    kb, kc, ks, kh, korder = jax.random.split(key, 5)
    vals = []
    for k, x in ((kb, cfg.brightness), (kc, cfg.contrast), (ks, cfg.saturation)):
        if x > 0:
            vals.append(float(jax.random.uniform(k, (), minval=max(0.0, 1 - x), maxval=1 + x)))
    if cfg.hue > 0:
        vals.append(float(jax.random.uniform(kh, (), minval=-cfg.hue, maxval=cfg.hue)))
    codes = np.array(ta.enabled_jitter_ops(cfg))
    perm = np.asarray(jax.random.permutation(korder, len(vals)))
    return codes[perm], np.array(vals, np.float32)[perm]


def _base_params(key, cfg):
    """The parameters ``ja._base_augment`` draws from ``key`` for one sample."""
    kc, kf, kj, kr = jax.random.split(key, 4)
    ky, kx = jax.random.split(kc)
    codes, factors = _jitter_params(kj, cfg)
    return {
        "crop_y": int(jax.random.randint(ky, (), 0, S - I + 1)),
        "crop_x": int(jax.random.randint(kx, (), 0, S - I + 1)),
        "flip": bool(jax.random.bernoulli(kf, cfg.hflip_prob)),
        "jitter_codes": codes, "jitter_factors": factors,
        "angle": float(jax.random.uniform(kr, (), minval=-cfg.rotation_degrees,
                                          maxval=cfg.rotation_degrees)),
    }


def _stack(per_sample):
    return {k: torch.as_tensor(np.stack([np.asarray(p[k]) for p in per_sample]))
            for k in per_sample[0]}


def test_apply_crop_and_flip_match_jax():
    img = _float_images(1, size=S)
    keys = _keys(1, 3)
    ref, y0, x0 = [], [], []
    for i in range(3):
        ky, kx = jax.random.split(keys[i])
        y0.append(int(jax.random.randint(ky, (), 0, S - I + 1)))
        x0.append(int(jax.random.randint(kx, (), 0, S - I + 1)))
        ref.append(np.asarray(ja.random_crop(jnp.asarray(img[i]), keys[i], I)))
    out = ta.apply_crop(torch.from_numpy(img), torch.tensor(y0), torch.tensor(x0), I)
    np.testing.assert_array_equal(out.numpy(), np.stack(ref))

    flips = [bool(jax.random.bernoulli(k, 0.5)) for k in keys]
    ref = np.stack([np.asarray(ja.random_hflip(jnp.asarray(img[i]), keys[i], 0.5))
                    for i in range(3)])
    out = ta.apply_hflip(torch.from_numpy(img), torch.tensor(flips))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert any(flips) and not all(flips)  # both branches ran


@pytest.mark.parametrize("knobs", [
    {},                                   # all four ops, hue in a random slot
    {"hue": 0.0},                         # one affine segment only
    {"brightness": 0.0, "saturation": 0.4},
])
def test_apply_color_jitter_matches_jax(knobs):
    jcfg = ja.AugmentConfig(**CFG, **knobs)
    tcfg = ta.AugmentConfig(**CFG, **knobs)
    img = _float_images(2, b=6)
    keys = _keys(2, 6)
    ref = np.stack([np.asarray(ja.color_jitter(jnp.asarray(img[i]), keys[i], jcfg))
                    for i in range(6)])
    params = [_jitter_params(k, jcfg) for k in keys]
    codes = torch.as_tensor(np.stack([p[0] for p in params]))
    factors = torch.as_tensor(np.stack([p[1] for p in params]))
    out = ta.apply_color_jitter(torch.from_numpy(img), codes, factors)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2e-6)
    assert np.abs(ref - img).max() > 1e-2  # the jitter did something
    hue_on = ta.HUE in ta.enabled_jitter_ops(tcfg)
    assert torch.equal(out, ta.apply_color_jitter(torch.from_numpy(img), codes, factors,
                                                  hue_on=hue_on))


def test_fft_shear_matches_the_jax_dft_shear():
    rng = np.random.default_rng(3)
    x = rng.random((3, 20, I)).astype(np.float32)            # [C, R, W]
    shifts = rng.uniform(-3, 3, size=(20,)).astype(np.float32)
    pad = 8
    ref = np.asarray(ja._dft_shift_last(jnp.asarray(x), jnp.asarray(shifts), pad))
    out = ta._fft_shift_last(torch.from_numpy(x)[None], torch.from_numpy(shifts)[None], pad)[0]
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)
    # the same transform as the JAX package's FFT form, at the same length
    n = I + 2 * pad
    ref_fft = np.asarray(ja._fft_shift_last(jnp.asarray(x), jnp.asarray(shifts), pad, n))
    np.testing.assert_allclose(out.numpy(), ref_fft, rtol=0, atol=2e-5)
    # an integer shift moves pixels exactly (to rounding)
    moved = ta._fft_shift_last(torch.from_numpy(x)[None], torch.full((1, 20), 2.0), pad)[0]
    np.testing.assert_allclose(moved[..., 2:].numpy(), x[..., :-2], rtol=0, atol=2e-5)


@pytest.mark.parametrize("max_abs_deg", [10.0, None])
def test_apply_rotate_matches_jax(max_abs_deg):
    img = _float_images(4)
    angles = np.array([7.5, -9.0, 0.3], np.float32)
    ref = np.stack([np.asarray(ja.rotate(jnp.asarray(img[i]), jnp.float32(angles[i]),
                                         max_abs_deg=max_abs_deg)) for i in range(3)])
    out = ta.apply_rotate(torch.from_numpy(img), torch.from_numpy(angles), max_abs_deg)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2e-4)
    assert np.abs(ref[0] - img[0]).max() > 0.1  # 7.5 degrees moves pixels
    assert ta.rotation_pad(224, 10.0) == 24 and ta.rotation_pad(224, None) == 78


def test_apply_rect_mask_and_grid_shuffle_match_jax():
    img = _float_images(5, b=4)
    keys = _keys(5, 4)
    y0, x0, mh, mw, ref = [], [], [], [], []
    for i in range(4):
        kr, ky, kx = jax.random.split(keys[i], 3)
        ratio = jax.random.uniform(kr, (), minval=0.15, maxval=0.45)
        h_ = int(jnp.floor(I * jnp.sqrt(ratio)))
        y0.append(int(jax.random.randint(ky, (), 0, max(1, I - h_) + 1)))
        x0.append(int(jax.random.randint(kx, (), 0, max(1, I - h_) + 1)))
        mh.append(h_)
        mw.append(h_)
        ref.append(np.asarray(ja.random_rect_mask(jnp.asarray(img[i]), keys[i], (0.15, 0.45),
                                                  0.25)))
    out = ta.apply_rect_mask(torch.from_numpy(img), torch.tensor(y0), torch.tensor(x0),
                             torch.tensor(mh), torch.tensor(mw), 0.25)
    np.testing.assert_array_equal(out.numpy(), np.stack(ref))

    for size, grid in ((I, 4), (30, 4)):  # 30 = 4 x 7 + a remainder strip that stays
        im = _float_images(6, b=4, size=size)
        perms = [np.asarray(jax.random.permutation(k, grid * grid)) for k in keys]
        ref = np.stack([np.asarray(ja.grid_shuffle(jnp.asarray(im[i]), keys[i], grid))
                        for i in range(4)])
        out = ta.apply_grid_shuffle(torch.from_numpy(im), torch.as_tensor(np.stack(perms)), grid)
        np.testing.assert_array_equal(out.numpy(), ref)


def test_whole_train_views_match_jax_given_the_same_parameters():
    """Both views through the whole chain, every parameter taken from the keys
    ``ja._train_sample`` would split."""
    jcfg, tcfg = ja.AugmentConfig(**CFG), ta.AugmentConfig(**CFG)
    u8 = _images(7, b=4)
    keys = _keys(7, 4)
    ref_a, ref_p, pa, pp, pos = [], [], [], [], []
    for i in range(4):
        a, p = ja._train_sample(jnp.asarray(u8[i]), keys[i], jcfg)
        ref_a.append(np.asarray(a))
        ref_p.append(np.asarray(p))
        ka, kp, kpa = jax.random.split(keys[i], 3)
        pa.append(_base_params(ka, jcfg))
        pp.append(_base_params(kp, jcfg))
        km, ks = jax.random.split(kpa)
        kr, ky, kx = jax.random.split(km, 3)
        side = int(jnp.floor(I * jnp.sqrt(jax.random.uniform(kr, (), minval=0.15, maxval=0.45))))
        pos.append({"mask": np.array([
            int(jax.random.randint(ky, (), 0, max(1, I - side) + 1)),
            int(jax.random.randint(kx, (), 0, max(1, I - side) + 1)), side, side]),
            "perm": np.asarray(jax.random.permutation(ks, 16))})
    images = torch.from_numpy(u8)
    anchor = ta.normalize(ta.apply_base_augment(images, _stack(pa), tcfg), tcfg)
    positive = ta.apply_base_augment(images, _stack(pp), tcfg)
    mask = torch.as_tensor(np.stack([p["mask"] for p in pos]))
    positive = ta.apply_positive_augment(
        positive, {"mask": tuple(mask[:, k] for k in range(4)),
                   "perm": torch.as_tensor(np.stack([p["perm"] for p in pos]))}, tcfg)
    positive = ta.normalize(positive, tcfg)
    # normalize divides by ~0.225: 2e-4 on the 0..1 image is 1e-3 here
    np.testing.assert_allclose(anchor.numpy(), np.stack(ref_a), rtol=0, atol=1e-3)
    np.testing.assert_allclose(positive.numpy(), np.stack(ref_p), rtol=0, atol=1e-3)


def test_draws_follow_the_jax_distributions():
    cfg = ta.AugmentConfig(**CFG)
    g = torch.Generator().manual_seed(0)
    n = N_DRAWS
    y0, x0 = ta.draw_crop(n, S, I, g, "cpu")
    for v in (y0, x0):
        assert v.min() == 0 and v.max() == S - I
        assert abs(v.float().mean().item() - (S - I) / 2) < 0.25
    flip = ta.draw_hflip(n, 0.3, g, "cpu")
    assert abs(flip.float().mean().item() - 0.3) < 0.03
    codes, factors = ta.draw_color_jitter(n, cfg, g, "cpu")
    assert codes.shape == factors.shape == (n, 4)
    assert torch.equal(codes.sort(dim=1).values, torch.arange(4).expand(n, 4))
    for code, lo, hi in ((ta.BRIGHTNESS, 0.8, 1.2), (ta.CONTRAST, 0.8, 1.2),
                         (ta.SATURATION, 0.8, 1.2), (ta.HUE, -0.1, 0.1)):
        f = factors[codes == code]
        assert f.numel() == n and f.min() >= lo and f.max() <= hi
        assert abs(f.mean().item() - (lo + hi) / 2) < 0.01 and f.std() > 0.2 * (hi - lo)
        # every op lands in every slot about a quarter of the time
        assert ((codes == code).float().mean(dim=0) - 0.25).abs().max() < 0.03
    angle = ta.draw_rotation(n, 10.0, g, "cpu")
    assert angle.min() >= -10 and angle.max() <= 10 and abs(angle.mean().item()) < 0.5
    y0, x0, mh, mw = ta.draw_rect_mask(n, I, I, (0.15, 0.45), g, "cpu")
    area = (mh.float() / I) ** 2
    assert area.min() >= 0.15 - 2 / I and area.max() <= 0.45
    assert torch.equal(mh, mw) and (y0 >= 0).all() and (y0 + mh <= I + 1).all()
    assert (x0 >= 0).all() and (x0 + mw <= I + 1).all()
    perm = ta.draw_grid_shuffle(n, 4, g, "cpu")
    assert torch.equal(perm.sort(dim=1).values, torch.arange(16).expand(n, 16))
    assert ((perm[:, 0][:, None] == torch.arange(16)).float().mean(dim=0) - 1 / 16).abs().max() < 0.02


def test_dual_view_train_batch_is_seeded_and_bounded():
    cfg = ta.AugmentConfig(**CFG)
    u8 = torch.from_numpy(_images(8, b=4))
    a1, p1 = ta.dual_view_train_batch(u8, torch.Generator().manual_seed(5), cfg)
    a2, p2 = ta.dual_view_train_batch(u8, torch.Generator().manual_seed(5), cfg)
    a3, _ = ta.dual_view_train_batch(u8, torch.Generator().manual_seed(6), cfg)
    assert a1.shape == p1.shape == (4, I, I, 3) and a1.dtype == torch.float32
    assert torch.equal(a1, a2) and torch.equal(p1, p2) and not torch.equal(a1, a3)
    assert not torch.equal(a1, p1)  # independent base chains, then mask and shuffle
    lo = (0.0 - max(cfg.mean)) / min(cfg.std)
    hi = (1.0 - min(cfg.mean)) / min(cfg.std)
    for v in (a1, p1):
        assert torch.isfinite(v).all() and v.min() >= lo - 1e-5 and v.max() <= hi + 1e-5
    # the mask leaves a constant patch in the positive view: 15-45 % of its pixels
    masked = ((p1 - ta.normalize(torch.zeros(3), cfg)).abs().amax(dim=-1) < 1e-6).float()
    assert (masked.mean(dim=(1, 2)) > 0.1).all()
    # the 'gather' rotation: seeded like the default, bounded by its zero fill
    gcfg = ta.AugmentConfig(**CFG, rotation_method="gather")
    ag, pg = ta.dual_view_train_batch(u8, torch.Generator().manual_seed(5), gcfg)
    ag2, _ = ta.dual_view_train_batch(u8, torch.Generator().manual_seed(5), gcfg)
    assert ag.shape == (4, I, I, 3) and torch.equal(ag, ag2) and not torch.equal(ag, a1)
    for v in (ag, pg):
        assert torch.isfinite(v).all() and v.min() >= lo - 1e-5 and v.max() <= hi + 1e-5
    with pytest.raises(ValueError, match="rotation_method"):
        ta.dual_view_train_batch(u8, None, ta.AugmentConfig(**CFG, rotation_method="pil"))


@pytest.mark.parametrize("angle", [0.0, 7.5, -10.0, 90.0])
def test_rotate_gather_matches_jax(angle):
    """The 'gather' rotation against the JAX ``rotate_gather`` on a
    non-square image, within 1e-6 absolute on 0..1 pixels (the inverse-map
    coordinates' sin and cos may round differently; measured 1.2e-7).  The
    four-corner bilinear gather and its zero fill are the same arithmetic."""
    img = np.random.default_rng(9).random((2, 23, 37, 3)).astype(np.float32)
    out = ta.rotate_gather(torch.from_numpy(img), torch.full((2,), angle)).numpy()
    for i in range(2):
        ref = np.asarray(ja.rotate_gather(jnp.asarray(img[i]), jnp.float32(angle)))
        np.testing.assert_allclose(out[i], ref, rtol=0, atol=1e-6)
    if angle == 0.0:
        np.testing.assert_array_equal(out, img)
    else:  # corners rotate out of the frame and fill with 0
        assert (out[:, 0, 0] == 0).all()
