"""The port's augmentation against the JAX package's ``data/augment.py``.

Both sides get the same uint8 images (numpy, from a seed) and the same
random parameters: the per-op tests hand each JAX function one image at a
time (vmapped) and the port's batched function the whole batch; the
pipeline tests draw JAX's own parameters here, splitting the keys as
``train_augment`` / ``_augment_one`` / ``_rand_augment`` /
``_random_erasing`` do, and hand them to the port's ``augment``.

Tolerances: the integer ops (equalize, invert, posterize, solarize,
solarize-add) and every warp by an identity matrix are bitwise equal; the
other ops may differ by 1 LSB in the uint8 domain, where a float sum in
another order lands on a half (the grey level, the warps' tap sums);
after normalization, rtol 1e-6 where the uint8 levels agree.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from a_pytorch_tutorial_to_class_incremental_learning_tpu import config as jcfg
from a_pytorch_tutorial_to_class_incremental_learning_tpu.data import augment as jaug
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch import config as tcfg
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data import augment as taug
from test_torch_dist import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

INTEGER_OPS = (1, 2, 4, 5, 6)  # Equalize, Invert, Posterize, Solarize, SolarizeAdd
MAGS = (0.0, 4.5, 9.0, 10.0)
SIGNS = (1.0, -1.0)


def _images(b, seed):
    """``b`` random images, then a constant image (autocontrast's ``hi ==
    lo``, equalize's ``step == 0``) and a two-level image."""
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (b, 32, 32, 3)).astype(np.float32)
    const = np.full((1, 32, 32, 3), 77, np.float32)
    two = np.where(rng.rand(1, 32, 32, 1) < 0.3, 200.0, 31.0).repeat(3, -1).astype(np.float32)
    return np.concatenate([imgs, const, two])


@functools.lru_cache(maxsize=None)
def _jax_ra_apply(interpolation):
    fn = functools.partial(jaug._ra_apply, size=32, interpolation=interpolation)
    return jax.jit(jax.vmap(lambda im, op, mag, sign: fn(im, op, mag, sign)))


@pytest.mark.parametrize("interpolation", ["bilinear", "bicubic"])
@pytest.mark.parametrize("op", range(taug.NUM_RA_OPS), ids=lambda i: taug.RA_OPS[i])
def test_ra_op_matches_jax(op, interpolation):
    """One op at magnitudes {0, 4.5, 9, 10} x sign ±1, on random images, a
    constant image and a two-level image."""
    base = _images(3, seed=op)
    grid = [(m, s) for m in MAGS for s in SIGNS]
    imgs = np.concatenate([base] * len(grid))
    mags = np.repeat([m for m, _ in grid], len(base)).astype(np.float32)
    signs = np.repeat([s for _, s in grid], len(base)).astype(np.float32)
    ops = np.full(len(imgs), op, np.int32)
    ref = np.asarray(_jax_ra_apply(interpolation)(imgs, ops, mags, signs))
    got = taug.ra_apply(torch.from_numpy(imgs), torch.from_numpy(ops).long(),
                        torch.from_numpy(mags), torch.from_numpy(signs), 32,
                        interpolation).numpy()
    diff = np.abs(got - ref)
    if op in INTEGER_OPS:
        np.testing.assert_array_equal(got, ref)
    else:
        assert diff.max() <= 1.0, f"max |diff| {diff.max()}"
    if op in taug.GEOMETRIC_OPS:  # magnitude 0: the identity warp
        ident = mags == 0.0
        np.testing.assert_array_equal(got[ident], ref[ident])
        np.testing.assert_array_equal(got[ident], imgs[ident])
    assert np.all(got == np.round(got)) and got.min() >= 0 and got.max() <= 255


@pytest.mark.parametrize("kernel", ["bilinear", "bicubic"])
def test_affine_matches_jax_on_random_matrices(kernel):
    imgs = _images(4, seed=20)
    rng = np.random.RandomState(21)
    mats = np.zeros((len(imgs), 2, 3), np.float32)
    for i in range(len(imgs)):
        a = rng.uniform(-0.5, 0.5)
        sh = rng.uniform(-0.3, 0.3)
        mats[i, :, :2] = [[np.cos(a), -np.sin(a) + sh], [np.sin(a), np.cos(a)]]
        mats[i, :, 2] = rng.uniform(-6, 6, 2)
    warp = jax.jit(jax.vmap(functools.partial(jaug._affine, kernel=kernel)))
    ref = np.asarray(warp(imgs, mats))
    got = taug.affine(torch.from_numpy(imgs), torch.from_numpy(mats), kernel).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)
    rounded = np.abs(np.asarray(jaug._round_u8(ref)) - taug.round_u8(torch.from_numpy(got)).numpy())
    assert rounded.max() <= 1.0
    assert np.mean(np.abs(got - jaug.FILL) < 1e-3) > 0.01  # some pixels fell outside


def test_cubic_weight_matches_jax():
    t = np.linspace(-2.5, 2.5, 101).astype(np.float32)
    np.testing.assert_array_equal(taug.cubic_weight(torch.from_numpy(t)).numpy(),
                                  np.asarray(jaug._cubic_weight(jnp.asarray(t))))


@pytest.mark.parametrize("aa", ["rand-m9-mstd0.5-inc1", "rand-n3-m5-p0.3", "rand-m7-w0",
                                None, "none"])
def test_parse_rand_augment_matches_jax(aa):
    assert taug.parse_rand_augment(aa) == jaug.parse_rand_augment(aa)


@pytest.mark.parametrize("aa,exc", [("rand-m9-inc0", NotImplementedError),
                                    ("augmix", NotImplementedError),
                                    ("rand-q3", ValueError)])
def test_parse_rand_augment_raises_as_jax(aa, exc):
    with pytest.raises(exc):
        jaug.parse_rand_augment(aa)
    with pytest.raises(exc):
        taug.parse_rand_augment(aa)


@pytest.mark.parametrize("recipe", [
    dict(),
    dict(aa="rand-n3-m5-p0.3", ra_interpolation="random", reprob=0.25, remode="rand",
         recount=2),
    dict(data_set="CIFAR", aa=None, color_jitter=0.2),
    dict(data_set="mnist", input_size=28),
])
def test_augment_config_from_config_matches_jax(recipe):
    j = jaug.AugmentConfig.from_config(jcfg.CilConfig(**recipe))
    t = taug.AugmentConfig.from_config(tcfg.CilConfig(**recipe))
    assert {f: getattr(t, f) for f in t.__dataclass_fields__} == \
        {f: getattr(j, f) for f in t.__dataclass_fields__}
    assert set(j.__dataclass_fields__) == set(t.__dataclass_fields__)


# --------------------------------------------------------------------------- #
# The whole pipeline on JAX's own draws
# --------------------------------------------------------------------------- #


def _jax_draws(key, b, cfg, shape=(32, 32, 3)):
    """The parameters ``jaug.train_augment(key, ·, cfg)`` draws for ``b``
    images of ``shape`` (H, W, C), as the port's ``Draws``."""
    h, w, c = shape
    cols = {k: [] for k in ("oy", "ox", "flip", "ra_op", "ra_mag", "ra_sign", "ra_apply",
                            "ra_bicubic", "jitter", "erase_do", "erase_area",
                            "erase_log_ratio", "erase_oy", "erase_ox", "erase_noise")}
    for k in jax.random.split(key, b):
        kcrop, kflip, kra, kerase = jax.random.split(k, 4)
        ky, kx = jax.random.split(kcrop)
        cols["oy"].append(int(jax.random.randint(ky, (), 0, 2 * cfg.crop_padding + 1)))
        cols["ox"].append(int(jax.random.randint(kx, (), 0, 2 * cfg.crop_padding + 1)))
        if cfg.hflip:
            cols["flip"].append(bool(jax.random.bernoulli(kflip)))
        if cfg.rand_augment:
            rk, row = kra, {n: [] for n in ("op", "mag", "sign", "apply", "bicubic")}
            for i in range(cfg.ra_num_ops):
                kop, kmag, ksign, kprob, rk = jax.random.split(jax.random.fold_in(rk, i), 5)
                row["bicubic"].append(bool(jax.random.bernoulli(jax.random.fold_in(kprob, 1))))
                row["op"].append(int(jax.random.randint(kop, (), 0, jaug.NUM_RA_OPS)))
                row["mag"].append(float(jnp.clip(
                    cfg.ra_magnitude + cfg.ra_mag_std * jax.random.normal(kmag), 0.0, 10.0)))
                row["sign"].append(1.0 if bool(jax.random.bernoulli(ksign)) else -1.0)
                row["apply"].append(bool(jax.random.bernoulli(kprob, cfg.ra_prob)))
            for n in row:
                cols["ra_" + n].append(row[n])
        elif cfg.color_jitter > 0:
            lo, hi = max(0.0, 1.0 - cfg.color_jitter), 1.0 + cfg.color_jitter
            cols["jitter"].append([float(jax.random.uniform(kk, (), minval=lo, maxval=hi))
                                   for kk in jax.random.split(kra, 3)])
        if cfg.reprob > 0:
            ek, row = kerase, {n: [] for n in ("do", "area", "log_ratio", "oy", "ox", "noise")}
            for i in range(cfg.recount):
                kp, karea, kar, ky, kx, knoise, ek = jax.random.split(
                    jax.random.fold_in(ek, i), 7)
                row["do"].append(bool(jax.random.bernoulli(kp, cfg.reprob)))
                row["area"].append(float(h * w * jax.random.uniform(
                    karea, (), minval=0.02, maxval=1 / 3)))
                row["log_ratio"].append(float(jax.random.uniform(
                    kar, (), minval=jnp.log(0.3), maxval=jnp.log(10 / 3))))
                row["oy"].append(int(jax.random.randint(ky, (), 0, h)))
                row["ox"].append(int(jax.random.randint(kx, (), 0, w)))
                noise = (h, w, c) if cfg.remode == "pixel" else (c,)
                row["noise"].append(np.asarray(jax.random.normal(knoise, noise, jnp.float32)))
            for n in row:
                cols["erase_" + n].append(row[n])
    dtypes = {"flip": torch.bool, "ra_apply": torch.bool, "ra_bicubic": torch.bool,
              "erase_do": torch.bool, "ra_op": torch.int64, "oy": torch.int64,
              "ox": torch.int64, "erase_oy": torch.int64, "erase_ox": torch.int64}
    out = {}
    for name, v in cols.items():
        if v and not (name == "ra_bicubic" and cfg.ra_interpolation != "random") \
                and not (name == "erase_noise" and cfg.remode == "const"):
            out[name] = torch.as_tensor(np.asarray(v), dtype=dtypes.get(name, torch.float32))
    return taug.Draws(**out)


def _configs(**kw):
    mean, std = jcfg.IMAGENET_MEAN, jcfg.IMAGENET_STD
    return (jaug.AugmentConfig(mean=mean, std=std, **kw),
            taug.AugmentConfig(mean=mean, std=std, **kw))


def _u8_levels(x, cfg):
    """Normalized images back on the uint8 scale."""
    return x * (np.asarray(cfg.std, np.float32) * 255) + np.asarray(cfg.mean, np.float32) * 255


def _assert_pipeline_close(got, ref, cfg):
    """≤ 1 LSB on the uint8 scale; rtol 1e-6 where the levels agree."""
    lg, lr = np.round(_u8_levels(got, cfg)), np.round(_u8_levels(ref, cfg))
    assert np.abs(lg - lr).max() <= 1.0
    same = lg == lr
    assert same.mean() > 0.99
    np.testing.assert_allclose(got[same], ref[same], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("interpolation", ["bilinear", "bicubic", "random"])
def test_train_augment_randaugment_matches_jax(interpolation):
    jc, tc = _configs(ra_interpolation=interpolation)
    u8 = _images(14, seed=30).astype(np.uint8)
    key = jax.random.PRNGKey(31)
    ref = np.asarray(jaug.train_augment(key, jnp.asarray(u8), jc))
    draws = _jax_draws(key, len(u8), jc)
    assert draws.ra_apply.any() and not draws.ra_apply.all()
    got = taug.augment(torch.from_numpy(u8), draws, tc).numpy()
    _assert_pipeline_close(got, ref, tc)


def test_train_augment_color_jitter_matches_jax():
    jc, tc = _configs(rand_augment=False, color_jitter=0.4)
    u8 = _images(14, seed=32).astype(np.uint8)
    key = jax.random.PRNGKey(33)
    ref = np.asarray(jaug.train_augment(key, jnp.asarray(u8), jc))
    draws = _jax_draws(key, len(u8), jc)
    got = taug.augment(torch.from_numpy(u8), draws, tc).numpy()
    _assert_pipeline_close(got, ref, tc)
    no_jitter = taug.augment(torch.from_numpy(u8), draws, _configs(rand_augment=False,
                                                                   color_jitter=0.0)[1])
    assert np.abs(got - no_jitter.numpy()).max() > 0.1  # the jitter did something


@pytest.mark.parametrize("remode", ["pixel", "rand", "const"])
def test_random_erasing_matches_jax(remode):
    jc, tc = _configs(rand_augment=False, color_jitter=0.0, reprob=0.5, remode=remode,
                      recount=2)
    u8 = _images(14, seed=34).astype(np.uint8)
    key = jax.random.PRNGKey(35)
    ref = np.asarray(jaug.train_augment(key, jnp.asarray(u8), jc))
    draws = _jax_draws(key, len(u8), jc)
    assert draws.erase_do.any() and not draws.erase_do.all()
    got = taug.augment(torch.from_numpy(u8), draws, tc).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_color_jitter_op_matches_jax():
    imgs = _images(5, seed=36)
    factors = np.random.RandomState(37).uniform(0.6, 1.4, (len(imgs), 3)).astype(np.float32)

    def one(img, f):  # _color_jitter with the factors given instead of drawn
        img = jaug._round_u8(jaug._brightness(img, f[0]))
        img = jaug._round_u8(jaug._contrast(img, f[1]))
        return jaug._round_u8(jaug._color(img, f[2]))

    ref = np.asarray(jax.jit(jax.vmap(one))(imgs, factors))
    got = taug.color_jitter(torch.from_numpy(imgs), torch.from_numpy(factors)).numpy()
    assert np.abs(got - ref).max() <= 1.0


# --------------------------------------------------------------------------- #
# The port's own draws
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("recipe", [
    dict(),
    dict(ra_interpolation="random", reprob=0.5, recount=2),
    dict(rand_augment=False, color_jitter=0.4, reprob=0.5, remode="rand"),
])
def test_train_augment_in_two_stripes_equals_one_global_batch(recipe):
    """Two processes, each with its stripe and a generator seeded alike,
    augment exactly as one process does over the global batch."""
    cfg = taug.AugmentConfig(**recipe)
    u8 = torch.from_numpy(_images(6, seed=40).astype(np.uint8))
    whole = taug.train_augment(u8, cfg, torch.Generator().manual_seed(41))
    parts = [taug.train_augment(u8[r * 4:(r + 1) * 4], cfg,
                                torch.Generator().manual_seed(41), r, 2) for r in range(2)]
    torch.testing.assert_close(torch.cat(parts), whole, rtol=0, atol=0)


def test_draws_follow_the_config():
    cfg = taug.AugmentConfig(ra_num_ops=3, ra_magnitude=9.0, ra_mag_std=0.5, ra_prob=0.3)
    d = taug.draw_params(4000, cfg, torch.Generator().manual_seed(0), (32, 32, 3))
    assert d.ra_op.shape == (4000, 3) and int(d.ra_op.min()) == 0 and int(d.ra_op.max()) == 14
    assert float(d.ra_mag.min()) >= 0 and float(d.ra_mag.max()) <= 10
    assert abs(float(d.ra_mag.mean()) - 9.0) < 0.05
    assert abs(float(d.ra_apply.float().mean()) - 0.3) < 0.02
    assert set(d.ra_sign.unique().tolist()) == {-1.0, 1.0}
    assert d.jitter is None and d.erase_do is None and d.ra_bicubic is None
    d = taug.draw_params(8, taug.AugmentConfig(rand_augment=False, color_jitter=0.4),
                         torch.Generator().manual_seed(0), (32, 32, 3))
    assert d.ra_op is None and float(d.jitter.min()) >= 0.6 and float(d.jitter.max()) <= 1.4


# --------------------------------------------------------------------------- #
# The CLI's flags
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("flags", [[], ["--precision", "f32"], ["--precision", "bf16_all"],
                                   ["--precision", "bf16_selective"],
                                   ["--compute_dtype", "bfloat16"],
                                   ["--reprob", "0.25", "--remode", "const", "--recount", "2"],
                                   ["--aa", "none"], ["--ra_interpolation", "random"]])
def test_check_supported_accepts_the_parsers_augmentation_and_presets(flags):
    """The parser's augmentation flags and precision presets make a config,
    its ``AugmentConfig`` and its policy (no slice check stands in the way
    since the port runs every flag)."""
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops.precision import (
        policy_from_config,
    )

    args = tcfg.get_args_parser().parse_args(["--data_set", "synthetic10", *flags])
    cfg = tcfg.config_from_args(args)
    aug = taug.AugmentConfig.from_config(cfg)
    assert aug.rand_augment == (cfg.aa is not None)
    assert (aug.reprob, aug.remode, aug.recount) == (cfg.reprob, cfg.remode, cfg.recount)
    assert aug.ra_interpolation == cfg.ra_interpolation
    alias = {"float32": "f32", "bfloat16": "bf16_all"}[cfg.compute_dtype]
    assert policy_from_config(cfg).name == (cfg.precision or alias)


@pytest.mark.parametrize("aa", ["augmix-m5-w4", "rand-m9-inc0"])
def test_unsupported_aa_raises_as_jax(aa):
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.main import build_trainer

    with pytest.raises(NotImplementedError):
        jaug.AugmentConfig.from_config(jcfg.CilConfig(data_set="synthetic10", aa=aa))
    with pytest.raises(NotImplementedError):
        build_trainer(["--platform", "cpu", "--data_set", "synthetic10", "--num_bases", "0",
                       "--increment", "5", "--aa", aa])
