"""The port's host data path against the JAX package's: identical task splits,
arrays, loader batches and herding orders (all numpy, so exact), and the
augmentation ops per op when both sides get the same offsets and flip bits."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from a_pytorch_tutorial_to_class_incremental_learning_tpu import config as jcfg
from a_pytorch_tutorial_to_class_incremental_learning_tpu import data as jdata
from a_pytorch_tutorial_to_class_incremental_learning_tpu.data import augment as jaug
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch import config as tcfg
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch import data as tdata
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data import augment as taug
from test_torch_dist import two_intra_op_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_intra_op_threads")

RECIPES = [
    dict(data_set="synthetic10", num_bases=0, increment=5),
    dict(data_set="synthetic_hard128", num_bases=50, increment=10),
]


def _assert_task_equal(a, b):
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.y, b.y)
    np.testing.assert_array_equal(a.t, b.t)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("recipe", RECIPES, ids=lambda r: r["data_set"])
def test_scenarios_are_identical(recipe, train):
    js, jn = jdata.build_scenario(jcfg.CilConfig(**recipe), train=train)
    ts, tn = tdata.build_scenario(tcfg.CilConfig(**recipe), train=train)
    assert jn == tn and js.increments() == ts.increments()
    for t in range(len(js)):
        _assert_task_equal(js[t], ts[t])
    _assert_task_equal(js[: len(js)], ts[: len(ts)])


def test_loader_batches_are_identical():
    recipe = RECIPES[0]
    js, _ = jdata.build_scenario(jcfg.CilConfig(**recipe), train=True)
    ts, _ = tdata.build_scenario(tcfg.CilConfig(**recipe), train=True)
    jt, tt = js[1], ts[1]
    extra = js[0]
    jt.add_samples(extra.x[:7], extra.y[:7], None)
    tt.add_samples(extra.x[:7], extra.y[:7], None)
    pairs = [
        (jdata.train_batches(jt, 24, seed=11), tdata.train_batches(tt, 24, seed=11)),
        (jdata.eval_batches(jt, 24), tdata.eval_batches(tt, 24)),
        (jdata.sequential_batches(jt, 24), tdata.sequential_batches(tt, 24)),
    ]
    for jb, tb in pairs:
        jb, tb = list(jb), list(tb)
        assert len(jb) == len(tb) > 1
        for a, b in zip(jb, tb):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("method", ["barycenter", "random", "cluster"])
def test_herding_and_memory_are_identical(method):
    rng = np.random.RandomState(3)
    feats = rng.randn(60, 16).astype(np.float32)
    x = rng.randint(0, 256, (60, 4, 4, 3)).astype(np.uint8)
    y = np.repeat(np.arange(6), 10).astype(np.int64)
    jmem = jdata.RehearsalMemory(memory_size=24, herding_method=method, prefer_native=False)
    tmem = tdata.RehearsalMemory(memory_size=24, herding_method=method, prefer_native=False)
    jmem.add(x[:30], y[:30], None, feats[:30])
    tmem.add(x[:30], y[:30], None, feats[:30])
    jmem.add(x, y, None, feats)  # re-ranks the old classes, shrinks the quota
    tmem.add(x, y, None, feats)
    for a, b in zip(jmem.get(), tmem.get()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        jdata.herd_barycenter(feats, 7, allow_native=False),
        tdata.herd_barycenter(feats, 7, allow_native=False),
    )


def test_augment_config_matches():
    recipe = dict(data_set="synthetic_hard128", aa=None, color_jitter=0.0)
    j = jaug.AugmentConfig.from_config(jcfg.CilConfig(**recipe))
    t = taug.AugmentConfig.from_config(tcfg.CilConfig(**recipe))
    assert (j.crop_padding, j.hflip, j.mean, j.std) == (
        t.crop_padding, t.hflip, t.mean, t.std
    )


def _images(b=6, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (b, 32, 32, 3)).astype(np.float32)


def test_random_crop_matches_jax_per_image():
    imgs = _images()
    keys = jax.random.split(jax.random.PRNGKey(4), len(imgs))
    ref, oys, oxs = [], [], []
    for key, img in zip(keys, imgs):
        ref.append(np.asarray(jaug._random_crop(key, jnp.asarray(img), 4)))
        # The offsets the JAX op draws from its key, handed to the port.
        ky, kx = jax.random.split(key)
        oys.append(int(jax.random.randint(ky, (), 0, 9)))
        oxs.append(int(jax.random.randint(kx, (), 0, 9)))
    assert len(set(zip(oys, oxs))) > 1
    got = taug.random_crop(torch.from_numpy(imgs), torch.tensor(oys), torch.tensor(oxs), 4)
    np.testing.assert_array_equal(got.numpy(), np.stack(ref))


def test_random_flip_matches_jax_per_image():
    imgs = _images(b=8, seed=1)
    keys = jax.random.split(jax.random.PRNGKey(5), len(imgs))
    ref = [np.asarray(jaug._random_flip(k, jnp.asarray(im))) for k, im in zip(keys, imgs)]
    bits = torch.tensor([bool(jax.random.bernoulli(k)) for k in keys])
    assert 0 < int(bits.sum()) < len(bits)
    got = taug.random_flip(torch.from_numpy(imgs), bits)
    np.testing.assert_array_equal(got.numpy(), np.stack(ref))


def test_normalize_and_eval_preprocess_match_jax():
    cfg_j = jaug.AugmentConfig(mean=jcfg.IMAGENET_MEAN, std=jcfg.IMAGENET_STD)
    cfg_t = taug.AugmentConfig(mean=tcfg.IMAGENET_MEAN, std=tcfg.IMAGENET_STD)
    u8 = _images(seed=2).astype(np.uint8)
    ref = np.asarray(jaug.eval_preprocess(jnp.asarray(u8), cfg_j))
    got = taug.eval_preprocess(torch.from_numpy(u8), cfg_t).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    imgs = _images(seed=3)
    ref = np.asarray(jaug._normalize(jnp.asarray(imgs), cfg_j))
    np.testing.assert_allclose(taug.normalize(torch.from_numpy(imgs), cfg_t).numpy(), ref,
                               rtol=1e-6, atol=1e-6)


def test_train_augment_is_crop_flip_normalize_of_its_draws():
    """The batched pipeline equals the per-op composition of the offsets and
    bits its generator draws, and stays a zero-padded shifted copy."""
    cfg = taug.AugmentConfig(rand_augment=False, color_jitter=0.0)
    u8 = torch.from_numpy(_images(b=16, seed=6).astype(np.uint8))
    out = taug.train_augment(u8, cfg, torch.Generator().manual_seed(9))
    d = taug.draw_params(16, cfg, torch.Generator().manual_seed(9), (32, 32, 3))
    oy, ox, flip = d.oy, d.ox, d.flip
    ref = taug.normalize(taug.random_flip(taug.random_crop(u8.float(), oy, ox, 4), flip), cfg)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert 0 < int(flip.sum()) < 16 and int(oy.min()) >= 0 and int(oy.max()) <= 8
