"""The port's losses and accuracy against the JAX package's, in value and
gradient, on identical numpy inputs (f32; rtol 1e-5 for values, rtol 1e-4 /
atol 1e-7 for gradients: sums taken in another order)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from a_pytorch_tutorial_to_class_incremental_learning_tpu.engine import losses as jl
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine import losses as tl
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.models import NEG_INF


def _logits(b, width, active, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, width).astype(np.float32) * 3
    x[:, active:] = NEG_INF
    y = rng.randint(0, active, b).astype(np.int64)
    return x, y


@pytest.mark.parametrize("width,known,active", [(100, 50, 60), (10, 5, 10), (7, 3, 5)])
def test_soft_target_kd_value_and_gradient(width, known, active):
    s, _ = _logits(16, width, active, seed=width)
    t, _ = _logits(16, width, known, seed=width + 1)
    ref, ref_grad = jax.value_and_grad(
        lambda x: jl.soft_target_kd(x, jnp.asarray(t), jnp.int32(known), 2.0)
    )(jnp.asarray(s))
    xs = torch.from_numpy(s).requires_grad_(True)
    got = tl.soft_target_kd(xs, torch.from_numpy(t), torch.tensor([known], dtype=torch.int32), 2.0)
    (grad,) = torch.autograd.grad(got, xs)
    got = got.detach()
    assert np.isclose(float(got), float(ref), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), rtol=1e-4, atol=1e-7)
    assert np.all(grad.numpy()[:, known:] == 0)


@pytest.mark.parametrize("smooth", [0.0, 0.1])
def test_weighted_cross_entropy_value_and_gradient(smooth):
    x, y = _logits(12, 20, 15, seed=4)
    w = np.random.RandomState(5).randint(0, 2, 12).astype(np.float32)
    ref, ref_grad = jax.value_and_grad(
        lambda a: jl.cross_entropy(a, jnp.asarray(y), jnp.int32(15), smooth, jnp.asarray(w))
    )(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tl.cross_entropy(xt, torch.from_numpy(y), torch.tensor([15], dtype=torch.int32),
                           smooth, torch.from_numpy(w))
    (grad,) = torch.autograd.grad(got, xt)
    got = got.detach()
    assert np.isclose(float(got), float(ref), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("width,active", [(100, 60), (10, 3), (4, 4)])
def test_topk_correct_and_accuracy(width, active):
    x, y = _logits(32, width, active, seed=width + active)
    y[::3] = np.argmax(x[::3, :active], axis=1)  # some top-1 hits
    w = np.random.RandomState(7).rand(32).astype(np.float32)
    for k in (1, 5):
        ref = jl.topk_correct(jnp.asarray(x), jnp.asarray(y), k, jnp.asarray(w))
        got = tl.topk_correct(torch.from_numpy(x), torch.from_numpy(y), k, torch.from_numpy(w))
        assert np.isclose(float(got), float(ref), rtol=1e-6)
    ref_acc = jl.accuracy(jnp.asarray(x), jnp.asarray(y), topk=(1, 5))
    got_acc = tl.accuracy(torch.from_numpy(x), torch.from_numpy(y), topk=(1, 5))
    for g, r in zip(got_acc, ref_acc):
        assert np.isclose(float(g), float(r), rtol=1e-6)
