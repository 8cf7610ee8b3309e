"""The port's fused masked-CE (plain version on CPU tensors) against the JAX
package's Pallas kernel in interpret mode and its XLA ``cross_entropy``.

Tolerances: values rtol 1e-5 and gradients rtol 1e-4 / atol 1e-7, those of
``tests/test_ops.py`` (f32 sums taken in another order); masked-column
gradients must be exactly 0 on both sides.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from a_pytorch_tutorial_to_class_incremental_learning_tpu.engine.losses import (
    cross_entropy as jax_cross_entropy,
)
from a_pytorch_tutorial_to_class_incremental_learning_tpu.ops import (
    fused_masked_cross_entropy as jax_fused,
)
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.models import NEG_INF
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops import (
    fused_ce_fwd,
    fused_masked_cross_entropy,
)
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops import fused_loss
from test_torch_dist import two_intra_op_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_intra_op_threads")

GRID = [(32, 100, 60), (64, 128, 128), (16, 7, 5)]


def _masked_logits(b, width, active, seed=0):
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, width).astype(np.float32) * 3
    logits[:, active:] = NEG_INF
    labels = rng.randint(0, active, b).astype(np.int64)
    return logits, labels


def _na(n):
    return torch.tensor([n], dtype=torch.int32)


def _port_value_and_grad(logits, labels, active, smooth, dtype=torch.float32):
    x = torch.from_numpy(logits).to(dtype).requires_grad_(True)
    loss = fused_masked_cross_entropy(x, torch.from_numpy(labels), _na(active), smooth)
    (grad,) = torch.autograd.grad(loss, x)
    return loss.detach(), grad


@pytest.mark.parametrize("smooth", [0.0, 0.1])
@pytest.mark.parametrize("b,width,active", GRID)
def test_value_matches_jax(smooth, b, width, active):
    logits, labels = _masked_logits(b, width, active)
    got, _ = _port_value_and_grad(logits, labels, active, smooth)
    na = jnp.int32(active)
    ref_kernel = jax_fused(jnp.asarray(logits), jnp.asarray(labels), na, smooth, True)
    ref_xla = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), na, smooth)
    assert np.isclose(float(got), float(ref_kernel), rtol=1e-5)
    assert np.isclose(float(got), float(ref_xla), rtol=1e-5)


@pytest.mark.parametrize("smooth", [0.0, 0.1])
@pytest.mark.parametrize("b,width,active", GRID)
def test_gradient_matches_jax(smooth, b, width, active):
    logits, labels = _masked_logits(b, width, active, seed=3)
    _, got = _port_value_and_grad(logits, labels, active, smooth)
    na = jnp.int32(active)
    lab = jnp.asarray(labels)
    ref_kernel = jax.grad(lambda x: jax_fused(x, lab, na, smooth, True))(jnp.asarray(logits))
    ref_xla = jax.grad(lambda x: jax_cross_entropy(x, lab, na, smooth))(jnp.asarray(logits))
    for ref in (ref_kernel, ref_xla):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-7)
    assert np.all(got.numpy()[:, active:] == 0)
    assert np.all(np.asarray(ref_kernel)[:, active:] == 0)


@pytest.mark.parametrize("b", [13, 320, 384])
def test_odd_batch_sizes(b):
    logits, labels = _masked_logits(b, 100, 60, seed=b)
    got, grad = _port_value_and_grad(logits, labels, 60, 0.1)
    ref = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), jnp.int32(60), 0.1)
    assert np.isclose(float(got), float(ref), rtol=1e-5)
    assert np.all(grad.numpy()[:, 60:] == 0)


def test_num_active_tensor_serves_two_counts_without_host_reads(monkeypatch):
    """num_active stays a tensor: one code path, two task sizes, and the
    wrapper never reads it back to the host (no .item()/int())."""
    cases = [_masked_logits(16, 100, 50, seed=5) + (50,),
             _masked_logits(16, 100, 30, seed=6) + (30,)]

    def refuse(*_a, **_k):
        raise AssertionError("host read inside the fused loss")

    monkeypatch.setattr(torch.Tensor, "item", refuse)
    monkeypatch.setattr(torch.Tensor, "tolist", refuse)
    monkeypatch.setattr(torch.Tensor, "__int__", refuse)
    got = [_port_value_and_grad(lg, lb, na, 0.1) for lg, lb, na in cases]
    monkeypatch.undo()
    for (lg, lb, na), (val, grad) in zip(cases, got):
        ref = jax_cross_entropy(jnp.asarray(lg), jnp.asarray(lb), jnp.int32(na), 0.1)
        assert np.isclose(float(val), float(ref), rtol=1e-5)
        assert np.all(grad.numpy()[:, na:] == 0)
    assert float(got[0][0]) != float(got[1][0])


def test_bf16_logits_accumulate_in_f32():
    logits, labels = _masked_logits(32, 100, 60, seed=9)
    x16 = torch.from_numpy(logits).bfloat16()
    val, grad = _port_value_and_grad(logits, labels, 60, 0.1, dtype=torch.bfloat16)
    ref = jax_cross_entropy(
        jnp.asarray(x16.float().numpy()), jnp.asarray(labels), jnp.int32(60), 0.1
    )
    assert val.dtype == torch.float32 and grad.dtype == torch.bfloat16
    assert np.isclose(float(val), float(ref), rtol=1e-5)
    assert torch.all(grad[:, 60:] == 0)


@pytest.mark.parametrize("smooth", [0.0, 0.1])
@pytest.mark.parametrize("b,width,active", GRID)
def test_forward_returns_the_scaled_batch_sum(smooth, b, width, active):
    """``out`` is ``scale · Σ per``: the batch mean at ``1/B``, a rank's
    share of the global mean at ``1/(B·N)``."""
    logits, labels = _masked_logits(b, width, active, seed=7)
    x, y = torch.from_numpy(logits), torch.from_numpy(labels)
    for scale in (1.0 / b, 1.0 / (4 * b), 1.0):
        per, lse, out = fused_ce_fwd(x, y, _na(active), smooth, scale)
        assert per.shape == lse.shape == (b,) and out.shape == ()
        assert out.dtype == per.dtype == lse.dtype == torch.float32
        assert float(out) == float(per.sum() * scale)
    np.testing.assert_allclose(float(fused_ce_fwd(x, y, _na(active), smooth, 1.0 / b)[2]),
                               float(per.mean()), rtol=1e-6)


def test_cpu_calls_count_no_kernel_launch():
    before = (fused_loss.FWD_LAUNCHES, fused_loss.BWD_LAUNCHES)
    logits, labels = _masked_logits(8, 10, 5)
    _port_value_and_grad(logits, labels, 5, 0.0)
    assert (fused_loss.FWD_LAUNCHES, fused_loss.BWD_LAUNCHES) == before


@pytest.mark.parametrize(
    "bad",
    ["labels_int32", "na_int64", "na_two", "logits_1d", "logits_int", "strided"],
)
def test_wrapper_rejects_what_it_does_not_take(bad):
    logits, labels = _masked_logits(8, 10, 5)
    x, y, na = torch.from_numpy(logits), torch.from_numpy(labels), _na(5)
    if bad == "labels_int32":
        y = y.int()
    elif bad == "na_int64":
        na = na.long()
    elif bad == "na_two":
        na = torch.tensor([5, 5], dtype=torch.int32)
    elif bad == "logits_1d":
        x = x[0]
    elif bad == "logits_int":
        x = x.int()
    elif bad == "strided":
        x = x.t()
    with pytest.raises((ValueError, TypeError)):
        fused_ce_fwd(x, y, na, 0.0, 1.0 / 8)

