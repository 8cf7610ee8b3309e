"""Tests of the port that need a CUDA card: the CUDA C++ kernels against
their plain versions, the forward's in-kernel batch reduction, and a train
step through the kernels against the same step through the plain loss.
They skip without a card.  This file imports no JAX, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine import train as tt
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.models import NEG_INF, CilModel
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops import fused_loss
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils.platform import (
    use_full_f32,
)

pytestmark = pytest.mark.cuda

GRID = [(32, 100, 60), (64, 128, 128), (16, 7, 5), (13, 100, 60), (128, 100, 50),
        (64, 5000, 4321)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    use_full_f32()
    return torch.device("cuda")


def _masked_logits(b, width, active, seed=0):
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, width).astype(np.float32) * 3
    logits[:, active:] = NEG_INF
    labels = rng.randint(0, active, b).astype(np.int64)
    return torch.from_numpy(logits), torch.from_numpy(labels)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("smooth", [0.0, 0.1])
@pytest.mark.parametrize("b,width,active", GRID)
def test_kernels_match_plain(cuda, b, width, active, smooth, dtype):
    x, y = _masked_logits(b, width, active)
    x, y = x.to(cuda, dtype), y.to(cuda)
    na = torch.tensor([active], dtype=torch.int32, device=cuda)
    g = torch.tensor(0.5, device=cuda)
    launches = (fused_loss.FWD_LAUNCHES, fused_loss.BWD_LAUNCHES)
    per, lse, out = fused_loss.fused_ce_fwd(x, y, na, smooth, 1.0 / b)
    dx = fused_loss.fused_ce_bwd(x, y, na, lse, g, smooth, 1.0 / b)
    torch.cuda.synchronize()
    assert (fused_loss.FWD_LAUNCHES, fused_loss.BWD_LAUNCHES) == (launches[0] + 1,
                                                                  launches[1] + 1)
    ref_per, ref_lse, _ = fused_loss.fused_ce_fwd_plain(x, y, na, smooth, 1.0 / b)
    ref_dx = fused_loss.fused_ce_bwd_plain(x, y, na, ref_lse, g, smooth, 1.0 / b)
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-5)
    torch.testing.assert_close(per, ref_per, **tol)
    torch.testing.assert_close(lse, ref_lse, **tol)
    # The in-kernel reduction sums the kernel's own per-sample losses.
    torch.testing.assert_close(out, per.sum() * (1.0 / b), rtol=1e-6, atol=0.0)
    assert dx.dtype == dtype
    torch.testing.assert_close(dx.float(), ref_dx.float(), **tol)
    assert torch.all(dx[:, active:] == 0)


@pytest.mark.parametrize("b,width,active", [(128, 100, 50), (13, 100, 60), (64, 5000, 4321)])
def test_forward_reduction_is_bitwise_reproducible(cuda, b, width, active):
    x, y = _masked_logits(b, width, active, seed=4)
    x, y = x.to(cuda), y.to(cuda)
    na = torch.tensor([active], dtype=torch.int32, device=cuda)
    outs = [fused_loss.fused_ce_fwd(x, y, na, 0.1, 1.0 / b)[2] for _ in range(10)]
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


def test_train_step_through_kernels_matches_plain_loss(cuda):
    """One step with the kernel loss and one with the plain loss, from the
    same weights on the same batch, agree (the kernels' f32 sums differ from
    PyTorch's only in order)."""
    torch.manual_seed(0)
    base = CilModel("resnet20", 10).to(cuda)
    with torch.no_grad():
        base.fc.weight[:6].uniform_(-0.1, 0.1)
    x = torch.randn(8, 32, 32, 3, device=cuda)
    y = torch.randint(0, 6, (8,), device=cuda)
    results = []
    for fused in (False, True):
        model = CilModel("resnet20", 10).to(cuda)
        model.load_state_dict(base.state_dict())
        state = tt.TrainState(model, tt.sgd_init(model.parameters()),
                              torch.tensor([6], dtype=torch.int32, device=cuda),
                              torch.tensor([0], dtype=torch.int32, device=cuda))
        m = tt.train_step_on_batch(state, None, x, y, 0.1, 0.5, label_smoothing=0.1,
                                   kd_temperature=2.0, momentum=0.9, weight_decay=5e-4,
                                   use_pallas_loss=fused)
        results.append((float(m["loss"]), model.state_dict()))
    assert np.isclose(results[0][0], results[1][0], rtol=1e-5)
    for k, v in results[0][1].items():
        torch.testing.assert_close(results[1][1][k], v, rtol=1e-4, atol=1e-6)
