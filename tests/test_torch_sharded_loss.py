"""The port's ``sharded_fused_masked_cross_entropy`` at two ``gloo`` ranks
against the JAX package's ``sharded_fused_masked_cross_entropy`` on a
``(2, 1)`` mesh of virtual CPU devices, its Pallas kernel in interpret mode.

Each rank holds one stripe of the batch and runs the kernel's plain version
(its tensors lie on the CPU).  The value is the global mean on both ranks,
rtol 1e-5; each stripe's ``dlogits`` is JAX's gradient for those rows, rtol
1e-4 / atol 1e-7 (the tolerances of ``tests/test_ops.py``: f32 sums taken in
another order); masked columns are exactly 0.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from a_pytorch_tutorial_to_class_incremental_learning_tpu.ops import (
    sharded_fused_masked_cross_entropy as jax_sharded,
)
from a_pytorch_tutorial_to_class_incremental_learning_tpu.parallel.mesh import make_mesh
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.models import NEG_INF
from test_torch_dist import spawn_ranks

CASES = [(b, w, active, s) for b, w, active in ((16, 128, 60), (32, 100, 60))
         for s in (0.0, 0.1)]

_RANK = r"""
import json, os
import numpy as np
import torch
import torch.distributed as dist
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops import fused_loss
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.parallel import (
    data_axis, init_distributed_mode,
)

init_distributed_mode(os.environ["DIST_URL"], "cpu")
axis = data_axis((2, 1))
inp = np.load("inputs.npz")
out = {}
for i in range(int(inp["n"])):
    logits, labels = inp[f"logits{i}"], inp[f"labels{i}"]
    b = logits.shape[0] // axis.size
    rows = slice(axis.rank * b, (axis.rank + 1) * b)
    x = torch.from_numpy(logits[rows]).requires_grad_(True)
    loss = fused_loss.sharded_fused_masked_cross_entropy(
        axis.group, x, torch.from_numpy(labels[rows]),
        torch.tensor([int(inp[f"active{i}"])], dtype=torch.int32), float(inp[f"smooth{i}"]),
    )
    (grad,) = torch.autograd.grad(loss, x)
    out[f"value{i}"] = loss.detach().numpy()
    out[f"grad{i}"] = grad.numpy()
# CPU tensors run the plain versions: no kernel launch is counted.
out["launches"] = np.array([fused_loss.FWD_LAUNCHES, fused_loss.BWD_LAUNCHES])
np.savez(f"out{axis.rank}.npz", **out)
dist.destroy_process_group()
"""


def _inputs(i, b, w, active):
    rng = np.random.RandomState(10 + i)
    logits = (rng.randn(b, w) * 3).astype(np.float32)
    logits[:, active:] = NEG_INF
    return logits, rng.randint(0, active, b).astype(np.int64)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_loss")
    arrays = {"n": np.array(len(CASES))}
    for i, (b, w, active, s) in enumerate(CASES):
        arrays[f"logits{i}"], arrays[f"labels{i}"] = _inputs(i, b, w, active)
        arrays[f"active{i}"], arrays[f"smooth{i}"] = np.array(active), np.array(s)
    np.savez(tmp / "inputs.npz", **arrays)
    spawn_ranks(tmp, _RANK)
    return [dict(np.load(tmp / f"out{r}.npz")) for r in range(2)]


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"B{b}-W{w}-a{a}-s{s}" for b, w, a, s in CASES])
def test_sharded_loss_matches_jax(ranks, case):
    b, w, active, s = CASES[case]
    logits, labels = _inputs(case, b, w, active)
    mesh = make_mesh((2, 1), devices=jax.devices()[:2])
    na, lab = jnp.int32(active), jnp.asarray(labels)
    ref, ref_grad = jax.value_and_grad(
        lambda x: jax_sharded(mesh, x, lab, na, s, interpret=True)
    )(jnp.asarray(logits))
    ref_grad = np.asarray(ref_grad)
    stripe = b // 2
    for r, out in enumerate(ranks):
        assert np.isclose(float(out[f"value{case}"]), float(ref), rtol=1e-5)
        got = out[f"grad{case}"]
        assert got.shape == (stripe, w)
        np.testing.assert_allclose(got, ref_grad[r * stripe:(r + 1) * stripe],
                                   rtol=1e-4, atol=1e-7)
        assert np.all(got[:, active:] == 0)
        assert list(out["launches"]) == [0, 0]
    assert np.all(ref_grad[:, active:] == 0)
    # Both ranks hold the same global value.
    assert ranks[0][f"value{case}"] == ranks[1][f"value{case}"]
