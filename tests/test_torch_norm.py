"""The port's BatchNorm layers (``models/norm.py``) against flax
``nn.BatchNorm`` and the JAX package's ``GroupedBatchNorm``, in train mode.

In one process: ``GroupedBatchNorm`` with groups of 4 and 8 rows on a batch
of 16.  At two ``gloo`` ranks x 8 rows: global-batch BN (the statistics
all-reduced, forward and backward), groups of 4 (on one rank each, running
stats all-reduced) and a group of 16 that spans both ranks, each against
the JAX layer on the whole 16-row batch.

Tolerances: output and input gradient rtol 2e-4 / atol 2e-5 (those of the
port's model tests: f32 reductions in another order); running stats rtol
1e-5 / atol 1e-7; the parameter gradients summed over the ranks rtol 2e-4 /
atol 2e-5.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from flax import linen as nn

from a_pytorch_tutorial_to_class_incremental_learning_tpu.models.norm import (
    GroupedBatchNorm as JaxGroupedBatchNorm,
)
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.models import GroupedBatchNorm
from test_torch_dist import spawn_ranks, two_intra_op_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_intra_op_threads")

B, C, H, W = 16, 8, 6, 6
FWD = dict(rtol=2e-4, atol=2e-5)
STATS = dict(rtol=1e-5, atol=1e-7)


def _data(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "x": (rng.randn(B, H, W, C) * 2 + 0.5).astype(np.float32),  # NHWC, as in JAX
        "r": rng.randn(B, H, W, C).astype(np.float32),  # d(loss)/d(output)
        "scale": (1 + 0.3 * rng.randn(C)).astype(np.float32),
        "bias": (0.2 * rng.randn(C)).astype(np.float32),
        "mean": (0.1 * rng.randn(C)).astype(np.float32),
        "var": (1 + 0.2 * rng.rand(C)).astype(np.float32),
    }


def _jax_reference(d, group_size):
    """Output, input gradient, parameter gradients and new running stats
    of the JAX layer over the whole batch (``group_size`` 0: flax BN)."""
    if group_size:
        mod = JaxGroupedBatchNorm(group_size=group_size, momentum=0.9, epsilon=1e-5)
        call = lambda v, x: mod.apply(v, x, use_running_average=False, mutable=["batch_stats"])
    else:
        mod = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
        call = lambda v, x: mod.apply(v, x, mutable=["batch_stats"])
    stats = {"mean": jnp.asarray(d["mean"]), "var": jnp.asarray(d["var"])}

    def loss(params, x):
        y, mutated = call({"params": params, "batch_stats": stats}, x)
        return jnp.sum(y * d["r"]), (y, mutated["batch_stats"])

    params = {"scale": jnp.asarray(d["scale"]), "bias": jnp.asarray(d["bias"])}
    (_, (y, new)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(d["x"]))
    return {k: np.asarray(v) for k, v in dict(
        y=y, gx=gx, gscale=gp["scale"], gbias=gp["bias"], mean=new["mean"], var=new["var"],
    ).items()}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _port_layer(layer, d):
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(d["scale"]))
        layer.bias.copy_(torch.from_numpy(d["bias"]))
        layer.running_mean.copy_(torch.from_numpy(d["mean"]))
        layer.running_var.copy_(torch.from_numpy(d["var"]))
    return layer


@pytest.mark.parametrize("group_size", [4, 8])
def test_grouped_batchnorm_matches_jax(group_size):
    d = _data()
    ref = _jax_reference(d, group_size)
    layer = _port_layer(GroupedBatchNorm(C, group_size), d)
    x = _nchw(d["x"]).requires_grad_(True)
    y = layer(x, train=True)
    (y * _nchw(d["r"])).sum().backward()
    np.testing.assert_allclose(_nhwc(y), ref["y"], **FWD)
    np.testing.assert_allclose(_nhwc(x.grad), ref["gx"], **FWD)
    np.testing.assert_allclose(layer.weight.grad.numpy(), ref["gscale"], **FWD)
    np.testing.assert_allclose(layer.bias.grad.numpy(), ref["gbias"], **FWD)
    np.testing.assert_allclose(layer.running_mean.numpy(), ref["mean"], **STATS)
    np.testing.assert_allclose(layer.running_var.numpy(), ref["var"], **STATS)
    # Eval mode normalizes with the running stats, as the JAX layer does.
    eval_ref = JaxGroupedBatchNorm(group_size=group_size).apply(
        {"params": {"scale": d["scale"], "bias": d["bias"]},
         "batch_stats": {"mean": ref["mean"], "var": ref["var"]}},
        jnp.asarray(d["x"]), use_running_average=True)
    np.testing.assert_allclose(_nhwc(layer(_nchw(d["x"]), train=False)),
                               np.asarray(eval_ref), **FWD)


def test_group_that_does_not_divide_the_batch_raises():
    layer = GroupedBatchNorm(C, 3)
    with pytest.raises(ValueError, match="bn group size 3"):
        layer(torch.zeros(16, C, H, W), train=True)


_RANK = r"""
import os
import numpy as np
import torch
import torch.distributed as dist
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.models import make_norm
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.parallel import (
    data_axis, init_distributed_mode,
)

init_distributed_mode(os.environ["DIST_URL"], "cpu")
axis = data_axis((2, 1))
d = np.load("inputs.npz")
b = d["x"].shape[0] // axis.size
rows = slice(axis.rank * b, (axis.rank + 1) * b)
nchw = lambda a: torch.from_numpy(np.ascontiguousarray(a[rows].transpose(0, 3, 1, 2)))
out = {}
for g in (0, 4, 16):
    layer = make_norm(d["scale"].shape[0], g, axis)
    with torch.no_grad():
        for name, key in (("weight", "scale"), ("bias", "bias"),
                          ("running_mean", "mean"), ("running_var", "var")):
            getattr(layer, name).copy_(torch.from_numpy(d[key]))
    x = nchw(d["x"]).requires_grad_(True)
    y = layer(x, train=True)
    (y * nchw(d["r"])).sum().backward()
    for k, v in dict(y=y, gx=x.grad, gscale=layer.weight.grad, gbias=layer.bias.grad,
                     mean=layer.running_mean, var=layer.running_var).items():
        v = v.detach().numpy()
        out[f"{k}{g}"] = v.transpose(0, 2, 3, 1) if v.ndim == 4 else v
np.savez(f"out{axis.rank}.npz", **out)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("norm")
    np.savez(tmp / "inputs.npz", **_data(seed=1))
    spawn_ranks(tmp, _RANK)
    return [dict(np.load(tmp / f"out{r}.npz")) for r in range(2)]


@pytest.mark.parametrize("group_size", [0, 4, 16],
                         ids=["global", "groups-on-one-rank", "group-spans-ranks"])
def test_two_rank_batchnorm_matches_jax_on_the_global_batch(two_ranks, group_size):
    d = _data(seed=1)
    ref = _jax_reference(d, group_size)
    g = group_size
    for r, out in enumerate(two_ranks):
        rows = slice(r * 8, (r + 1) * 8)
        np.testing.assert_allclose(out[f"y{g}"], ref["y"][rows], **FWD)
        np.testing.assert_allclose(out[f"gx{g}"], ref["gx"][rows], **FWD)
        # The running stats are replicated: every rank holds the global ones.
        np.testing.assert_allclose(out[f"mean{g}"], ref["mean"], **STATS)
        np.testing.assert_allclose(out[f"var{g}"], ref["var"], **STATS)
        np.testing.assert_array_equal(out[f"mean{g}"], two_ranks[0][f"mean{g}"])
        np.testing.assert_array_equal(out[f"var{g}"], two_ranks[0][f"var{g}"])
    # Each rank's parameter gradient is its share; the shares sum to JAX's.
    for k in ("gscale", "gbias"):
        np.testing.assert_allclose(two_ranks[0][f"{k}{g}"] + two_ranks[1][f"{k}{g}"],
                                   ref[k], **FWD)
