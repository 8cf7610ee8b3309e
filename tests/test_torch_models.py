"""The port's models against the JAX package's on identical weights.

JAX variables go through ``from_jax_variables`` into the port.  Forwards
agree at rtol 2e-4 / atol 2e-5, the tolerances of ``tests/test_models.py``:
the two frameworks sum the convolutions in another order.  BN running
statistics must match after a train-mode step, which holds only because the
port folds the biased batch variance in, as flax does.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from flax.core import unfreeze

from a_pytorch_tutorial_to_class_incremental_learning_tpu import models as jm
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch import models as tm
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils import jax_random
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils.jax_weights import (
    from_jax_variables,
)
from test_torch_dist import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

RTOL, ATOL = 2e-4, 2e-5


def _to_jax(state_dict):
    """Inverse of ``from_jax_variables`` for a CilModel state_dict."""
    params, stats = {}, {}
    for key, v in state_dict.items():
        v = v.detach().numpy()
        *path, leaf = key.split(".")
        if path == ["fc"]:
            params["fc_" + {"weight": "kernel", "bias": "bias"}[leaf]] = (
                v.T if leaf == "weight" else v
            )
            continue
        p = params
        s = stats
        for name in path:
            p = p.setdefault(name, {})
            s = s.setdefault(name, {})
        if leaf == "weight" and v.ndim == 4:
            p["kernel"] = v.transpose(2, 3, 1, 0)
        elif leaf == "weight":
            p["scale"] = v
        elif leaf == "bias":
            p["bias"] = v
        elif leaf == "running_mean":
            s["mean"] = v
        elif leaf == "running_var":
            s["var"] = v

    def prune(d):
        if not isinstance(d, dict):
            return d
        return {k: prune(v) for k, v in d.items() if not isinstance(v, dict) or prune(v)}

    return params, prune(stats)


def _jax_model(width=10, active=6, seed=0):
    """A JAX CilModel with a grown head and randomized BN running stats."""
    model, variables = jm.create_model("resnet20", nb_classes=width)
    variables = unfreeze(jm.grow(variables, jax.random.PRNGKey(seed), 0, active))
    rng = np.random.RandomState(seed)

    def randomize(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                randomize(v)
            elif k == "mean":
                tree[k] = jnp.asarray(rng.normal(0, 0.5, v.shape).astype(np.float32))
            elif k == "var":
                tree[k] = jnp.asarray(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))

    randomize(variables["batch_stats"])
    return model, jax.device_get(variables)


def _port_model(variables, width=10):
    model = tm.CilModel("resnet20", width)
    model.load_state_dict(
        from_jax_variables(variables["params"], variables["batch_stats"]), strict=True
    )
    return model


def _images(b=8, seed=1):
    return np.random.RandomState(seed).randn(b, 32, 32, 3).astype(np.float32)


def test_weight_carry_over_round_trips():
    _, variables = _jax_model()
    sd = from_jax_variables(variables["params"], variables["batch_stats"])
    params, stats = _to_jax(sd)
    flat = jax.tree_util.tree_leaves_with_path
    ref = dict(flat({"params": variables["params"], "batch_stats": variables["batch_stats"]}))
    got = dict(flat({"params": params, "batch_stats": stats}))
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_array_equal(np.asarray(ref[k]), got[k])


def test_eval_forward_matches_jax():
    jmodel, variables = _jax_model()
    x = _images()
    ref_logits, ref_feats = jmodel.apply(variables, jnp.asarray(x), num_active=jnp.int32(6),
                                         train=False)
    model = _port_model(variables)
    with torch.no_grad():
        logits, feats = model(torch.from_numpy(x), torch.tensor([6], dtype=torch.int32))
    np.testing.assert_allclose(feats.numpy(), np.asarray(ref_feats), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(logits.numpy()[:, :6], np.asarray(ref_logits)[:, :6],
                               rtol=RTOL, atol=ATOL)
    assert np.all(logits.numpy()[:, 6:] == tm.NEG_INF)
    assert np.all(np.asarray(ref_logits)[:, 6:] == tm.NEG_INF)


def test_train_forward_and_running_stats_match_jax():
    """One train-mode forward (batch statistics, running stats updated),
    then an eval forward on the updated stats."""
    jmodel, variables = _jax_model(seed=2)
    # Batch 2: stage 3 normalizes over 2*8*8 = 128 values, where torch's
    # unbiased variance would differ from flax's by 1/127 -- well outside
    # the tolerance, so this test tells the two conventions apart.
    x = _images(b=2, seed=3)
    (ref_logits, ref_feats), mutated = jmodel.apply(
        variables, jnp.asarray(x), num_active=jnp.int32(6), train=True,
        mutable=["batch_stats"],
    )
    model = _port_model(variables)
    with torch.no_grad():
        logits, feats = model(torch.from_numpy(x), 6, train=True)
    np.testing.assert_allclose(feats.numpy(), np.asarray(ref_feats), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(logits.numpy()[:, :6], np.asarray(ref_logits)[:, :6],
                               rtol=RTOL, atol=ATOL)

    new_stats = jax.device_get(unfreeze(mutated["batch_stats"]))
    ref_sd = from_jax_variables(variables["params"], new_stats)
    sd = model.state_dict()
    running = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(running) == 2 * 19  # resnet20: stem BN + 9 blocks x 2
    for k in running:
        np.testing.assert_allclose(sd[k].numpy(), ref_sd[k].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=k)

    x2 = _images(seed=4)
    ref_eval, _ = jmodel.apply({"params": variables["params"], "batch_stats": new_stats},
                               jnp.asarray(x2), num_active=jnp.int32(6), train=False)
    with torch.no_grad():
        got_eval, _ = model(torch.from_numpy(x2), 6, train=False)
    np.testing.assert_allclose(got_eval.numpy()[:, :6], np.asarray(ref_eval)[:, :6],
                               rtol=RTOL, atol=ATOL)


def test_masked_logits_matches_jax():
    rng = np.random.RandomState(5)
    feats = rng.randn(4, 64).astype(np.float32)
    kernel = rng.randn(64, 12).astype(np.float32)
    bias = rng.randn(12).astype(np.float32)
    ref = jm.masked_logits(jnp.asarray(feats), {"kernel": jnp.asarray(kernel),
                                                 "bias": jnp.asarray(bias)}, jnp.int32(7))
    got = tm.masked_logits(torch.from_numpy(feats), torch.from_numpy(kernel.T.copy()),
                           torch.from_numpy(bias), torch.tensor([7], dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_weight_align_golden_matches_jax():
    """The golden matrix of tests/test_models.py: old norms 3, 4 and new
    norms 1, 2 give gamma = 3.5 / 1.5."""
    kernel = np.array([[3.0, 0.0, 1.0, 0.0], [0.0, 4.0, 0.0, 2.0]], np.float32)
    bias = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    ref_fc, ref_gamma = jm.weight_align(
        {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}, known=2, nb_new=2
    )
    fc = torch.nn.Linear(2, 4)
    with torch.no_grad():
        fc.weight.copy_(torch.from_numpy(kernel.T.copy()))
        fc.bias.copy_(torch.from_numpy(bias))
    gamma = tm.weight_align(fc, known=2, nb_new=2)
    assert np.isclose(float(gamma), 3.5 / 1.5, rtol=1e-6)
    assert np.isclose(float(gamma), float(ref_gamma), rtol=1e-6)
    np.testing.assert_allclose(fc.weight.detach().numpy().T, np.asarray(ref_fc["kernel"]),
                               rtol=1e-6)
    np.testing.assert_array_equal(fc.bias.detach().numpy(), bias)


def test_grow_head_initializes_only_the_new_rows():
    model = tm.CilModel("resnet20", 20)
    tm.grow_head(model.fc, jax_random.key(0), known=0, nb_new=10)
    w0 = model.fc.weight.detach().clone()
    tm.grow_head(model.fc, jax_random.key(1), known=10, nb_new=10)
    w1 = model.fc.weight.detach()
    torch.testing.assert_close(w1[:10], w0[:10], rtol=0, atol=0)
    assert w1[10:].abs().max() > 0
    # nn.Linear's default init, as the JAX torch_linear_init: U(+-1/sqrt(64)).
    assert w1.abs().max() <= 1 / 8 + 1e-7 and model.fc.bias.abs().max() <= 1 / 8 + 1e-7
    with pytest.raises(ValueError):
        tm.grow_head(model.fc, jax_random.key(2), known=15, nb_new=10)
