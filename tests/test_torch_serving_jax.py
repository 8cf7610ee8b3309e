"""The port's serving artifacts held against the JAX package's own.

A JAX artifact (resnet20, width 10, buckets (1, 4), f32, with BN running
statistics that are not the defaults) is written by JAX's
``serving.export_artifact``; its ``weights.pkl`` is read, carried over with
``from_jax_variables`` and exported through the port.  The port's served
logits must match JAX's ``direct_predict`` at the forward parity of
``tests/test_torch_models.py`` (rtol 2e-4 / atol 2e-5) with equal argmax,
and the manifest's and ``meta.json``'s keys must be JAX's.  Then a
``bf16_selective`` artifact carries its casts and serves the live module's
logits bitwise.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from a_pytorch_tutorial_to_class_incremental_learning_tpu.data.augment import (
    AugmentConfig as JaxAugmentConfig,
)
from a_pytorch_tutorial_to_class_incremental_learning_tpu.models import (
    create_model as jax_create_model,
)
from a_pytorch_tutorial_to_class_incremental_learning_tpu.models import grow as jax_grow
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data.augment import (
    AugmentConfig,
    eval_preprocess,
)
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.models import create_model
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.serving import (
    direct_predict,
    export_artifact,
    load_artifact,
    read_manifest,
)
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils.checkpoint import (
    _read_payload,
)
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils.jax_weights import (
    from_jax_variables,
)
from serving import direct_predict as jax_direct_predict
from serving import export_artifact as jax_export_artifact
from test_torch_dist import one_intra_op_thread  # noqa: F401
from test_torch_serving import BUCKETS, NB, _export, _img, _model

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

KNOWN = 7
MODEL_META = {"backbone": "resnet20", "width": NB, "compute_dtype": "float32",
              "precision": "f32", "bn_group_size": 0}


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """``(jax artifact dir, port artifact dir)`` over the same weights."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        root = tmp_path_factory.mktemp("serve_jax")
        jax_dir, port_dir = str(root / "jax"), str(root / "port")
        os.makedirs(jax_dir)
        os.makedirs(port_dir)
        model, variables = jax_create_model("resnet20", NB)
        variables = jax_grow(variables, jax.random.PRNGKey(3), 0, KNOWN)
        rng = np.random.RandomState(7)
        stats = jax.tree_util.tree_map_with_path(
            lambda path, a: (rng.rand(*a.shape) + 0.5 if "var" in str(path[-1])
                             else rng.randn(*a.shape) * 0.1).astype(np.float32),
            jax.device_get(variables["batch_stats"]))
        jax_path = jax_export_artifact(
            jax_dir, 0, model, JaxAugmentConfig(), variables["params"], stats,
            known=KNOWN, class_order=list(range(NB)), input_size=32, channels=3,
            buckets=BUCKETS, model_meta=MODEL_META)
        payload, why = _read_payload(os.path.join(jax_path, "weights.pkl"))
        assert payload is not None, why
        state = from_jax_variables(payload["params"], payload["batch_stats"])
        names = {n for n, _ in create_model("resnet20", NB).named_parameters()}
        port_path = export_artifact(
            port_dir, 0, AugmentConfig(),
            {k: v.numpy() for k, v in state.items() if k in names},
            {k: v.numpy() for k, v in state.items() if k not in names},
            known=KNOWN, class_order=list(range(NB)), input_size=32, channels=3,
            buckets=BUCKETS, model_meta=MODEL_META, device="cpu")
    finally:
        torch.set_num_threads(threads)
    return jax_path, port_path


def test_port_serves_jax_weights_as_jax_serves_them(artifacts):
    jax_path, port_path = artifacts
    art = load_artifact(port_path, "cpu")
    rng = np.random.RandomState(8)
    for bucket in BUCKETS:
        x = _img(rng, bucket)
        got = art.predict_padded(x, bucket)
        want = np.asarray(jax_direct_predict(jax_path, x))
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
        np.testing.assert_array_equal(np.argmax(got[:, :KNOWN], -1),
                                      np.argmax(want[:, :KNOWN], -1))
        np.testing.assert_array_equal(got, direct_predict(port_path, x, "cpu"))
        assert np.all(got[:, KNOWN:] <= -1e9)


def test_manifest_and_meta_keys_are_jax_keys(artifacts):
    jax_path, port_path = artifacts
    jm = read_manifest(os.path.dirname(jax_path))
    pm = read_manifest(os.path.dirname(port_path))
    assert set(pm) == set(jm)
    assert set(pm["artifacts"]["0"]) == set(jm["artifacts"]["0"])
    jmeta = json.load(open(os.path.join(jax_path, "meta.json")))
    pmeta = json.load(open(os.path.join(port_path, "meta.json")))
    assert set(pmeta) == set(jmeta)
    assert set(pmeta["files"]) == set(jmeta["files"])
    for key in ("task_id", "known", "class_map", "buckets", "input_size", "channels",
                "mean", "std", "model"):
        assert pmeta[key] == jmeta[key], key
    assert pmeta["backend"] == "cpu"
    assert sorted(pmeta["files"]["exported"]) == sorted(jmeta["files"]["exported"])
    for f in ("x", "logits", "bucket"):
        assert np.load(os.path.join(port_path, "probe.npz"))[f].shape == \
            np.load(os.path.join(jax_path, "probe.npz"))[f].shape


def test_bf16_preset_artifact_equals_the_live_module(tmp_path):
    """A ``bf16_selective`` artifact carries the preset's casts in its
    program and serves the live module's eval logits bitwise."""
    model = _model(7, 3, precision="bf16_selective")
    apath = _export(str(tmp_path), 0, model, 7, precision="bf16_selective")
    program = torch.export.load(os.path.join(apath, "exported_b004.pt2"))
    casts = [n for n in program.graph.nodes
             if any(a is torch.bfloat16 for a in (*n.args, *n.kwargs.values()))]
    assert casts, "no bfloat16 cast in the exported program"
    x = _img(np.random.RandomState(5), 4)
    na = torch.tensor(7, dtype=torch.int32)
    with torch.no_grad():
        live, _ = model(eval_preprocess(torch.from_numpy(x), AugmentConfig()), na, train=False)
        ref, _ = _model(7, 3)(eval_preprocess(torch.from_numpy(x), AugmentConfig()), na,
                              train=False)
    served = load_artifact(apath, "cpu").predict_padded(x, 4)
    np.testing.assert_array_equal(served, live.numpy())
    assert not np.array_equal(served, ref.numpy())  # the casts change the logits
