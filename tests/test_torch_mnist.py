"""MNIST and the 1-channel backbones: the port against the JAX package.

The IDX loader on files the test writes (plain and ``.gz``, both roots, the
errors), ``synthetic_mnist`` bitwise, ``resnet20mnist``'s forward on carried
weights, one train step on 1-channel input against JAX in float64 (as
``tests/test_torch_train_step.py`` does, at its tolerances), the
augmentation at 28 px on one channel against JAX's draws, the refusal of
``resnet10mnist`` by both packages, the trainer's three guards as JAX's
raise them, and a 2-task ``mnist`` run on a small IDX distribution whose
fused epoch equals the per-step loop bitwise.
"""

import gzip
import struct

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from a_pytorch_tutorial_to_class_incremental_learning_tpu import config as jcfg
from a_pytorch_tutorial_to_class_incremental_learning_tpu import models as jm
from a_pytorch_tutorial_to_class_incremental_learning_tpu.data import augment as jaug
from a_pytorch_tutorial_to_class_incremental_learning_tpu.data import datasets as jds
from a_pytorch_tutorial_to_class_incremental_learning_tpu.engine.loop import (
    CilTrainer as JaxTrainer,
)
from a_pytorch_tutorial_to_class_incremental_learning_tpu.parallel.mesh import make_mesh
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch import config as tcfg
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch import models as tm
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data import augment as taug
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data import datasets as tds
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine import train as tt
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.main import build_trainer
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils.jax_weights import (
    from_jax_variables,
)
from test_torch_augment import _assert_pipeline_close, _jax_draws
from test_torch_dist import one_intra_op_thread  # noqa: F401
from test_torch_train_step import HP, _as_param_list, _count, _jax_step, _port_model, _setup

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

MNIST = (28, 28, 1)


def _idx(magic, dims, payload: bytes) -> bytes:
    return struct.pack(">" + "i" * (1 + len(dims)), magic, *dims) + payload


def _write_mnist(root, n=20, gz=True, prefixes=("train", "t10k"), n_labels=None, magic=0x803):
    """IDX files of ``n`` random 28x28 images (and ``n_labels`` labels)."""
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(n)
    imgs = _idx(magic, (n, 28, 28), rng.randint(0, 256, (n, 28, 28), np.uint8).tobytes())
    k = n if n_labels is None else n_labels
    lbls = _idx(0x801, (k,), (np.arange(k, dtype=np.uint8) % 10).tobytes())
    for prefix in prefixes:
        for kind, blob in (("images-idx3-ubyte", imgs), ("labels-idx1-ubyte", lbls)):
            name = f"{prefix}-{kind}" + (".gz" if gz else "")
            (root / name).write_bytes(gzip.compress(blob) if gz else blob)


def _both(fn_jax, fn_port):
    """Both loaders' results, or both exceptions (type and message)."""
    out = []
    for fn in (fn_jax, fn_port):
        try:
            out.append(fn())
        except (ValueError, FileNotFoundError) as e:
            out.append((type(e), str(e)))
    return out


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("sub", ["", "MNIST/raw"])
def test_load_mnist_idx_matches_jax(tmp_path, gz, sub):
    _write_mnist(tmp_path / sub if sub else tmp_path, gz=gz)
    for train in (True, False):
        (jx, jy), (px, py) = _both(lambda: jds.load_mnist_idx(str(tmp_path), train),
                                   lambda: tds.load_mnist_idx(str(tmp_path), train))
        assert px.shape == (20, 28, 28, 1) and px.dtype == np.uint8 and py.dtype == np.int64
        np.testing.assert_array_equal(px, jx)
        np.testing.assert_array_equal(py, jy)


@pytest.mark.parametrize("case", ["bad_magic", "length_mismatch", "missing"])
def test_load_mnist_idx_errors_match_jax(tmp_path, case):
    if case == "bad_magic":
        _write_mnist(tmp_path, magic=0x802)
    elif case == "length_mismatch":
        _write_mnist(tmp_path, n_labels=19)
    j, p = _both(lambda: jds.load_mnist_idx(str(tmp_path), True),
                 lambda: tds.load_mnist_idx(str(tmp_path), True))
    assert isinstance(j, tuple) and j[0] is p[0]
    if case != "missing":  # the "not found" hints name each package's own data set
        assert j == p


@pytest.mark.parametrize("train", [True, False])
def test_synthetic_mnist_is_bitwise_jax(train):
    (jx, jy), jn = jds.build_raw_dataset("synthetic_mnist", "", train, 28)
    (px, py), pn = tds.build_raw_dataset("synthetic_mnist", "", train, 28)
    assert pn == jn == 10 and px.shape[1:] == MNIST
    np.testing.assert_array_equal(px, jx)
    np.testing.assert_array_equal(py, jy)


def test_resnet10mnist_is_refused_by_both_packages():
    with pytest.raises(AssertionError, match="depth"):
        jm.create_model("resnet10mnist", 10, input_size=28, channels=1)
    with pytest.raises(ValueError, match="depth"):
        tm.create_model("resnet10mnist", 10)


def test_backbone_channels_follow_the_name():
    for name in ("resnet20mnist", "resnet32mnist"):
        model = tm.create_model(name, 10)
        assert model.backbone.channels == 1
        assert model.backbone.conv_1_3x3.weight.shape == (16, 1, 3, 3)
    assert tm.create_model("resnet20", 10).backbone.channels == 3


def test_resnet20mnist_forward_matches_jax():
    jmodel, variables = jm.create_model("resnet20mnist", 10, input_size=28, channels=1)
    variables = jax.device_get(jm.grow(variables, jax.random.PRNGKey(3), 0, 6))
    x = np.random.RandomState(4).randn(8, *MNIST).astype(np.float32)
    apply = jax.jit(lambda v, x: jmodel.apply(v, x, num_active=jnp.int32(6), train=False))
    ref_logits, ref_feats = apply(variables, jnp.asarray(x))
    model = _port_model(variables, "resnet20mnist")
    with torch.no_grad():
        logits, feats = model(torch.from_numpy(x), _count(6))
    np.testing.assert_allclose(feats.numpy(), np.asarray(ref_feats), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(logits.numpy()[:, :6], np.asarray(ref_logits)[:, :6],
                               rtol=1e-5, atol=1e-6)
    assert np.all(logits.numpy()[:, 6:] == tm.NEG_INF)


@pytest.fixture(scope="module")
def one_channel_step():
    """The inputs and the JAX step (float64), computed once."""
    smooth = 0.1
    _, variables, teacher, momentum, x, y = _setup(smooth, "resnet20mnist", MNIST)
    ref = _jax_step(variables, teacher, momentum, x, y, smooth, "resnet20mnist")
    return smooth, variables, teacher, momentum, x, y, ref


@pytest.mark.parametrize("use_pallas_loss", [False, True])
def test_one_step_on_one_channel_matches_jax(one_channel_step, use_pallas_loss):
    """The step of ``tests/test_torch_train_step.py`` on 28x28x1 input
    through ``resnet20mnist``, against JAX in float64, at its tolerances
    (loss rtol 1e-4; parameters and momentum rtol 1e-4 / atol 1e-5)."""
    smooth, variables, teacher, momentum, x, y, ref = one_channel_step
    _, ref_params, ref_buf, ref_stats, ref_loss = ref
    student = _port_model(variables, "resnet20mnist")
    state = tt.TrainState(student, _as_param_list(student, momentum, variables["batch_stats"]),
                          _count(10), _count(5))
    metrics = tt.train_step_on_batch(
        state, tt.Teacher(_port_model(teacher, "resnet20mnist").requires_grad_(False),
                          _count(5)),
        torch.from_numpy(x), torch.from_numpy(y), HP["lr"], HP["lam"],
        label_smoothing=smooth, kd_temperature=HP["temperature"], momentum=HP["momentum"],
        weight_decay=HP["weight_decay"], use_pallas_loss=use_pallas_loss)
    assert np.isclose(float(metrics["loss"]), float(ref_loss), rtol=1e-4)
    ref_sd = from_jax_variables(ref_params, ref_stats)
    ref_mom = _as_param_list(student, ref_buf, ref_stats)
    sd = student.state_dict()
    for (name, _), buf, want in zip(student.named_parameters(), state.momentum, ref_mom):
        np.testing.assert_allclose(sd[name].numpy(), ref_sd[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(buf.numpy(), want.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("recipe", [
    dict(rand_augment=False, color_jitter=0.4),
    dict(rand_augment=False, color_jitter=0.4, reprob=0.5, remode="pixel", recount=2),
    dict(rand_augment=False, color_jitter=0.0, reprob=0.5, remode="rand"),
])
def test_one_channel_augmentation_matches_jax(recipe):
    """Crop with padding 4, no flip, colour jitter (its saturation through
    the 1-channel grayscale) and erasing per channel, at 28 px, on JAX's
    draws; MNIST's statistics."""
    kw = dict(input_size=28, hflip=False, mean=jcfg.MNIST_MEAN, std=jcfg.MNIST_STD, **recipe)
    jc, tc = jaug.AugmentConfig(**kw), taug.AugmentConfig(**kw)
    u8 = np.random.RandomState(50).randint(0, 256, (8, *MNIST)).astype(np.uint8)
    key = jax.random.PRNGKey(51)
    ref = np.asarray(jaug.train_augment(key, jnp.asarray(u8), jc))
    draws = _jax_draws(key, len(u8), jc, MNIST)
    assert draws.flip is None
    got = taug.augment(torch.from_numpy(u8), draws, tc).numpy()
    assert got.shape == u8.shape
    _assert_pipeline_close(got, ref, tc)


def test_augment_config_for_mnist_matches_jax():
    args = ["--data_set", "mnist", "--input_size", "28", "--aa", "none"]
    jc = jaug.AugmentConfig.from_config(jcfg.config_from_args(
        jcfg.get_args_parser().parse_args(args)))
    tc = taug.AugmentConfig.from_config(tcfg.config_from_args(
        tcfg.get_args_parser().parse_args(args)))
    assert tc == taug.AugmentConfig(**{f: getattr(jc, f) for f in jc.__dataclass_fields__})
    assert not tc.hflip and tc.mean == jcfg.MNIST_MEAN and tc.crop_padding == 4


SMOKE = ["--num_bases", "0", "--increment", "5", "--batch_size", "16", "--num_epochs", "1",
         "--memory_size", "20", "--eval_every_epoch", "100", "--seed", "2"]


def _jax_guard(argv):
    cfg = jcfg.config_from_args(jcfg.get_args_parser().parse_args([*SMOKE, *argv]))
    JaxTrainer(cfg, mesh=make_mesh((1, 1), jax.devices()[:1]), init_dist=False)


def _port_guard(argv):
    build_trainer(["--platform", "cpu", *SMOKE, *argv])


@pytest.mark.parametrize("argv,match", [
    (["--data_set", "synthetic_mnist", "--backbone", "resnet20mnist", "--input_size", "28"],
     "RandAugment"),
    (["--data_set", "synthetic10", "--backbone", "resnet20mnist"], "channel"),
    (["--data_set", "mnist", "--data_path", "{idx}", "--backbone", "resnet20mnist"],
     "input_size"),
])
def test_trainer_guards_raise_as_jax(tmp_path, argv, match):
    """JAX ``tests/test_e2e.py::test_channel_and_size_guards``'s cases."""
    _write_mnist(tmp_path)
    argv = [a.replace("{idx}", str(tmp_path)) for a in argv]
    with pytest.raises(ValueError, match=match):
        _jax_guard(argv)
    with pytest.raises(ValueError, match=match):
        _port_guard(argv)


def test_mnist_fused_epoch_equals_per_step(tmp_path):
    """``--data_set mnist`` end to end on a small IDX distribution the test
    writes, two tasks (5 + 5 classes), on the fused epoch and on the
    per-step loop: every state tensor and the accuracies bitwise equal."""
    _write_mnist(tmp_path / "MNIST" / "raw", n=80)
    runs = []
    for extra in ([], ["--no_fused_epochs"]):
        trainer = build_trainer([
            "--platform", "cpu", "--data_set", "mnist", "--data_path", str(tmp_path),
            "--backbone", "resnet20mnist", "--input_size", "28", "--aa", "none", *SMOKE,
            "--batch_size", "8", "--log_file", str(tmp_path / "log.jsonl"), *extra])
        result = trainer.fit()
        runs.append((result, trainer.state.model.state_dict()))
    (r0, sd0), (r1, sd1) = runs
    assert r0["acc1s"] == r1["acc1s"] and len(r0["acc1s"]) == 2
    assert all(np.isfinite(r0["acc1s"]))
    for name in sd0:
        assert torch.equal(sd0[name], sd1[name]), name
    assert sd0["backbone.conv_1_3x3.weight"].shape == (16, 1, 3, 3)
