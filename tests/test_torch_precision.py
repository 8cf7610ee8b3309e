"""The port's precision presets against the JAX package's ``ops/precision.py``.

Small size: resnet20, a 10-wide head, batches of 8, the same weights on
both sides (``from_jax_variables``).  The f32 preset keeps the models'
tolerances (rtol 2e-4 / atol 2e-5).  For a bf16 preset P the port must round
where JAX rounds: ``‖port_P − jax_P‖ ≤ 0.25 · ‖jax_P − jax_f32‖`` (Frobenius
norms), i.e. the port lands far closer to JAX's P than JAX's own f32-to-P
gap, for the logits, the activations, the input gradients and the
parameters after a step, unit by unit on JAX's inputs (see
``test_units_round_where_jax_rounds`` for why not end to end).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from flax import linen as nn
from flax.core import unfreeze

from a_pytorch_tutorial_to_class_incremental_learning_tpu import config as jcfg
from a_pytorch_tutorial_to_class_incremental_learning_tpu import models as jm
from a_pytorch_tutorial_to_class_incremental_learning_tpu.engine import losses as jl
from a_pytorch_tutorial_to_class_incremental_learning_tpu.engine import train as jt
from a_pytorch_tutorial_to_class_incremental_learning_tpu.models import resnet as jr
from a_pytorch_tutorial_to_class_incremental_learning_tpu.models.classifier import (
    masked_logits as jmasked,
)
from a_pytorch_tutorial_to_class_incremental_learning_tpu.ops import fused_loss as _jfl  # noqa: F401
from a_pytorch_tutorial_to_class_incremental_learning_tpu.ops import precision as jprec
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch import config as tcfg
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch import models as tm
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data import augment as taug
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine import train as tt
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.models.norm import BatchNorm
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.models.resnet import Conv2d
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops import precision as tprec
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils.jax_weights import (
    from_jax_variables,
)
from test_torch_dist import two_intra_op_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_intra_op_threads")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "a_pytorch_tutorial_to_class_incremental_learning_tpu_torch"
PRESETS = ("f32", "bf16_all", "bf16_selective")
BF16 = ("bf16_all", "bf16_selective")
HP = dict(lr=0.05, momentum=0.9, weight_decay=5e-4, lam=0.5, temperature=2.0, smooth=0.1)


def _count(n):
    return torch.tensor([n], dtype=torch.int32)


def _rel(a, b, ref):
    """``‖a − b‖ / ‖ref‖`` (Frobenius)."""
    return float(np.linalg.norm(a - b) / np.linalg.norm(ref))


@pytest.mark.parametrize("name", [*PRESETS, "float32", "bfloat16"])
def test_get_policy_matches_jax(name):
    assert tprec.get_policy(name).describe() == jprec.get_policy(name).describe()


@pytest.mark.parametrize("flags", [
    dict(), dict(precision="bf16_selective"), dict(compute_dtype="bfloat16"),
    dict(precision="f32", compute_dtype="bfloat16"),
    dict(precision="bf16_all", compute_dtype="float32"),
])
def test_policy_from_config_matches_jax(flags):
    got = tprec.policy_from_config(tcfg.CilConfig(**flags))
    assert got.describe() == jprec.policy_from_config(jcfg.CilConfig(**flags)).describe()


def test_unknown_policy_raises_as_jax():
    for get in (jprec.get_policy, tprec.get_policy):
        with pytest.raises(ValueError, match="unknown precision policy"):
            get("fp8")
    with pytest.raises(ValueError):
        tprec.register_policy_kernel("k", "fp8")


def test_fused_loss_kernel_is_registered_for_every_preset():
    want = frozenset(PRESETS)
    assert tprec.kernel_policies("fused_masked_cross_entropy") == want
    assert jprec.kernel_policies("fused_masked_cross_entropy") == want
    for name in PRESETS:
        assert tprec.kernel_policy_compatible("fused_masked_cross_entropy",
                                              tprec.get_policy(name))


# --------------------------------------------------------------------------- #
# Forward and one step, against JAX
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def weights():
    """Teacher after task 0 (5 classes) and student grown to 10, f32, with
    BatchNorm scales, shifts and running statistics drawn at random (as
    ``tests/test_torch_models.py`` draws the statistics): at the initial
    identity BN, a block's input and the BN output it is added to land on
    the same bf16 grid points and cancel exactly, so a 1-ulp f32
    difference in BN's scale (rsqrt against 1/sqrt) flips ReLU masks."""
    _, variables = jm.create_model("resnet20", nb_classes=10)
    variables = jm.grow(variables, jax.random.PRNGKey(0), 0, 5)
    teacher = jax.device_get(unfreeze(variables))
    variables = jax.device_get(unfreeze(jm.grow(variables, jax.random.PRNGKey(1), 5, 5)))
    rng = np.random.RandomState(5)

    def randomize(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                randomize(v)
            elif k in ("mean", "bias"):
                tree[k] = rng.normal(0, 0.5 if k == "mean" else 0.2, v.shape).astype(np.float32)
            elif k in ("var", "scale"):
                tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)

    for v in (variables, teacher):
        randomize(v["batch_stats"])
        randomize(v["params"]["backbone"])
    rng = np.random.RandomState(7)
    momentum = jax.tree_util.tree_map(
        lambda p: (0.01 * rng.randn(*p.shape)).astype(np.float32), variables["params"])
    x = rng.randn(8, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, 8).astype(np.int64)
    return variables, teacher, momentum, x, y


def _port_model(variables, name):
    model = tm.CilModel("resnet20", 10, policy=tprec.get_policy(name))
    model.load_state_dict(from_jax_variables(variables["params"], variables["batch_stats"]))
    return model


def _jax_logits(variables, x, name, train):
    model, _ = jm.create_model("resnet20", nb_classes=10, policy=jprec.get_policy(name))
    out = model.apply(variables, jnp.asarray(x), num_active=jnp.int32(10), train=train,
                      mutable=["batch_stats"] if train else False)
    logits = out[0][0] if train else out[0]
    assert logits.dtype == jnp.float32
    return np.asarray(logits)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_logits_match_jax_f32(weights, train):
    variables, _, _, x, _ = weights
    ref = _jax_logits(variables, x, "f32", train)
    with torch.no_grad():
        got, feats = _port_model(variables, "f32")(torch.from_numpy(x), _count(10), train=train)
    assert got.dtype == torch.float32 and feats.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-5)


class _JaxStem(nn.Module):
    """The lines of the JAX ``CifarResNet.__call__`` before its blocks."""

    dtype: object
    act: object
    train: bool

    @nn.compact
    def __call__(self, x):
        x = x.astype(self.act)
        x = nn.Conv(16, (3, 3), strides=(1, 1), padding=1, use_bias=False, dtype=self.dtype,
                    name="conv_1_3x3")(x)
        x = jr._norm(0, self.train, self.act, "bn_1")(x.astype(self.act))
        return nn.relu(x)


def _jax_units(variables, name, train):
    """``[(name, fn(params, a) -> out, params)]``: the stem, each block, and
    the pooling plus the masked head, as the JAX model runs them under
    preset ``name`` (op by op, as written: XLA:CPU's jit upcasts a bf16
    convolution to f32 and drops the rounding of its output, so a jitted
    function on the CPU does not round where the module casts)."""
    pol = jprec.get_policy(name)
    cd = pol.compute_dtype
    act = None if name == "f32" else pol.act_dtype
    params, stats = variables["params"]["backbone"], variables["batch_stats"]["backbone"]
    mutable = ["batch_stats"] if train else False

    def run(module, bn_stats, **kw):
        def fn(p, a):
            out = module.apply({"params": p, "batch_stats": bn_stats}, a, mutable=mutable, **kw)
            return out[0] if train else out
        return fn

    units = [("stem", run(_JaxStem(cd, pol.act_dtype, train), {"bn_1": stats["bn_1"]}),
              {"conv_1_3x3": params["conv_1_3x3"], "bn_1": params["bn_1"]})]
    for stage, (planes, stride) in enumerate(((16, 1), (32, 2), (64, 2)), start=1):
        for i in range(3):
            n = f"stage_{stage}_block_{i}"
            block = jr.BasicBlock(planes=planes, stride=stride if i == 0 else 1,
                                  downsample=i == 0 and stage > 1, dtype=cd, act_dtype=act)
            units.append((n, run(block, stats[n], train=train), params[n]))

    def head(p, a):
        feats = jnp.mean(a, axis=(1, 2)).astype(jnp.float32)
        fc = {"kernel": p["fc_kernel"], "bias": p["fc_bias"]}
        return jmasked(feats, fc, jnp.int32(10), pol.head_dtype)

    units.append(("head", head, {k: variables["params"][k] for k in ("fc_kernel", "fc_bias")}))
    return units


def _port_units(model, train):
    """The port's units, each with its ``(prefix, module)`` parameters."""
    bb = model.backbone

    def head(a):
        return tm.masked_logits(bb.pool(a), model.fc.weight, model.fc.bias, 10,
                                model.policy.head_dtype)

    return ([(lambda a: bb.stem(a, train), [("conv_1_3x3", bb.conv_1_3x3), ("bn_1", bb.bn_1)])]
            + [(lambda a, b=b: b(a, train), [("", b)]) for b in bb.blocks()]
            + [(head, [("fc", model.fc)])])


def _jax_leaf(tree, key):
    """The JAX leaf of the port parameter ``key``, in the port's layout."""
    *path, leaf = key.split(".")
    if path == ["fc"]:
        return np.asarray(tree["fc_kernel"]).T if leaf == "weight" else np.asarray(tree["fc_bias"])
    for p in path:
        tree = tree[p]
    if leaf == "weight" and "kernel" in tree:
        return np.asarray(tree["kernel"], np.float32).transpose(3, 2, 0, 1)
    return np.asarray(tree["scale" if leaf == "weight" else "bias"], np.float32)


def _np(t):
    """A port tensor as f32 numpy, NCHW back to JAX's NHWC."""
    t = t.detach().float()
    return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t).numpy()


def _f32(v):
    return np.asarray(jnp.asarray(v).astype(jnp.float32))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", BF16)
def test_units_round_where_jax_rounds(weights, name, train):
    """The whole network unit by unit (the stem, the 9 blocks, the pooling
    with the masked head), each on JAX's own input under preset P, forward
    and backward: over all units, the outputs (the last are the logits),
    the input gradients and the parameters after one SGD step from each
    unit's gradient lie within 0.25 of JAX's f32-to-P gap from JAX's P
    (Frobenius norms over the concatenation; the logits alone too).

    Unit by unit because the whole network is chaotic in bf16: a change of
    1e-6 in the input images moves the port's end-to-end logits by 0.2-0.7
    of that gap, and one whole step's parameters by 0.9 of it (jitting the
    JAX model moves JAX's own by 0.8-1.1), so only the units' own rounding
    can be held to the gap.  Per unit the ratios are mostly below 0.05; in
    train mode a few reach 0.3-0.4, where the batch statistics, summed in
    another order than XLA's, move a value across a bf16 rounding boundary
    next to a ReLU's zero."""
    variables, _, _, x, _ = weights
    model = _port_model(variables, name)
    act = model.policy.act_dtype
    rng = np.random.RandomState(11)
    lr, mom, wd = HP["lr"], HP["momentum"], HP["weight_decay"]
    sides = {k: {"port": [], "P": [], "f32": []}
             for k in ("outputs", "input gradients", "parameters after a step")}
    per_unit = []
    a = jnp.asarray(x)
    units = zip(_jax_units(variables, name, train), _jax_units(variables, "f32", train),
                _port_units(model, train))
    for (unit, fp, params), (_, ff, _), (port_fn, mods) in units:
        out_p, vjp_p = jax.vjp(fp, params, a)
        out_f, vjp_f = jax.vjp(ff, params, a.astype(jnp.float32))
        cot = rng.randn(*out_p.shape).astype(np.float32)
        (gp_p, ga_p), (gp_f, ga_f) = vjp_p(jnp.asarray(cot, out_p.dtype)), vjp_f(jnp.asarray(cot))

        at = torch.from_numpy(_f32(a).copy())
        at = (at if unit == "stem" else at.permute(0, 3, 1, 2).to(act)).requires_grad_(True)
        out = port_fn(at)
        assert out.dtype == (torch.float32 if unit == "head" else act)
        keys = [f"{prefix}.{n}".lstrip(".") for prefix, m in mods for n, _ in m.named_parameters()]
        tparams = [p for _, m in mods for p in m.parameters()]
        ct = torch.from_numpy(cot)
        grads = torch.autograd.grad(out, [at, *tparams],
                                    grad_outputs=(ct.permute(0, 3, 1, 2) if ct.dim() == 4
                                                  else ct).to(out.dtype))
        unit_sides = {
            "outputs": (_np(out), _f32(out_p), _f32(out_f)),
            "input gradients": (grads[0].float().numpy() if unit == "stem" else _np(grads[0]),
                                _f32(ga_p), _f32(ga_f)),
        }
        # One SGD step of the unit's parameters (the same f32 weights and
        # momentum on every side) from each side's gradient.
        tree = variables["params"] if unit == "head" else params
        updated = {"port": [], "P": [], "f32": []}
        for key, g_port in zip(keys, grads[1:]):
            p0 = _jax_leaf(tree, key)
            buf = 0.01 * rng.randn(*p0.shape).astype(np.float32)
            for side, g in (("port", g_port.numpy()), ("P", _jax_leaf(gp_p, key)),
                            ("f32", _jax_leaf(gp_f, key))):
                updated[side].append((p0 - lr * (mom * buf + g + wd * p0)).reshape(-1))
        unit_sides["parameters after a step"] = tuple(np.concatenate(updated[k])
                                                      for k in ("port", "P", "f32"))
        for what, vals in unit_sides.items():
            for side, v in zip(("port", "P", "f32"), vals):
                sides[what][side].append(v.reshape(-1))
        per_unit.append((unit, {w: _rel(g, r, r - b) if np.any(r != b) else 0.0
                                for w, (g, r, b) in unit_sides.items()}))
        a = out_p
    logits = unit_sides["outputs"]
    assert _rel(logits[0], logits[1], logits[1] - logits[2]) <= 0.25, per_unit[-1]
    for what, s in sides.items():
        got, ref, base = (np.concatenate(s[k]) for k in ("port", "P", "f32"))
        assert np.linalg.norm(ref - base) > 0, f"{what}: no rounding under {name}"
        ratio = _rel(got, ref, ref - base)
        assert ratio <= 0.25, f"{what}: {ratio:.3f} of JAX's f32-to-{name} gap; {per_unit}"


def _jax_step(weights, name):
    """One CE + λ·KD + SGD step of the JAX composition under preset
    ``name``, op by op (see ``_jax_units``); returns the parameters in the
    port's names and the loss."""
    variables, teacher, momentum, x, y = weights
    model, _ = jm.create_model("resnet20", nb_classes=10, policy=jprec.get_policy(name))

    def loss_fn(params):
        (logits, _), mutated = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(x),
            num_active=jnp.int32(10), train=True, mutable=["batch_stats"])
        ce = jl.cross_entropy(logits, jnp.asarray(y), jnp.int32(10), HP["smooth"])
        t_logits, _ = model.apply(teacher, jnp.asarray(x), num_active=jnp.int32(5), train=False)
        kd = HP["lam"] * jl.soft_target_kd(logits, t_logits, jnp.int32(5), HP["temperature"])
        return ce + kd, mutated["batch_stats"]

    (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    params, _ = jt.sgd_update(variables["params"], grads, momentum, HP["lr"], HP["momentum"],
                              HP["weight_decay"])
    return from_jax_variables(jax.device_get(params), unfreeze(jax.device_get(stats))), float(loss)


def test_bf16_selective_step_against_jax(weights):
    """One whole train step under ``bf16_selective``: the loss equals JAX's
    to rtol 1e-3, and the step departs from the f32 step by as much as
    JAX's does (a factor 0.5-2: the noise of rounding, not its absence or
    rounding in more places; see ``test_units_round_where_jax_rounds`` for
    the unit-by-unit bound)."""
    (sel, m_sel), (f32, _) = _port_step(weights, "bf16_selective"), _port_step(weights, "f32")
    (jsel, jloss), (jf32, _) = _jax_step(weights, "bf16_selective"), _jax_step(weights, "f32")
    assert np.isclose(float(m_sel["loss"]), jloss, rtol=1e-3)
    names = [n for n, _ in sel.model.named_parameters()]
    flat = lambda sd: np.concatenate([np.asarray(sd[n]).reshape(-1) for n in names])
    port_gap = np.linalg.norm(flat(sel.model.state_dict()) - flat(f32.model.state_dict()))
    jax_gap = np.linalg.norm(flat(jsel) - flat(jf32))
    assert jax_gap > 0 and 0.5 <= port_gap / jax_gap <= 2.0, (port_gap, jax_gap)


def _port_step(weights, name, use_pallas_loss=False):
    variables, teacher, momentum, x, y = weights
    student = _port_model(variables, name)
    t_model = _port_model(teacher, name).requires_grad_(False)
    mom = from_jax_variables(momentum, variables["batch_stats"])
    state = tt.TrainState(student, [mom[n].clone() for n, _ in student.named_parameters()],
                          _count(10), _count(5))
    metrics = tt.train_step_on_batch(
        state, tt.Teacher(t_model, _count(5)), torch.from_numpy(x), torch.from_numpy(y),
        HP["lr"], HP["lam"], label_smoothing=HP["smooth"], kd_temperature=HP["temperature"],
        momentum=HP["momentum"], weight_decay=HP["weight_decay"],
        use_pallas_loss=use_pallas_loss)
    return state, metrics


@pytest.mark.parametrize("name", PRESETS)
def test_dtype_contract_after_a_step(weights, name):
    """f32 logits, parameters, momentum and BN statistics under every
    preset; the conv outputs in the compute dtype; BatchNorm's input and
    output in the activation dtype."""
    policy = tprec.get_policy(name)
    seen = {"conv": set(), "bn_in": set(), "bn_out": set(), "logits": set()}
    model = _port_model(weights[0], name)

    def record(key, get):
        def hook(_module, inputs, output):
            seen[key].add(get(inputs, output).dtype)
        return hook

    for m in model.modules():
        if isinstance(m, Conv2d):
            m.register_forward_hook(record("conv", lambda i, o: o))
        elif isinstance(m, BatchNorm):
            m.register_forward_hook(record("bn_in", lambda i, o: i[0]))
            m.register_forward_hook(record("bn_out", lambda i, o: o))
    model.register_forward_hook(record("logits", lambda i, o: o[0]))
    variables, _, momentum, x, y = weights
    mom = from_jax_variables(momentum, variables["batch_stats"])
    state = tt.TrainState(model, [mom[n].clone() for n, _ in model.named_parameters()],
                          _count(10), _count(0))
    metrics = tt.train_step_on_batch(
        state, None, torch.from_numpy(x), torch.from_numpy(y), HP["lr"], 0.0,
        label_smoothing=0.0, kd_temperature=2.0, momentum=0.9, weight_decay=5e-4,
        use_pallas_loss=True)
    assert np.isfinite(float(metrics["loss"]))
    assert seen["conv"] == {policy.compute_dtype}
    assert seen["bn_in"] == seen["bn_out"] == {policy.act_dtype}
    assert seen["logits"] == {torch.float32}
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype == torch.float32 for b in model.buffers())
    assert all(m.dtype == torch.float32 for m in state.momentum)


def test_unregistered_policy_raises_instead_of_falling_back(weights, monkeypatch):
    monkeypatch.setattr(tprec, "_KERNEL_REGISTRY", {})
    policy = tprec.get_policy("bf16_selective")
    cfg = taug.AugmentConfig()
    with pytest.raises(ValueError, match="not registered"):
        tt.make_train_step(cfg, policy, 0.0, 2.0, 0.9, 5e-4, use_pallas_loss=True)
    with pytest.raises(ValueError, match="not registered"):
        _port_step(weights, "bf16_selective", use_pallas_loss=True)
    tt.make_train_step(cfg, policy, 0.0, 2.0, 0.9, 5e-4, use_pallas_loss=False)
    _port_step(weights, "bf16_selective", use_pallas_loss=False)


@pytest.mark.parametrize("name", BF16)
def test_fused_loss_step_under_bf16_matches_plain_loss(weights, name):
    """The kernel's plain version and the plain loss give the same step
    under a bf16 preset (the kernel reads the f32 logits either way)."""
    a, ma = _port_step(weights, name, use_pallas_loss=True)
    b, mb = _port_step(weights, name, use_pallas_loss=False)
    assert np.isclose(float(ma["loss"]), float(mb["loss"]), rtol=1e-5)
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=n)


def test_cli_with_default_augmentation_and_bf16_selective(tmp_path):
    """The synthetic10 CLI with the parser's augmentation defaults
    (RandAugment) and ``--precision bf16_selective`` runs to its end."""
    log = tmp_path / "run.jsonl"
    argv = ["--platform", "cpu", "--data_set", "synthetic10", "--num_bases", "0",
            "--increment", "5", "--backbone", "resnet20", "--batch_size", "16",
            "--num_epochs", "2", "--eval_every_epoch", "100", "--memory_size", "20",
            "--seed", "6", "--precision", "bf16_selective", "--use_pallas_loss",
            "--log_file", str(log)]
    proc = subprocess.run([sys.executable, "-m", PORT, *argv], cwd=REPO, capture_output=True,
                          text=True, timeout=600, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    import json

    records = [json.loads(ln) for ln in log.read_text().splitlines()]
    assert [r["type"] for r in records][-1] == "final"
    run = records[0]
    assert run["aa"] == "rand-m9-mstd0.5-inc1" and run["precision"] == "bf16_selective"
    assert run["compute_dtype"] == "bfloat16"
    assert all(np.isfinite(r["loss"]) for r in records if r["type"] == "epoch")
