"""``utils/jax_random.py`` against ``jax.random`` and flax, and the port's
initial network against the JAX trainer's, on the CPU.

The keys, ``bits`` and ``uniform`` are held bitwise; ``normal`` (XLA:CPU's
ErfInv and log1p, their multiply-adds fused) is held bitwise too, with the
count of differing elements asserted to be 0.  The trainer's initial state
and its heads are held bitwise to the JAX trainer's, and the digests of
``tests/fixtures/jax_init_digests.json`` (which ``chip_smoke.py`` checks on
the card's host) to the port's draws.  Rewrite the fixture with

    JAX_PLATFORMS=cpu python tests/test_torch_jax_random.py write
"""

import json
import os
import sys
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from a_pytorch_tutorial_to_class_incremental_learning_tpu import models as jm  # noqa: E402
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.main import (  # noqa: E402
    build_trainer,
)
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils import (  # noqa: E402
    jax_random as jr,
)
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils.jax_weights import (  # noqa: E402,E501
    from_jax_variables,
)
from test_torch_race_init import jax_initial_state, port_initial_state  # noqa: E402
from test_torch_dist import two_intra_op_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_intra_op_threads")

SEEDS = (0, 3, 5, 2**31 - 1)
SHAPES = ((1,), (7,), (3, 5), (3, 3, 3, 16), (64, 50))
DIGESTS = os.path.join(REPO, chip_smoke.INIT_DIGESTS)
RECIPES = [("resnet32", 100, (50, 10)), ("resnet20mnist", 10, (5, 5))]


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_bits_match_jax(seed):
    k, kk = jax.random.PRNGKey(seed), jr.key(seed)
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(k)), kk)
    for data in (0, 1, 0xC11, 2**32 - 1):
        np.testing.assert_array_equal(np.asarray(jax.random.fold_in(k, data)),
                                      jr.fold_in(kk, data))
    for num in (2, 3):
        np.testing.assert_array_equal(np.asarray(jax.random.split(k, num)), jr.split(kk, num))
    for shape in SHAPES:
        np.testing.assert_array_equal(np.asarray(jax.random.bits(k, shape)), jr.bits(kk, shape))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.125, 0.125), (-0.3, 1.7)])
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_uniform_matches_jax_bitwise(seed, lo, hi):
    k, kk = jax.random.PRNGKey(seed), jr.key(seed)
    for shape in SHAPES:
        want = np.asarray(jax.random.uniform(k, shape, jnp.float32, lo, hi))
        np.testing.assert_array_equal(jr.uniform(kk, shape, lo, hi), want)


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_normal_matches_jax_bitwise(seed):
    """Bitwise: 0 of the ~126k elements differ (the bound was 4 ulp)."""
    k, kk = jax.random.PRNGKey(seed), jr.key(seed)
    differ = total = 0
    for shape in ((3, 3, 16, 32), (3, 3, 64, 64), (1001,), (50000,)):
        want = np.asarray(jax.random.normal(k, shape, jnp.float32))
        got = jr.normal(kk, shape)
        differ += int((got.view(np.int32) != want.view(np.int32)).sum())
        total += want.size
    assert total == 4608 + 36864 + 1001 + 50000
    assert differ == 0


def _round32(x: Fraction) -> np.float32:
    """``x`` rounded to the nearest float32, ties to even."""
    f = np.float32(float(x))
    best = min((f, np.nextafter(f, np.float32(np.inf)), np.nextafter(f, np.float32(-np.inf))),
               key=lambda c: (abs(Fraction(float(c)) - x), int(np.float32(c).view(np.int32)) & 1))
    return np.float32(best)


def test_fma32_is_correctly_rounded():
    """One rounding, at the float32 midpoints a float64 sum lands on too: (1 +
    2^-12)² is 1 + 2^-11 + 2^-24, a float32 midpoint, and ±2^-80 beside it
    must round away from it, not to even; and random operands."""
    a = np.float32(1 + 2.0**-12)
    for c, want in ((2.0**-80, 1 + 2.0**-11 + 2.0**-23), (-(2.0**-80), 1 + 2.0**-11),
                    (0.0, 1 + 2.0**-11)):
        assert jr.fma32(a, a, np.float32(c))[0] == np.float32(want)
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 2000) * 10.0 ** rng.randint(-8, 8, (3, 2000))).astype(np.float32)
    got = jr.fma32(*x)
    want = [_round32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))
            for a, b, c in x.T]
    np.testing.assert_array_equal(got, np.array(want, np.float32))


def test_fold_in_static_is_flax_per_parameter_key():
    """flax's ``init`` of a conv from a key: the kernel is ``he_normal`` of
    ``param_key(key, path)``."""
    from flax import linen as nn

    conv = nn.Conv(16, (3, 3), use_bias=False,
                   kernel_init=nn.initializers.variance_scaling(2.0, "fan_out", "normal"))
    want = conv.init(jax.random.PRNGKey(7), jnp.zeros((1, 8, 8, 3)))["params"]["kernel"]
    got = jr.he_normal_fan_out(jr.param_key(jr.key(7), ()), (3, 3, 3, 16))
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("seed", [0, 3, 5])
def test_initial_state_is_the_jax_trainers(seed):
    """``create_model(seed=s)`` and head 0 grown from ``fold_in(grow_key, 0)``
    against the JAX trainer's weights for ``--seed s`` (resnet32, the
    race's 100-wide head, 50 classes): every tensor bitwise."""
    want = jax_initial_state(seed, "resnet32", 100, 50)
    got = port_initial_state(seed, "resnet32", 100, 50)
    assert got.keys() == want.keys()
    differ = sum(int((got[k] != want[k]).sum()) for k in want)
    assert differ == 0


def test_one_channel_stem_is_flaxs_draw():
    """The 1-channel backbones' stem kernel ``[3, 3, 1, 16]``: flax's
    initializer on the key flax's ``init`` gives it at seed 0."""
    from flax import linen as nn
    from flax.core.scope import _fold_in_static

    init_key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), 0xC11))[0]
    key = _fold_in_static(init_key, ("backbone", "conv_1_3x3", 1))
    want = nn.initializers.variance_scaling(2.0, "fan_out", "normal")(key, (3, 3, 1, 16))
    got = port_initial_state(0, "resnet20mnist", 10, 5)["backbone.conv_1_3x3.weight"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).transpose(3, 2, 0, 1))


def test_the_trainers_first_two_heads_are_jaxs():
    """The port trainer at ``--seed 3`` (synthetic10, resnet20) after growing
    task 0 equals ``jax_initial_state``; its head 1, grown at task 1, equals
    JAX's ``grow`` from ``fold_in(grow_key, 1)``."""
    trainer = build_trainer(["--platform", "cpu", "--data_set", "synthetic10", "--num_bases",
                             "0", "--increment", "5", "--backbone", "resnet20", "--seed", "3",
                             "--aa", "none", "--color_jitter", "0"])
    trainer._grow_state(0, 0, 5)
    state = {k: v.clone() for k, v in trainer.state.model.state_dict().items()}
    want = jax_initial_state(3, "resnet20", 10, 5)
    for k in want:
        np.testing.assert_array_equal(state[k].numpy(), want[k].numpy(), err_msg=k)
    trainer._grow_state(1, 5, 5)
    model, variables = jm.create_model("resnet20", 10)
    grow_key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(3), 0xC11))[1]
    variables = jm.grow(variables, jax.random.fold_in(grow_key, 1), 5, 5)
    variables = jax.device_get(unfreeze(variables))
    fc = from_jax_variables(variables["params"], variables["batch_stats"])
    np.testing.assert_array_equal(trainer.state.model.fc.weight[5:].detach().numpy(),
                                  fc["fc.weight"][5:].numpy())
    np.testing.assert_array_equal(trainer.state.model.fc.bias[5:].detach().numpy(),
                                  fc["fc.bias"][5:].numpy())
    np.testing.assert_array_equal(trainer.state.model.fc.weight[:5].detach().numpy(),
                                  want["fc.weight"][:5].numpy())


def test_fixture_digests_are_the_ports_draws():
    recipes = json.load(open(DIGESTS))["recipes"]
    assert [(r["backbone"], r["seed"]) for r in recipes] == [
        (b, s) for b, _, _ in RECIPES for s in (0, 5)]
    for r in recipes:
        assert chip_smoke.init_digests(r["backbone"], r["width"], r["increments"],
                                       r["seed"]) == r["digests"], r


def write_fixture() -> None:
    recipes = [{"backbone": b, "width": w, "increments": list(inc), "seed": s,
                "digests": chip_smoke.init_digests(b, w, inc, s)}
               for b, w, inc in RECIPES for s in (0, 5)]
    with open(DIGESTS, "w") as f:
        json.dump({"recipes": recipes}, f, indent=1)
        f.write("\n")
    print(DIGESTS)


if __name__ == "__main__":
    if sys.argv[1:] == ["write"]:
        torch.set_num_threads(1)
        write_fixture()
