"""Tests of the port that need a CUDA card: the CUDA C++ kernels against
their plain versions, the forward's in-kernel batch reduction, a train
step through the kernels against the same step through the plain loss, the
augmentation on the card against the same functions on the CPU, one
step under each precision preset, the graphed fused epoch against eager
steps, the prefetcher's side stream, ``stall_frac`` of a per-step epoch
at ``--prefetch_depth 0`` against the profiler's idle share, and a serving
artifact's captured graphs (bitwise its eager model; a capture in one
thread while another replays).  They skip without a card.  This file imports no JAX, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data import augment as taug
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine import train as tt
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.models import NEG_INF, CilModel
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.models.resnet import Conv2d
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops import fused_loss
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops.precision import PRESETS
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
    ran = fused_loss.device_launches()
    per, lse, out = fused_loss.fused_ce_fwd(x, y, na, smooth, 1.0 / b)
    dx = fused_loss.fused_ce_bwd(x, y, na, lse, g, smooth, 1.0 / b)
    torch.cuda.synchronize()
    assert (fused_loss.FWD_LAUNCHES, fused_loss.BWD_LAUNCHES) == (launches[0] + 1,
                                                                  launches[1] + 1)
    # Each kernel counted its own run on the card.
    assert fused_loss.device_launches() == (ran[0] + 1, ran[1] + 1)
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


INTEGER_OPS = (1, 2, 4, 5, 6)  # Equalize, Invert, Posterize, Solarize, SolarizeAdd


@pytest.mark.parametrize("interpolation", ["bilinear", "bicubic"])
@pytest.mark.parametrize("op", range(taug.NUM_RA_OPS), ids=lambda i: taug.RA_OPS[i])
def test_ra_op_on_the_card_matches_the_cpu(cuda, op, interpolation):
    """Each op at magnitudes {0, 4.5, 9, 10} x sign ±1 on 128 seeded images:
    within 1 LSB of the CPU, bitwise for the integer ops and the identity
    warp (magnitude 0 of a geometric op)."""
    imgs = torch.from_numpy(np.random.RandomState(op).randint(0, 256, (128, 32, 32, 3))
                            .astype(np.float32))
    for mag in (0.0, 4.5, 9.0, 10.0):
        for sign in (1.0, -1.0):
            args = (torch.full((128,), op), torch.full((128,), mag), torch.full((128,), sign))
            ref = taug.ra_apply(imgs, *args, 32, interpolation)
            got = taug.ra_apply(imgs.to(cuda), *(a.to(cuda) for a in args), 32,
                                interpolation).cpu()
            if op in INTEGER_OPS or (op in taug.GEOMETRIC_OPS and mag == 0.0):
                assert torch.equal(got, ref), (op, mag, sign)
            else:
                assert (got - ref).abs().max() <= 1.0, (op, mag, sign)


@pytest.mark.parametrize("recipe", [
    dict(rand_augment=False, color_jitter=0.4),
    dict(rand_augment=False, color_jitter=0.0, reprob=0.5, remode="pixel", recount=2),
    dict(rand_augment=False, color_jitter=0.0, reprob=0.5, remode="rand"),
    dict(reprob=0.5, remode="const", ra_interpolation="random"),
])
def test_pipeline_on_the_card_matches_the_cpu(cuda, recipe):
    """Colour jitter, erasing and RandAugment with draws fixed on the CPU:
    the card's normalized output equals the CPU's to rtol 1e-6 where the
    uint8 levels agree, and the levels to 1 LSB."""
    cfg = taug.AugmentConfig(**recipe)
    u8 = torch.from_numpy(np.random.RandomState(3).randint(0, 256, (128, 32, 32, 3))
                          .astype(np.uint8))
    draws = taug.draw_params(128, cfg, torch.Generator().manual_seed(4), (32, 32, 3))
    ref = taug.augment(u8, draws, cfg)
    on_card = taug.Draws(**{k: None if v is None else v.to(cuda)
                            for k, v in vars(draws).items()})
    got = taug.augment(u8.to(cuda), on_card, cfg).cpu()
    std = torch.tensor(cfg.std) * 255
    levels = (got - ref).mul(std).abs()
    assert levels.max() <= 1.0 + 1e-3
    same = levels < 1e-3
    assert same.float().mean() > 0.99
    torch.testing.assert_close(got[same], ref[same], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("preset", list(PRESETS))
def test_step_under_each_preset_through_the_kernels(cuda, preset):
    """One RandAugment train step through the CUDA kernels under each
    preset: finite loss, one launch of each kernel, f32 logits, parameters,
    momentum and BN statistics, conv outputs in the compute dtype."""
    policy = PRESETS[preset]
    torch.manual_seed(0)
    model = CilModel("resnet20", 10, policy=policy).to(cuda)
    with torch.no_grad():
        model.fc.weight[:6].uniform_(-0.1, 0.1)
    conv_dtypes = set()
    for m in model.modules():
        if isinstance(m, Conv2d):
            m.register_forward_hook(lambda _m, _i, out: conv_dtypes.add(out.dtype) and None)
    state = tt.TrainState(model, tt.sgd_init(model.parameters()),
                          torch.tensor([6], dtype=torch.int32, device=cuda),
                          torch.tensor([0], dtype=torch.int32, device=cuda))
    step = tt.make_train_step(taug.AugmentConfig(), policy, 0.0, 2.0, 0.9, 5e-4,
                              use_pallas_loss=True)
    x = torch.randint(0, 256, (16, 32, 32, 3), dtype=torch.uint8, device=cuda)
    y = torch.randint(0, 6, (16,), device=cuda)
    launches = (fused_loss.FWD_LAUNCHES, fused_loss.BWD_LAUNCHES)
    m = step(state, None, x, y, torch.Generator(device=cuda).manual_seed(1), 0.1, 0.5)
    torch.cuda.synchronize()
    assert (fused_loss.FWD_LAUNCHES, fused_loss.BWD_LAUNCHES) == (launches[0] + 1,
                                                                  launches[1] + 1)
    assert np.isfinite(float(m["loss"]))
    assert conv_dtypes == {policy.compute_dtype}
    with torch.no_grad():
        logits, _ = model(taug.eval_preprocess(x, taug.AugmentConfig()), state.num_active)
    assert logits.dtype == torch.float32
    assert all(t.dtype == torch.float32 for t in [*model.parameters(), *model.buffers(),
                                                  *state.momentum])


def test_graphed_epoch_equals_eager_steps_and_counts_launches(cuda):
    """The fused epoch on the card (a captured step replayed) against the
    same steps run eagerly from the same state, bitwise under deterministic
    cuDNN: two epochs, the second all replays, a reseeded generator.  The
    kernels count themselves once a step on the card; the graphed run calls
    the wrappers twice (the eager first step and the capture)."""
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.models import (
        create_model,
        grow,
    )
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils import jax_random

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        g = torch.Generator().manual_seed(0)
        data_x = torch.randint(0, 256, (40, 32, 32, 3), dtype=torch.uint8, generator=g).to(cuda)
        data_y = torch.randint(0, 6, (40,), generator=g).to(cuda)
        tables = [torch.stack([torch.randperm(40, generator=g)[:16] for _ in range(3)]).to(cuda)
                  for _ in range(2)]
        runs = []
        for graphed in (True, False):
            model = create_model("resnet20", 10, seed=3).to(cuda)
            grow(model, jax_random.key(1), 0, 6)
            state = tt.TrainState(model, tt.sgd_init(model.parameters()),
                                  torch.tensor([6], dtype=torch.int32, device=cuda),
                                  torch.tensor([0], dtype=torch.int32, device=cuda))
            epoch = tt.make_epoch_fn(taug.AugmentConfig(), PRESETS["f32"], 0.0, 2.0, 0.9, 5e-4,
                                     use_pallas_loss=True, device=cuda)
            assert epoch.graphed
            epoch.graphed = graphed
            gen = torch.Generator(device=cuda)
            lr, lam = torch.tensor(0.1, device=cuda), torch.tensor(0.5, device=cuda)
            fused_loss.reset_launches()
            rows = []
            for e, table in enumerate(tables):
                gen.manual_seed(100 + e)
                lr.fill_(0.1 / (e + 1))
                rows.append(epoch(state, None, data_x, data_y, table, gen, lr, lam))
            torch.cuda.synchronize()
            assert fused_loss.device_launches() == (6, 6)
            calls = 2 if graphed else 6
            assert (fused_loss.FWD_LAUNCHES, fused_loss.BWD_LAUNCHES) == (calls, calls)
            assert epoch.captures == (1 if graphed else 0)
            runs.append((torch.cat(rows).cpu(),
                         [t.detach().cpu() for t in [*model.parameters(), *model.buffers()]]))
        assert torch.equal(runs[0][0], runs[1][0])
        assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    finally:
        torch.backends.cudnn.deterministic = False


def test_prefetcher_copies_on_a_side_stream(cuda):
    """At depth 2 on the card the batches are the host's, each placed on a
    side stream that the consumer's stream waits on."""
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data.prefetch import (
        DevicePrefetcher,
        to_device,
    )

    rng = np.random.RandomState(0)
    host = [(rng.randint(0, 256, (64, 32, 32, 3)).astype(np.uint8), np.arange(64) + i)
            for i in range(6)]
    streams = set()

    def place(batch):
        streams.add(torch.cuda.current_stream(cuda).cuda_stream)
        return to_device(cuda, *batch, pinned=True)

    with DevicePrefetcher(iter(host), place, 2, device=cuda) as pf:
        got = [(x.cpu().numpy(), y.cpu().numpy()) for x, y in pf]
    assert not pf.alive and len(got) == len(host)
    assert all(np.array_equal(a, c) and np.array_equal(b, d) for (a, b), (c, d) in zip(got, host))
    assert streams and torch.cuda.current_stream(cuda).cuda_stream not in streams


def _serving_artifact(tmp_path, task_id, known, seed):
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data.augment import (
        AugmentConfig,
    )
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.models import (
        create_model,
        grow,
    )
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.serving import (
        export_artifact,
    )
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils import jax_random
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils.checkpoint import (
        _model_state,
    )

    model = create_model("resnet20", 10, seed=seed)
    grow(model, jax_random.key(seed), 0, known)
    state = _model_state(model)
    return export_artifact(
        str(tmp_path), task_id, AugmentConfig(), state["params"], state["batch_stats"],
        known=known, class_order=list(range(10)), input_size=32, channels=3, buckets=(1, 8),
        device="cuda", model_meta={"backbone": "resnet20", "width": 10, "precision": "f32",
                                   "bn_group_size": 0})


@pytest.mark.parametrize("host_ms", [0, 8, 32])
def test_stall_frac_at_depth_0_is_the_cards_idle_share(cuda, host_ms):
    """A per-step epoch at ``--prefetch_depth 0`` whose step is long (a chain
    of 4096² matmuls, ~21 ms) and whose host batches are cheap (16 uint8
    images) or take ``host_ms`` more to make (a sleep in the decode): the
    card is busy nearly all the epoch, or (32 ms) idle a third of it.  The
    step is long against the loop's own ~1.5 ms a step under the profiler.  The
    blocking copy of each batch waits for the step queued before it, and
    the production that overlaps that step starves nothing, so
    ``stall_frac`` must be within 0.10 of the idle share the profiler
    measures (it read ~0.7 when the wait was charged to the host)."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine.train import METRICS
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.main import build_trainer
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.telemetry import StallClock
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils.profiling import (
        kernel_table,
    )

    trainer = build_trainer([
        "--data_set", "synthetic10", "--num_bases", "0", "--increment", "5",
        "--backbone", "resnet20", "--batch_size", "16", "--aa", "none", "--color_jitter", "0",
        "--no_fused_epochs", "--prefetch_depth", "0"])
    task = next(iter(trainer.scenario_train))
    a = torch.randn(4096, 4096, device=cuda) / 64

    def long_step(state, teacher, x, y, gen, lr, lam):
        b = a
        for _ in range(8):
            b = a @ b
        v = b[0, 0] + x.float().mean() + y.float().mean()
        return {k: v for k in METRICS}

    trainer.train_step = long_step
    decode = trainer._decode
    trainer._decode = lambda x, train, seed: (time.sleep(host_ms / 1e3), decode(x, train, seed))[1]
    long_step(None, None, torch.zeros(1, device=cuda), torch.zeros(1, device=cuda), None, 0, 0)
    torch.cuda.synchronize()
    clock = StallClock()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rows = trainer._run_epoch_steps(0, task, 0, None, clock)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    busy_ms = sum(us for _, us in kernel_table(prof).values()) / 1e3
    idle = 1.0 - busy_ms / wall_ms
    assert len(rows) == 20 and 0.0 <= idle < 0.6, (len(rows), busy_ms, wall_ms)
    assert abs(clock.stall_frac - idle) < 0.10, (clock.snapshot(), busy_ms, wall_ms)


def test_serving_artifact_replays_its_eager_model_bitwise(cuda, tmp_path):
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.serving import (
        direct_predict,
        load_artifact,
        probe_artifact,
    )

    path = _serving_artifact(tmp_path, 0, 5, 0)
    art = load_artifact(path)
    assert art.device.type == "cuda" and all(r.graph is not None for r in art.runners.values())
    assert probe_artifact(art) == {"ok": True, "checked": True, "max_abs": 0.0}
    x = np.random.RandomState(0).randint(0, 256, (8, 32, 32, 3)).astype(np.uint8)
    np.testing.assert_array_equal(art.predict_padded(x, 8), direct_predict(path, x))
    assert art.runners[8].programs._cache_size() == 0


def test_serving_capture_while_another_thread_replays(cuda, tmp_path):
    """A hot swap's load captures its graphs while the batcher replays the
    old artifact: thread-local capture lets both run, and neither changes
    the other's logits."""
    import threading

    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.serving import (
        load_artifact,
    )

    old = load_artifact(_serving_artifact(tmp_path / "a", 0, 5, 0))
    new_path = _serving_artifact(tmp_path / "b", 1, 10, 1)
    x = np.random.RandomState(1).randint(0, 256, (8, 32, 32, 3)).astype(np.uint8)
    want = old.predict_padded(x, 8)
    stop, got, errors = threading.Event(), [], []

    def replay():
        while not stop.is_set():
            try:
                got.append(old.predict_padded(x, 8))
            except Exception as e:  # noqa: BLE001 — asserted empty below
                errors.append(repr(e))

    t = threading.Thread(target=replay)
    t.start()
    try:
        new = [load_artifact(new_path) for _ in range(3)]
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive() and not errors and got
    assert all(np.array_equal(g, want) for g in got)
    assert all(np.array_equal(a.predict_padded(x, 8), new[0].predict_padded(x, 8)) for a in new)
