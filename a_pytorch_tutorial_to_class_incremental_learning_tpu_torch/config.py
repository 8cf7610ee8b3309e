"""Experiment configuration: the frozen ``CilConfig`` and the CLI parser.

Same field names, flag names and defaults as the JAX package's
``config.py``, so one argv drives either trainer.  The port runs the race
recipe (crop + flip, f32, per-step loop) on one device or data parallel over
N processes; every flag that selects something outside it is rejected by
:func:`check_supported` (or, for ``--mesh_model``, ``parallel.data_axis``)
with the name of the slice that will bring it, never silently ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# The iCaRL/PODNet CIFAR-100 class order of the reference's experiment script.
CIFAR100_CLASS_ORDER: Tuple[int, ...] = (
    68, 56, 78, 8, 23, 84, 90, 65, 74, 76, 40, 89, 3, 92, 55, 9, 26, 80, 43,
    38, 58, 70, 77, 1, 85, 19, 17, 50, 28, 53, 13, 81, 45, 82, 6, 59, 83, 16,
    15, 44, 91, 41, 72, 60, 79, 52, 20, 10, 31, 54, 37, 95, 14, 71, 96, 98,
    97, 2, 64, 66, 42, 22, 35, 86, 24, 34, 87, 21, 99, 0, 88, 27, 18, 94, 11,
    12, 47, 25, 30, 46, 62, 69, 36, 61, 7, 63, 75, 5, 32, 4, 51, 48, 73, 93,
    39, 67, 29, 49, 57, 33,
)

# CIFAR statistics apply only to the exact flag value "CIFAR" at 32 px; the
# default lowercase "cifar" normalizes with ImageNet statistics (a quirk of
# the reference kept for parity).
CIFAR_MEAN = (0.5071, 0.4867, 0.4408)
CIFAR_STD = (0.2675, 0.2565, 0.2761)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
MNIST_MEAN = (0.1307,)
MNIST_STD = (0.3081,)


def compute_increments(
    nb_classes: int, initial_increment: int, increment: int
) -> Tuple[int, ...]:
    """``[base, increment, increment, ...]``; ``base = initial_increment``,
    or ``increment`` when it is 0."""
    base = initial_increment if initial_increment > 0 else increment
    if base > nb_classes:
        raise ValueError(f"num_bases={base} exceeds nb_classes={nb_classes}")
    rest = nb_classes - base
    if increment <= 0 or rest % increment != 0:
        raise ValueError(
            f"increment={increment} does not evenly divide the "
            f"{rest} classes remaining after the base task"
        )
    return (base,) + (increment,) * (rest // increment)


@dataclass(frozen=True)
class CilConfig:
    """Static configuration for one class-incremental experiment."""

    seed: int = 0

    num_bases: int = 50
    increment: int = 10

    backbone: str = "resnet32"

    batch_size: int = 128          # per process (the global batch is × N)
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 5e-4
    num_epochs: int = 140
    smooth: float = 0.0            # label smoothing
    eval_every_epoch: int = 5

    input_size: int = 32
    color_jitter: float = 0.4
    aa: Optional[str] = "rand-m9-mstd0.5-inc1"
    reprob: float = 0.0
    remode: str = "pixel"
    recount: int = 1
    resplit: bool = False
    ra_interpolation: str = "bilinear"

    herding_method: str = "barycenter"
    memory_size: int = 2000
    fixed_memory: bool = False
    herding_augmented: bool = True  # herding features from augmented images

    lambda_kd: float = 0.5
    dynamic_lambda_kd: bool = False
    kd_temperature: float = 2.0

    data_set: str = "cifar"
    data_path: str = "/data/data/data/cifar100"
    class_order: Optional[Tuple[int, ...]] = CIFAR100_CLASS_ORDER

    dist_url: str = "env://"
    mesh_shape: Optional[Tuple[int, int]] = None  # (data, model)

    precision: str = ""
    compute_dtype: str = "float32"
    bn_group_size: int = 0
    use_pallas_loss: bool = False  # the fused masked-CE kernel (ops/)
    compile_cache: str = ""        # XLA's cache: the port has no compiler cache
    fused_epochs: bool = True      # the port always runs the per-step loop
    prefetch_depth: int = 0

    ckpt_dir: Optional[str] = None
    ckpt_backend: str = "pickle"
    resume: bool = False
    epoch_ckpt_every: int = 0

    fault_spec: Optional[str] = None
    fault_state: Optional[str] = None

    recompile_budget: bool = False
    check_donation: bool = False
    check_threads: bool = False
    check_contracts: bool = False
    check_lockstep: bool = False
    lockstep_dir: Optional[str] = None
    lockstep_deadline_s: float = 120.0

    profile_dir: Optional[str] = None
    log_file: Optional[str] = None

    telemetry_dir: Optional[str] = None
    heartbeat_path: Optional[str] = None
    heartbeat_interval_s: float = 15.0
    flight_events: int = 256
    metrics: bool = True
    metrics_interval_s: float = 10.0

    export_dir: Optional[str] = None
    serve_buckets: Tuple[int, ...] = (1, 8, 32, 64)
    serve_skew_check: bool = False

    def increments(self, nb_classes: int) -> Tuple[int, ...]:
        return compute_increments(nb_classes, self.num_bases, self.increment)

    def normalization_stats(self) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
        if self.data_set == "CIFAR" and self.input_size == 32:
            return CIFAR_MEAN, CIFAR_STD
        if "mnist" in self.data_set.lower():
            return MNIST_MEAN, MNIST_STD
        return IMAGENET_MEAN, IMAGENET_STD

    def replace(self, **kw) -> "CilConfig":
        return dataclasses.replace(self, **kw)


# (field, predicate that is True when the value is outside this slice, slice)
_LATER_SLICES = (
    ("aa", lambda v: v not in (None, "none", "None", ""), "augmentation (RandAugment)"),
    ("color_jitter", lambda v: v > 0, "augmentation (color jitter)"),
    ("reprob", lambda v: v > 0, "augmentation (random erasing)"),
    ("precision", lambda v: v not in ("", "f32"), "precision"),
    ("compute_dtype", lambda v: v != "float32", "precision"),
    ("ckpt_dir", lambda v: v is not None, "checkpoints"),
    ("resume", bool, "checkpoints"),
    ("epoch_ckpt_every", lambda v: v > 0, "checkpoints"),
    ("fault_spec", lambda v: v is not None, "faults"),
    ("fault_state", lambda v: v is not None, "faults"),
    ("telemetry_dir", lambda v: v is not None, "telemetry"),
    ("heartbeat_path", lambda v: v is not None, "telemetry"),
    ("profile_dir", lambda v: v is not None, "telemetry"),
    ("recompile_budget", bool, "telemetry"),
    ("check_donation", bool, "checkpoints"),
    ("check_threads", bool, "telemetry"),
    ("check_contracts", bool, "telemetry"),
    ("check_lockstep", bool, "lockstep"),
    ("lockstep_dir", lambda v: v is not None, "lockstep"),
    ("prefetch_depth", lambda v: v > 0, "prefetch"),
    ("export_dir", lambda v: v is not None, "serving"),
    ("serve_skew_check", bool, "serving"),
)


def check_supported(config: CilConfig) -> None:
    """Raise ``NotImplementedError`` for any option this slice does not run."""
    for field, outside, later in _LATER_SLICES:
        value = getattr(config, field)
        if outside(value):
            raise NotImplementedError(
                f"{field}={value!r} is not ported yet: it arrives with the "
                f"{later} slice of the PyTorch port (it runs crop + flip "
                "augmentation in f32; pass e.g. --aa none --color_jitter 0)"
            )


def get_args_parser() -> argparse.ArgumentParser:
    """The JAX package's flags, names and defaults unchanged; ``--platform``
    picks the torch device instead of the JAX backend."""
    p = argparse.ArgumentParser(
        "Class-Incremental Learning training and evaluation script (PyTorch)",
        add_help=False,
    )
    d = CilConfig()
    p.add_argument("--seed", default=d.seed, type=int)
    p.add_argument("--num_bases", default=d.num_bases, type=int)
    p.add_argument("--increment", default=d.increment, type=int)
    p.add_argument("--backbone", default=d.backbone, type=str)
    p.add_argument("--batch_size", default=d.batch_size, type=int)
    p.add_argument("--input_size", default=d.input_size, type=int)
    p.add_argument("--color_jitter", default=d.color_jitter, type=float)
    p.add_argument("--aa", default=d.aa, type=str,
                   help='AutoAugment policy, e.g. "rand-m9-mstd0.5-inc1" or "none"')
    p.add_argument("--reprob", default=d.reprob, type=float,
                   help="Random erase probability")
    p.add_argument("--remode", default=d.remode, type=str)
    p.add_argument("--recount", default=d.recount, type=int)
    p.add_argument("--resplit", action="store_true", default=False)
    p.add_argument("--ra_interpolation", default=d.ra_interpolation, type=str,
                   choices=("bilinear", "bicubic", "random"))
    p.add_argument("--herding_method", default=d.herding_method, type=str)
    p.add_argument("--memory_size", default=d.memory_size, type=int)
    p.add_argument("--fixed_memory", action="store_true", default=False)
    p.add_argument("--no_herding_augmented", action="store_false",
                   dest="herding_augmented", default=True,
                   help="extract herding features from clean (eval-"
                   "preprocessed) images instead of augmented ones")
    p.add_argument("--lr", default=d.lr, type=float)
    p.add_argument("--momentum", default=d.momentum, type=float)
    p.add_argument("--weight_decay", default=d.weight_decay, type=float)
    p.add_argument("--num_epochs", default=d.num_epochs, type=int)
    p.add_argument("--smooth", default=d.smooth, type=float)
    p.add_argument("--eval_every_epoch", default=d.eval_every_epoch, type=int)
    p.add_argument("--dist_url", default=d.dist_url)
    p.add_argument("--data_set", default=d.data_set)
    p.add_argument("--data_path", default=d.data_path)
    p.add_argument("--lambda_kd", default=d.lambda_kd, type=float)
    p.add_argument("--dynamic_lambda_kd", action="store_true", default=False)
    p.add_argument("--precision", default=d.precision,
                   choices=["", "f32", "bf16_all", "bf16_selective"])
    p.add_argument("--compute_dtype", default=d.compute_dtype,
                   choices=["float32", "bfloat16"])
    p.add_argument("--mesh_data", default=0, type=int,
                   help="data-axis size: 0 or the number of processes "
                   "(torchrun --nproc_per_node N ... --mesh_data N)")
    p.add_argument("--mesh_model", default=1, type=int)
    p.add_argument("--ckpt_dir", default=None, type=str)
    p.add_argument("--ckpt_backend", default=d.ckpt_backend,
                   choices=["pickle", "orbax"])
    p.add_argument("--resume", action="store_true", default=False)
    p.add_argument("--epoch_ckpt_every", default=d.epoch_ckpt_every, type=int)
    p.add_argument("--fault_spec", default=None, type=str)
    p.add_argument("--fault_state", default=None, type=str)
    p.add_argument("--recompile_budget", action="store_true", default=False)
    p.add_argument("--check_donation", action="store_true", default=False)
    p.add_argument("--check_threads", action="store_true", default=False)
    p.add_argument("--check_contracts", action="store_true", default=False)
    p.add_argument("--check_lockstep", action="store_true", default=False)
    p.add_argument("--lockstep_dir", default=None, type=str)
    p.add_argument("--lockstep_deadline_s", default=120.0, type=float)
    p.add_argument("--profile_dir", default=None, type=str)
    p.add_argument("--log_file", default=None, type=str,
                   help="write a structured JSONL experiment log")
    p.add_argument("--telemetry_dir", default=None, type=str)
    p.add_argument("--heartbeat_path", default=None, type=str)
    p.add_argument("--heartbeat_interval_s", default=d.heartbeat_interval_s,
                   type=float)
    p.add_argument("--flight_events", default=d.flight_events, type=int)
    p.add_argument("--no_metrics", dest="metrics", action="store_false",
                   default=True)
    p.add_argument("--metrics_interval_s", default=d.metrics_interval_s,
                   type=float)
    p.add_argument("--bn_group_size", default=0, type=int)
    p.add_argument("--use_pallas_loss", action="store_true", default=False,
                   help="run the train loss through the fused masked-CE "
                   "kernels (CUDA C++ on CUDA; their plain version on the CPU)")
    p.add_argument("--no_fused_epochs", action="store_false",
                   dest="fused_epochs", default=True,
                   help="accepted for parity; the port runs one step per "
                   "batch either way")
    p.add_argument("--prefetch_depth", default=d.prefetch_depth, type=int)
    p.add_argument("--platform", default="default",
                   choices=["default", "cpu", "cuda"],
                   help="torch device: default = cuda, and an error when no "
                   "CUDA device exists; 'cpu' runs the whole CLI on the CPU")
    p.add_argument("--host_devices", default=0, type=int)
    p.add_argument("--export_dir", default=None, type=str)
    p.add_argument("--serve_buckets", default="1,8,32,64", type=str)
    p.add_argument("--serve_skew_check", action="store_true", default=False)
    p.add_argument("--compile_cache", default="~/.cache/cil_tpu/xla_cache",
                   help="accepted for parity; the port compiles no XLA "
                   "programs")
    return p


def parse_serve_buckets(text) -> Tuple[int, ...]:
    try:
        vals = sorted({int(tok) for tok in str(text).split(",") if tok.strip()})
    except ValueError:
        raise ValueError(f"bad --serve_buckets {text!r}; want e.g. '1,8,32,64'")
    if not vals or vals[0] <= 0:
        raise ValueError(f"--serve_buckets must be positive ints, got {text!r}")
    return tuple(vals)


def config_from_args(args: argparse.Namespace) -> CilConfig:
    aa = None if args.aa in (None, "none", "None", "") else args.aa
    mesh_shape = None
    if args.mesh_data or args.mesh_model != 1:
        mesh_shape = (args.mesh_data or 1, args.mesh_model)
    precision = args.precision or ""
    compute_dtype = args.compute_dtype
    if precision:
        compute_dtype = "bfloat16" if precision.startswith("bf16") else "float32"
    return CilConfig(
        seed=args.seed,
        num_bases=args.num_bases,
        increment=args.increment,
        backbone=args.backbone,
        batch_size=args.batch_size,
        lr=args.lr,
        momentum=args.momentum,
        weight_decay=args.weight_decay,
        num_epochs=args.num_epochs,
        smooth=args.smooth,
        eval_every_epoch=int(args.eval_every_epoch),
        input_size=args.input_size,
        color_jitter=args.color_jitter,
        aa=aa,
        reprob=args.reprob,
        remode=args.remode,
        recount=args.recount,
        resplit=args.resplit,
        ra_interpolation=args.ra_interpolation,
        herding_method=args.herding_method,
        memory_size=args.memory_size,
        fixed_memory=args.fixed_memory,
        herding_augmented=args.herding_augmented,
        lambda_kd=args.lambda_kd,
        dynamic_lambda_kd=args.dynamic_lambda_kd,
        data_set=args.data_set,
        data_path=args.data_path,
        dist_url=args.dist_url,
        mesh_shape=mesh_shape,
        precision=precision,
        compute_dtype=compute_dtype,
        bn_group_size=args.bn_group_size,
        use_pallas_loss=args.use_pallas_loss,
        compile_cache=args.compile_cache or "",
        fused_epochs=args.fused_epochs,
        prefetch_depth=args.prefetch_depth,
        ckpt_dir=args.ckpt_dir,
        ckpt_backend=args.ckpt_backend,
        resume=args.resume,
        epoch_ckpt_every=args.epoch_ckpt_every,
        fault_spec=args.fault_spec,
        fault_state=args.fault_state,
        recompile_budget=args.recompile_budget,
        check_donation=args.check_donation,
        check_threads=args.check_threads,
        check_contracts=args.check_contracts,
        check_lockstep=args.check_lockstep,
        lockstep_dir=args.lockstep_dir,
        lockstep_deadline_s=args.lockstep_deadline_s,
        profile_dir=args.profile_dir,
        log_file=args.log_file,
        telemetry_dir=args.telemetry_dir,
        heartbeat_path=args.heartbeat_path,
        heartbeat_interval_s=args.heartbeat_interval_s,
        flight_events=args.flight_events,
        metrics=args.metrics,
        metrics_interval_s=args.metrics_interval_s,
        export_dir=args.export_dir,
        serve_buckets=parse_serve_buckets(args.serve_buckets),
        serve_skew_check=args.serve_skew_check,
    )
