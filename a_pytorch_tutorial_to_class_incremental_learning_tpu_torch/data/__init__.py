"""Data layer: datasets, class-incremental scenario, rehearsal memory, host
batching and on-device augmentation."""

from .datasets import build_raw_dataset, load_cifar100, load_synthetic  # noqa: F401
from .scenario import ClassIncremental, TaskSet  # noqa: F401
from .memory import (  # noqa: F401
    RehearsalMemory,
    herd_barycenter,
    herd_cluster,
    herd_random,
)
from .loader import eval_batches, sequential_batches, train_batches  # noqa: F401


def build_scenario(config, train: bool):
    """Dataset flags -> ``(ClassIncremental scenario, nb_classes)``.

    The default CIFAR-100 order on a dataset with another class count (a
    synthetic smoke run) falls back to the identity order; any other order
    that does not fit the dataset is an error.
    """
    from ..config import CIFAR100_CLASS_ORDER

    (x, y), nb_classes = build_raw_dataset(
        config.data_set, config.data_path, train, config.input_size
    )
    order = config.class_order
    if order is not None and len(order) != nb_classes:
        if tuple(order) != CIFAR100_CLASS_ORDER:
            raise ValueError(
                f"class_order has {len(order)} entries but the dataset has "
                f"{nb_classes} classes"
            )
        order = None
    scenario = ClassIncremental(
        x,
        y,
        initial_increment=config.num_bases,
        increment=config.increment,
        class_order=order,
    )
    return scenario, nb_classes
