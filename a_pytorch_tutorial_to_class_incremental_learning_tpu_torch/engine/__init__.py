"""Engine: train/eval/feature steps, SGD, losses and the WA task loop."""

from .losses import accuracy, cross_entropy, soft_target_kd, topk_correct  # noqa: F401
from .train import (  # noqa: F401
    Teacher,
    TrainState,
    cosine_lr,
    make_eval_step,
    make_feature_step,
    make_train_step,
    sgd_init,
    sgd_update,
    train_step_on_batch,
)
from .loop import CilTrainer  # noqa: F401
