from .trainer import (
    MultiSteps,
    TrainState,
    create_train_state,
    init_weights,
    make_eval_step,
    make_forward,
    make_optimizer,
    make_train_step,
)

__all__ = [
    "MultiSteps", "TrainState", "create_train_state", "init_weights", "make_eval_step",
    "make_forward", "make_optimizer", "make_train_step",
]
