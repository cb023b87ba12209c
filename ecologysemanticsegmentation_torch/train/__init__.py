"""Training machinery of the port: the steps, the schedules and the
checkpoints."""

from .checkpoint import (
    checkpoint_path,
    list_checkpoints,
    load_checkpoint_file,
    load_recent_model,
    make_checkpointer,
    save_checkpoint,
)
from .schedules import (
    BackgroundWeightSchedule,
    ReduceLROnPlateau,
    cosine_annealing_warm_restarts,
    curriculum_gates,
)
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
    "BackgroundWeightSchedule", "MultiSteps", "ReduceLROnPlateau", "TrainState",
    "checkpoint_path", "cosine_annealing_warm_restarts", "create_train_state",
    "curriculum_gates", "init_weights", "list_checkpoints", "load_checkpoint_file",
    "load_recent_model", "make_checkpointer", "make_eval_step", "make_forward",
    "make_optimizer", "make_train_step", "save_checkpoint",
]
