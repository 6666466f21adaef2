from stylex_tpu_torch.train.state import TrainState, create_train_state, make_optimizers
from stylex_tpu_torch.train.steps import (
    PhaseDraws,
    StepDraws,
    draw_step,
    make_train_step,
    microbatch_schedule,
    step_flags,
)

__all__ = [
    "TrainState",
    "create_train_state",
    "make_optimizers",
    "PhaseDraws",
    "StepDraws",
    "draw_step",
    "make_train_step",
    "microbatch_schedule",
    "step_flags",
]
