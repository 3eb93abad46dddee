"""Training: the microbatched QAT step, the compressed-gradient step and
the trainer loop."""
from .step import (TrainState, init_state, loss_fn,  # noqa: F401
                   make_eval_step, make_train_step,
                   make_train_step_compressed)
from .trainer import Trainer, TrainerConfig  # noqa: F401
