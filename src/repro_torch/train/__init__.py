"""Training: the microbatched QAT step and the trainer loop."""
from .step import (TrainState, init_state, loss_fn,  # noqa: F401
                   make_eval_step, make_train_step)
from .trainer import Trainer, TrainerConfig  # noqa: F401
