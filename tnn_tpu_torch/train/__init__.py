from .step import (TrainState, create_train_state, make_eval_step,  # noqa: F401
                   make_train_step)
