from .loop import evaluate, train_model  # noqa: F401
from .step import (TrainState, create_train_state,  # noqa: F401
                   load_jax_train_state, make_eval_step, make_predict,
                   make_train_step, resolve_remat_policy,
                   train_state_trees)
