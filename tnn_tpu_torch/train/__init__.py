"""Training (``tnn_tpu.train``): the train and eval steps, their state,
and ``train_model``'s loop with checkpoints."""
from .loop import evaluate, train_model
from .step import (TrainState, create_train_state, load_jax_train_state,
                   make_eval_step, make_predict, make_train_step,
                   resolve_remat_policy, train_state_trees)

__all__ = ["TrainState", "create_train_state", "make_eval_step",
           "make_predict", "make_train_step", "train_model", "evaluate",
           "load_jax_train_state", "resolve_remat_policy",
           "train_state_trees"]
