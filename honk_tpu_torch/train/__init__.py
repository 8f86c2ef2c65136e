from .loop import evaluate, evaluate_split, train
from .state import SGD, TrainState, create_train_state, lr_ladder, make_optimizer
from .steps import make_eval_step, make_eval_sweep, make_forward, make_train_scan, make_train_step

__all__ = [
    "SGD", "TrainState", "create_train_state", "evaluate", "evaluate_split", "lr_ladder",
    "make_eval_step", "make_eval_sweep", "make_forward", "make_optimizer", "make_train_scan",
    "make_train_step", "train",
]
