from .loop import evaluate, evaluate_split, train
from .state import SGD, AdamW, TrainState, create_train_state, lr_ladder, make_adamw, make_optimizer, warmup_cosine
from .steps import make_eval_step, make_eval_sweep, make_forward, make_train_scan, make_train_step

__all__ = [
    "SGD", "AdamW", "TrainState", "create_train_state", "evaluate", "evaluate_split", "lr_ladder",
    "make_adamw", "make_eval_step", "make_eval_sweep", "make_forward", "make_optimizer", "make_train_scan",
    "make_train_step", "train", "warmup_cosine",
]
