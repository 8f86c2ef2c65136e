from .augment import (
    AugmentConfig,
    Draws,
    TrainArrays,
    assemble_batch,
    draw_batch,
    eval_batch,
    kernel_operands,
    make_noise_windows,
    pad_pool,
    prepare_train_arrays,
    sample_train_batch,
    step_generator,
    timeshift,
)
from .dataset import (
    DEFAULT_WANTED_WORDS,
    LABEL_SILENCE,
    LABEL_UNKNOWN,
    PackedDataset,
    PackedSplit,
    load_speech_commands,
)
from .splits import DEV, TEST, TRAIN, which_set
from .synthetic import generate_dataset, generate_hard_dataset
from .wavio import read_wav, read_wav_int16, write_wav

__all__ = [
    "AugmentConfig", "DEFAULT_WANTED_WORDS", "DEV", "Draws", "LABEL_SILENCE", "LABEL_UNKNOWN",
    "PackedDataset", "PackedSplit", "TEST", "TRAIN", "TrainArrays", "assemble_batch", "draw_batch",
    "eval_batch", "generate_dataset", "kernel_operands", "generate_hard_dataset", "load_speech_commands",
    "make_noise_windows", "pad_pool", "prepare_train_arrays", "read_wav", "read_wav_int16",
    "sample_train_batch", "step_generator", "timeshift", "which_set", "write_wav",
]
