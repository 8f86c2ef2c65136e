from .configs import DataConfig, ExperimentConfig, MeshConfig, StreamConfig, TrainConfig

__all__ = ["DataConfig", "ExperimentConfig", "MeshConfig", "StreamConfig", "TrainConfig"]
