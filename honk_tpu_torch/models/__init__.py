from .cnn import SpeechModel
from .layers import init_weights
from .registry import ConfigType, find_config, find_model
from .res import SpeechResModel
from .torch_compat import from_flax_variables, load_honk_checkpoint, load_state_dict

__all__ = [
    "ConfigType", "SpeechModel", "SpeechResModel", "find_config", "find_model",
    "from_flax_variables", "init_weights", "load_honk_checkpoint", "load_state_dict",
]
