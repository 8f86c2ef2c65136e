"""Label names shared by serving and (later) the data loaders.

Copied from ``honk_tpu.data.dataset``; the loaders come with the training
slice of the port.
"""

LABEL_SILENCE = "__silence__"
LABEL_UNKNOWN = "__unknown__"
DEFAULT_WANTED_WORDS = ("yes", "no", "up", "down", "left", "right", "on", "off", "stop", "go")
