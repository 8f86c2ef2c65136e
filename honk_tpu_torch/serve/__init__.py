from .http import serve
from .service import LabelService, TrainingService, default_labels
from .streams import StreamHub

__all__ = ["LabelService", "StreamHub", "TrainingService", "default_labels", "serve"]
