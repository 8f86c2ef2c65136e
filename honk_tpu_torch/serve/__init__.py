from .http import serve
from .service import LabelService, default_labels
from .streams import StreamHub

__all__ = ["LabelService", "StreamHub", "default_labels", "serve"]
