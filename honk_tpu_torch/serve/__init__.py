from .http import serve
from .service import LabelService, default_labels

__all__ = ["LabelService", "default_labels", "serve"]
