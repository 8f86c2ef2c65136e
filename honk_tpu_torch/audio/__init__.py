from .snippet import AudioSnippet

__all__ = ["AudioSnippet"]
