"""Synthetic datasets, drawn with numpy from a seed."""
from .synthetic import digit_images, face_images, token_stream

__all__ = ["digit_images", "face_images", "token_stream"]
