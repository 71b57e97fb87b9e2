"""Synthetic datasets, drawn with numpy from a seed, and the step-indexed
pipeline over them."""
from .pipeline import (Prefetcher, StepIndexedSource, finite_batches,
                       image_source, lm_source)
from .synthetic import digit_images, face_images, token_stream

__all__ = ["Prefetcher", "StepIndexedSource", "digit_images", "face_images",
           "finite_batches", "image_source", "lm_source", "token_stream"]
