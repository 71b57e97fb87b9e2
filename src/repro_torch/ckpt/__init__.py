"""Checkpoints in the JAX package's on-disk layout."""
from .checkpoint import (AsyncCheckpointer, restore, retain, save,
                         train_state_from_numpy, valid_steps)

__all__ = ["AsyncCheckpointer", "restore", "retain", "save",
           "train_state_from_numpy", "valid_steps"]
