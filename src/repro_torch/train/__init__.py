"""Training: WGAN-GP for the generators, masked MSE for the zoo's
supervised heads, and a resilient generic driver."""
from .loop import NodeFailure, TrainDriver
from .supervised import SupervisedTrainer, pair_source, train_supervised
from .wgan import (WganTrainer, critic_loss, generator_loss, make_wgan_steps,
                   train_wgan)

__all__ = ["NodeFailure", "SupervisedTrainer", "TrainDriver", "WganTrainer",
           "critic_loss", "generator_loss", "make_wgan_steps", "pair_source",
           "train_supervised", "train_wgan"]
