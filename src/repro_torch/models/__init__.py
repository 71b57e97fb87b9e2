"""The paper's generator towers."""
from .dcnn import (CELEBA_DCNN, MNIST_DCNN, DcnnConfig, DeconvLayerCfg,
                   generator_apply, generator_init,
                   generator_params_from_numpy, tower_input)

__all__ = ["CELEBA_DCNN", "MNIST_DCNN", "DcnnConfig", "DeconvLayerCfg",
           "generator_apply", "generator_init", "generator_params_from_numpy",
           "tower_input"]
