"""The paper's generator towers and the WGAN critic."""
from .dcnn import (CELEBA_DCNN, MNIST_DCNN, DcnnConfig, DeconvLayerCfg,
                   critic_apply, critic_init, critic_params_from_numpy,
                   generator_apply, generator_init,
                   generator_params_from_numpy, make_fused_generator,
                   tower_input)

__all__ = ["CELEBA_DCNN", "MNIST_DCNN", "DcnnConfig", "DeconvLayerCfg",
           "critic_apply", "critic_init", "critic_params_from_numpy",
           "generator_apply", "generator_init", "generator_params_from_numpy",
           "make_fused_generator", "tower_input"]
