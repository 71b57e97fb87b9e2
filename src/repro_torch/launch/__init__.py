"""Device meshes (`launch.mesh`: the DCNN paths' single-controller mesh,
the LM's process-group mesh) and the sharded LM's step builders and
shardings (`launch.steps`)."""
from .mesh import (DeviceMesh, LmMesh, init_distributed, make_lm_mesh,
                   make_serving_mesh, make_test_mesh)
from .steps import (abstract_params, batch_shardings, build_decode_step,
                    build_prefill_step, build_train_step, cache_shardings,
                    default_grad_accum, default_policy, init_placed_params,
                    make_optimizer, opt_shardings, opt_state_shapes,
                    place_params)

__all__ = ["DeviceMesh", "LmMesh", "init_distributed", "make_lm_mesh",
           "make_serving_mesh", "make_test_mesh",
           "abstract_params", "batch_shardings", "build_decode_step",
           "build_prefill_step", "build_train_step", "cache_shardings",
           "default_grad_accum", "default_policy", "init_placed_params",
           "make_optimizer", "opt_shardings", "opt_state_shapes",
           "place_params"]
