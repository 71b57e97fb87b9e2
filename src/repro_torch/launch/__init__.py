"""Device meshes (`launch.mesh`: the DCNN paths' single-controller mesh,
the LM's process-group mesh, the production meshes over a fake world)
and the sharded LM's step builders, shardings and dry-run cells
(`launch.steps`); the dry run and the hill-climb (`launch.dryrun`,
`launch.hillclimb`, entry points of their own)."""
from .mesh import (DeviceMesh, LmMesh, init_distributed, make_lm_mesh,
                   make_production_mesh, make_serving_mesh, make_test_mesh)
from .steps import (abstract_params, batch_shardings, build_decode_step,
                    build_prefill_step, build_train_step, cache_shardings,
                    default_grad_accum, default_policy, init_placed_params,
                    lower_cell, make_optimizer, opt_shardings,
                    opt_state_shapes, place_params)

__all__ = ["DeviceMesh", "LmMesh", "init_distributed", "make_lm_mesh",
           "make_production_mesh", "make_serving_mesh", "make_test_mesh",
           "abstract_params", "batch_shardings", "build_decode_step",
           "build_prefill_step", "build_train_step", "cache_shardings",
           "default_grad_accum", "default_policy", "init_placed_params",
           "lower_cell", "make_optimizer", "opt_shardings",
           "opt_state_shapes", "place_params"]
