"""Tiny sizes of the benchmark's cells, for the CPU tests."""

PARALLEL = {"geometry.image_size": 32, "geometry.n_angles": 40, "model.base_features": 8,
            "model.n_iters": 2}
RADIAL = {"geometry.image_size": 32, "geometry.n_angles": 64, "model.base_features": 8,
          "model.n_iters": 2}
#: the cells' runs here unroll in float32: a sound tiny run then reads far
#: below the limits set for bf16 at full size, and a broken one far above
F32 = {"model.use_bfloat16": False}

#: cell → (config overrides, traffic overrides)
CELLS = {
    "pdunet_parallel.volume": ({**PARALLEL, **F32},
                               {"batch": 4, "pool": 2, "trace_requests": [1, 3]}),
    "pdunet_radial.volume": ({**RADIAL, **F32}, {"batch": 2, "pool": 2, "trace_requests": [1, 3]}),
    "pdunet_parallel.train": ({**PARALLEL, **F32},
                              {"batch": 4, "trace_steps": [1, 3], "phase_steps": [3, 5]}),
}

SEED = 2 ** 33 + 17
