"""A cell cut to a size the CPU runs in seconds: few pixels, views and
samples, a small grid. Only the tests use it."""

RENDER = {"n_coarse": 8, "n_fine": 8}


def overrides(name: str):
    """``(workload overrides, configuration overrides)`` for cell ``name``."""
    if name == "ref-train":
        return {"views": 20, "resolution": [16, 16]}, {"train": {"n_rays": 64}, "render": RENDER}
    config = {"render": RENDER}
    if name == "ref-accel32":
        config["accel"] = {"grid_resolution": 16, "probe_resolution": 8}
    return {"resolution": [24, 16], "warm_frames": 1, "max_frames": 16}, config


def execute(name: str, seed: int = 12345678901, seconds: float = 0.5, **config_extra):
    from nerfbench import run

    wo, co = overrides(name)
    co.update(config_extra)
    return run.execute(name, seed, seconds, False, device="cpu", workload_overrides=wo,
                       config_overrides=co)
