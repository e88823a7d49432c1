"""Pipeline package (lazy imports, so the light CLI commands stay light)."""


def __getattr__(name):
    if name in ("run_pipeline", "run_kinematic_stage", "run_physics_stage",
                "run_retarget_stage"):
        from . import run as _run

        return getattr(_run, name)
    raise AttributeError(name)
