"""The envs' third-party packages. MuJoCo and gymnasium are needed by
`envs/` and the env half of `data/demos.py` only, so they are imported when
an env module is, never by the rest of the package."""
import importlib


def require(name: str):
    """Import and return the module `name`; raise ImportError naming it when
    it is not installed."""
    try:
        return importlib.import_module(name)
    except ImportError as e:
        raise ImportError(f"real_robot_nerf_actor_tpu_torch.envs needs the {name!r} "
                          f"package, which is not installed") from e
