from .compose import (
    Composer, instantiate, resolve_interpolations, save_config,
)

__all__ = ["Composer", "instantiate", "resolve_interpolations",
           "save_config"]
