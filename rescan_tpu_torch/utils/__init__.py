from . import rng, timing  # noqa: F401
