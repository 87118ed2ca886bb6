from . import ply, rsdb, paths  # noqa: F401
