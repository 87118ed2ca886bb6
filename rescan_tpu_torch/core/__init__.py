from .pointcloud import PointCloud  # noqa: F401
