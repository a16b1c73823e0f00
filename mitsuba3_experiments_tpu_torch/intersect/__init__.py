from .bvh_torch import ray_intersect, ray_intersect_brute, ray_test  # noqa: F401
from .triangle import intersect_tri  # noqa: F401
