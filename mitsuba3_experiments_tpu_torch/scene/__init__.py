from .types import (  # noqa: F401
    BSDFKind,
    BVH,
    Camera,
    EmitterTable,
    Geometry,
    MaterialTable,
    Scene,
    TextureAtlas,
)
from .build import load_dict  # noqa: F401
from .cornell import cornell_box  # noqa: F401
from .bvh import build_bvh  # noqa: F401
from .flagship import standin_dict  # noqa: F401
from .convert import scene_from_numpy, scene_to_numpy  # noqa: F401
from .params import PARAM_KEYS, traverse, update  # noqa: F401
