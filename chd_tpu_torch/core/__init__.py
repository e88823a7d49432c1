from . import bvh, fk, quat
from .animation import Animation
from .skeleton import Skeleton, ancestors_mask, children_list, descendants_mask
