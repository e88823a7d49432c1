from . import openpose, totalcap
from .one_euro import one_euro_filter
