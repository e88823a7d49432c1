from .mesh import contact_model_shardings, make_mesh, replicate, shard_batch
from .distributed import initialize as distributed_initialize
from .distributed import make_global_mesh, shard_global_batch
from .longseq import lm_solve_frame_sharded
