from .types import PhysInput, PhysResult, PhysWeights
from .prepare import prepare_input
from .collocation import solve_physics
from .apply import apply_results
