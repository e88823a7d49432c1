"""What the JᵀJ·v kernel test files share (``tests/test_torch_jtjv.py``,
``tests/test_torch_phys_jtjv.py`` and their ``_cuda`` twins): a graph cache
that records its keys, and the emulation put in the kernels' place. Imports
no JAX."""
from chd_tpu_torch.ops import jtjv as jtjv_ops


class RecordingGraphs:
    """A ``GraphCache`` stand-in that runs each step eagerly and keeps its
    key, and keeps constants as the cache does."""

    def __init__(self):
        self.keys = []
        self.constants = {}

    def constant(self, key, make):
        if key not in self.constants:
            self.constants[key] = make()
        return self.constants[key]

    def run(self, key, step, state, args, iters):
        self.keys.append(key)
        for _ in range(iters):
            state = step(state, args)
        return state


def emulate(monkeypatch, tile=None) -> dict:
    """Put the emulation in the kernels' place on every device: the one rule
    (``ops.jtjv.supplier``) then gives every solve of a residual that names
    a kernel that kernel's ``emulated(tile)`` supplier, one per kernel
    supplier, so a captured step's key is found again. Returns the map
    kernel supplier → emulation."""
    made = {}

    def supplier(x0, make):
        kernel = make()
        if kernel not in made:
            made[kernel] = kernel.emulated(tile)
        return made[kernel]

    monkeypatch.setattr(jtjv_ops, "supplier", supplier)
    return made


def linearize(fn, x, *args):
    """JᵀJ of the residual ``fn`` at x by the supplier ``fn`` names for a
    solve from x (the one route ``lm_solve`` takes: on a card, its kernel)."""
    product = fn.product_for(x)
    assert product is not None, f"the residual names no supplier on {x.device}"
    return product(x, *args)
